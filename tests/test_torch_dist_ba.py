"""The port's distributed BAs (orb_slam3_fast_tpu_torch/parallel/dist_ba.py,
kernel AF's plain versions on the CPU) against the JAX package's
(tests/test_dist_ba.py): ``make_ba_problem(K=8, M=256)`` through
``make_distributed_ba`` and ``make_distributed_ba_cg``, built fresh (never
through the ``get_*`` factories), at a world of one in this process and at
two gloo ranks spawned once for the module.  The port's two ranks hold the
same state bit for bit and agree with its world of one and with the JAX
package's runs on ``make_mesh(8)`` and ``make_mesh(1)`` within the JAX
package's own 5e-4 (rotation entries) and 5e-3 (translations)
(tests/test_dist_ba.py:37-38); the dense run converges as there (:20-24).
The global BA's slice through the mapper is tests/test_torch_dist_gba.py."""
import jax
import numpy as np
import pytest
import torch

from orb_slam3_fast_tpu.parallel import dist_ba as jdist
from tests import torch_dist_cases as cases
from tests.test_ba import BF, CAM, make_ba_problem, reproj_rmse
from tests.torch_ranks import Ranks

torch.set_num_threads(1)

CAM_ARGS = (400.0, 400.0, 320.0, 240.0)  # tests/test_ba.py's CAM
RUNS = {"dense": dict(n_iters=8), "cg": dict(iters1=4, iters2=6)}  # tests/test_dist_ba.py's dense counts
TOL_R, TOL_T = 5e-4, 5e-3


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    r = Ranks(2, tmp_path_factory.mktemp("dist_ba_ranks"))
    yield r
    r.close()


def arrays_of(prob) -> dict:
    return {f: np.array(getattr(prob, f)) for f in cases.dist_ba.STATE + cases.dist_ba.OBS}


def jax_run(prob, form: str, n_devices: int) -> tuple:
    mesh = jdist.make_mesh(n_devices)
    make = jdist.make_distributed_ba if form == "dense" else jdist.make_distributed_ba_cg
    out = make(mesh, CAM, BF, **RUNS[form])(jdist.shard_problem(prob, mesh))
    return tuple(np.asarray(x) for x in out)


def close(a, b) -> None:
    np.testing.assert_allclose(a[0], b[0], atol=TOL_R)
    np.testing.assert_allclose(a[1], b[1], atol=TOL_T)


@pytest.mark.parametrize("form", ["dense", "cg"])
def test_two_ranks_match_world_one_and_jax(ranks, form):
    """Each form on make_ba_problem(K=8, M=256, noise 0.3): the two ranks
    bit for bit equal; their state against the port's world of one and the
    JAX package's 8- and 1-device meshes, and the port's world of one
    against the JAX package's one device, within 5e-4 / 5e-3; the inlier
    masks (O,) over the whole table, the ranks' equal; the cost finite."""
    assert len(jax.devices()) >= 8, "conftest must provide 8 virtual devices"
    prob, *_ = make_ba_problem(np.random.default_rng(0), K=8, M=256, noise=0.3)
    arrays = arrays_of(prob)
    one = cases.ba_run(arrays, CAM_ARGS, float(BF), form, RUNS[form])
    two = ranks.run(cases.ba_run, arrays, CAM_ARGS, float(BF), form, RUNS[form])
    assert all(np.array_equal(a, b) for a, b in zip(two[0][:4], two[1][:4])) and two[0][4] == two[1][4]
    j8, j1 = jax_run(prob, form, 8), jax_run(prob, form, 1)
    for ref in (one, j8, j1):
        close(two[0], ref)
    close(one, j1)
    assert two[0][3].shape == (prob.obs_kf.shape[0],) and np.isfinite(two[0][4])
    assert int((two[0][3] != one[3]).sum()) <= 2


def test_two_ranks_dense_converges(ranks):
    """tests/test_dist_ba.py:11-24 at two ranks: the dense run (12 LM
    iterations) brings the reprojection RMSE under 0.5 px and the camera
    centres within 0.02 of the truth."""
    prob, R_gt, t_gt, _ = make_ba_problem(np.random.default_rng(0), K=8, M=256, noise=0.2)
    R, t, xw, _, _ = ranks.run(cases.ba_run, arrays_of(prob), CAM_ARGS, float(BF), "dense", dict(n_iters=12))[0]
    assert reproj_rmse(prob, R, t, xw) < 0.5
    c_est = -np.einsum("kji,kj->ki", R, t)
    c_gt = -np.einsum("kji,kj->ki", R_gt, t_gt)
    assert np.linalg.norm(c_est - c_gt, axis=1).max() < 0.02


def test_shard_pads_to_the_world(ranks):
    """An observation count the world does not divide: the table is padded
    with obs_valid=False rows, each rank gets its contiguous chunk, and the
    CG run over 2 ranks still matches the world of one."""
    prob, *_ = make_ba_problem(np.random.default_rng(4), K=8, M=256, noise=0.3)
    arrays = arrays_of(prob)
    for f in cases.dist_ba.OBS:
        arrays[f] = arrays[f][:-3]  # 2045 observations
    one = cases.ba_run(arrays, CAM_ARGS, float(BF), "cg", RUNS["cg"])
    two = ranks.run(cases.ba_run, arrays, CAM_ARGS, float(BF), "cg", RUNS["cg"])
    assert two[0][3].shape == (2046,) and not two[0][3][-1]
    close(two[0], one)
