"""The port's 4-DoF essential graph (kernel Z's plain version,
``optimize_4dof_graph``) against the JAX package on tests/test_pose_graph.py's
yaw-only drifted circle: the dense branch, the PCG branch (``_FORCE_CG``
in both packages, and at 200 vertices without it), and the edge Jacobians
against ``jax.jacfwd``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam3_fast_tpu.optim import pose_graph as jpg
from orb_slam3_fast_tpu_torch.optim import pose_graph as tpg
from tests.test_pose_graph import _ate, _build_drifted, _rel_sim3

torch.set_num_threads(1)


def graph4(K: int = 30, seed: int = 1, pad_e: int = 4) -> tuple[dict, tuple]:
    """tests/test_pose_graph.py:105's graph: the odometry chain of a circle
    drifted about gravity alone (rotation noise 0.015, translation noise
    0.02), the exact loop edge (0, K-1), ``pad_e`` invalid edges (0, 0),
    vertex 0 fixed.  Returns the arrays and the truth (R, t)."""
    R0, t0, s0, R_gt, t_gt, _, meas = _build_drifted(K, rot_noise=0.015, t_noise=0.02, s_drift=1.0, seed=seed,
                                                     yaw_only=True)
    E = K + pad_e
    ei, ej = np.zeros(E, np.int32), np.zeros(E, np.int32)
    mR = np.tile(np.eye(3, dtype=np.float32), (E, 1, 1))
    mt, ev = np.zeros((E, 3), np.float32), np.zeros(E, bool)
    for k in range(K - 1):
        ei[k], ej[k] = k + 1, k
        mR[k], mt[k] = meas[k][:2]
        ev[k] = True
    R, t, _ = _rel_sim3(R_gt[0], t_gt[0], 1.0, R_gt[K - 1], t_gt[K - 1], 1.0)
    ei[K - 1], ej[K - 1], mR[K - 1], mt[K - 1], ev[K - 1] = 0, K - 1, R, t, True
    fixed = np.zeros(K, bool)
    fixed[0] = True
    arrays = dict(R=R0.astype(np.float32), t=t0.astype(np.float32), edge_i=ei, edge_j=ej, meas_R=mR, meas_t=mt,
                  edge_valid=ev, fixed=fixed, edge_w=np.ones(E, np.float32))
    return arrays, (R_gt, t_gt)


def _run_both(arrays, iters=12):
    gt = tpg.SE3Graph(**{k: torch.as_tensor(v) for k, v in arrays.items()})
    gj = jpg.SE3Graph(**{k: jnp.asarray(v) for k, v in arrays.items()})
    return [x.numpy() for x in tpg.optimize_4dof_graph(gt, iters=iters)[:2]], \
        [np.asarray(x) for x in jpg.optimize_4dof_graph(gj, iters=iters)]


def test_dense_4dof_matches_jax():
    """The yaw-drifted circle snaps back as in the JAX test (ATE to under
    0.3 of its drift), and the port (float64 solve) lands within 2e-3 of
    the JAX package (float32 LU of the 120 x 120 system) in every rotation
    entry and translation; the fixed vertex does not move."""
    arrays, (R_gt, t_gt) = graph4()
    launches = tpg.optimize_4dof_graph.launches.total()  # other files' host-compiled kernels count on this worker too
    (R_t, t_t), (R_j, t_j) = _run_both(arrays)
    ones = np.ones(len(R_t))
    before = _ate(arrays["R"], arrays["t"], ones, R_gt, t_gt)
    after = _ate(R_t, t_t, ones, R_gt, t_gt)
    assert before > 0.2 and after < 0.3 * before, (before, after)
    np.testing.assert_allclose(R_t, R_j, atol=2e-3)
    np.testing.assert_allclose(t_t, t_j, atol=2e-3)
    assert np.array_equal(R_t[0], arrays["R"][0]) and np.array_equal(t_t[0], arrays["t"][0])
    assert tpg.optimize_4dof_graph.launches.total() == launches  # the CPU runs the plain version


def test_pcg_4dof_matches_jax(monkeypatch):
    """``_FORCE_CG`` in both packages, 12 iterations: the PCG branch within
    2e-3 of the JAX package's and within 2e-3 of the port's dense solve."""
    arrays, _ = graph4()
    dense = [x.numpy() for x in tpg.optimize_4dof_graph(
        tpg.SE3Graph(**{k: torch.as_tensor(v) for k, v in arrays.items()}))[:2]]
    monkeypatch.setattr(tpg, "_FORCE_CG", True)
    monkeypatch.setattr(jpg, "_FORCE_CG", True)
    jax.clear_caches()  # the JAX program reads _FORCE_CG while it traces
    try:
        (R_t, t_t), (R_j, t_j) = _run_both(arrays)
    finally:
        jax.clear_caches()
    for a, b, c in ((R_t, R_j, dense[0]), (t_t, t_j, dense[1])):
        np.testing.assert_allclose(a, b, atol=2e-3)
        np.testing.assert_allclose(a, c, atol=2e-3)


def test_pcg_4dof_at_200_vertices_matches_jax():
    """A yaw-drifted circle of 200 vertices, which both packages solve by
    the PCG branch without ``_FORCE_CG`` (K > DENSE_MAX_K; 64 CG
    iterations a step), 12 iterations: the port within 2e-3 of the JAX
    package, both moving the camera centres towards the truth."""
    arrays, (R_gt, t_gt) = graph4(200, seed=3)
    assert len(arrays["R"]) > tpg.DENSE_MAX_K and not tpg._FORCE_CG and not jpg._FORCE_CG
    (R_t, t_t), (R_j, t_j) = _run_both(arrays)
    np.testing.assert_allclose(R_t, R_j, atol=2e-3)
    np.testing.assert_allclose(t_t, t_j, atol=2e-3)
    ones = np.ones(len(R_t))
    before, after = _ate(arrays["R"], arrays["t"], ones, R_gt, t_gt), _ate(R_t, t_t, ones, R_gt, t_gt)
    assert after < 0.8 * before and abs(after - _ate(R_j, t_j, ones, R_gt, t_gt)) < 1e-3, (before, after)


@pytest.mark.parametrize("moved", [False, True])
def test_edge_jacobians_4dof_match_jacfwd(moved):
    """Residuals (6) and both 6x4 Jacobians of every edge against the JAX
    package's jax.jacfwd: residuals within 1e-5, Jacobians within 1e-4 of
    each edge's largest entry; at the drifted circle and with every vertex
    moved off it by 0.3 rad of yaw and 0.2 m (larger residuals, the closed
    form of the Jacobian inverse)."""
    arrays, _ = graph4()
    if moved:
        rng = np.random.default_rng(5)
        d = rng.normal(0, [0.2, 0.2, 0.2, 0.3], (len(arrays["R"]), 4)).astype(np.float32)
        R, t = jax.vmap(jpg._yaw_update)(jnp.asarray(d), jnp.asarray(arrays["R"]), jnp.asarray(arrays["t"]))
        arrays = dict(arrays, R=np.asarray(R), t=np.asarray(t))
    g = tpg.SE3Graph(**{k: torch.as_tensor(v) for k, v in arrays.items()})
    r, Ji, Jj = tpg.edge_jacobians_4dof(g.R, g.t, g)
    a = {k: jnp.asarray(v) for k, v in arrays.items()}
    zero = jnp.zeros(4)

    @jax.jit
    @jax.vmap
    def one_edge(i, j, mR, mt):
        def f(di, dj):
            return jpg._edge_residual_4dof(di, dj, a["R"][i], a["t"][i], a["R"][j], a["t"][j], mR, mt)

        return f(zero, zero), jax.jacfwd(f, argnums=0)(zero, zero), jax.jacfwd(f, argnums=1)(zero, zero)

    rj, Jij, Jjj = (np.asarray(x) for x in one_edge(a["edge_i"], a["edge_j"], a["meas_R"], a["meas_t"]))
    np.testing.assert_allclose(r.numpy(), rj, atol=1e-5)
    scale = np.maximum(np.abs(Jij).max((1, 2)), np.abs(Jjj).max((1, 2)))[:, None, None]
    assert np.all(np.abs(Ji.numpy() - Jij) <= 1e-4 * scale)
    assert np.all(np.abs(Jj.numpy() - Jjj) <= 1e-4 * scale)


def test_gpu_branch_goes_to_kernel_z():
    """A graph on a device other than the CPU (a meta tensor) goes to
    kernel Z's wrapper, whose argument check refuses a tensor that is not
    on CUDA: it is never run plain there."""
    arrays, _ = graph4()
    g = tpg.SE3Graph(**{k: torch.as_tensor(v).to("meta") for k, v in arrays.items()})
    with pytest.raises(ValueError, match="CUDA"):
        tpg.optimize_4dof_graph(g)
