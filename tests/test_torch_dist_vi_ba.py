"""FullInertialBA over observation shards (``parallel/dist_ba.py``
``shard_vi_problem``, ``make_distributed_vi_ba_cg``; kernel AG's plain
stages on the CPU) against the JAX package, at the port's world of one
(this process) and at two gloo ranks spawned once for the module:

(a) one plain LM step and the implicit solve with their reduction hooks
    against the JAX package's ``_lm_step_vi`` / ``_implicit_vi_solve``
    with psum-free hooks, on tests/test_vi_ba.py's ``build_vi_problem``
    (8 keyframes, 256 landmarks);
(b) the whole run (4 + 8 LM steps, 32 CG iterations) against the JAX
    package's ``make_distributed_vi_ba_cg`` on its 8 virtual devices and
    the port's ``full_inertial_ba_cg`` (which tests/test_torch_vi_ba_cg.py
    holds to the JAX package's), under tests/test_dist_ba.py:41-72's gates;
    and at two ranks with an odd observation count, whose padded row adds
    nothing;
(c) the slice: ``InertialTracker._full_inertial_ba`` on
    tests/test_torch_vi_loop.py's 30-keyframe world (O = 1920, one outlier)
    at two ranks, at the port's world of one and in the JAX package on its
    8 virtual devices (its sharded branch: 1920 % 8 = 0);
(d) the port's factory keeping each ``T_cb`` and ``bf``, where the JAX
    package's cache key (``parallel/dist_ba.py:326``) omits them.

The bound of (c) between the port's two ranks and its world of one is
derived from the spread measured on this world (the same CPU runs, numpy-
seeded): 1.85e-6 in the keyframe states (rotation entries, translations,
velocities, biases) and 5.5e-5 m in the landmarks, the two ranks summing
the shards' float64 partial sums in another order than one rank; five and
ten times those, 1e-5 and 5e-4 m, are held.  Against the JAX package
(float32 CG) the port keeps test_torch_vi_loop.py:90's 2e-3."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam3_fast_tpu.map.worldmap import WorldMap as JMap
from orb_slam3_fast_tpu.optim import vi_ba_cg as jcg
from orb_slam3_fast_tpu.parallel import dist_ba as jdist
from orb_slam3_fast_tpu.utils import lie as jlie
from orb_slam3_fast_tpu_torch.cameras import models as tcam
from orb_slam3_fast_tpu_torch.optim import vi_ba_cg as tcg
from orb_slam3_fast_tpu_torch.parallel import dist_ba, multihost
from orb_slam3_fast_tpu_torch.utils import convert
from orb_slam3_fast_tpu_torch.utils import lie as tlie
from tests import torch_dist_cases as cases
from tests.test_inertial import CAM as J_CAM
from tests.test_vi_ba import build_vi_problem
from tests.test_vi_ba_cg import _make_tracker
from tests.torch_ranks import Ranks

torch.set_num_threads(1)

CAM_ARGS = (400.0, 400.0, 320.0, 240.0)  # tests/test_inertial.py's camera (= the body)
NOISE_ARGS = (1.7e-4, 2e-3, 1.9e-5, 3e-3, 200.0)  # tests/test_inertial.py's IMU noise
RUN = dict(iters1=4, iters2=8, cg_iters=32)  # tests/test_dist_ba.py:63-64
CG = 32
TOL_WORLD = (1e-5, 5e-4)  # (c): the port's two ranks against its world of one, derived in the docstring
OUTLIER = (10, 0)  # (c): tests/test_torch_vi_loop.py's outlier observation (keyframe, slot)
T_ID = tlie.SE3(torch.eye(3), torch.zeros(3))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    r = Ranks(2, tmp_path_factory.mktemp("dist_vi_ranks"))
    yield r
    r.close()


@pytest.fixture(scope="module")
def problem():
    """build_vi_problem(n_kf=8, n_lm=256) (2048 observations) in both
    packages, the port's as numpy arrays for the ranks, and the truth."""
    jp, R_gt, p_gt, v_gt, _ = build_vi_problem(np.random.default_rng(0), n_kf=8, n_lm=256)
    tp = convert.inertial_to_torch(jp)
    return jp, tp, convert.inertial_to_numpy(tp), (R_gt, p_gt, v_gt)


@pytest.fixture
def jax_caches():
    """The JAX package's distributed FullInertialBA cache emptied for the
    test and restored after it."""
    saved = dict(jdist._DIST_VI_BA_CG_CACHE)
    jdist._DIST_VI_BA_CG_CACHE.clear()
    yield
    jdist._DIST_VI_BA_CG_CACHE.clear()
    jdist._DIST_VI_BA_CG_CACHE.update(saved)


def _np(x):
    return np.asarray(x, np.float64)


class Counted:
    """An identity reduction hook that counts its calls."""

    def __init__(self):
        self.calls = 0

    def __call__(self, x):
        self.calls += 1
        return x


@pytest.fixture(scope="module")
def jax_step(problem):
    """The JAX package's ``_lm_step_vi`` with its psum-free default hooks on
    the whole problem (jitted: ``lm_segment_vi`` of one step, lam 1e-4)."""
    jp = problem[0]
    return jcg.lm_segment_vi(J_CAM, jnp.float32(0.0), jlie.SE3.identity(), jp, jp.R_wb, jp.p_wb, jp.v_w, jp.bias,
                             jp.xw, jnp.ones(jp.obs_uv.shape[0], bool), jnp.float32(1e-4), n_iters=1, cg_iters=CG)


@pytest.fixture(scope="module")
def jax_solve(problem):
    """The port's plain blocks at the start (tests/test_torch_vi_ba_cg.py
    holds them to the JAX package's) and the JAX package's
    ``_implicit_vi_solve`` on them with its psum-free default hooks, lam
    1e-4: (blocks as numpy, dx, dl)."""
    jp, tp = problem[:2]
    inl = torch.ones(tp.obs_uv.shape[0], dtype=torch.bool)
    Hpp, Hll, bp, bl, W, w_lm, _ = tcg._visual_blocks_cg(tcam.Camera.pinhole(*CAM_ARGS), 0.0, T_ID, tp.R_wb, tp.p_wb,
                                                         tp.xw, tp, inl)
    Hii, Hjj, Hij, g, _ = tcg._inertial_edge_blocks(tp, tp.R_wb, tp.p_wb, tp.v_w, tp.bias)
    blocks = {k: v.numpy() for k, v in dict(Hpp=Hpp, Hll=Hll, bp=bp, bl=bl, W=W, w_lm=w_lm, Hii=Hii, Hjj=Hjj,
                                             Hij=Hij, g=g).items()}
    j = {k: jnp.asarray(v) for k, v in blocks.items()}
    dx, dl = jcg._implicit_vi_solve(j["Hpp"], j["Hll"], j["bp"], j["bl"], j["W"], j["Hii"], j["Hjj"], j["Hij"],
                                    j["g"], jp.obs_kf, jp.obs_lm, jp.edge_i, jp.edge_j, j["w_lm"], jp.state_fixed,
                                    jp.lm_valid, jnp.float32(1e-4), CG)
    return blocks, _np(dx), _np(dl)


@pytest.mark.parametrize("world", ["one", "two"])
def test_plain_step_with_hooks_matches_jax(problem, ranks, jax_step, world):
    """One plain LM step (lam 1e-4, 32 CG iterations) from the perturbed
    start with the reduction hooks: at a world of one with counting
    identity hooks (reduce_s on the 6 visual sums and the candidate's cost,
    reduce_k at setup twice and once per CG iteration, reduce_m once per CG
    iteration and at the back-substitution), at two ranks with
    ``Mesh.all_reduce`` on each rank's shard (both ranks bit for bit equal)
    -- against the JAX package's ``_lm_step_vi`` with its psum-free default
    hooks on the whole problem (jitted: ``lm_segment_vi`` of one step):
    states within 1e-3, landmarks within 2e-3 m, the damping and the cost
    within 1e-4 relative (test_torch_vi_ba_cg.py's bounds)."""
    jp, tp, arrays, _ = problem
    out_j = jax_step
    if world == "one":
        hooks = Counted(), Counted(), Counted()
        out = tcg._lm_step_vi(tcam.Camera.pinhole(*CAM_ARGS), 0.0, T_ID, tp, tp.R_wb, tp.p_wb, tp.v_w, tp.bias, tp.xw,
                              torch.ones(tp.obs_uv.shape[0], dtype=torch.bool), torch.tensor(1e-4), CG,
                              reduce_k=hooks[0], reduce_m=hooks[1], reduce_s=hooks[2])
        assert [h.calls for h in hooks] == [2 + CG, CG + 1, 7]
        out = tuple(x.numpy() for x in out)
    else:
        two = ranks.run(cases.vi_step, arrays, CAM_ARGS, 0.0, CG)
        assert all(np.array_equal(a, b) for a, b in zip(two[0], two[1]))
        out = two[0]
    for name, a, b, tol in zip(("R", "p", "v", "bias", "xw"), out[:5], out_j[:5], (1e-3, 1e-3, 1e-3, 1e-3, 2e-3)):
        np.testing.assert_allclose(_np(a), _np(b), atol=tol, err_msg=name)
    assert float(out[5]) == pytest.approx(float(out_j[5]), rel=1e-4)
    assert float(out[6]) == pytest.approx(float(out_j[6]), rel=1e-4)
    assert np.abs(_np(out[1]) - _np(jp.p_wb)).max() > 1e-3  # the step moved the states


@pytest.mark.parametrize("world", ["one", "two"])
def test_plain_solve_with_hooks_matches_jax(problem, ranks, jax_solve, world):
    """``_implicit_vi_solve`` on the same blocks as the JAX package's (lam
    1e-4, 32 CG iterations), the per-observation W split over the ranks with
    ``Mesh.all_reduce`` as reduce_k and reduce_m (two ranks bit for bit
    equal), or whole at a world of one: within 2e-3 of the largest state
    and landmark step of the JAX package's psum-free solve (float64 against
    float32 CG, test_torch_vi_ba_cg.py's bound); the fixed state unmoved."""
    arrays = problem[2]
    blocks, dx_j, dl_j = jax_solve
    if world == "one":
        dx, dl = cases.vi_solve(arrays, blocks, CG)
    else:
        two = ranks.run(cases.vi_solve, arrays, blocks, CG)
        assert all(np.array_equal(a, b) for a, b in zip(two[0], two[1]))
        dx, dl = two[0]
    np.testing.assert_allclose(_np(dx), dx_j, atol=2e-3 * np.abs(dx_j).max())
    np.testing.assert_allclose(_np(dl), dl_j, atol=2e-3 * np.abs(dl_j).max())
    assert not dx[0].any()


@pytest.fixture(scope="module")
def jax_run(problem):
    """The JAX package's sharded run on its 8 virtual devices, RUN's
    schedule (its single-device solve and the port's are held together by
    tests/test_torch_vi_ba_cg.py)."""
    jp = problem[0]
    mesh = jdist.make_mesh(8)
    run = jdist.make_distributed_vi_ba_cg(mesh, J_CAM, jnp.float32(0.0), jlie.SE3.identity(), **RUN)
    return tuple(np.asarray(x) for x in run(jdist.shard_vi_problem(jp, mesh)))


@pytest.mark.parametrize("world", ["one", "two"])
def test_run_meets_jax_gates(problem, ranks, jax_run, world):
    """The whole run (4 + 8 LM steps, 32 CG iterations) at a world of one
    (bit for bit the port's single-device ``full_inertial_ba_cg``) and at
    two ranks (bit for bit equal): tests/test_dist_ba.py:41-72's gates --
    every position within 0.01 m and velocity within 0.05 m/s of the truth,
    positions within 5e-3 of the single-device solve -- and states and
    landmarks within 5e-3 of the JAX package's sharded run on 8 devices;
    the inlier masks differ on at most 0.5% of the observations."""
    jp, tp, arrays, (_, p_gt, v_gt) = problem
    single = tcg.full_inertial_ba_cg(tcam.Camera.pinhole(*CAM_ARGS), 0.0, T_ID, tp, **RUN)
    if world == "one":
        out = cases.vi_run(arrays, CAM_ARGS, 0.0, RUN)
        assert all(np.array_equal(a, b.numpy()) for a, b in zip(out, single[:6]))
    else:
        two = ranks.run(cases.vi_run, arrays, CAM_ARGS, 0.0, RUN)
        assert all(np.array_equal(a, b) for a, b in zip(two[0], two[1]))
        out = two[0]
    assert out[5].shape == (jp.obs_kf.shape[0],)
    assert np.linalg.norm(out[1] - p_gt, axis=1).max() < 0.01
    assert np.linalg.norm(out[2] - v_gt, axis=1).max() < 0.05
    assert np.abs(out[1] - single[1].numpy()).max() < 5e-3
    for name, a, b in zip(("R", "p", "v", "bias", "xw"), out[:5], jax_run[:5]):
        np.testing.assert_allclose(_np(a), _np(b), atol=5e-3, err_msg=f"{name} against 8 JAX devices")
    assert np.mean(out[5] != jax_run[5]) <= 0.005


def _last_observation(arrays: dict, drop: bool) -> dict:
    """``arrays`` with its last observation dropped, or kept with
    ``obs_valid`` False."""
    out = dict(arrays)
    for f in dist_ba.OBS:
        out[f] = arrays[f][:-1] if drop else arrays[f].copy()
    if not drop:
        out["obs_valid"][-1] = False
    return out


def test_padded_row_adds_nothing(problem, ranks):
    """An odd observation count at two ranks: build_vi_problem with its last
    observation dropped (2047 rows, so rank 1's shard ends in an
    ``OBS_PAD`` row, in neither of its CSRs) runs bit for bit as the
    2048-row problem whose last observation is kept but marked
    ``obs_valid`` False (the same split, a real row in the pad's place):
    the padded row adds no cost, no w_lm and no CSR row.  The ranks are bit
    for bit equal and meet tests/test_dist_ba.py:41-72's gates against the
    truth and the single-device solve of the 2047 rows.  (A world of one
    adds the shards' float64 partial sums in another order, so it is not
    the ranks' bit for bit.)"""
    _, _, arrays, (_, p_gt, v_gt) = problem
    odd, masked = _last_observation(arrays, True), _last_observation(arrays, False)
    assert arrays["obs_valid"][-1] and odd["obs_kf"].shape[0] % 2 == 1
    shard = dist_ba.shard_vi_problem(cases.vi_problem(odd), multihost.Mesh(1, 2, torch.device("cpu"), None))
    valid = int(shard.local.obs_valid.sum())
    assert not shard.local.obs_valid[-1] and int(shard.csr[0][-1]) == int(shard.csr[2][-1]) == valid
    assert valid == shard.csr[1].shape[0] == shard.csr[3].shape[0] == int(odd["obs_valid"][1024:].sum())
    two = ranks.run(cases.vi_run, odd, CAM_ARGS, 0.0, RUN)
    ref = ranks.run(cases.vi_run, masked, CAM_ARGS, 0.0, RUN)
    assert all(np.array_equal(a, b) for a, b in zip(two[0], two[1]))
    out = two[0]
    assert out[5].shape == (odd["obs_kf"].shape[0],)
    for name, a, b in zip(("R", "p", "v", "bias", "xw", "inlier"), out, ref[0]):
        assert np.array_equal(a, b[: a.shape[0]]), name
    single = tcg.full_inertial_ba_cg(tcam.Camera.pinhole(*CAM_ARGS), 0.0, T_ID, cases.vi_problem(odd), **RUN)
    assert np.linalg.norm(out[1] - p_gt, axis=1).max() < 0.01
    assert np.linalg.norm(out[2] - v_gt, axis=1).max() < 0.05
    assert np.abs(out[1] - single[1].numpy()).max() < 5e-3


@pytest.fixture(scope="module")
def slice_map(tmp_path_factory):
    """tests/test_torch_vi_loop.py's 30-keyframe inertial world (one
    observation 40 px off), built by the port's copy of
    ``make_inertial_world`` (``chip_smoke.inertial_world``: the same draws,
    its poses within 1.5e-5 of the JAX package's build, in seconds where
    that build takes ~40 s) and saved for both packages."""
    import chip_smoke

    w, _, _, _ = chip_smoke.inertial_world(np.random.default_rng(11), n_kf=30, n_lm=300, obs_per_kf=64)
    w.kf_xy[OUTLIER] += 40.0
    path = str(tmp_path_factory.mktemp("dist_vi_map") / "world.npz")
    w.save(path)
    return path


def test_full_inertial_ba_slice_on_two_ranks(ranks, slice_map, jax_caches):
    """``InertialTracker._full_inertial_ba`` (keyframe 0 fixed) on the
    30-keyframe world: two ranks complete it over observation shards and
    hold the same keyframe states, landmarks and observations bit for bit,
    within the derived 1e-5 / 5e-4 m of the port's world of one (kernel
    AA's plain schedule), and within 2e-3 of the JAX package's
    FullInertialBA on its 8 virtual devices (its sharded branch, whose
    factory it leaves in the cache); the outlier's observation is erased
    on both ranks and in the JAX package."""
    one = cases.vi_tracker_full_ba(slice_map, CAM_ARGS, NOISE_ARGS, [0])
    two = ranks.run(cases.vi_tracker_full_ba, slice_map, CAM_ARGS, NOISE_ARGS, [0])
    assert one[0] and two[0][0] and two[1][0]
    assert all(np.array_equal(a, b) for a, b in zip(two[0][1:], two[1][1:]))
    for name, a, b, tol in zip(("kf_R", "kf_t", "kf_vel", "kf_bias", "lm_pos"), two[0][1:6], one[1:6],
                               (TOL_WORLD[0],) * 4 + (TOL_WORLD[1],)):
        np.testing.assert_allclose(a, b, atol=tol, err_msg=name)
    jw = JMap.load(slice_map)
    assert jw.kf_obs[OUTLIER] >= 0
    assert _make_tracker(jw)._full_inertial_ba(jw, fixed_ids=np.asarray([0]))
    assert len(jdist._DIST_VI_BA_CG_CACHE) == 1  # the JAX tracker took its sharded branch
    K, M = jw.n_kf, jw.n_lm
    for name, a, b in zip(("kf_R", "kf_t", "kf_vel", "kf_bias", "lm_pos"), two[0][1:6],
                          (jw.kf_R[:K], jw.kf_t[:K], jw.kf_vel[:K], jw.kf_bias[:K], jw.lm_pos[:M])):
        np.testing.assert_allclose(a, b, atol=2e-3, err_msg=name)
    assert two[0][6][OUTLIER] == -1 and jw.kf_obs[OUTLIER] == -1


def test_port_factory_keeps_each_T_cb_and_bf(jax_caches):
    """``get_distributed_vi_ba_cg`` builds a run per call, closing over the
    ``T_cb`` and ``bf`` it is given: on the tracker-shaped problem (stereo
    edges, a camera offset from the body) three (T_cb, bf) pairs give three
    results, each a fresh ``make_distributed_vi_ba_cg``'s bit for bit; the
    JAX package's factory returns its first build for every ``T_cb`` and
    ``bf`` of one camera kind and iteration counts."""
    from tests.test_torch_loop_kernels_host import _aa_problem
    from tests.test_torch_vi_ba import T_CAM

    prob, T_off = _aa_problem()
    mesh = multihost.global_mesh("cpu")
    shard = dist_ba.shard_vi_problem(prob, mesh)
    outs = []
    for T_cb, bf in ((T_ID, 40.0), (T_off, 40.0), (T_ID, 48.0)):
        got = dist_ba.get_distributed_vi_ba_cg(mesh, T_CAM, bf, T_cb, 2, 2, cg_iters=8)(shard)
        fresh = dist_ba.make_distributed_vi_ba_cg(mesh, T_CAM, bf, T_cb, 2, 2, cg_iters=8)(shard)
        assert all(torch.equal(a, b) for a, b in zip(got, fresh))
        outs.append(got[1])
    assert float((outs[0] - outs[1]).abs().max()) > 1e-4 and float((outs[0] - outs[2]).abs().max()) > 1e-6
    jmesh = jdist.make_mesh(2)
    first = jdist.get_distributed_vi_ba_cg(jmesh, J_CAM, jnp.float32(40.0), jlie.SE3.identity(), 2, 2, cg_iters=8)
    other = jlie.SE3(jnp.asarray(T_off.R.numpy()), jnp.asarray(T_off.t.numpy()))
    assert jdist.get_distributed_vi_ba_cg(jmesh, J_CAM, jnp.float32(48.0), other, 2, 2, cg_iters=8) is first
