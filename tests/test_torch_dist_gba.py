"""The slice through the mapper: ``Mapper._run_gba(distributed=True)``, the
loop closer's global BA, over the loop map of tests/test_torch_loop.py
(``loop_keyframes()``, all 24 drifted keyframes, keyframe 0 fixed, 4 + 6
LM iterations), at two gloo ranks spawned once for the module (kernel
AF's CG run, plain on the CPU), against the port's world of one (E -> T ->
AC) and the JAX package's sharded GBA on its 8 virtual devices (its
caches cleared); ``_run_ba(distributed=True)`` at two ranks against the
world of one; and the JAX package's cache-key defect
(``parallel/dist_ba.py:326, 340, 354``) pinned against the port's
factories, which cache nothing.

The tolerance of the two ranks against the JAX package's 8 devices is
derived from the spreads measured on this map (a CPU, numpy-seeded, the
same runs): the JAX package's 8 devices against its one device 5.2e-4 in
rotation entries and 3.5e-2 m in translation; the port against the JAX
package at one device 1.84e-3 and 8.0e-2 m (the GBA starts 0.4 m and 0.13
rad from the truth and does not converge in 10 iterations, and the two
take other paths there: float64 CG in the port, float32 in the JAX
package; test_torch_loop.py's 1e-3 / 1e-2 hold after the essential graph,
nearer the optimum); the port's two ranks against its one 2.5e-5 and
1.3e-3 m.  Their sums, 2.4e-3 and 0.116 m, give 3e-3 and 0.12 m (3% of the
circle's 4 m radius).  The port's two ranks against its one are held to
the JAX package's own unit bounds, 5e-4 and 5e-3 (tests/test_dist_ba.py).
At 8 + 12 iterations the JAX package's single-device GBA goes non-finite
on this map (an SVD of its poses does not converge), so 4 + 6 is kept."""
import numpy as np
import pytest
import torch

from orb_slam3_fast_tpu.backend.mapper import Mapper as JMapper
from orb_slam3_fast_tpu.cameras import models as jcam
from orb_slam3_fast_tpu.map.worldmap import WorldMap as JMap
from orb_slam3_fast_tpu.parallel import dist_ba as jdist
from orb_slam3_fast_tpu_torch.cameras import models as tcam
from orb_slam3_fast_tpu_torch.map.worldmap import WorldMap as TMap
from orb_slam3_fast_tpu_torch.parallel import dist_ba, multihost
from orb_slam3_fast_tpu_torch.utils import lie as tlie
from tests import torch_dist_cases as cases
from tests.test_torch_loop import KP_CAP, N_KF, SIGMA2, add_keyframe, loop_keyframes
from tests.torch_ranks import Ranks

torch.set_num_threads(1)

CAM_ARGS = (400.0, 400.0, 320.0, 240.0)  # the loop map's camera
EUROC_ARGS = (458.654, 457.296, 367.215, 248.375)  # a second pin-hole camera: EuRoC cam0's intrinsics
ITERS, FIXED = (4, 6), [0]
TOL_JAX = (3e-3, 0.12)  # derived in the module's docstring
TOL_WORLD = (5e-4, 5e-3)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    r = Ranks(2, tmp_path_factory.mktemp("dist_gba_ranks"))
    yield r
    r.close()


@pytest.fixture(scope="module")
def loop_map(tmp_path_factory) -> str:
    """The loop map of 24 keyframes, saved for both packages."""
    kfs, _ = loop_keyframes()
    world = TMap(kp_cap=KP_CAP, max_kf=32, max_lm=4096)
    point_lm: dict = {}
    for k in range(N_KF):
        add_keyframe(world, kfs[k], k, point_lm, packed=True)
    path = str(tmp_path_factory.mktemp("dist_gba_map") / "loop.npz")
    world.save(path)
    return path


@pytest.fixture
def jax_caches():
    """The JAX package's distributed-BA caches emptied for the test and
    restored after it, so that no other test of this worker meets what it
    left there."""
    caches = (jdist._DIST_BA_CACHE, jdist._DIST_BA_CG_CACHE, jdist._DIST_VI_BA_CG_CACHE)
    saved = [dict(c) for c in caches]
    for c in caches:
        c.clear()
    yield
    for c, s in zip(caches, saved):
        c.clear()
        c.update(s)


def jax_gba(path: str, cam_args=CAM_ARGS) -> tuple:
    world = JMap.load(path)
    JMapper(jcam.Camera.pinhole(*cam_args), sigma2=SIGMA2)._run_gba(world, np.arange(N_KF), fixed=np.asarray(FIXED),
                                                                     iters=ITERS, distributed=True)
    return world.kf_R[:N_KF].copy(), world.kf_t[:N_KF].copy()


def max_angle(Ra, Rb) -> float:
    """The largest rotation angle between two stacks of rotations."""
    d = torch.as_tensor(np.einsum("kij,klj->kil", Ra, Rb), dtype=torch.float64)
    return float(tlie.so3_log(d).norm(dim=-1).max())


def test_gba_two_ranks_against_world_one_and_jax(ranks, loop_map, jax_caches):
    """The global BA through the mapper: both ranks complete it and hold
    the same map bit for bit; within 5e-4 / 5e-3 of the port's world of one
    and within the derived 3e-3 / 0.12 m of the JAX package's sharded GBA
    on 8 devices; then the JAX package's cache-key defect: a second
    pin-hole camera's GBA asked of ``get_distributed_ba_cg`` first leaves
    the loop camera's sharded GBA on the other camera's closure, at least
    0.1 rad from the fresh build, yet finite (a stale camera does not make
    the sharded GBA non-finite).  The port's factories keep each
    camera: test_port_factories_keep_each_camera."""
    one = cases.mapper_run(loop_map, CAM_ARGS, SIGMA2, "gba", ITERS, FIXED)
    two = ranks.run(cases.mapper_run, loop_map, CAM_ARGS, SIGMA2, "gba", ITERS, FIXED)
    assert one[0] and two[0][0] and two[1][0]
    assert all(np.array_equal(a, b) for a, b in zip(two[0][1:], two[1][1:]))
    np.testing.assert_allclose(two[0][1], one[1], atol=TOL_WORLD[0])
    np.testing.assert_allclose(two[0][2], one[2], atol=TOL_WORLD[1])
    R8, t8 = jax_gba(loop_map)
    np.testing.assert_allclose(two[0][1], R8, atol=TOL_JAX[0])
    np.testing.assert_allclose(two[0][2], t8, atol=TOL_JAX[1])
    # the defect: the JAX cache keys on (devices, camera kind, iterations), not on the intrinsics or bf
    jdist._DIST_BA_CG_CACHE.clear()
    stale = jdist.get_distributed_ba_cg(jdist.make_mesh(), jcam.Camera.pinhole(*EUROC_ARGS), 0.0, *ITERS, cg_iters=32)
    Rs, ts = jax_gba(loop_map)
    assert jdist.get_distributed_ba_cg(jdist.make_mesh(), jcam.Camera.pinhole(*CAM_ARGS), 0.0, *ITERS,
                                       cg_iters=32) is stale
    assert np.isfinite(Rs).all() and np.isfinite(ts).all()
    assert max_angle(Rs, R8) >= 0.1


def test_port_factories_keep_each_camera(loop_map):
    """``get_distributed_ba_cg`` builds a run per call, closing over the
    camera it is given: on the loop map's global-BA problem two cameras of
    one kind and iteration counts give two results, each a fresh
    ``make_distributed_ba_cg``'s bit for bit."""
    from orb_slam3_fast_tpu_torch.backend.mapper import Mapper

    world = TMap.load(loop_map)
    mapper = Mapper(tcam.Camera.pinhole(*CAM_ARGS), bf=0.0, sigma2=SIGMA2, device="cpu")
    prob = mapper._gather_problem(world, np.arange(N_KF), np.asarray(FIXED))[0]
    mesh = multihost.global_mesh("cpu")
    outs = {}
    for args in (EUROC_ARGS, CAM_ARGS):
        cam = tcam.Camera.pinhole(*args)
        got = dist_ba.get_distributed_ba_cg(mesh, cam, 0.0, *ITERS)(dist_ba.shard_problem(prob, mesh))
        fresh = dist_ba.make_distributed_ba_cg(mesh, cam, 0.0, *ITERS)(dist_ba.shard_problem(prob, mesh))
        assert all(torch.equal(a, b) for a, b in zip(got[:4], fresh[:4]))
        outs[args] = got
    assert max_angle(outs[EUROC_ARGS][0].numpy(), outs[CAM_ARGS][0].numpy()) > 1e-3


def test_local_ba_two_ranks_against_world_one(ranks, loop_map):
    """``_run_ba(distributed=True)`` over two ranks, keyframes 0 and 1 fixed
    (the scale too), the mapper's caps: the dense run (F on the gathered
    W) written back alike on both ranks, bit for bit, and within 5e-4 /
    5e-3 of the same dense run at a world of one on the problem the mapper
    gathers.  (The world of one's single-device E -> F -> AC rounds its
    sums in float32 where AF rounds float64 partial sums, and on this
    drifted map the plain float32 LU carries that to 3.6e-4 / 6.9e-3 m
    after 5 + 10 iterations, 4.2e-3 / 0.14 m after 5: not a bound to hold.)"""
    from orb_slam3_fast_tpu_torch.backend.mapper import Mapper

    fixed = [0, 1]
    mapper = Mapper(tcam.Camera.pinhole(*CAM_ARGS), bf=0.0, sigma2=SIGMA2, device="cpu")
    prob = mapper._gather_problem(TMap.load(loop_map), np.arange(N_KF), np.asarray(fixed),
                                  lm_cap=mapper.cfg.ba_lm_cap, obs_cap=mapper.cfg.ba_obs_cap)[0]
    mesh = multihost.global_mesh("cpu")
    run = dist_ba.make_distributed_ba(mesh, tcam.Camera.pinhole(*CAM_ARGS), 0.0, iters1=5, iters2=10)
    R1, t1 = (x[:N_KF].numpy() for x in run(dist_ba.shard_problem(prob, mesh, whole=True))[:2])
    two = ranks.run(cases.mapper_run, loop_map, CAM_ARGS, SIGMA2, "local", (5, 10), fixed)
    assert two[0][0] and two[1][0]
    assert all(np.array_equal(a, b) for a, b in zip(two[0][1:], two[1][1:]))
    np.testing.assert_allclose(two[0][1], R1, atol=TOL_WORLD[0])
    np.testing.assert_allclose(two[0][2], t1, atol=TOL_WORLD[1])
