"""Parity of the port's inertial loop closing with the JAX package: the
inertial tracker's MergeInertialBA on tests/test_vi_ba_cg.py:208's welded
map, FullInertialBA on a 30-keyframe ``make_inertial_world`` (its gather
and write-back under the map lock), the loop closer's essential graph of
an inertial map (the 4-DoF graph, never the Sim3 one), and one test for
each defect of the JAX package that the port repairs on this path, each
naming its divergence."""
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam3_fast_tpu.backend import loopcloser as jlc
from orb_slam3_fast_tpu.map.worldmap import WorldMap as JMap
from orb_slam3_fast_tpu.utils import lie as jlie
from orb_slam3_fast_tpu_torch.backend import loopcloser as tlc
from orb_slam3_fast_tpu_torch.backend.mapper import Mapper as TMapper
from orb_slam3_fast_tpu_torch.frontend import vi_tracker as tvi
from orb_slam3_fast_tpu_torch.imu import preintegration as tpre
from orb_slam3_fast_tpu_torch.map.worldmap import WorldMap as TMap
from orb_slam3_fast_tpu_torch.optim import pose_graph as tpg
from orb_slam3_fast_tpu_torch.utils import lie as tlie
from tests.test_torch_vi_ba import T_CAM
from tests.test_vi_ba_cg import RecordingLock, _make_tracker, _pose_errors, make_inertial_world

torch.set_num_threads(1)

T_NOISE = tpre.ImuNoise.from_continuous(1.7e-4, 2e-3, 1.9e-5, 3e-3, 200.0)  # tests/test_inertial.py's NOISE
OUTLIER = (10, 0)  # (keyframe, slot) of the observation made an outlier
FIELDS = ("kf_R", "kf_t", "kf_vel", "kf_bias", "lm_pos")


def port_tracker(w: TMap) -> tvi.InertialTracker:
    """The JAX tests' _make_tracker in the port: camera = body, a mapper."""
    return tvi.InertialTracker(T_CAM, world=w, noise=T_NOISE, mapper=TMapper(T_CAM, bf=0.0, device="cpu"),
                               device="cpu")


def both_worlds(jw: JMap, tmp_path) -> TMap:
    """The port's copy of a JAX map (saved by one package, loaded by the other)."""
    path = str(tmp_path / "world.npz")
    jw.save(path)
    return TMap.load(path)


class HookLock(RecordingLock):
    """A map lock that, when taken the second time (FullInertialBA's
    write-back), first plays the tracker thread of the async System: it
    adds a keyframe (a copy of the newest, with a velocity) and binds the
    outlier's slot to another landmark, as a fusion would while the solve
    ran."""

    def __init__(self, world, vel):
        super().__init__()
        self.world, self.vel = world, vel

    def __enter__(self):
        if self.acquisitions == 1:
            w, n = self.world, self.world.n_kf
            for name in ("kf_R", "kf_t", "kf_obs", "kf_xy", "kf_kp_valid", "kf_valid"):
                getattr(w, name)[n] = getattr(w, name)[n - 1]
            w.kf_ts[n] = w.kf_ts[n - 1] + 0.25
            w.kf_vel[n] = self.vel
            self.made_R = w.kf_R[n].copy()
            w.n_kf = n + 1
            w.kf_obs[OUTLIER] = w.n_lm - 1
        return super().__enter__()


@pytest.fixture(scope="module")
def full_ba(tmp_path_factory):
    """A 30-keyframe inertial world (one observation 40 px off, an
    outlier), FullInertialBA (keyframe 0 fixed) run by both packages from
    the same map, each under a HookLock."""
    jw, R_gt, p_gt, _, _ = make_inertial_world(np.random.default_rng(11), n_kf=30, n_lm=300, obs_per_kf=64)
    jw.kf_xy[OUTLIER] += 40.0
    gathered_lm = int(jw.kf_obs[OUTLIER])
    tw = both_worlds(jw, tmp_path_factory.mktemp("full_ba"))
    err0 = _pose_errors(jw, R_gt, p_gt)
    vel = np.array([0.3, -0.2, 0.1], np.float32)
    locks = HookLock(jw, vel), HookLock(tw, vel)
    ok_j = _make_tracker(jw)._full_inertial_ba(jw, fixed_ids=np.asarray([0]), map_lock=locks[0])
    ok_t = port_tracker(tw)._full_inertial_ba(tw, fixed_ids=np.asarray([0]), map_lock=locks[1])
    return SimpleNamespace(jw=jw, tw=tw, ok=(ok_j, ok_t), locks=locks, err0=err0, truth=(R_gt, p_gt), vel=vel,
                           gathered_lm=gathered_lm)


def test_full_inertial_ba_matches_jax(full_ba):
    """FullInertialBA over every keyframe, landmark and the whole chain:
    both complete, the gather and the write-back each took the map lock,
    every state moved toward the truth (tests/test_vi_ba_cg.py:167's gates:
    the largest position error halved, the mean under 0.02 m), and the
    port's keyframe poses, velocities, biases and landmarks within 2e-3 of
    the JAX package's (float64 against float32 CG; the keyframe made during
    the solve is left to its own test)."""
    assert full_ba.ok == (True, True)
    assert all(lock.acquisitions >= 2 for lock in full_ba.locks)
    R_wb = np.transpose(full_ba.tw.kf_R[:30], (0, 2, 1))
    err1 = np.linalg.norm(-np.einsum("kij,kj->ki", R_wb, full_ba.tw.kf_t[:30]) - full_ba.truth[1], axis=1)
    assert err1.max() < 0.5 * full_ba.err0.max() and err1.mean() < 0.02, (full_ba.err0.max(), err1)
    for name in FIELDS:
        a, b = getattr(full_ba.tw, name), getattr(full_ba.jw, name)
        n = 30 if name.startswith("kf_") else full_ba.tw.n_lm
        np.testing.assert_allclose(a[:n], b[:n], atol=2e-3, err_msg=name)


def test_full_inertial_ba_turns_new_keyframes_velocities(full_ba):
    """Divergence from the JAX package (frontend/vi_tracker.py:833): a
    keyframe made while the solve ran follows its parent's correction in
    both packages, and in the port its velocity turns with its pose (v' =
    R_wk' R_kw v, to 1e-5), where the JAX package leaves the velocity in
    the frame before the correction."""
    jw, tw, vel, k = full_ba.jw, full_ba.tw, full_ba.vel, 30
    assert tw.n_kf == jw.n_kf == 31
    np.testing.assert_allclose(tw.kf_R[k], jw.kf_R[k], atol=2e-3)
    np.testing.assert_array_equal(jw.kf_vel[k], vel)
    turn = tw.kf_R[k].T @ full_ba.locks[1].made_R
    assert np.abs(turn - np.eye(3)).max() > 1e-4  # the correction turned the keyframe
    np.testing.assert_allclose(tw.kf_vel[k], turn @ vel, atol=1e-5)


def test_full_inertial_ba_keeps_rebound_slots(full_ba):
    """Divergence from the JAX package (frontend/vi_tracker.py:831): an
    outlier observation is erased only where its slot still holds the
    landmark that was gathered; the slot bound to another landmark while
    the solve ran keeps that binding, where the JAX package erases it
    through the slot it gathered."""
    rebound = full_ba.tw.n_lm - 1
    assert full_ba.gathered_lm != rebound
    assert full_ba.jw.kf_obs[OUTLIER] == -1
    assert full_ba.tw.kf_obs[OUTLIER] == rebound


def welded_map():
    """tests/test_vi_ba_cg.py:208's welded map: one flight whose keyframes
    0-9 play the destination map and 10-19 the transplanted source (no
    window spans the weld 9 -> 10), the source's welding window 14-19
    perturbed (0.02 rad, 5 cm, 0.1 m/s) as an imperfect Sim3 weld leaves it."""
    rng = np.random.default_rng(0)
    w, R_gt, p_gt, v_gt, _ = make_inertial_world(rng, n_kf=20, n_lm=300, obs_per_kf=96, pose_pert=0.0)
    del w.kf_preint[10]
    for k in range(14, 20):
        R_wb = R_gt[k] @ np.asarray(jlie.so3_exp(jnp.asarray(rng.normal(0, 0.02, 3).astype(np.float32))))
        p_wb = p_gt[k] + rng.normal(0, 0.05, 3).astype(np.float32)
        w.kf_R[k] = R_wb.T
        w.kf_t[k] = -R_wb.T @ p_wb
        w.kf_vel[k] = v_gt[k] + rng.normal(0, 0.1, 3).astype(np.float32)
    return w, R_gt, p_gt, v_gt


def test_merge_inertial_ba_matches_jax(tmp_path):
    """MergeInertialBA on the welded map (kernel Y's plain version on a
    window over both sides of the weld, their outer keyframes fixed): the
    JAX test's gates on the port's result (the source window's position
    error halved, velocities within 0.06 m/s, biases within 0.02, the
    velocity across the weld within 0.15 m/s of the finite difference) and
    the same window, and the JAX package's result (float32 LU solves in
    both frameworks, as tests/test_torch_vi_ba.py holds them): rotation
    entries within 2e-4, translations within 2e-3, velocities within 1e-2,
    biases within 1e-3, landmarks within 2e-2 m and 99% of them within 2e-3
    (those few keyframes see from a short baseline move most)."""
    jw, R_gt, p_gt, v_gt = welded_map()
    tw = both_worlds(jw, tmp_path)
    err0 = _pose_errors(jw, R_gt, p_gt)[14:20]
    real_j = _make_tracker(jw)._merge_inertial_ba(jw, k_new=19, c2=8)
    real_t = port_tracker(tw)._merge_inertial_ba(tw, k_new=19, c2=8)
    np.testing.assert_array_equal(real_t, real_j)
    assert any(r >= 14 for r in real_t) and any(r <= 9 for r in real_t)
    err1 = _pose_errors(tw, R_gt, p_gt)[14:20]
    assert err1.max() < 0.5 * err0.max(), (err0.max(), err1.max())
    assert np.linalg.norm(tw.kf_vel[14:20] - v_gt[14:20], axis=1).max() < 0.06
    assert np.abs(tw.kf_bias[14:20]).max() < 0.02
    R_wb = np.transpose(tw.kf_R[:20], (0, 2, 1))
    p_wb = -np.einsum("kij,kj->ki", R_wb, tw.kf_t[:20])
    v_fd = (p_wb[15] - p_wb[13]) / float(tw.kf_ts[15] - tw.kf_ts[13])
    assert np.linalg.norm(tw.kf_vel[14] - v_fd) < 0.15
    for name, tol in zip(FIELDS, (2e-4, 2e-3, 1e-2, 1e-3, 2e-2)):
        n = 20 if name.startswith("kf_") else tw.n_lm
        np.testing.assert_allclose(getattr(tw, name)[:n], getattr(jw, name)[:n], atol=tol, err_msg=name)
    assert np.mean(np.abs(tw.lm_pos[:tw.n_lm] - jw.lm_pos[:jw.n_lm]).max(1) <= 2e-3) >= 0.99


def _merge_with_stubs(lc, dst, S_kc, monkeypatch):
    """``_merge`` of a one-keyframe map into ``dst`` with the Atlas, the
    fusion and the local BA stubbed: what the inertial hooks see."""
    monkeypatch.setattr(lc, "_fuse_loop", lambda *a: None)
    atlas = SimpleNamespace(merge_into=lambda *a, **k: {"kf_offset": 3, "lm_offset": 0}, current=dst)
    return lc._merge(atlas, dst, 0, 1, dst, 0, 0, S_kc)


def test_merge_falls_back_to_the_window_when_no_weld_window(monkeypatch):
    """Divergence from the JAX package (backend/loopcloser.py:255): when
    MergeInertialBA finds no welding window (returns None), the merge of an
    inertial map falls back to the windowed VI-BA of the newest keyframes;
    the JAX package calls only MergeInertialBA once it is set, and so leaves
    such a weld without an inertial BA."""
    calls = {"port": [], "jax": []}
    for name, mod, Map in (("port", tlc, TMap), ("jax", jlc, JMap)):
        log = calls[name]
        mapper = SimpleNamespace(device=torch.device("cpu"), _local_ba=lambda w, k, log=log: log.append("local_ba"))
        lc = (mod.LoopCloser(T_CAM, None, None, mapper) if name == "port"
              else mod.LoopCloser(None, None, None, mapper))
        lc.merge_inertial_ba = lambda w, k, c2, log=log: log.append(("merge", k, c2))  # no window: None
        lc.inertial_ba = lambda w, k, window=None, log=log: log.append(("window", k))
        dst = Map(kp_cap=8, max_kf=8)
        dst.n_kf, dst.imu_initialized = 4, True
        dst.kf_R[:4] = np.eye(3, dtype=np.float32)
        S_kc = (tlie.Sim3.identity() if name == "port" else jlie.Sim3(jnp.eye(3), jnp.zeros(3), jnp.float32(1.0)))
        _merge_with_stubs(lc, dst, S_kc, monkeypatch)
    assert calls["port"] == ["local_ba", ("merge", 3, 0), ("window", 3)]
    assert calls["jax"] == ["local_ba", ("merge", 3, 0)]


@pytest.mark.parametrize("inertial", [True, False])
def test_essential_graph_routes_inertial_maps_to_4dof(inertial, monkeypatch, tmp_path):
    """The loop closer's essential graph on a 30-keyframe inertial world
    (its last 6 keyframes corrected by a yaw of 0.05 rad and a 0.3 m
    shift, the loop edge 29 -> 2, keyframe 2 fixed): an IMU-initialised map
    takes the 4-DoF graph and never the Sim3 one (a visual map the
    reverse), and an inertial map's corrected poses and landmarks land
    within 2e-3 of the JAX package's on the same map
    (tests/test_loop_closing.py:69; the Sim3 graph's parity is
    tests/test_torch_pose_graph.py's)."""
    jw, *_ = make_inertial_world(np.random.default_rng(5), n_kf=30, n_lm=300, obs_per_kf=64)
    jw.imu_initialized = inertial
    tw = both_worlds(jw, tmp_path)
    K, k, c = 30, 29, 2
    R_old, t_old, s_old = jw.kf_R[:K].copy(), jw.kf_t[:K].copy(), np.ones(K, np.float32)
    R_init, t_init = R_old.copy(), t_old.copy()
    cy, sy = np.cos(0.05), np.sin(0.05)
    Rz = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]], np.float32)
    R_init[24:] = R_old[24:] @ Rz.T
    t_init[24:] = t_old[24:] + 0.3
    args = (k, c, R_old, t_old, s_old, R_init, t_init, s_old.copy())
    calls = []
    for name in ("optimize_4dof_graph", "optimize_sim3_graph"):
        fn = getattr(tpg, name)
        monkeypatch.setattr(tpg, name, lambda *a, _fn=fn, _n=name, **kw: (calls.append(_n), _fn(*a, **kw))[1])
    cfg = dict(min_covis_edge=30, temporal_gap=15)
    tlc.LoopCloser(T_CAM, None, None, SimpleNamespace(device=torch.device("cpu")),
                   cfg=tlc.LoopCloserConfig(**cfg))._essential_graph(tw, k, c, K, *args[2:])
    assert calls == (["optimize_4dof_graph"] if inertial else ["optimize_sim3_graph"])
    if not inertial:
        return
    jlc.LoopCloser(None, None, None, None, cfg=jlc.LoopCloserConfig(**cfg))._essential_graph(jw, *args)
    np.testing.assert_allclose(tw.kf_R[:K], jw.kf_R[:K], atol=2e-3)
    np.testing.assert_allclose(tw.kf_t[:K], jw.kf_t[:K], atol=2e-3)
    np.testing.assert_allclose(tw.lm_pos[:tw.n_lm], jw.lm_pos[:jw.n_lm], atol=2e-3)



def test_phase_12_scene_helpers():
    """chip_smoke.py's builders of the inertial loop path's scenes, which
    the card runs without JAX: ``inertial_world`` gives
    tests/test_vi_ba_cg.py's make_inertial_world (the same observations and
    windows, poses within 2e-5, pixels within 5e-3 from the float32
    projections), and the IMU stream of ``circle_trajectory_with_imu``
    integrates (the plain preintegration and PredictStateIMU) from frame 0's
    true state to frame 20's pose within 1e-3 m and 1e-4 in rotation
    entries (float32 steps over 1 s)."""
    import chip_smoke as cs

    jw, *_ = make_inertial_world(np.random.default_rng(13), n_kf=12)
    tw, *_ = cs.inertial_world(np.random.default_rng(13), n_kf=12)
    np.testing.assert_array_equal(tw.kf_obs[:12], jw.kf_obs[:12])
    for name, tol in (("kf_R", 2e-5), ("kf_t", 2e-5), ("kf_vel", 0.0), ("lm_pos", 0.0), ("kf_xy", 5e-3)):
        np.testing.assert_allclose(getattr(tw, name)[:12], getattr(jw, name)[:12], atol=tol, err_msg=name)
    for k in (1, 11):
        for f, a, b in zip(tw.kf_preint[k]._fields, tw.kf_preint[k], jw.kf_preint[k]):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5, err_msg=f)
    poses, imu = cs.circle_trajectory_with_imu(150)
    take = imu[imu[:, 0] <= 1.0 + 1e-9]
    p = tpre.preintegrate_plain(torch.as_tensor(take[:, 1:4], dtype=torch.float32),
                                torch.as_tensor(take[:, 4:7], dtype=torch.float32), torch.full((len(take),), 0.005),
                                torch.zeros(6), T_NOISE)
    (R0, t0), (R1, t1) = poses[0], poses[20]
    amp, freq = cs.VI_LOOP_SPEED
    v0 = torch.tensor([0.0, 4.0 * 2 * np.pi * 1.12 / 7.5 * (1 + amp), 0.0])
    R, pos, _ = tpre.predict_state(torch.as_tensor(R0.T), torch.as_tensor(-R0.T @ t0), v0, p, torch.zeros(6))
    np.testing.assert_allclose(pos.numpy(), -R1.T @ t1, atol=1e-3)
    np.testing.assert_allclose(R.numpy(), R1.T, atol=1e-4)


def test_inertial_maps_cross_packages_after_a_global_ba(full_ba, tmp_path):
    """The maps FullInertialBA left (a keyframe made during the solve, an
    erased or rebound observation, turned velocities) saved by one package
    load in the other with every table, window, velocity and bias equal."""
    for src, load in ((full_ba.tw, JMap.load), (full_ba.jw, TMap.load)):
        path = str(tmp_path / f"{type(src).__module__.split('.')[0]}.npz")
        src.save(path)
        got = load(path)
        assert got.imu_initialized and got.n_kf == src.n_kf == 31 and sorted(got.kf_preint) == sorted(src.kf_preint)
        for name in ("kf_R", "kf_t", "kf_vel", "kf_bias", "kf_obs", "lm_pos", "lm_n_obs", "kf_valid"):
            np.testing.assert_array_equal(getattr(got, name), getattr(src, name), err_msg=name)
        for k in (1, 29):
            for f, a, b in zip(got.kf_preint[k]._fields, got.kf_preint[k], src.kf_preint[k]):
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=f)
