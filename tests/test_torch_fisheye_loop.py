"""Loop closing on the TUM-VI rig's KB8 camera (configs/
TUMVI_fisheye_stereo_inertial.yaml's cam0) in the port beside the JAX
package, on the CPU with the plain versions: kernel Q's and R's plain
versions against the JAX package's sim3_ransac / optimize_sim3 on KB8
pixels, with the scale free and fixed; FullInertialBA (kernel AA's plain
segment and classification) and MergeInertialBA (kernel Y's) on small
inertial maps seen through the fisheye, each map carried across by the
Atlas save / load; the loop
closer's detection, verification and correction on a small KB8 map; the
global BA (kernels E and T's plain versions) on KB8 observations; and
the System with loop closing, whose constructor no longer refuses the
KB8 camera, and its default constructor on the async backend, whose
threads' forward-mode derivatives take turns (utils.forward_ad).  The 150-frame phase 14 loop of both packages is ``-m slow``
(``python -m tests.fisheye_loop_reference`` is the JAX package's run
alone)."""
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from orb_slam3_fast_tpu.backend import loopcloser as jlc
from orb_slam3_fast_tpu.backend.mapper import Mapper as JMapper
from orb_slam3_fast_tpu.cameras import models as jcam
from orb_slam3_fast_tpu.frontend import vi_tracker as jvi
from orb_slam3_fast_tpu.map.worldmap import WorldMap as JMap
from orb_slam3_fast_tpu.optim import ba_cg as jcg
from orb_slam3_fast_tpu.optim import sim3 as jsim3
from orb_slam3_fast_tpu.vocab import database as jdb
from orb_slam3_fast_tpu.vocab import vocabulary as jvoc
from orb_slam3_fast_tpu_torch.backend import loopcloser as tlc
from orb_slam3_fast_tpu_torch.backend.mapper import Mapper as TMapper
from orb_slam3_fast_tpu_torch.cameras import models as tcam
from orb_slam3_fast_tpu_torch.frontend import vi_tracker as tvi
from orb_slam3_fast_tpu_torch.map.worldmap import WorldMap as TMap
from orb_slam3_fast_tpu_torch.optim import ba_cg as tcg
from orb_slam3_fast_tpu_torch.optim import sim3 as tsim3
from orb_slam3_fast_tpu_torch.slam import system as tsys
from orb_slam3_fast_tpu_torch.vocab import database as tdb
from orb_slam3_fast_tpu_torch.vocab import vocabulary as tvoc
from tests import test_torch_loop as tl
from tests.test_inertial import NOISE as J_NOISE
from tests.test_torch_ba import BF, both, problem
from tests.test_torch_vi_loop import T_NOISE
from tests.test_vi_ba_cg import _pose_errors, make_inertial_world

torch.set_num_threads(1)

CONFIG = str(Path(__file__).resolve().parents[1] / "configs" / "TUMVI_fisheye_stereo_inertial.yaml")
KB8 = (190.97847715128717, 190.9733070521226, 254.93170605935475, 256.8974428996504, 0.0034823894022493434,
       0.0007150348452162257, -0.0020532361418706202, 0.00020293673591811182)  # cam0 of the configuration
TCAM, JCAM = tcam.Camera.kb8(*KB8), jcam.Camera.kb8(*KB8)
# the pixels of TCAM that see what the loop scenario's 400 px pin-hole camera sees on 640x480 (+-38.7 deg across,
# +-31 deg down): the scenario's 200 observations a keyframe then cover the same part of the scene
KB8_BOX = (125, 140, 385, 375)
NAMES = ("xc1", "xc2", "uv1", "uv2", "is1", "is2")


def kb8_pairs(rng, s: float, outliers: float = 0.25):
    """chip_smoke.sim3_pairs through the TUM-VI camera: 768 slots, 300 valid,
    xc1 = S12 xc2 with a share of the pairs replaced, 0.5 px noise."""
    arrays, xi = chip_smoke.sim3_pairs(rng, s=s, outliers=outliers, cam=TCAM)
    return dict(zip((*NAMES, "valid"), arrays)), xi


@pytest.mark.parametrize("fix_scale", [False, True])
def test_sim3_ransac_kb8_matches_jax(fix_scale):
    """Kernel Q's plain version on KB8 pixels, with the JAX package's own
    subsets: the same winning count, ok and inlier mask, the Sim3 within
    1e-4 (the pin-hole test's tolerances)."""
    p, _ = kb8_pairs(np.random.default_rng(3), 1.0 if fix_scale else 1.3)
    key = 30 * 2654435761 + 5
    subsets = tl.jax_subsets(key, torch.as_tensor(p["valid"]))
    res_t = tsim3.sim3_ransac(TCAM, TCAM, *(torch.as_tensor(p[k]) for k in NAMES), torch.as_tensor(p["valid"]),
                              tsim3.jax_seed(key), fix_scale=fix_scale, subsets=subsets)
    res_j = jsim3.sim3_ransac(JCAM, JCAM, *(jnp.asarray(p[k]) for k in (*NAMES, "valid")), jax.random.PRNGKey(key),
                              fix_scale=fix_scale)
    assert int(res_t.n_inliers) == int(res_j.n_inliers) > 150 and bool(res_t.ok) == bool(res_j.ok)
    np.testing.assert_array_equal(res_t.inliers.numpy(), np.asarray(res_j.inliers))
    np.testing.assert_allclose(res_t.S12.R.numpy(), np.asarray(res_j.S12.R), atol=1e-4)
    np.testing.assert_allclose(res_t.S12.t.numpy(), np.asarray(res_j.S12.t), atol=1e-4)
    np.testing.assert_allclose(float(res_t.S12.s), float(res_j.S12.s), rtol=1e-4)


@pytest.mark.parametrize("fix_scale", [False, True])
def test_optimize_sim3_kb8_matches_jax(fix_scale):
    """Kernel R's plain version on KB8 pixels from a perturbed start: the
    same inlier mask and count, the Sim3 within 2e-4 (the JAX package
    solves the 7x7 system in float32 and differentiates the KB8 projection
    with jacfwd, the port in float64 through the same expression), the
    scale untouched under fix_scale."""
    from orb_slam3_fast_tpu.utils import lie as jlie

    p, xi = kb8_pairs(np.random.default_rng(4), 1.0 if fix_scale else 1.3, outliers=0.1)
    xi0 = xi + np.array([0.05, -0.03, 0.04, 0.01, 0.01, -0.01, 0.0 if fix_scale else 0.02], np.float32)
    S0_j = jlie.sim3_exp(jnp.asarray(xi0))
    S0_t = tsim3.lie.Sim3(*(torch.as_tensor(np.asarray(x)) for x in (S0_j.R, S0_j.t, S0_j.s)))
    S_t, inl_t, n_t = tsim3.optimize_sim3(TCAM, TCAM, S0_t, *(torch.as_tensor(p[k]) for k in NAMES),
                                          torch.as_tensor(p["valid"]), fix_scale=fix_scale)
    S_j, inl_j, n_j = jsim3.optimize_sim3(JCAM, JCAM, S0_j, *(jnp.asarray(p[k]) for k in NAMES),
                                          jnp.asarray(p["valid"]), fix_scale=fix_scale)
    assert int(n_t) == int(n_j) > 200
    np.testing.assert_array_equal(inl_t.numpy(), np.asarray(inl_j))
    np.testing.assert_allclose(S_t.R.numpy(), np.asarray(S_j.R), atol=2e-4)
    np.testing.assert_allclose(S_t.t.numpy(), np.asarray(S_j.t), atol=2e-4)
    np.testing.assert_allclose(float(S_t.s), float(S_j.s), rtol=2e-4)
    if fix_scale:
        assert float(S_t.s) == float(S0_t.s)


def test_full_inertial_ba_kb8_matches_jax(tmp_path):
    """FullInertialBA (the port's kernel AA plain segments and
    classification) on a 20-keyframe inertial world whose observations are
    the TUM-VI camera's pixels (tests/test_vi_ba_cg.py's make_inertial_world,
    the pin-hole rays re-projected through the fisheye), the map built by
    the JAX package and carried to the port by save / load: both complete,
    every state moves toward the truth (the largest position error halved),
    and the port's keyframe poses, velocities, biases and landmarks are
    within 2e-3 of the JAX package's (tests/test_torch_vi_loop.py's
    tolerance: float64 against float32 CG)."""
    jw, R_gt, p_gt, _, _ = make_inertial_world(np.random.default_rng(11), n_kf=20, n_lm=200, obs_per_kf=48)
    live = jw.kf_obs[: jw.n_kf] >= 0
    jw.kf_xy[: jw.n_kf][live] = chip_smoke.kb8_pixels(TCAM, jw.kf_xy[: jw.n_kf][live])
    path = str(tmp_path / "world.npz")
    jw.save(path)
    tw = TMap.load(path)
    err0 = _pose_errors(jw, R_gt, p_gt)
    ok_j = jvi.InertialTracker(JCAM, world=jw, noise=J_NOISE, mapper=JMapper(JCAM))._full_inertial_ba(
        jw, fixed_ids=np.asarray([0]))
    ok_t = tvi.InertialTracker(TCAM, world=tw, noise=T_NOISE, mapper=TMapper(TCAM, bf=0.0, device="cpu"),
                               device="cpu")._full_inertial_ba(tw, fixed_ids=np.asarray([0]))
    assert ok_j and ok_t
    err1 = _pose_errors(tw, R_gt, p_gt)
    assert err1.max() < 0.5 * err0.max(), (err0.max(), err1.max())
    for name in ("kf_R", "kf_t", "kf_vel", "kf_bias", "lm_pos"):
        n = tw.n_kf if name.startswith("kf_") else tw.n_lm
        np.testing.assert_allclose(getattr(tw, name)[:n], getattr(jw, name)[:n], atol=2e-3, err_msg=name)


def test_merge_inertial_ba_kb8_matches_jax(tmp_path):
    """MergeInertialBA (kernel Y's plain version; the loop closer's hook on
    a merge of inertial maps) on tests/test_torch_vi_loop.py's welded map
    with every observation the TUM-VI camera's pixel, carried across by
    save / load: the same welding window, the source window's position
    error halved, and the port's states and landmarks at that test's
    tolerances from the JAX package's (rotation entries 2e-4, translations
    2e-3 m, velocities 1e-2 m/s, biases 1e-3, landmarks 2e-2 m)."""
    from tests.test_torch_vi_loop import FIELDS, welded_map

    jw, R_gt, p_gt, _ = welded_map()
    live = jw.kf_obs[: jw.n_kf] >= 0
    jw.kf_xy[: jw.n_kf][live] = chip_smoke.kb8_pixels(TCAM, jw.kf_xy[: jw.n_kf][live])
    path = str(tmp_path / "welded.npz")
    jw.save(path)
    tw = TMap.load(path)
    err0 = _pose_errors(jw, R_gt, p_gt)[14:20]
    real_j = jvi.InertialTracker(JCAM, world=jw, noise=J_NOISE, mapper=JMapper(JCAM))._merge_inertial_ba(
        jw, k_new=19, c2=8)
    real_t = tvi.InertialTracker(TCAM, world=tw, noise=T_NOISE, mapper=TMapper(TCAM, bf=0.0, device="cpu"),
                                 device="cpu")._merge_inertial_ba(tw, k_new=19, c2=8)
    np.testing.assert_array_equal(real_t, real_j)
    assert any(r >= 14 for r in real_t) and any(r <= 9 for r in real_t)
    err1 = _pose_errors(tw, R_gt, p_gt)[14:20]
    assert err1.max() < 0.5 * err0.max(), (err0.max(), err1.max())
    for name, tol in zip(FIELDS, (2e-4, 2e-3, 1e-2, 1e-3, 2e-2)):
        n = 20 if name.startswith("kf_") else tw.n_lm
        np.testing.assert_allclose(getattr(tw, name)[:n], getattr(jw, name)[:n], atol=tol, err_msg=name)


def test_loop_closes_alike_on_a_kb8_map(monkeypatch, tmp_path):
    """tests/test_torch_loop.py's loop scenario seen through the TUM-VI
    camera (the part of its image that spans the scenario's pin-hole field
    of view, KB8_BOX): keyframes 21-23 through process_keyframe in both
    packages, both loop closers on the KB8 camera (the Sim3 search and
    its guided projection, the fusion, the Sim3 propagation through
    cameras.project): the same return values, the loop closed at the same
    keyframe pair, S_kc within 2e-3, and after the essential graph and
    the global BA the rotation entries within 1e-3, the translations
    within 1e-2 m and the landmarks within 1e-2 of the scene's 9 m, the
    same observation table (that test's tolerances)."""
    monkeypatch.setattr(tsim3, "_sample_subsets", tl.jax_subsets)
    run_gba = JMapper._run_gba  # one device, as the port (tests/test_torch_loop.py)
    monkeypatch.setattr(JMapper, "_run_gba", lambda self, *a, **kw: run_gba(self, *a, **{**kw, "distributed": False}))
    kfs, _ = tl.loop_keyframes(cam=TCAM, box=KB8_BOX)
    wt = TMap(kp_cap=tl.KP_CAP, max_kf=32, max_lm=4096)
    point_lm: dict = {}
    for k in range(tl.LOOP_START):
        tl.add_keyframe(wt, kfs[k], k, point_lm, packed=True)
    path = str(tmp_path / "base.npz")
    wt.save(path)
    wj = JMap.load(path)
    point_lm_j = dict(point_lm)
    voc_t, voc_j = tvoc.default_vocabulary(), jvoc.default_vocabulary()
    db_t, db_j = tdb.KeyFrameDatabase(voc_t.n_words, max_kf=32), jdb.KeyFrameDatabase(voc_j.n_words, max_kf=32)
    for k in range(tl.LOOP_START):
        tl._index(tvoc, voc_t, db_t, wt, k, True)
        tl._index(jvoc, voc_j, db_j, wj, k, False)
    lc_t = tlc.LoopCloser(TCAM, voc_t, db_t, TMapper(TCAM, bf=0.0, sigma2=tl.SIGMA2, device="cpu"),
                          cfg=tlc.LoopCloserConfig(**tl.CFG), sigma2=tl.SIGMA2)
    lc_j = jlc.LoopCloser(JCAM, voc_j, db_j, JMapper(JCAM, sigma2=tl.SIGMA2), cfg=jlc.LoopCloserConfig(**tl.CFG),
                          sigma2=tl.SIGMA2)
    log_t, log_j = [], []
    tl._spy_correct(monkeypatch, tlc, log_t)
    tl._spy_correct(monkeypatch, jlc, log_j)
    for k in range(tl.LOOP_START, tl.N_KF):
        tl.add_keyframe(wt, kfs[k], k, point_lm, packed=True)
        tl.add_keyframe(wj, kfs[k], k, point_lm_j, packed=False)
        tl._index(tvoc, voc_t, db_t, wt, k, True)
        tl._index(jvoc, voc_j, db_j, wj, k, False)
        out_t, out_j = lc_t.process_keyframe(wt, k), lc_j.process_keyframe(wj, k)
        assert out_t == out_j, (k, out_t, out_j)
    assert lc_t.n_loops_closed == lc_j.n_loops_closed == 1
    (k_t, c_t, S_t, R0_t, _), (k_j, c_j, S_j, _, _) = log_t[0], log_j[0]
    assert (k_t, c_t) == (k_j, c_j)
    assert tl.sim3_err(S_t, S_j) <= 2e-3
    K = wt.n_kf
    np.testing.assert_allclose(wt.kf_R[:K], wj.kf_R[:K], atol=1e-3)
    np.testing.assert_allclose(wt.kf_t[:K], wj.kf_t[:K], atol=1e-2)
    np.testing.assert_array_equal(wt.lm_valid[: wt.n_lm], wj.lm_valid[: wj.n_lm])
    np.testing.assert_array_equal(wt.kf_obs[:K], wj.kf_obs[:K])
    live = wt.lm_valid[: wt.n_lm]
    assert np.abs(wt.lm_pos[: wt.n_lm][live] - wj.lm_pos[: wj.n_lm][live]).max() <= 1e-2 * 9.0
    true_rel = kfs[23]["R_true"] @ kfs[c_t]["R_true"].T  # the correction undid the drift to the loop neighbour
    err = lambda R23, Rc: float(np.abs(R23 @ Rc.T - true_rel).max())  # noqa: E731
    assert err(wt.kf_R[23], wt.kf_R[c_t]) < 0.3 * err(R0_t[23], R0_t[c_t])


def test_global_ba_on_kb8_observations_matches_jax():
    """The global BA (bundle_adjust_cg: kernels E and T's plain versions, 5
    + 10 LM iterations) on tests/test_torch_ba.py's problem with every
    observation the TUM-VI camera's monocular pixel (the fisheye rig's
    keyframes carry no right-u) and its poses 0 and 1 fixed (monocular
    edges leave the scale to the gauge), at tests/test_torch_ba_cg.py's
    tolerances: poses within 1e-3, the landmarks that keep two inlier observations
    within 1e-3, inlier masks within 0.2%."""
    p = problem(3)
    p["obs_uv"][:, :2] = chip_smoke.kb8_pixels(TCAM, p["obs_uv"][:, :2])
    p["obs_uv"][:, 2] = -1.0
    p["obs_is_stereo"][:] = False
    p["pose_fixed"][1] = True  # monocular edges leave the scale free: a second fixed pose holds it
    jp, tp = both(p)
    R_t, t_t, x_t, inl_t, ab_t = tcg.bundle_adjust_cg(TCAM, BF, tp)
    R_j, t_j, x_j, inl_j, ab_j = jcg.bundle_adjust_cg(JCAM, jnp.float32(BF), jp)
    assert not ab_t and not ab_j
    np.testing.assert_allclose(R_t.numpy(), np.asarray(R_j), atol=1e-3)
    np.testing.assert_allclose(t_t.numpy(), np.asarray(t_j), atol=1e-3)
    n_inl = np.bincount(p["obs_lm"][p["obs_valid"] & np.asarray(inl_j)], minlength=len(p["xw"]))
    held = p["lm_valid"] & (n_inl >= 2)
    assert held.sum() > 150
    np.testing.assert_allclose(x_t.numpy()[held], np.asarray(x_j)[held], atol=1e-3)
    assert np.mean(inl_t.numpy() != np.asarray(inl_j)) <= 0.002


@pytest.mark.parametrize("sensor", ["stereo", "stereo-inertial"])
def test_kb8_system_with_loop_closing_constructs(sensor):
    """``System(TUM-VI config, sensor)`` with its defaults: loop closing on
    the left KB8 camera (settings.cam, as the JAX System builds it), the
    Atlas and the async backend, the inertial hooks for stereo-inertial;
    the monocular sensor on the same file builds its loop closer on that
    camera too, the scale free (the JAX System's fix_scale=(sensor !=
    MONOCULAR))."""
    slam = tsys.System(CONFIG, sensor, device="cpu")
    try:
        assert slam.loopcloser is not None and slam.loopcloser.cam is slam.settings.cam
        assert slam.loopcloser.cam.kind == tcam.KB8 and slam.atlas is not None and slam.backend is not None
        assert slam.tracker.cam2 is slam.settings.cam2
        hooks = (slam.loopcloser.inertial_ba, slam.loopcloser.inertial_gba, slam.loopcloser.merge_inertial_ba)
        assert all(h is not None for h in hooks) == (sensor == "stereo-inertial")
    finally:
        slam.shutdown()
    slam = tsys.System(CONFIG, "monocular", device="cpu")
    try:
        assert slam.loopcloser.cam is slam.settings.cam and slam.loopcloser.cfg.fix_scale is False
        assert slam.atlas is not None and slam.backend is not None
    finally:
        slam.shutdown()


@pytest.mark.slow
def test_fisheye_circle_matches_jax_system():
    """Phase 14 (a)'s 150 frames (the ring world along the circle through
    the TUM-VI rig, ``chip_smoke.fisheye_loop_frames``) through the port's
    stereo System with loop closing and the JAX package's, every Sim3
    RANSAC drawing the JAX package's hypotheses (~12 min): both track the
    same frames and close their first loop within 5 frames of each other
    (phase 14's window; both at frame 133 on this sandbox's CPU); the
    correction brings both to the same map, their camera poses within
    chip_smoke.LOOP_DT after it (3.5e-3 m at most here); the port meets
    tests/test_loop_closing.py's ATE gate (0.20 m).  Before the loop the
    two drift apart as two float32 paths of this rig do (every pose edge
    monocular, the local BA's Schur solve float32 in the JAX package and
    float64 in the port): the poses within 6e-2 m (5.0e-2 at frame 130
    here, 3.6e-3 up to frame 60) and the keyframe counts within 6 (a
    keyframe decision is a count against a ratio: the first flip is at
    frame 93, 60 against 61).  The per-frame table is printed."""
    from orb_slam3_fast_tpu.slam.settings import Settings as JSettings
    from orb_slam3_fast_tpu.slam.system import System as JSystem
    from orb_slam3_fast_tpu_torch.eval import ate
    from orb_slam3_fast_tpu_torch.utils import convert

    mp = pytest.MonkeyPatch()
    mp.setattr(tsim3, "_sample_subsets", tl.jax_subsets)
    try:
        frames, poses, _ = chip_smoke.fisheye_loop_frames()
        settings = JSettings.from_yaml(CONFIG, "stereo")
        opts = dict(max_keyframes=256, enable_loop_closing=True, multi_map=True, async_backend=False)
        js = JSystem(settings, "stereo", **opts)
        js.loopcloser.cfg = jlc.LoopCloserConfig(**chip_smoke.LOOP_CONFIG, fix_scale=True)
        ts = tsys.System(convert.settings_to_torch(settings), "stereo", device="cpu", **opts)
        ts.loopcloser.cfg = tlc.LoopCloserConfig(**chip_smoke.LOOP_CONFIG, fix_scale=True)
        closed, rows, est, gt = {"j": [], "t": []}, [], [], []
        for i, ((img_l, img_r), (R, t)) in enumerate(zip(frames, poses)):
            loops = js.loopcloser.n_loops_closed, ts.loopcloser.n_loops_closed
            sj, pj = js.track_stereo(img_l, img_r, i * 0.05)
            st, pt = ts.track_stereo(img_l, img_r, i * 0.05)
            closed["j"] += [i] if js.loopcloser.n_loops_closed > loops[0] else []
            closed["t"] += [i] if ts.loopcloser.n_loops_closed > loops[1] else []
            gap = float(np.abs(np.asarray(pj[1]) - pt[1]).max()) if sj == st == "OK" else None
            rows.append((i, sj, st, js.world.n_kf, ts.world.n_kf, gap))
            if st == "OK":
                est.append(-pt[0].T @ pt[1])
                gt.append(-R.T @ t)
        print("frame, state JAX / port, keyframes JAX / port, max |t_port - t_JAX|:", rows, "loops:", closed)
        assert all(r[1] == r[2] and abs(r[3] - r[4]) <= 6 for r in rows), rows
        assert closed["j"] and closed["t"] and abs(closed["j"][0] - closed["t"][0]) <= 5, closed
        first, last = min(closed["j"][0], closed["t"][0]), max(closed["j"][0], closed["t"][0])
        before = [r[5] for r in rows[:first] if r[5] is not None]
        after = [r[5] for r in rows[last + 1:] if r[5] is not None]
        assert max(before) <= 6e-2 and after and max(after) <= chip_smoke.LOOP_DT, (max(before), after)
        stamps = np.arange(len(est)) * 0.05
        rmse = ate.ate_rmse(stamps, np.asarray(est), stamps, np.asarray(gt), with_scale=False)[0]
        assert rmse < 0.20, rmse
    finally:
        mp.undo()


def test_forward_mode_derivatives_take_turns_across_threads():
    """PyTorch's forward-AD levels are one table for the whole process: the
    async backend's worker and the tracker, both inside a plain version's
    forward-mode derivative at once (the KB8 camera's projection Jacobian
    in the local BA and the pose optimisation), found each other's level
    gone.  Every such section holds utils.forward_ad.LOCK: four threads
    each taking 150 KB8 projection Jacobians finish without an error and
    with the single-threaded result."""
    import threading

    x = torch.as_tensor(np.random.default_rng(0).normal(size=(256, 3)).astype(np.float32)) + torch.tensor([0, 0, 4.0])
    want = tcam.project_jac(TCAM, x)
    errors, got = [], []

    def work():
        try:
            for _ in range(150):
                got.append(bool(torch.equal(tcam.project_jac(TCAM, x), want)))
        except RuntimeError as e:  # the race: "... forward AD ..."
            errors.append(str(e))

    threads = [threading.Thread(target=work) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors[:1]
    assert len(got) == 600 and all(got)


def test_default_kb8_stereo_system_tracks_on_the_async_backend():
    """``System(TUM-VI config, "stereo")`` with every default (the async
    backend, loop closing, the Atlas) on the CPU: the first 12 frames of
    phase 14's circle track OK, the backend maps them and drains with no
    worker error (its plain versions take forward-mode derivatives beside
    the tracker's)."""
    frames = [chip_smoke._render_fisheye_circle(i) for i in range(12)]
    slam = tsys.System(CONFIG, "stereo", device="cpu")
    try:
        states = [slam.track_stereo(l, r, i * 0.05)[0] for i, (l, r) in enumerate(frames)]
        assert slam.backend.wait_idle(timeout=120)
    finally:
        slam.shutdown()
    assert states == ["OK"] * 12 and not slam.backend.errors, (states, slam.backend.errors)
    assert slam.world.n_kf >= 3 and slam.mapper.n_local_ba >= 1
