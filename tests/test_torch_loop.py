"""The loop-closing slice of the port against the JAX package.

A synthetic loop map built in numpy: 24 keyframes round the ring of
tests/synthetic.make_ring_world, their poses drifting progressively (a
Sim3 of the world growing with the keyframe index: yaw, translation,
scale), landmarks with random 256-bit descriptors and a few flipped bits per
observation; the last three keyframes come back to the first ones' place
and see their points again under new landmark ids; every keyframe indexed
through the default vocabulary.  Both packages load the same map and run
``LoopCloser.process_keyframe`` on the last three keyframes, with the
port's RANSAC drawing the JAX package's hypotheses.  Also ``Atlas.merge_into``
and save / load across the two packages, the System with loop closing and
the Atlas on a few frames, and (``slow``) the whole 150-frame circle."""
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from orb_slam3_fast_tpu.backend import loopcloser as jlc
from orb_slam3_fast_tpu.backend.mapper import Mapper as JMapper
from orb_slam3_fast_tpu.cameras import models as jcam
from orb_slam3_fast_tpu.map.atlas import Atlas as JAtlas
from orb_slam3_fast_tpu.map.worldmap import WorldMap as JMap
from orb_slam3_fast_tpu.utils import lie as jlie
from orb_slam3_fast_tpu.vocab import database as jdb
from orb_slam3_fast_tpu.vocab import vocabulary as jvoc
from orb_slam3_fast_tpu_torch.backend import loopcloser as tlc
from orb_slam3_fast_tpu_torch.backend.mapper import Mapper as TMapper
from orb_slam3_fast_tpu_torch.cameras import models as tcam
from orb_slam3_fast_tpu_torch.map.atlas import Atlas as TAtlas
from orb_slam3_fast_tpu_torch.map.worldmap import WorldMap as TMap
from orb_slam3_fast_tpu_torch.map.worldmap import pack_bits
from orb_slam3_fast_tpu_torch.optim import sim3 as tsim3
from orb_slam3_fast_tpu_torch.slam import system as tsys
from orb_slam3_fast_tpu_torch.utils import lie as tlie
from orb_slam3_fast_tpu_torch.vocab import database as tdb
from orb_slam3_fast_tpu_torch.vocab import vocabulary as tvoc

torch.set_num_threads(1)

CONFIG = str(Path(__file__).resolve().parents[1] / "configs" / "synthetic_mono.yaml")
N_KF, LOOP_START, KP_CAP, MAX_OBS = 24, 21, 320, 200
SIGMA2 = (1.2 ** (2 * np.arange(8))).astype(np.float32)
CFG = dict(min_covis_edge=30, temporal_gap=15, gba_iters=(4, 6), pose_graph_iters=8)


def jax_subsets(seed, valid, n_hyp=tsim3.N_HYP):
    """The JAX package's Sim3 RANSAC draw (sim3.py:87-89); PRNGKey keeps the
    key's low word, which is the port's seed."""
    g = jax.random.gumbel(jax.random.PRNGKey(seed), (n_hyp, valid.shape[0]))
    g = jnp.where(jnp.asarray(valid.cpu().numpy())[None, :], g, -jnp.inf)
    return torch.as_tensor(np.asarray(jax.lax.top_k(g, 3)[1]))


def _drift(k):
    """The world Sim3 G_k that keyframe k's estimate has drifted by."""
    S = tlie.sim3_exp(torch.tensor([0.02 * k, 0.012 * k, 0.0, 0.0, 0.0, 0.006 * k, 0.004 * k], dtype=torch.float64))
    return S.R.numpy(), S.t.numpy(), float(S.s)


def loop_keyframes(seed=0, cam=None, box=(8, 8, 632, 472)):
    """Per keyframe: the estimated pose (T_cw, drifted) and its observations
    (slot, world point id, pixel, level, descriptor bits), and the world
    points' true positions and base descriptors.  Keyframe k sits at angle
    2 pi k / 21 of the radius-4 circle, half a step further from 21 on, so
    keyframes 21-23 revisit 0-3 between their places (with no baseline to
    the loop candidate, reprojection errors would not fix the Sim3's
    scale).  The pixels are the 400 px pin-hole camera's, or those of the
    port's camera ``cam``; a keyframe observes points whose pixel lies
    inside ``box`` (x0, y0, x1, y1)."""
    rng = np.random.default_rng(seed)
    world = chip_smoke.make_ring_world(np.random.default_rng(0), n=1200)
    pts = world["centers"].astype(np.float64)
    base = rng.integers(0, 2, (len(pts), 256)).astype(np.int8)
    kfs = []
    for k in range(N_KF):
        a = 2 * np.pi * (k + 0.5 * (k >= LOOP_START)) / LOOP_START
        c, s = np.cos(a), np.sin(a)
        Rwc = np.stack([[c, s, 0.0], [0.0, 0.0, -1.0], [-s, c, 0.0]], axis=1)
        R_true = Rwc.T
        t_true = -R_true @ np.array([4.0 * c, 4.0 * s, 0.0])
        xc = pts @ R_true.T + t_true
        if cam is None:
            uv = 400.0 * xc[:, :2] / np.maximum(xc[:, 2:], 1e-9) + [320.0, 240.0]
        else:
            uv = tcam.project(cam, torch.as_tensor(xc, dtype=torch.float32)).numpy().astype(np.float64)
        vis = np.nonzero((xc[:, 2] > 0.5) & (uv[:, 0] > box[0]) & (uv[:, 0] < box[2]) & (uv[:, 1] > box[1])
                         & (uv[:, 1] < box[3]))[0]
        vis = np.sort(rng.permutation(vis)[:MAX_OBS])
        RG, tG, sG = _drift(k)
        R_est = R_true @ RG
        t_est = (R_true @ tG + t_true) / sG
        desc = base[vis].copy()
        flips = rng.integers(0, 256, (len(vis), 4))
        for j in range(4):
            desc[np.arange(len(vis)), flips[:, j]] ^= 1
        kfs.append(dict(R=R_est.astype(np.float32), t=t_est.astype(np.float32), pts=vis,
                        uv=(uv[vis] + rng.normal(0, 0.5, (len(vis), 2))).astype(np.float32),
                        level=rng.integers(0, 3, len(vis)).astype(np.int32), desc=desc, xc=xc[vis] / sG,
                        R_true=R_true))
    return kfs, base


def _kp(kf, packed: bool):
    n = KP_CAP
    xy = np.zeros((n, 2), np.float32)
    level = np.zeros(n, np.int32)
    desc = np.zeros((n, 256), np.int8)
    valid = np.zeros(n, bool)
    m = len(kf["pts"])
    xy[:m], level[:m], desc[:m], valid[:m] = kf["uv"], kf["level"], kf["desc"], True
    return SimpleNamespace(xy=xy, level=level, angle=np.zeros(n, np.float32),
                           desc=pack_bits(desc) if packed else desc, valid=valid)


def add_keyframe(world, kf, k, point_lm, packed: bool):
    """Keyframe k into ``world``: it observes the landmarks of its points
    made by the last 10 keyframes and makes new ones for the rest at their
    drifted positions (x_w = T_cw^-1 of the drifted camera point);
    ``point_lm`` maps a world point to (landmark id, keyframe that made it)."""
    kid = world.add_keyframe(_kp(kf, packed), kf["R"], kf["t"], float(k))
    assert kid == k
    slots = np.arange(len(kf["pts"]))
    old = np.asarray([p in point_lm and k - point_lm[p][1] <= 10 for p in kf["pts"]], bool)
    if old.any():
        world.add_observations(k, slots[old], np.asarray([point_lm[p][0] for p in kf["pts"][old]], np.int32))
    new = ~old
    pos = (kf["xc"][new] - kf["t"]) @ kf["R"]
    desc = kf["desc"][new]
    ids = world.add_landmarks(pos.astype(np.float32), pack_bits(desc) if packed else desc, k, slots[new],
                              kf["level"][new])
    for p, i in zip(kf["pts"][new], ids):
        point_lm[int(p)] = (int(i), k)
    world.update_landmark_stats(np.unique(world.kf_obs[k][world.kf_obs[k] >= 0]))


def _index(voc_mod, voc, kfdb, world, k, packed):
    desc = world.kf_desc[k]
    if packed:
        bow = voc_mod.transform(voc, torch.as_tensor(desc), torch.as_tensor(world.kf_kp_valid[k]))[2].numpy()
    else:
        bow = np.asarray(voc_mod.transform(voc, jnp.asarray(desc), jnp.asarray(world.kf_kp_valid[k]))[2])
    kfdb.add(k, bow)


def _spy_correct(monkeypatch, module, log):
    fn = module.LoopCloser._correct

    def spy(self, world, k, c, S_kc):
        S = tuple(np.asarray(torch.as_tensor(np.asarray(x)).detach().cpu()) for x in S_kc)
        log.append((k, c, S, world.kf_R[: world.n_kf].copy(), world.kf_t[: world.n_kf].copy()))
        return fn(self, world, k, c, S_kc)

    monkeypatch.setattr(module.LoopCloser, "_correct", spy)


def test_loop_closes_alike_in_both_packages(monkeypatch, tmp_path):
    """Keyframes 21, 22, 23 through process_keyframe in both packages: the
    same return values; the loop closed at the same keyframe pair; S_kc
    within 2e-3 (rotation entries, relative t and s); the poses before the
    correction equal, and after the essential graph and the global BA the
    rotation entries within 1e-3 and the translations within 1e-2 m, 0.25%
    of the circle's 4 m (the drift to undo is 0.13 rad and 0.4 m; the JAX
    package solves both in float32, the port in float64; measured 2.3e-4
    and 6.5e-3); the landmarks within 1e-2 of the scene's 9 m; the same
    landmarks replaced and the same observation table."""
    monkeypatch.setattr(tsim3, "_sample_subsets", jax_subsets)
    # the JAX package's tests run on 8 virtual devices, where its global BA would take the sharded path
    # (parallel/dist_ba.py); this test holds it to one device, as the port's lone process runs it. The sharded
    # path of both packages is held against each other in tests/test_torch_dist_gba.py
    run_gba = JMapper._run_gba
    monkeypatch.setattr(JMapper, "_run_gba", lambda self, *a, **kw: run_gba(self, *a, **{**kw, "distributed": False}))
    cam_t, cam_j = tcam.Camera.pinhole(400.0, 400.0, 320.0, 240.0), jcam.Camera.pinhole(400.0, 400.0, 320.0, 240.0)
    kfs, _ = loop_keyframes()
    wt = TMap(kp_cap=KP_CAP, max_kf=32, max_lm=4096)
    point_lm: dict = {}
    for k in range(LOOP_START):
        add_keyframe(wt, kfs[k], k, point_lm, packed=True)
    path = str(tmp_path / "base.npz")
    wt.save(path)
    wj = JMap.load(path)
    point_lm_j = dict(point_lm)
    voc_t, voc_j = tvoc.default_vocabulary(), jvoc.default_vocabulary()
    db_t, db_j = tdb.KeyFrameDatabase(voc_t.n_words, max_kf=32), jdb.KeyFrameDatabase(voc_j.n_words, max_kf=32)
    for k in range(LOOP_START):
        _index(tvoc, voc_t, db_t, wt, k, True)
        _index(jvoc, voc_j, db_j, wj, k, False)
    lc_t = tlc.LoopCloser(cam_t, voc_t, db_t, TMapper(cam_t, bf=0.0, sigma2=SIGMA2, device="cpu"),
                          cfg=tlc.LoopCloserConfig(**CFG), sigma2=SIGMA2)
    lc_j = jlc.LoopCloser(cam_j, voc_j, db_j, JMapper(cam_j, sigma2=SIGMA2), cfg=jlc.LoopCloserConfig(**CFG),
                          sigma2=SIGMA2)
    log_t, log_j = [], []
    _spy_correct(monkeypatch, tlc, log_t)
    _spy_correct(monkeypatch, jlc, log_j)
    for k in range(LOOP_START, N_KF):
        add_keyframe(wt, kfs[k], k, point_lm, packed=True)
        add_keyframe(wj, kfs[k], k, point_lm_j, packed=False)
        _index(tvoc, voc_t, db_t, wt, k, True)
        _index(jvoc, voc_j, db_j, wj, k, False)
        np.testing.assert_array_equal(wt.kf_obs[: k + 1], wj.kf_obs[: k + 1])
        out_t, out_j = lc_t.process_keyframe(wt, k), lc_j.process_keyframe(wj, k)
        assert out_t == out_j, (k, out_t, out_j)
    assert lc_t.n_loops_closed == lc_j.n_loops_closed == 1
    (k_t, c_t, S_t, R0_t, t0_t), (k_j, c_j, S_j, R0_j, t0_j) = log_t[0], log_j[0]
    assert (k_t, c_t) == (k_j, c_j) and c_t < 3
    np.testing.assert_allclose(R0_t, R0_j, atol=1e-6)
    np.testing.assert_allclose(t0_t, t0_j, atol=1e-5)
    err = sim3_err(S_t, S_j)
    assert err <= 2e-3, err
    K = wt.n_kf
    np.testing.assert_allclose(wt.kf_R[:K], wj.kf_R[:K], atol=1e-3)
    np.testing.assert_allclose(wt.kf_t[:K], wj.kf_t[:K], atol=1e-2)
    np.testing.assert_array_equal(wt.lm_valid[: wt.n_lm], wj.lm_valid[: wj.n_lm])
    np.testing.assert_array_equal(wt.kf_obs[:K], wj.kf_obs[:K])
    live = wt.lm_valid[: wt.n_lm]
    assert np.abs(wt.lm_pos[: wt.n_lm][live] - wj.lm_pos[: wj.n_lm][live]).max() <= 1e-2 * 9.0
    # the correction undid the drift between keyframe 23 and keyframe 2, its loop neighbour
    true_rel = kfs[23]["R_true"] @ kfs[2]["R_true"].T

    def rel_err(R23, R2):
        return float(np.abs(R23 @ R2.T - true_rel).max())

    assert rel_err(wt.kf_R[23], wt.kf_R[2]) < 0.3 * rel_err(R0_t[23], R0_t[2])


def sim3_err(Sa, Sb) -> float:
    (Ra, ta, sa), (Rb, tb, sb) = Sa, Sb
    return max(float(np.abs(Ra - Rb).max()), float(np.linalg.norm(ta - tb) / max(np.linalg.norm(tb), 1e-9)),
               abs(float(sa) - float(sb)) / abs(float(sb)))


def _two_maps(packed: bool):
    """A stored map (keyframes 0-5 of the loop map) and an active one
    (keyframes 15-20, renumbered), as the Atlas holds them."""
    kfs, _ = loop_keyframes(seed=1)
    MapT = TMap if packed else JMap
    maps = []
    for ks in (range(0, 6), range(15, 21)):
        w = MapT(kp_cap=KP_CAP, max_kf=8, max_lm=2048)
        point_lm: dict = {}
        for i, k in enumerate(ks):
            add_keyframe(w, kfs[k], i, point_lm, packed=packed)
        maps.append(w)
    return maps


def test_atlas_merge_and_save_load_across_packages(tmp_path):
    """merge_into with the same Sim3 gives the same arrays in both packages
    (poses and landmarks within 1e-5, ids and the row registry equal); an
    Atlas saved by either package loads in the other with every map, the
    current id and the rows."""
    xi = np.array([0.3, -0.2, 0.1, 0.02, -0.03, 0.2, 0.1], np.float32)
    atlases = []
    for packed, Atlas, Sim3 in ((True, TAtlas, tlie.sim3_exp(torch.as_tensor(xi))),
                                (False, JAtlas, jlie.sim3_exp(jnp.asarray(xi)))):
        stored, active = _two_maps(packed)
        made = iter([stored, active])
        MapT = TMap if packed else JMap
        atlas = Atlas(lambda: next(made, None) or MapT(kp_cap=KP_CAP, max_kf=8, max_lm=2048))
        atlas.create_new_map()
        for m, w in enumerate(atlas.maps):
            for k in range(w.n_kf):
                atlas.register_kf(m, k)
        n_lm = stored.n_lm
        assert atlas.merge_into(1, 0, Sim3) == {"kf_offset": 6, "lm_offset": n_lm}
        atlases.append(atlas)
    at, aj = atlases
    assert at.current_id == aj.current_id == 0 and at.maps[1] is None and aj.maps[1] is None
    assert at.row_map == aj.row_map
    wt, wj = at.current, aj.current
    assert (wt.n_kf, wt.n_lm) == (wj.n_kf, wj.n_lm)
    np.testing.assert_allclose(wt.kf_R[: wt.n_kf], wj.kf_R[: wj.n_kf], atol=1e-5)
    np.testing.assert_allclose(wt.kf_t[: wt.n_kf], wj.kf_t[: wj.n_kf], atol=1e-5)
    np.testing.assert_allclose(wt.lm_pos[: wt.n_lm], wj.lm_pos[: wj.n_lm], atol=1e-5)
    np.testing.assert_array_equal(wt.kf_obs[: wt.n_kf], wj.kf_obs[: wj.n_kf])
    np.testing.assert_array_equal(wt.lm_first_kf[: wt.n_lm], wj.lm_first_kf[: wj.n_lm])
    # save / load both ways, with a second live map
    for atlas in atlases:
        atlas.create_new_map()
        atlas.register_kf(2, 0)
    at.save(str(tmp_path / "port"))
    aj.save(str(tmp_path / "jax"))
    from_port = JAtlas.load(str(tmp_path / "port"), lambda: JMap(kp_cap=KP_CAP, max_kf=8, max_lm=2048))
    from_jax = TAtlas.load(str(tmp_path / "jax"), lambda: TMap(kp_cap=KP_CAP, max_kf=8, max_lm=2048))
    for loaded, ref in ((from_port, wt), (from_jax, wj)):
        assert loaded.current_id == 2 and len(loaded.maps) == 3 and loaded.maps[1] is None
        assert loaded.row_map == at.row_map
        w = loaded.maps[0]
        np.testing.assert_allclose(w.kf_R[: w.n_kf], ref.kf_R[: ref.n_kf], atol=1e-5)
        np.testing.assert_array_equal(w.kf_obs[: w.n_kf], ref.kf_obs[: ref.n_kf])
        np.testing.assert_array_equal(w.lm_valid[: w.n_lm], ref.lm_valid[: ref.n_lm])
    np.testing.assert_array_equal(from_jax.maps[0].kf_desc[: wj.n_kf], wt.kf_desc[: wt.n_kf])


def test_system_with_loop_closing_and_atlas_tracks(tmp_path):
    """The default System of the JAX package (loop closing and the Atlas
    on, inline backend) on the CPU: it initialises on the ring and tracks
    the first frames of the circle, one map in the Atlas, every keyframe
    indexed under its global row; its saved Atlas loads in the JAX package;
    a timestamp jump resets the young map."""
    slam = tsys.System(CONFIG, "monocular", tracker_overrides=dict(min_init_matches=60, motion_radius=25.0),
                       max_keyframes=256, enable_loop_closing=True, multi_map=True, async_backend=False, device="cpu")
    assert slam.loopcloser is not None and not slam.loopcloser.cfg.fix_scale and slam.atlas is not None
    cam = slam.settings.cam
    world = chip_smoke.make_ring_world(np.random.default_rng(0))
    poses = chip_smoke.circle_trajectory(150, radius=4.0, frac=1.12)
    states = [slam.track_monocular(chip_smoke.render(world, cam, *poses[i]), i * 0.05)[0] for i in range(9)]
    assert states[-1] == "OK" and states.count("OK") >= 3, states
    assert slam.atlas.n_maps() == 1 and slam.tracker.map_id == 0 and slam.world.n_kf >= 2
    assert slam.atlas.row_map == [(0, k) for k in range(len(slam.atlas.row_map))]
    assert int(slam.kfdb.valid.sum()) == slam.world.n_kf
    assert len(slam.tracker.trajectory_world()) == len(slam.tracker.trajectory) >= 6
    slam.save_atlas(str(tmp_path / "sys"))
    loaded = JAtlas.load(str(tmp_path / "sys"), lambda: JMap(kp_cap=768))
    assert loaded.current.n_kf == slam.world.n_kf and loaded.row_map == slam.atlas.row_map
    slam.load_atlas(str(tmp_path / "sys"))
    assert slam.world.n_kf == loaded.current.n_kf and slam.tracker.atlas is slam.atlas
    # a timestamp jump (Tracking.cc:1818-1848): a map of <= min_kf_keep_map keyframes is reset in place
    state, _ = slam.track_monocular(chip_smoke.render(world, cam, *poses[9]), 9 * 0.05 + 5.0)
    assert state == "NOT_INITIALIZED" and slam.tracker.world.n_kf == 0 and slam.atlas.n_maps() == 1
    assert not slam.kfdb.valid.any()


@pytest.mark.slow
def test_circle_matches_jax_tracker_and_loop_closer():
    """The 150-frame circle of tests/test_loop_closing.py through the port's
    System and the JAX Tracker + Mapper + LoopCloser, every RANSAC drawing
    the JAX package's hypotheses: both close the loop, at the same keyframe,
    track the same frames, and land within 0.20 m scale-aligned ATE; their
    poses agree within 2e-2 m."""
    from orb_slam3_fast_tpu.eval import ate
    from orb_slam3_fast_tpu.frontend import tracker as jtrk
    from orb_slam3_fast_tpu.ops import extractor as jext
    from orb_slam3_fast_tpu_torch.ops import twoview as ttv
    from orb_slam3_fast_tpu_torch.optim import pnp as tpnp
    from tests.test_torch_mono import jax_hypotheses
    from tests.test_torch_mono import jax_subsets as jax_pnp_subsets

    mp = pytest.MonkeyPatch()
    mp.setattr(ttv, "_sample_hypotheses", jax_hypotheses)
    mp.setattr(tpnp, "_sample_subsets", jax_pnp_subsets)
    mp.setattr(tsim3, "_sample_subsets", jax_subsets)
    try:
        frames, poses = chip_smoke.loop_frames()
        slam, summary, track = chip_smoke.run_loop(frames, poses, torch.device("cpu"))
        cam_j = jcam.Camera.pinhole(400.0, 400.0, 320.0, 240.0)
        ecfg = jext.ExtractorConfig(n_features=768)
        cfg = jtrk.TrackerConfig(extractor=ecfg, min_init_matches=60, motion_radius=25.0)
        voc = jvoc.default_vocabulary()
        kfdb = jdb.KeyFrameDatabase(voc.n_words, max_kf=256)
        mapper = JMapper(cam_j, sigma2=jext.level_sigma2(ecfg))
        lc = jlc.LoopCloser(cam_j, voc, kfdb, mapper, cfg=jlc.LoopCloserConfig(**chip_smoke.LOOP_CONFIG),
                            sigma2=jext.level_sigma2(ecfg))
        jt = jtrk.Tracker(cam_j, cfg, mapper=mapper, voc=voc, kfdb=kfdb, loopcloser=lc,
                          atlas=JAtlas(lambda: JMap(kp_cap=jext.total_capacity(ecfg), max_kf=256)))
        est, gt, ts, dt = [], [], [], []
        for i, (img, (R, t)) in enumerate(zip(frames, poses)):
            state, pose = jt.process_mono(img, i * 0.05)
            assert state == track[i][0], (i, state, track[i][0])
            if state == "OK":
                dt.append(float(np.abs(pose[1] - track[i][2]).max()))
                est.append(-pose[0].T @ pose[1])
                gt.append(-R.T @ t)
                ts.append(i * 0.05)
        rmse, _, _ = ate.ate_rmse(np.asarray(ts), np.asarray(est), np.asarray(ts), np.asarray(gt), with_scale=True)
        assert lc.n_loops_closed >= 1 and summary["loops"] == lc.n_loops_closed
        assert rmse < 0.20 and summary["ate_m"] < 0.20
        assert max(dt) <= 2e-2, max(dt)
    finally:
        mp.undo()
