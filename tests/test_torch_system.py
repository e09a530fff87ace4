"""The stereo System of the port beside the JAX package's Tracker + Mapper
on the synthetic corridor of tests/test_slam_e2e.py (seed 1, 0.12 m
baseline, 640x480, 768 features), 8 frames with a keyframe at most every 3
frames so that keyframes with triangulation and local BA land; and
chip_smoke.py's numpy scene against tests/synthetic.py."""
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import chip_smoke
from orb_slam3_fast_tpu.backend.mapper import Mapper as JMapper
from orb_slam3_fast_tpu.cameras import models as jcam
from orb_slam3_fast_tpu.frontend import tracker as jtrk
from orb_slam3_fast_tpu.map.worldmap import WorldMap as JMap
from orb_slam3_fast_tpu.ops import extractor as jext
from orb_slam3_fast_tpu.slam.system import System as JSystem
from orb_slam3_fast_tpu_torch.slam import system as tsys
from tests import synthetic as syn

torch.set_num_threads(1)

CONFIG = str(Path(__file__).resolve().parents[1] / "configs" / "synthetic_stereo.yaml")
N_FRAMES, BASELINE, BF = 8, 0.12, 48.0
OPTS = dict(enable_loop_closing=False, multi_map=False, async_backend=False, device="cpu")


def test_numpy_scene_matches_synthetic():
    """chip_smoke's numpy copies of the scene helpers: the same world from
    the same seed, poses within 1e-5, and a rendered frame within one grey
    level of tests/synthetic.render."""
    w_j = syn.make_corridor_world(np.random.default_rng(1), n=900)
    w_t = chip_smoke.make_corridor_world(np.random.default_rng(1), n=900)
    for k in w_j:
        np.testing.assert_array_equal(w_t[k], w_j[k])
    p_j = syn.arc_trajectory(12, step=0.06, lateral=0.05)
    p_t = chip_smoke.arc_trajectory(12, step=0.06, lateral=0.05)
    for T, (R, t) in zip(p_j, p_t):
        np.testing.assert_allclose(R, np.asarray(T.R), atol=1e-5)
        np.testing.assert_allclose(t, np.asarray(T.t), atol=1e-5)
    R, t = np.asarray(p_j[11].R), np.asarray(p_j[11].t)
    img_j = syn.render(w_j, jcam.Camera.pinhole(400.0, 400.0, 320.0, 240.0), p_j[11])
    img_t = chip_smoke.render(w_t, tsys.Settings.from_yaml(CONFIG, "stereo").cam, R, t)
    assert np.abs(img_t - img_j).max() <= 1.0


def test_not_ported_options_raise():
    """The database on a device mesh raises, naming ROADMAP §A item 12;
    loop closing on the fisheye two-camera rig builds, its loop closer on
    the left KB8 camera (item 14 is ported).  The three inertial sensors build
    with loop closing and with the async backend (the default
    constructor), the loop closer wired to the inertial tracker's windowed
    VI-BA, MergeInertialBA and FullInertialBA, which run (on an empty map:
    no welding window, nothing to solve) instead of raising; the async
    backend, loop closing and the Atlas are built (fix_scale for stereo)."""
    slam = tsys.System(CONFIG, "stereo", **dict(OPTS, async_backend=True))
    assert slam.backend is not None and slam.tracker.backend is slam.backend
    slam.shutdown()
    fisheye = tsys.Settings.from_yaml(str(Path(CONFIG).parents[0] / "TUMVI_fisheye_stereo_inertial.yaml"), "stereo")
    slam = tsys.System(fisheye, "stereo", **dict(OPTS, enable_loop_closing=True))
    assert slam.loopcloser.cam is fisheye.cam and slam.loopcloser.cam.kind == "kb8"
    for sensor in ("monocular-inertial", "rgbd-inertial", "stereo-inertial"):
        slam = tsys.System(CONFIG, sensor, **dict(OPTS, multi_map=True))
        assert slam.tracker.icfg.fix_scale == (sensor != "monocular-inertial")
        assert slam.tracker.icfg.imu_bucket == 32  # 200 Hz IMU, 20 fps camera
        assert slam.loopcloser is None and slam.backend is None
        for opts in (dict(enable_loop_closing=True), dict(async_backend=True)):
            slam = tsys.System(CONFIG, sensor, **dict(OPTS, **opts))
            lc = slam.loopcloser
            if "enable_loop_closing" in opts:
                assert lc.inertial_gba == slam.tracker._full_inertial_ba
                assert lc.merge_inertial_ba == slam.tracker._merge_inertial_ba and callable(lc.inertial_ba)
            else:
                assert slam.backend is not None and slam.tracker.backend is slam.backend
            assert slam.tracker._full_inertial_ba(slam.world, [0]) is False
            assert slam.tracker._merge_inertial_ba(slam.world, 1, 0) is None
            slam.shutdown()
    with pytest.raises(NotImplementedError, match="ROADMAP §A item 12"):
        tsys.System(CONFIG, "stereo", **OPTS).kfdb.attach_mesh(None)
    slam = tsys.System(CONFIG, "stereo", **dict(OPTS, enable_loop_closing=True, multi_map=True))
    assert slam.loopcloser.cfg.fix_scale and slam.atlas.current is slam.world


def _jax_tum(tracker, path):
    """The JAX System's TUM saver over a bare Tracker (no vocabulary)."""
    fake = SimpleNamespace(tracker=tracker, _quat=JSystem._quat)
    fake._world_frames = lambda only_ok=True: JSystem._world_frames(fake, only_ok)
    JSystem.save_trajectory_tum(fake, path)


def test_whole_path_matches_jax(tmp_path):
    """Per frame: the same state, inliers within 2%, pose within 2e-3 m and
    rotation entries within 1e-3; the same keyframe count and live
    landmarks within 3%; local BA and triangulation ran; the TUM files
    agree line by line."""
    world = chip_smoke.make_corridor_world(np.random.default_rng(1), n=900)
    poses = chip_smoke.arc_trajectory(N_FRAMES, step=0.06, lateral=0.05)
    port = tsys.System(CONFIG, "stereo", tracker_overrides=dict(max_frames_between_kf=3), **OPTS)
    cam_j = jcam.Camera.pinhole(400.0, 400.0, 320.0, 240.0)
    ecfg = jext.ExtractorConfig(n_features=768)
    jt = jtrk.Tracker(
        cam_j, jtrk.TrackerConfig(extractor=ecfg, th_depth=40.0, max_frames_between_kf=3), bf=BF,
        world=JMap(kp_cap=jext.total_capacity(ecfg)), mapper=JMapper(cam_j, bf=BF, sigma2=jext.level_sigma2(ecfg)),
    )
    for i, (R, t) in enumerate(poses):
        img_l, img_r = chip_smoke.stereo_pair(world, port.settings.cam, R, t, BASELINE)
        st_j, pose_j = jt.process_stereo(img_l, img_r, i * 0.05)
        st_t, pose_t = port.track_stereo(img_l, img_r, i * 0.05)
        assert st_t == st_j == "OK", (i, st_t, st_j)
        np.testing.assert_allclose(pose_t[1], pose_j[1], atol=2e-3)
        np.testing.assert_allclose(pose_t[0], pose_j[0], atol=1e-3)
        assert port.world.n_kf == jt.world.n_kf, i
    inl_t, inl_j = np.asarray(port.tracker.stats["inliers"]), np.asarray(jt.stats["inliers"])
    assert np.all(np.abs(inl_t - inl_j) <= 0.02 * inl_j)
    n_t, n_j = int(port.world.lm_valid.sum()), int(jt.world.lm_valid.sum())
    assert abs(n_t - n_j) <= 0.03 * n_j
    assert port.world.n_kf >= 3 and port.mapper.n_local_ba >= 2 and port.mapper.n_triangulated > 0
    # every keyframe indexed for place recognition, culled ones erased
    np.testing.assert_array_equal(port.kfdb.valid[: port.world.n_kf], port.world.kf_valid[: port.world.n_kf])
    assert {"track_total", "orb_extract", "lm_track"} <= set(port.timers.spans)
    assert {"map_local_ba", "map_triangulate"} <= set(port.mapper.timers.spans)
    assert port.map_changed() and not port.map_changed()
    p_t, p_j = tmp_path / "port.txt", tmp_path / "jax.txt"
    port.save_trajectory_tum(str(p_t))
    _jax_tum(jt, str(p_j))
    lines_t, lines_j = p_t.read_text().splitlines(), p_j.read_text().splitlines()
    assert len(lines_t) == len(lines_j) == N_FRAMES
    for a, b in zip(lines_t, lines_j):
        fa, fb = a.split(), b.split()
        assert len(fa) == len(fb) == 8 and fa[0] == fb[0]
        assert all(len(x.split(".")[1]) == len(y.split(".")[1]) for x, y in zip(fa, fb))  # same decimals
        np.testing.assert_allclose(np.float64(fa[1:]), np.float64(fb[1:]), atol=2e-3)
