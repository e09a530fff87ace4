"""The RGB-D System of the port beside the JAX package's Tracker.process_rgbd
+ Mapper on the RGB-D corridor of tests/test_slam_e2e.py (seed 2, 900
splats, virtual baseline bf = 0.08 * 400 = 32, 640x480, 768 features), 8
frames with a keyframe at most every 3 frames so that keyframes and a local
BA land; the depth map factor; chip_smoke.py's numpy depth renderer against
the test's loop; and the entry points' default device."""
import dataclasses
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from orb_slam3_fast_tpu.backend.mapper import Mapper as JMapper
from orb_slam3_fast_tpu.cameras import models as jcam
from orb_slam3_fast_tpu.frontend import tracker as jtrk
from orb_slam3_fast_tpu.map.worldmap import WorldMap as JMap
from orb_slam3_fast_tpu.ops import extractor as jext
from orb_slam3_fast_tpu.slam import settings as jset
from orb_slam3_fast_tpu_torch.backend.mapper import Mapper
from orb_slam3_fast_tpu_torch.frontend import tracker as ttrk
from orb_slam3_fast_tpu_torch.slam import system as tsys
from tests import synthetic as syn

torch.set_num_threads(1)

CONFIG = str(Path(__file__).resolve().parents[1] / "configs" / "synthetic_stereo.yaml")
N_FRAMES, BF = 8, 0.08 * 400.0
OPTS = dict(enable_loop_closing=False, multi_map=False, async_backend=False)


def rgbd_settings(**kw):
    """configs/synthetic_stereo.yaml loaded for RGB-D, bf replaced by the
    virtual baseline (there is no RGB-D config file)."""
    return dataclasses.replace(tsys.Settings.from_yaml(CONFIG, "rgbd"), bf=BF, **kw)


def frames(n):
    world = chip_smoke.make_corridor_world(np.random.default_rng(2), n=900)
    cam = tsys.Settings.from_yaml(CONFIG, "rgbd").cam
    poses = chip_smoke.arc_trajectory(n, step=0.06, lateral=0.05)
    return [(chip_smoke.render(world, cam, R, t), chip_smoke.splat_depth(world, cam, R, t)) for R, t in poses]


def test_depth_renderer_matches_test_loop():
    """chip_smoke.splat_depth against the depth loop of test_rgbd_e2e on the
    same world and poses (tests/synthetic.py's, through JAX): equal."""
    world = syn.make_corridor_world(np.random.default_rng(2), n=900)
    cam_j = jcam.Camera.pinhole(400.0, 400.0, 320.0, 240.0)
    cam_t = tsys.Settings.from_yaml(CONFIG, "rgbd").cam
    for T in syn.arc_trajectory(25, step=0.06, lateral=0.05)[::8]:
        Xc = np.asarray(T.apply(jnp.asarray(world["centers"])))
        uv = np.asarray(jcam.project(cam_j, jnp.asarray(Xc)))
        depth = np.zeros((480, 640), np.float32)
        for j in np.argsort(-Xc[:, 2]):
            z = Xc[j, 2]
            if z < 0.5:
                continue
            u, v = uv[j]
            s = world["sizes"][j] * 400.0 / z
            if s < 2:
                continue
            u0, v0, u1, v1 = int(u - s / 2), int(v - s / 2), int(u + s / 2), int(v + s / 2)
            depth[max(v0, 0) : max(v1, 0), max(u0, 0) : max(u1, 0)] = z
        got = chip_smoke.splat_depth(world, cam_t, np.asarray(T.R), np.asarray(T.t))
        np.testing.assert_array_equal(got, depth)
        assert (depth > 0).mean() > 0.1


def test_whole_rgbd_path_matches_jax():
    """Per frame: the same state, pose within 2e-3 m and rotation entries
    within 1e-3, the same keyframe count; inliers within 2%; live landmarks
    within 3%; keyframes and a local BA landed."""
    s_t = rgbd_settings()
    s_j = dataclasses.replace(jset.Settings.from_yaml(CONFIG, "rgbd"), bf=BF)
    assert (s_t.th_depth, s_t.depth_map_factor, s_t.n_features) == (s_j.th_depth, s_j.depth_map_factor, s_j.n_features)
    port = tsys.System(s_t, "rgbd", tracker_overrides=dict(max_frames_between_kf=3), device="cpu", **OPTS)
    ecfg = jext.ExtractorConfig(n_features=s_j.n_features)
    jt = jtrk.Tracker(
        s_j.cam, jtrk.TrackerConfig(extractor=ecfg, th_depth=s_j.th_depth, max_frames_between_kf=3), bf=s_j.bf,
        world=JMap(kp_cap=jext.total_capacity(ecfg)), mapper=JMapper(s_j.cam, bf=s_j.bf, sigma2=jext.level_sigma2(ecfg)),
    )
    for i, (img, depth) in enumerate(frames(N_FRAMES)):
        st_j, pose_j = jt.process_rgbd(img, depth, i * 0.05)
        st_t, pose_t = port.track_rgbd(img, depth, i * 0.05)
        assert st_t == st_j == "OK", (i, st_t, st_j)
        np.testing.assert_allclose(pose_t[1], pose_j[1], atol=2e-3)
        np.testing.assert_allclose(pose_t[0], pose_j[0], atol=1e-3)
        assert port.world.n_kf == jt.world.n_kf, i
    inl_t, inl_j = np.asarray(port.tracker.stats["inliers"]), np.asarray(jt.stats["inliers"])
    assert np.all(np.abs(inl_t - inl_j) <= 0.02 * inl_j)
    n_t, n_j = int(port.world.lm_valid.sum()), int(jt.world.lm_valid.sum())
    assert abs(n_t - n_j) <= 0.03 * n_j
    assert port.world.n_kf >= 3 and port.mapper.n_local_ba >= 1
    assert {"track_total", "orb_extract", "depth_sample", "lm_track"} <= set(port.timers.spans)


def test_depth_map_factor_is_honoured():
    """Depth x 5000 with factor 5000 tracks as depth with factor 1."""
    seq = frames(2)
    runs = []
    for factor in (1.0, 5000.0):
        slam = tsys.System(rgbd_settings(depth_map_factor=factor), "rgbd", device="cpu", **OPTS)
        runs.append([slam.track_rgbd(img, depth * np.float32(factor), i * 0.05) for i, (img, depth) in enumerate(seq)])
        runs[-1].append(slam.world.lm_pos[slam.world.lm_valid])
    (*a, lm_a), (*b, lm_b) = runs
    for (st_a, (R_a, t_a)), (st_b, (R_b, t_b)) in zip(a, b):
        assert st_a == st_b == "OK"
        np.testing.assert_allclose(t_a, t_b, atol=1e-5)
        np.testing.assert_allclose(R_a, R_b, atol=1e-5)
    assert lm_a.shape == lm_b.shape and lm_a.shape[0] > 100
    np.testing.assert_allclose(lm_a, lm_b, rtol=1e-5, atol=1e-6)


def test_entry_points_default_to_the_card():
    """Without ``device``, System, Tracker, Mapper and StereoTrackingStep run
    on the card; with no card they raise, and never build on the CPU."""
    cam = tsys.Settings.from_yaml(CONFIG, "rgbd").cam
    builds = (
        lambda: tsys.System(rgbd_settings(), "rgbd", **OPTS),
        lambda: ttrk.Tracker(cam, bf=BF),
        lambda: Mapper(cam, bf=BF),
        lambda: ttrk.StereoTrackingStep(cam, BF, (640, 480)),
    )
    for build in builds:
        if torch.cuda.is_available():
            obj = build()
            dev = obj.device if hasattr(obj, "device") else obj.scales.device
            assert dev.type == "cuda"
        else:
            with pytest.raises(RuntimeError, match="device='cpu'"):
                build()
