"""A pin-hole camera with radial-tangential distortion (EuRoC cam0's
coefficients on the synthetic intrinsics) through the plain versions of
kernels D, E, Q and R against the JAX package, and a short monocular
System with that camera against the JAX Tracker + Mapper on frames rendered
through it."""
import jax
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
from orb_slam3_fast_tpu.optim import ba as jba
from orb_slam3_fast_tpu.optim import pose_opt as jpo
from orb_slam3_fast_tpu.optim import sim3 as jsim3
from orb_slam3_fast_tpu.utils import lie as jlie
from orb_slam3_fast_tpu.vocab import database as jdb
from orb_slam3_fast_tpu.vocab import vocabulary as jvoc
from orb_slam3_fast_tpu_torch.cameras import models as tcam
from orb_slam3_fast_tpu_torch.ops import twoview as ttv
from orb_slam3_fast_tpu_torch.optim import ba as tba
from orb_slam3_fast_tpu_torch.optim import pose_opt as tpo
from orb_slam3_fast_tpu_torch.optim import sim3 as tsim3
from orb_slam3_fast_tpu_torch.slam import system as tsys
from orb_slam3_fast_tpu_torch.utils import lie as tlie
from tests import synthetic as syn
from tests.test_torch_ba import both
from tests.test_torch_ba import problem as ba_problem
from tests.test_torch_mono import jax_hypotheses
from tests.test_torch_sim3 import _t, jax_subsets

torch.set_num_threads(1)

DIST = chip_smoke.EUROC_DIST
CAM_J = jcam.Camera.pinhole(400.0, 400.0, 320.0, 240.0, dist=DIST)
CAM_T = tcam.Camera.pinhole(400.0, 400.0, 320.0, 240.0, DIST)
BF = 48.0


def test_pose_optimization_with_distortion_matches_jax(rng):
    """Kernel D's plain version: 256 slots projected through the distorted
    camera, half stereo, 15% outliers, 10% empty, from 0.1 rad / 0.3 m off;
    rotation entries within 1e-4, translation within 1e-3, at most 2 edges
    classified otherwise (as the undistorted parity test), and the truth
    found."""
    n = 256
    xw = np.stack([rng.uniform(-3, 3, n), rng.uniform(-2, 2, n), rng.uniform(3, 15, n)], -1).astype(np.float32)
    T_gt = jlie.se3_exp(jnp.asarray([0.15, -0.1, 0.2, 0.03, -0.02, 0.04], jnp.float32))
    uvr = np.array(jcam.stereo_project(CAM_J, T_gt.apply(jnp.asarray(xw)), jnp.float32(BF)))
    uvr += rng.normal(0, 0.4, uvr.shape).astype(np.float32)
    stereo = rng.uniform(size=n) < 0.5
    uvr[~stereo, 2] = -1.0
    uvr[:38, :2] += rng.uniform(15, 50, (38, 2)) * rng.choice([-1, 1], (38, 2))
    valid = rng.uniform(size=n) > 0.1
    xw[~valid], uvr[~valid] = 0.0, -1.0
    inv_s2 = np.ones(n, np.float32)
    T0_j = jlie.se3_exp(jnp.asarray([0.3, 0.0, -0.1, 0.1, 0.0, 0.0], jnp.float32))
    arrays = (xw, uvr.astype(np.float32), inv_s2, stereo & valid, valid)
    Tj, inl_j, n_j = jpo.pose_optimization(CAM_J, jnp.float32(BF), T0_j, jpo.PoseObs(*map(jnp.asarray, arrays)))
    T0_t = tlie.SE3(_t(T0_j.R), _t(T0_j.t))
    Tt, inl_t, n_t = tpo.pose_optimization(CAM_T, BF, T0_t, tpo.PoseObs(*map(torch.as_tensor, arrays)))
    np.testing.assert_allclose(Tt.R.numpy(), np.asarray(Tj.R), atol=1e-4)
    np.testing.assert_allclose(Tt.t.numpy(), np.asarray(Tj.t), atol=1e-3)
    assert np.sum(inl_t.numpy() != np.asarray(inl_j)) <= 2 and abs(int(n_t) - int(n_j)) <= 2
    assert np.abs(Tt.t.numpy() - np.asarray(T_gt.t)).max() < 0.05


def test_ba_blocks_with_distortion_match_jax():
    """Kernel E's plain version with the distorted camera: every block
    within 1e-4 of its largest entry of the JAX package's (as the
    undistorted parity test); a whole BA lands within 1e-3 of it."""
    p = ba_problem()
    jp, tp = both(p)
    inlier = np.random.default_rng(1).uniform(size=len(p["obs_kf"])) > 0.05
    want = jba.build_normal_blocks(CAM_J, jnp.float32(BF), jp.R, jp.t, jp.xw, jp, jnp.asarray(inlier))
    got = tba.build_normal_blocks_plain(CAM_T, BF, tp.R, tp.t, tp.xw, tp, torch.as_tensor(inlier))
    for g, w in zip(got, want):
        g, w = g.numpy(), np.asarray(w)
        assert np.abs(g - w).max() <= 1e-4 * max(float(np.abs(w).max()), 1e-12)
    Rj, tj, xj, _ = jba.bundle_adjust(CAM_J, jnp.float32(BF), jp)
    Rt, tt, xt, _ = tba.bundle_adjust(CAM_T, BF, tp)
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), atol=1e-3)
    np.testing.assert_allclose(Rt.numpy(), np.asarray(Rj), atol=1e-3)


def _distorted_pairs(rng, s=1.3):
    arrays, xi = chip_smoke.sim3_pairs(rng, n=768, n_valid=300, s=s, cam=CAM_T)
    return dict(zip(("xc1", "xc2", "uv1", "uv2", "is1", "is2", "valid"), arrays)), xi


@pytest.mark.parametrize("fix_scale", [False, True])
def test_sim3_ransac_with_distortion_matches_jax(rng, fix_scale):
    """Kernel Q's plain version with JAX's own draws and distorted cameras on
    both keyframes: the same count, ok and mask, the Sim3 within 1e-4."""
    p, _ = _distorted_pairs(rng, s=1.0 if fix_scale else 1.3)
    key = 30 * 2654435761 + 5
    names = ("xc1", "xc2", "uv1", "uv2", "is1", "is2")
    res_t = tsim3.sim3_ransac(CAM_T, CAM_T, *(_t(p[k]) for k in names), torch.as_tensor(p["valid"]),
                              tsim3.jax_seed(key), fix_scale=fix_scale, subsets=jax_subsets(key, p["valid"]))
    res_j = jsim3.sim3_ransac(CAM_J, CAM_J, *(jnp.asarray(p[k]) for k in (*names, "valid")), jax.random.PRNGKey(key),
                              fix_scale=fix_scale)
    assert int(res_t.n_inliers) == int(res_j.n_inliers) and bool(res_t.ok) == bool(res_j.ok) and bool(res_t.ok)
    np.testing.assert_array_equal(res_t.inliers.numpy(), np.asarray(res_j.inliers))
    np.testing.assert_allclose(res_t.S12.R.numpy(), np.asarray(res_j.S12.R), atol=1e-4)
    np.testing.assert_allclose(res_t.S12.t.numpy(), np.asarray(res_j.S12.t), atol=1e-4)
    np.testing.assert_allclose(float(res_t.S12.s), float(res_j.S12.s), rtol=1e-4)


@pytest.mark.parametrize("fix_scale", [False, True])
def test_optimize_sim3_with_distortion_matches_jax(rng, fix_scale):
    """Kernel R's plain version with distorted cameras from a perturbed
    start: the same mask and count, the Sim3 within 2e-4 (the JAX package
    solves the 7x7 system in float32, the port in float64)."""
    p, xi = _distorted_pairs(rng, s=1.0 if fix_scale else 1.3)
    xi0 = xi + np.array([0.05, -0.03, 0.04, 0.01, 0.01, -0.01, 0.0 if fix_scale else 0.02], np.float32)
    S0_j = jlie.sim3_exp(jnp.asarray(xi0))
    names = ("xc1", "xc2", "uv1", "uv2", "is1", "is2")
    S_t, inl_t, n_t = tsim3.optimize_sim3(CAM_T, CAM_T, tlie.Sim3(_t(S0_j.R), _t(S0_j.t), _t(S0_j.s)),
                                          *(_t(p[k]) for k in names), torch.as_tensor(p["valid"]), fix_scale=fix_scale)
    S_j, inl_j, n_j = jsim3.optimize_sim3(CAM_J, CAM_J, S0_j, *(jnp.asarray(p[k]) for k in names),
                                          jnp.asarray(p["valid"]), fix_scale=fix_scale)
    assert int(n_t) == int(n_j) and int(n_t) > 150
    np.testing.assert_array_equal(inl_t.numpy(), np.asarray(inl_j))
    np.testing.assert_allclose(S_t.R.numpy(), np.asarray(S_j.R), atol=2e-4)
    np.testing.assert_allclose(S_t.t.numpy(), np.asarray(S_j.t), atol=2e-4)
    np.testing.assert_allclose(float(S_t.s), float(S_j.s), rtol=2e-4)


def test_distorted_mono_system_matches_jax(monkeypatch):
    """The port's monocular System with the distorted camera
    (``chip_smoke.distorted_mono_settings``) beside the JAX Tracker + Mapper
    with the same camera, on the mono corridor (seed 0) rendered through it,
    through initialisation and 10 frames, both drawing the JAX package's
    two-view hypotheses: per frame the same state, the pose within 2e-3
    (rotation entries 1e-3); the same keyframe count, live landmarks within
    3%.  The frames are chip_smoke.render's (numpy, through the port's
    camera), held against tests/synthetic.render's (through the JAX
    package's) within one grey level on the last one: the JAX renderer
    takes ~6 s a frame with distortion on the CPU."""
    monkeypatch.setattr(ttv, "_sample_hypotheses", jax_hypotheses)
    imgs, poses = chip_smoke.mono_frames(10, cam=CAM_T)
    world = syn.make_corridor_world(np.random.default_rng(0), n=900)
    T_last = syn.arc_trajectory(10, step=0.06, lateral=0.05)[-1]
    np.testing.assert_allclose(poses[-1][1], np.asarray(T_last.t), atol=1e-5)
    assert np.abs(imgs[-1] - syn.render(world, CAM_J, T_last)).max() <= 1.0
    settings = chip_smoke.distorted_mono_settings()
    assert np.allclose(settings.cam.params.numpy(), np.asarray(CAM_J.params))
    port = tsys.System(settings, "monocular", tracker_overrides=dict(min_init_matches=60), max_keyframes=256,
                       enable_loop_closing=False, multi_map=False, async_backend=False, device="cpu")
    cfg = jtrk.TrackerConfig(extractor=jext.ExtractorConfig(n_features=768), min_init_matches=60)
    voc = jvoc.default_vocabulary()
    jt = jtrk.Tracker(CAM_J, cfg, world=JMap(kp_cap=jext.total_capacity(cfg.extractor)),
                      mapper=JMapper(CAM_J, sigma2=jext.level_sigma2(cfg.extractor)), voc=voc,
                      kfdb=jdb.KeyFrameDatabase(voc.n_words, max_kf=256))
    states = []
    for i, img in enumerate(imgs):
        st_j, pose_j = jt.process_mono(img, i * 0.05)
        st_t, pose_t = port.track_monocular(img, i * 0.05)
        assert st_t == st_j, (i, st_t, st_j)
        states.append(st_t)
        if pose_t is not None:
            np.testing.assert_allclose(pose_t[1], pose_j[1], atol=2e-3, err_msg=f"frame {i}")
            np.testing.assert_allclose(pose_t[0], pose_j[0], atol=1e-3, err_msg=f"frame {i}")
    assert "OK" in states and states[-1] == "OK"
    assert port.world.n_kf == jt.world.n_kf >= 3
    n_t, n_j = int(port.world.lm_valid.sum()), int(jt.world.lm_valid.sum())
    assert abs(n_t - n_j) <= 0.03 * n_j
