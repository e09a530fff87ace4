"""The fisheye two-camera slice of the port against the JAX package on the
CPU: the KB8 camera's projection, Jacobian and unprojection; the fisheye
stereo match (K26) on tests/test_fisheye.py's pair; the fisheye Tracker
with local mapping on the first frames of that scene through the TUM-VI
rig (configs/TUMVI_fisheye_stereo_inertial.yaml: both KB8 cameras,
Stereo.T_c1_c2 with its 0.047 rad roll, bf 19.3); the System's wiring of
the rig; and the mapper's pin-hole F on KB8 pixels, which the port keeps
as the JAX package has it."""
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from orb_slam3_fast_tpu.backend import mapper as jmapper
from orb_slam3_fast_tpu.backend.mapper import Mapper as JMapper
from orb_slam3_fast_tpu.cameras import models as jcam
from orb_slam3_fast_tpu.frontend import tracker as jtrk
from orb_slam3_fast_tpu.map.worldmap import WorldMap as JMap
from orb_slam3_fast_tpu.ops import extractor as jext
from orb_slam3_fast_tpu.ops import matching as jmat
from orb_slam3_fast_tpu.slam.settings import Settings as JSettings
from orb_slam3_fast_tpu.utils import lie as jlie
from orb_slam3_fast_tpu_torch.backend import mapper as tmapper
from orb_slam3_fast_tpu_torch.cameras import models as tcam
from orb_slam3_fast_tpu_torch.ops import matching as tmat
from orb_slam3_fast_tpu_torch.slam import system as tsys
from orb_slam3_fast_tpu_torch.utils import convert
from tests import synthetic as syn
from tests.test_fisheye import CAM_L, CAM_R, CFG, T_C1_C2, WH

torch.set_num_threads(1)

CONFIG = str(Path(__file__).resolve().parents[1] / "configs" / "TUMVI_fisheye_stereo_inertial.yaml")
OPTS = dict(enable_loop_closing=False, multi_map=False, async_backend=False, device="cpu")
N_FRAMES = 8


def _cams(cam_j):
    return cam_j, convert.camera_to_torch(cam_j.kind, np.asarray(cam_j.params))


def test_kb8_camera_matches_jax():
    """The port's KB8 projection, its jacfwd Jacobian (cast back to float32)
    and its Newton unprojection against the JAX package's on and near the
    optical axis and out to ~100 deg off it: pixels within 1e-3 px,
    Jacobian entries within 1e-4 of the largest of their row, rays within
    1e-5 relative (where z > 0)."""
    from tests.test_torch_fisheye_kernels_host import probe_points

    cj, ct = _cams(CAM_L)
    xc = probe_points()
    uv_j = np.asarray(jcam.project(cj, jnp.asarray(xc)))
    uv_t = tcam.project(ct, torch.as_tensor(xc)).numpy()
    np.testing.assert_allclose(uv_t, uv_j, atol=1e-3)
    J_j = np.asarray(jcam.project_jac(cj, jnp.asarray(xc)))
    J_t = tcam.project_jac(ct, torch.as_tensor(xc))
    assert J_t.dtype == torch.float32
    scale = np.abs(J_j).max(axis=-1, keepdims=True)
    assert np.all(np.abs(J_t.numpy() - J_j) <= 1e-4 * scale)
    pix = uv_j[xc[:, 2] > 0.05]
    np.testing.assert_allclose(tcam.unproject(ct, torch.as_tensor(pix)).numpy(),
                               np.asarray(jcam.unproject(cj, jnp.asarray(pix))), rtol=1e-5, atol=1e-6)


def fisheye_pair_keypoints():
    """tests/test_fisheye.py's pair (frame 1 of its arc, its two cameras,
    T_c1_c2 a 10 cm shift), extracted by the JAX package, and R_rl, t_rl."""
    world = syn.make_corridor_world(np.random.default_rng(3), n=900, half_w=2.0, half_h=2.0, length=12.0)
    T = syn.arc_trajectory(3, step=0.06, lateral=0.05)[0]
    img_l, img_r = syn.stereo_pair_cams(world, CAM_L, CAM_R, T, T_C1_C2, wh=WH)
    kp_l = jext.extract(jnp.asarray(img_l, dtype=jnp.float32), CFG.extractor)
    kp_r = jext.extract(jnp.asarray(img_r, dtype=jnp.float32), CFG.extractor)
    Tm = np.asarray(T_C1_C2)
    R_rl, t_rl = Tm[:3, :3].T.astype(np.float32), (-Tm[:3, :3].T @ Tm[:3, 3]).astype(np.float32)
    return kp_l, kp_r, R_rl, t_rl, np.asarray(jext.level_sigma2(CFG.extractor), np.float32)


def to_torch_kp(kp):
    return convert.keypoints_to_torch(np.asarray(kp.xy), np.asarray(kp.level), np.asarray(kp.angle),
                                      np.asarray(kp.response), np.asarray(kp.desc), np.asarray(kp.valid), "cpu")


def test_fisheye_stereo_match_matches_jax():
    """``fisheye_stereo_match`` (kernel C's mutual mode and kernel AB, their
    plain versions on CPU tensors) against
    ``orb_slam3_fast_tpu/ops/matching.py:305`` on the same
    JAX-extracted keypoints: at most 1% of the slots flip valid, each
    within 1e-4 relative of a float cut it decides (the parallax cosine,
    either depth, either chi2); where both accept, the same right
    keypoint, depth and point within 1e-4 m; more than 120 accepted (the
    JAX test's gate)."""
    kp_l, kp_r, R_rl, t_rl, sigma2 = fisheye_pair_keypoints()
    fj = jmat.fisheye_stereo_match(CAM_L, CAM_R, kp_l, kp_r, jnp.asarray(R_rl), jnp.asarray(t_rl),
                                   jnp.asarray(sigma2))
    (_, cl), (_, cr) = _cams(CAM_L), _cams(CAM_R)
    tl, tr = to_torch_kp(kp_l), to_torch_kp(kp_r)
    ft = tmat.fisheye_stereo_match(cl, cr, tl, tr, torch.as_tensor(R_rl), torch.as_tensor(t_rl),
                                   torch.as_tensor(sigma2))
    vj, vt = np.asarray(fj.valid), ft.valid.numpy()
    assert vj.sum() > 120
    both = vj & vt
    np.testing.assert_array_equal(ft.idx.numpy()[both], np.asarray(fj.idx)[both])
    np.testing.assert_allclose(ft.depth.numpy()[both], np.asarray(fj.depth)[both], atol=1e-4)
    np.testing.assert_allclose(ft.x3d.numpy()[both], np.asarray(fj.x3d)[both], atol=1e-4)
    flipped = np.nonzero(vj != vt)[0]
    assert len(flipped) <= 0.01 * len(vj)
    if len(flipped):
        from tests.test_torch_fisheye_kernels_host import fisheye_margins

        rig = type("Rig", (), {"cam": cl, "cam2": cr})
        margins = fisheye_margins(rig, tl, tr, ft, torch.as_tensor(sigma2), torch.as_tensor(R_rl),
                                  torch.as_tensor(t_rl))
        assert all(float(margins[i]) < 1e-4 for i in flipped), margins[flipped]


def test_fisheye_tracker_matches_jax():
    """The port's System on the TUM-VI configuration (stereo, 1000
    features, a keyframe at most every 3 frames so that triangulation and
    local BA land) beside the JAX package's Tracker + Mapper built from
    the same file with the same rig, on the first 8 frames of
    tests/test_fisheye.py's corridor (chip_smoke.fisheye_frames): per frame
    the same state, pose within 2e-3 m and rotation entries within 1e-3;
    the same keyframes; live landmarks within 3%; local BA ran."""
    frames, poses, _ = chip_smoke.fisheye_frames(N_FRAMES)
    port = tsys.System(CONFIG, "stereo", tracker_overrides=dict(max_frames_between_kf=3), **OPTS)
    s = JSettings.from_yaml(CONFIG, sensor="stereo")
    ecfg = jext.ExtractorConfig(n_features=s.n_features, n_levels=s.n_levels, scale_factor=s.scale_factor,
                                ini_th_fast=s.ini_th_fast, min_th_fast=s.min_th_fast)
    jt = jtrk.Tracker(
        s.cam, jtrk.TrackerConfig(extractor=ecfg, th_depth=s.th_depth, max_frames_between_kf=3), bf=s.bf,
        image_wh=(s.width, s.height), cam2=s.cam2, T_c1_c2=s.T_c1_c2,
        world=JMap(kp_cap=jext.total_capacity(ecfg)), mapper=JMapper(s.cam, bf=s.bf, sigma2=jext.level_sigma2(ecfg)),
    )
    kf_t, kf_j = [], []
    for i, (img_l, img_r) in enumerate(frames):
        st_j, pose_j = jt.process_stereo(img_l, img_r, i * 0.05)
        st_t, pose_t = port.track_stereo(img_l, img_r, i * 0.05)
        assert st_t == st_j == "OK", (i, st_t, st_j)
        np.testing.assert_allclose(pose_t[1], np.asarray(pose_j[1]), atol=2e-3)
        np.testing.assert_allclose(pose_t[0], np.asarray(pose_j[0]), atol=1e-3)
        kf_t.append(port.world.n_kf)
        kf_j.append(jt.world.n_kf)
    assert kf_t == kf_j and kf_t[-1] >= 3
    n_t, n_j = int(port.world.lm_valid.sum()), int(jt.world.lm_valid.sum())
    assert abs(n_t - n_j) <= 0.03 * n_j
    assert port.mapper.n_local_ba >= 1
    # every edge monocular: the frames carry depth, no right-u
    assert (port.tracker.last.right_u == -1.0).all() and (port.tracker.last.depth > 0).sum() >= 100


def test_system_wires_the_fisheye_rig():
    """``System(TUM-VI config)`` on the CPU routes the second KB8 camera and
    Stereo.T_c1_c2 to the tracker (R_rl = R_lr^T, t_rl = -R_lr^T t_lr, as
    the JAX package's tracker keeps them), for stereo and stereo-inertial,
    and the JAX package's settings convert to the same rig
    (``convert.settings_to_torch``);
    with loop closing it raises at construction naming ROADMAP §A item 14,
    and a monocular KB8 System naming item 15."""
    for sensor in ("stereo", "stereo-inertial"):
        slam = tsys.System(CONFIG, sensor, **OPTS)
        s = slam.settings
        # the JAX package's settings converted field by field give the same rig
        sc = convert.settings_to_torch(JSettings.from_yaml(CONFIG, sensor))
        assert sc.cam.kind == sc.cam2.kind == tcam.KB8 and sc.bf == s.bf
        for a, b in ((sc.cam.params, s.cam.params), (sc.cam2.params, s.cam2.params)):
            np.testing.assert_array_equal(a.numpy(), b.numpy())
        np.testing.assert_array_equal(sc.T_c1_c2, s.T_c1_c2)
        np.testing.assert_array_equal(sc.T_b_c1, s.T_b_c1)
        assert slam.tracker.cam2 is s.cam2 and s.cam2.kind == tcam.KB8
        R_lr, t_lr = s.T_c1_c2[:3, :3], s.T_c1_c2[:3, 3]
        np.testing.assert_allclose(slam.tracker.T_rl[0].numpy(), R_lr.T, atol=1e-7)
        np.testing.assert_allclose(slam.tracker.T_rl[1].numpy(), -R_lr.T @ t_lr, atol=1e-7)
        jt = jtrk.Tracker(JSettings.from_yaml(CONFIG, sensor).cam, T_c1_c2=s.T_c1_c2,
                          cam2=JSettings.from_yaml(CONFIG, sensor).cam2)
        np.testing.assert_allclose(slam.tracker.T_rl[0].numpy(), np.asarray(jt.T_rl[0]), atol=1e-7)
        np.testing.assert_allclose(slam.tracker.T_rl[1].numpy(), np.asarray(jt.T_rl[1]), atol=1e-7)
        with pytest.raises(NotImplementedError, match="ROADMAP §A item 14"):
            tsys.System(CONFIG, sensor, **dict(OPTS, enable_loop_closing=True))
    with pytest.raises(NotImplementedError, match="ROADMAP §A item 15"):
        tsys.System(CONFIG, "monocular", **OPTS)


def test_mapper_pinhole_f_on_kb8_pixels_kept():
    """The divergence the port keeps: the JAX mapper's epipolar search
    takes ``compute_f12``'s pin-hole F from the KB8 camera's K on the
    distorted fisheye pixels (orb_slam3_fast_tpu/backend/mapper.py:39-55,
    whose docstring says a fisheye caller should match on unprojected
    bearings).  The port computes the same F to float32 rounding, and on a
    true KB8 correspondence far off the optical axis that F's epipolar
    residual lies beyond the search's chi2 band at level 0 (3.84 px^2)
    while the bearings satisfy the essential matrix: the defect,
    reproduced (ROADMAP §C)."""
    cj, ct = _cams(CAM_L)
    # keyframe 1: 0.3 m to the side of keyframe 0 and turned 0.1 rad, so that the epipolar lines are not radial
    R2 = np.asarray(jlie.so3_exp(jnp.asarray([0.0, 0.1, 0.0])), np.float32)
    t2 = np.asarray([-0.3, 0.0, 0.05], np.float32)
    F_t = tmapper.compute_f12(_Poses((np.eye(3), np.zeros(3)), (R2, t2)), ct, 1, 0)
    F_j = np.asarray(jmapper.compute_f12(_Poses((np.eye(3), np.zeros(3)), (R2, t2)), cj, 1, 0))
    np.testing.assert_allclose(F_t, F_j, rtol=1e-5, atol=1e-9)
    # a point ~60 deg off the axis, high in the image, seen from both keyframes
    Xw = np.array([1.6, 1.6, 1.3], np.float64)
    x0 = np.asarray(jcam.project(cj, jnp.asarray(Xw, jnp.float32)), np.float64)
    x1 = np.asarray(jcam.project(cj, jnp.asarray(R2 @ Xw + t2)), np.float64)
    line = F_j @ np.r_[x0, 1.0]  # keyframe 0's point -> a line in keyframe 1
    resid_px = abs(line @ np.r_[x1, 1.0]) / np.hypot(line[0], line[1])
    assert resid_px ** 2 > 3.84  # beyond the search's band at level 0 (ORBmatcher.cc:1067): the true match is lost
    b0 = np.asarray(jcam.unproject(cj, jnp.asarray(x0, jnp.float32)), np.float64)
    b1 = np.asarray(jcam.unproject(cj, jnp.asarray(x1, jnp.float32)), np.float64)
    tx = np.array([[0, -t2[2], t2[1]], [t2[2], 0, -t2[0]], [-t2[1], t2[0], 0]])
    assert abs(b1 @ (tx @ R2) @ b0) < 1e-3 * np.linalg.norm(b0) * np.linalg.norm(b1)


class _Poses:
    """The two keyframe poses ``compute_f12`` reads (kf_R, kf_t)."""

    def __init__(self, *poses):
        self.kf_R = np.stack([np.asarray(R, np.float32) for R, _ in poses])
        self.kf_t = np.stack([np.asarray(t, np.float32) for _, t in poses])


def test_body_imu_stream_through_T_b_c1():
    """chip_smoke's IMU stream of the body for phase 13 (b): with the rig's
    IMU.T_b_c1 the samples are the body's rotation rate and specific force,
    the lever arm's centripetal term included, so they match the numerical
    derivatives of the body's trajectory T_wb = T_wc T_cb (one sample per
    pose at 200 Hz, noise-free): rates within 1e-4 rad/s, forces within
    2e-2 m/s^2 (the central difference's error at 5 ms steps)."""
    from scipy.spatial.transform import Rotation

    T_bc = chip_smoke.fisheye_settings("stereo-inertial").T_b_c1
    dt = 1.0 / 200.0
    poses, imu = chip_smoke.arc_trajectory_with_imu(60, dt_frame=dt, step=0.06 * dt / 0.05,
                                                    lateral=0.05 * dt / 0.05, T_bc=T_bc)
    R_bc, t_bc = T_bc[:3, :3], T_bc[:3, 3]
    R_wb = np.stack([R.T.astype(np.float64) @ R_bc.T for R, _ in poses])
    p_wb = np.stack([-R.T.astype(np.float64) @ t - R.T.astype(np.float64) @ R_bc.T @ t_bc for R, t in poses])
    g = np.array([0.0, 9.81, 0.0])
    for i in (10, 30, 50):
        acc = (p_wb[i + 1] - 2 * p_wb[i] + p_wb[i - 1]) / dt ** 2
        np.testing.assert_allclose(imu[i, 1:4], R_wb[i].T @ (acc - g), atol=2e-2)
        w = Rotation.from_matrix(R_wb[i].T @ R_wb[i + 1]).as_rotvec() / dt
        np.testing.assert_allclose(imu[i, 4:], w, atol=1e-4)
