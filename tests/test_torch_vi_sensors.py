"""The port's stereo- and RGB-D-inertial trackers beside the JAX package's
InertialTracker for 12 frames of test_vi_tracker.py's IMU stream over the
stereo and RGB-D corridors, the bad-IMU reset through the Atlas, and
chip_smoke.py's numpy copy of the IMU stream generator."""
import numpy as np
import pytest
import torch

import chip_smoke
from orb_slam3_fast_tpu_torch.imu import preintegration as tpre
from orb_slam3_fast_tpu_torch.slam import system as tsys
from tests import synthetic as syn
from tests.test_torch_vi_system import _run_both

torch.set_num_threads(1)

N_SHORT = 12


@pytest.mark.parametrize("sensor", ["stereo", "rgbd"])
def test_short_inertial_runs_match_jax(sensor):
    """Stereo- and RGB-D-inertial, 12 frames (the scale fixed, the IMU
    preintegrated every frame, not yet initialised): the same states, poses
    within 2e-3 (rotation entries 1e-3), the same keyframes, and the
    keyframes' preintegrated windows within 1e-5."""
    rows, jt, tt = _run_both(sensor, N_SHORT, dict(fix_scale=True, imu_bucket=32))
    for i, (sj, st, pj, pt, ij, it) in enumerate(rows):
        assert (st, it) == (sj, ij), (i, st, sj)
        np.testing.assert_allclose(pt[1], pj[1], atol=2e-3, err_msg=f"frame {i}")
        np.testing.assert_allclose(pt[0], pj[0], atol=1e-3, err_msg=f"frame {i}")
    assert all(r[1] == "OK" for r in rows)
    assert tt.world.n_kf == jt.world.n_kf >= 2 and sorted(tt.world.kf_preint) == sorted(jt.world.kf_preint)
    for k in tt.world.kf_preint:
        for f, a, b in zip(tpre.Preintegrated._fields, tt.world.kf_preint[k], jt.world.kf_preint[k]):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5 * max(1.0, float(np.abs(b).max())),
                                       err_msg=f"keyframe {k} {f}")


def test_bad_imu_resets_the_active_map_through_the_atlas():
    """The mono-inertial System with the Atlas: five windows of non-finite
    samples in a row reset the active map (mbBadImu), as the JAX tracker
    does; finite samples keep it."""
    slam = tsys.System(chip_smoke.MONO_CONFIG, "monocular-inertial", tracker_overrides=dict(min_init_matches=60),
                       enable_loop_closing=False, async_backend=False, multi_map=True, device="cpu")
    frames, _, imu = chip_smoke.vi_frames("monocular", 12)
    slices = chip_smoke.imu_slices(imu, 12)
    for i in range(6):
        slam.track_monocular(frames[i][0], i * 0.05, imu=slices[i])
    assert slam.get_tracking_state() == "OK" and slam.world.n_kf >= 2
    world = slam.world
    for i in range(6, 11):
        bad = slices[i].copy()
        bad[:, 1:] = np.nan
        slam.track_monocular(frames[i][0], i * 0.05, imu=bad)
    assert slam.tracker.world is not world and slam.tracker.world.n_kf <= 1
    assert slam.atlas.maps[slam.atlas.current_id] is slam.tracker.world


def test_imu_stream_matches_synthetic():
    """chip_smoke's numpy copy of synthetic.arc_trajectory_with_imu: poses
    within 1e-5, samples within 1e-4."""
    kw = dict(step=0.06, lateral=0.05, gyro_bias=(0.002, -0.001, 0.0015), acc_bias=(0.03, -0.02, 0.04),
              noise_gyro=1.7e-4 * np.sqrt(200.0), noise_acc=2e-3 * np.sqrt(200.0), seed=0)
    pj, ij = syn.arc_trajectory_with_imu(12, **kw)
    pt, it = chip_smoke.arc_trajectory_with_imu(12, **kw)
    for T, (R, t) in zip(pj, pt):
        np.testing.assert_allclose(R, np.asarray(T.R), atol=1e-5)
        np.testing.assert_allclose(t, np.asarray(T.t), atol=1e-5)
    np.testing.assert_allclose(it, ij, atol=1e-4)


def jax_stereo_reference(n_frames: int = chip_smoke.VI_FRAMES) -> dict:
    """The JAX package's stereo-inertial InertialTracker (scale fixed, IMU
    bucket 32, init_min_kfs 8, init_min_time 1.0) on chip_smoke.py's
    phase 11 (b) scene, read as run_vi reads the port's System."""
    import jax

    from orb_slam3_fast_tpu.eval import ate
    from tests.test_torch_vi_system import _pair

    jax.config.update("jax_platforms", "cpu")
    frames, poses, imu = chip_smoke.vi_frames("stereo", n_frames)
    jt, _ = _pair("stereo", dict(fix_scale=True, imu_bucket=32))
    est, gt, ts, states, init_frame = [], [], [], [], None
    for i, (f, (R, t), samples) in enumerate(zip(frames, poses, chip_smoke.imu_slices(imu, n_frames))):
        jt.grab_imu(samples)
        state, pose = jt.process_stereo(*f, i * 0.05)
        states.append(state)
        if jt.world.imu_initialized and init_frame is None:
            init_frame = i
        if state == "OK" and init_frame is not None and i > init_frame:
            est.append(-pose[0].T @ pose[1])
            gt.append(-R.T @ t)
            ts.append(i * 0.05)
    out = dict(state=states[-1], tracked=states.count("OK"), init_frame=init_frame, n_kf=jt.world.n_kf)
    if len(est) >= 3:
        est, gt, ts = np.asarray(est), np.asarray(gt), np.asarray(ts)
        out["ate_unscaled_m"] = float(ate.ate_rmse(ts, est, ts, gt, with_scale=False)[0])
    return out


if __name__ == "__main__":
    print(jax_stereo_reference())
