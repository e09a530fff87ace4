"""The port's stereo-inertial System on the fisheye rig beside the JAX
package's (configs/TUMVI_fisheye_stereo_inertial.yaml: both KB8 cameras,
Stereo.T_c1_c2, IMU.T_b_c1 and the file's IMU block; synchronous, without
loop closing) on chip_smoke.py's phase 13 (b) scene: tests/test_fisheye.py's
corridor along the arc whose speed is modulated, the IMU stream the body's
through IMU.T_b_c1, phase 11's initialisation window (init_min_kfs 8,
init_min_time 1.0), on the frames up to and just past the IMU
initialisation (frame 25 in both): the same state and keyframes every
frame, the IMU initialised at the same frame, poses close.
The whole 45 frames: ``python -m tests.fisheye_reference --sensor
stereo-inertial`` (the JAX package) and chip_smoke.py phase 13 (b)."""
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
from orb_slam3_fast_tpu.slam.settings import Settings as JSettings
from orb_slam3_fast_tpu.slam.system import System as JSystem
from orb_slam3_fast_tpu_torch.slam import system as tsys
from orb_slam3_fast_tpu_torch.utils import convert

torch.set_num_threads(1)

CONFIG = str(Path(__file__).resolve().parents[1] / "configs" / "TUMVI_fisheye_stereo_inertial.yaml")
N_FRAMES = 28
INIT_WINDOW = dict(init_min_kfs=8, init_min_time=1.0)  # chip_smoke._fisheye_system's


@pytest.fixture(scope="module")
def both_runs():
    """Both Systems on the first N_FRAMES frames, run once for the module.
    Per frame (state_j, state_t, pose_j, pose_t, initialised_j,
    initialised_t, keyframes_j, keyframes_t)."""
    frames, _, imu = chip_smoke.fisheye_frames(N_FRAMES, imu=True)
    opts = dict(enable_loop_closing=False, multi_map=False, async_backend=False)
    settings = JSettings.from_yaml(CONFIG, sensor="stereo-inertial")  # one settings object for both
    js = JSystem(settings, "stereo-inertial", **opts)
    ts = tsys.System(convert.settings_to_torch(settings), "stereo-inertial", device="cpu", **opts)
    for s in (js, ts):
        s.tracker.icfg = s.tracker.icfg._replace(**INIT_WINDOW)
    rows = []
    for i, ((img_l, img_r), samples) in enumerate(zip(frames, chip_smoke.imu_slices(imu, N_FRAMES))):
        sj, pj = js.track_stereo(img_l, img_r, i * 0.05, imu=samples)
        st, pt = ts.track_stereo(img_l, img_r, i * 0.05, imu=samples)
        rows.append((sj, st, pj, pt, js.world.imu_initialized, ts.world.imu_initialized, js.world.n_kf, ts.world.n_kf))
    return rows, js, ts


def test_states_keyframes_and_init_frame_match_jax(both_runs):
    """Every frame the same state, the same keyframe count and the same
    IMU-initialised flag; the IMU initialised within the run, with at least
    two inertial frames after it; both built the fisheye rig's tracker
    (cam2 routed, every pose edge monocular)."""
    rows, js, ts = both_runs
    for i, (sj, st, _, _, ij, it, kj, kt) in enumerate(rows):
        assert (sj, ij, kj) == (st, it, kt), (i, rows[i][:2], rows[i][4:])
    init = [i for i, r in enumerate(rows) if r[5]]
    assert init and init[0] <= N_FRAMES - 3, [r[5] for r in rows]
    assert ts.tracker.cam2 is ts.settings.cam2 and (ts.tracker.last.right_u == -1.0).all()


def test_poses_match_jax(both_runs):
    """Camera poses within 2e-3 m and rotation entries within 1e-3 before
    the IMU initialisation, and within phase 11's stereo-inertial bounds
    (chip_smoke.VI_BOUNDS: 5e-2 m, 5e-3) from it on, where both solve the
    inertial problem in float32 with other summation orders."""
    rows, _, _ = both_runs
    for i, (sj, st, pj, pt, ij, it, _, _) in enumerate(rows):
        if pj is None:
            continue
        dt, dr = (2e-3, 1e-3) if not it else chip_smoke.VI_BOUNDS["stereo"]
        np.testing.assert_allclose(pt[1], np.asarray(pj[1]), atol=dt, err_msg=f"frame {i}")
        np.testing.assert_allclose(pt[0], np.asarray(pj[0]), atol=dr, err_msg=f"frame {i}")
