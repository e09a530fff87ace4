"""The JAX package's own System on chip_smoke.py's phase 14 scene: the
loop scenario's ring world along chip_smoke.circle_trajectory_with_imu
(150 frames, the speed modulated) seen by the TUM-VI rig
(configs/TUMVI_fisheye_stereo_inertial.yaml: two 512x512 KB8 cameras,
Stereo.T_c1_c2, 1000 features), synchronous, with loop closing, the Atlas,
256 keyframes and phase 9's LoopCloserConfig (the scale fixed):
``--sensor stereo`` (phase 14 (a)) or ``--sensor stereo-inertial`` (phase
14 (b), the exact IMU stream of the body through IMU.T_b_c1, the
configuration's IMU noise densities scaled by ``--noise-scale``).  It
prints each 25 frames' (frame, state, keyframes, IMU initialised, loops),
then what phase 14 gates the port on: the final state, the frames
tracked, the IMU-initialisation frame, the loops and their frames, the
keyframes and the unscaled ATE of the frames tracked (after the
initialisation with the IMU).  These readings are the level phase 14's
gates are set at.

Run from the repository root on the CPU (about 10 minutes each):
``python -m tests.fisheye_loop_reference --sensor stereo-inertial``;
``--frames 80`` stops early.
"""
import argparse
import dataclasses
import time

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

import chip_smoke as cs  # noqa: E402
from orb_slam3_fast_tpu.backend.loopcloser import LoopCloserConfig  # noqa: E402
from orb_slam3_fast_tpu.eval import ate  # noqa: E402
from orb_slam3_fast_tpu.slam.settings import Settings  # noqa: E402
from orb_slam3_fast_tpu.slam.system import System  # noqa: E402


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--sensor", choices=("stereo", "stereo-inertial"), default="stereo")
    parser.add_argument("--noise-scale", type=float, default=cs.FISHEYE_LOOP_IMU_NOISE)
    parser.add_argument("--frames", type=int, default=cs.LOOP_FRAMES)
    args = parser.parse_args()
    inertial = args.sensor == "stereo-inertial"
    frames, poses, imu = cs.fisheye_loop_frames()
    s = Settings.from_yaml(cs.FISHEYE_CONFIG, args.sensor)
    if inertial:
        k = args.noise_scale
        s = dataclasses.replace(s, imu_noise_gyro=k * s.imu_noise_gyro, imu_noise_acc=k * s.imu_noise_acc,
                                imu_gyro_walk=k * s.imu_gyro_walk, imu_acc_walk=k * s.imu_acc_walk)
    slam = System(s, args.sensor, max_keyframes=256, enable_loop_closing=True, multi_map=True, async_backend=False)
    slam.loopcloser.cfg = LoopCloserConfig(**cs.LOOP_CONFIG, fix_scale=True)
    n = min(args.frames, len(frames))
    samples = cs.imu_slices(imu, n) if inertial else [()] * n
    rows, est, gt, ts, init_frame, closed, n_ok = [], [], [], [], None, [], 0
    t0 = time.perf_counter()
    for i, ((img_l, img_r), smp) in enumerate(zip(frames[:n], samples)):
        loops = slam.loopcloser.n_loops_closed
        state, pose = slam.track_stereo(img_l, img_r, i * 0.05, imu=smp)
        closed += [i] if slam.loopcloser.n_loops_closed > loops else []
        if slam.world.imu_initialized and init_frame is None:
            init_frame = i
        n_ok += state == "OK"
        rows.append(f"{i}:{state[0]}:{slam.world.n_kf}:{int(slam.world.imu_initialized)}:{slam.loopcloser.n_loops_closed}")
        if state == "OK" and pose is not None and (not inertial or (init_frame is not None and i > init_frame)):
            R, t = poses[i]
            est.append(-np.asarray(pose[0]).T @ np.asarray(pose[1]))
            gt.append(-R.T @ t)
            ts.append(i * 0.05)
        if i % 25 == 24:
            print(" ".join(rows[-25:]), flush=True)
    out = dict(sensor=args.sensor, noise_scale=args.noise_scale if inertial else None,
               state=slam.get_tracking_state(), tracked=n_ok, init_frame=init_frame,
               loops=slam.loopcloser.n_loops_closed, merges=slam.loopcloser.n_maps_merged, closed_at=closed,
               n_kf=slam.world.n_kf, seconds=time.perf_counter() - t0)
    if len(est) >= 3:
        out["ate_unscaled_m"] = float(ate.ate_rmse(np.asarray(ts), np.asarray(est), np.asarray(ts), np.asarray(gt),
                                                   with_scale=False)[0])
    print(out, flush=True)


if __name__ == "__main__":
    main()
