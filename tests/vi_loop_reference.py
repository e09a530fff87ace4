"""The JAX package's own stereo-inertial System on chip_smoke.py's phase 12
(a) scene: the loop scenario's ring world in stereo along
chip_smoke.circle_trajectory_with_imu (150 frames, the speed modulated,
the exact IMU stream), synchronous, with loop closing and the Atlas and
phase 9's LoopCloserConfig (the scale fixed), the IMU noise densities of
configs/synthetic_stereo.yaml scaled by ``--noise-scale`` (phase 12 flies
chip_smoke.VI_LOOP_IMU_NOISE times them).  It prints each 25 frames'
(frame, state, keyframes, IMU initialised, loops), then what phase 12 (a)
gates the port on: the final state, the frames tracked, the
IMU-initialisation frame, the loops and their frames, the keyframes and
the unscaled ATE of the frames tracked after the initialisation.  These
readings are the level phase 12 (a)'s gates fall to where the JAX
package's own System misses them.

Run from the repository root on the CPU (about 10 minutes):
``python -m tests.vi_loop_reference --noise-scale 300``; ``--frames 80``
stops early.
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
    parser.add_argument("--noise-scale", type=float, default=cs.VI_LOOP_IMU_NOISE)
    parser.add_argument("--frames", type=int, default=cs.LOOP_FRAMES)
    args = parser.parse_args()
    frames, poses, imu = cs.vi_loop_frames()
    k = args.noise_scale
    s = Settings.from_yaml(cs.SYS_CONFIG, "stereo-inertial")
    s = dataclasses.replace(s, imu_noise_gyro=k * s.imu_noise_gyro, imu_noise_acc=k * s.imu_noise_acc,
                            imu_gyro_walk=k * s.imu_gyro_walk, imu_acc_walk=k * s.imu_acc_walk)
    slam = System(s, "stereo-inertial", max_keyframes=256, enable_loop_closing=True, multi_map=True,
                  async_backend=False)
    slam.loopcloser.cfg = LoopCloserConfig(**cs.LOOP_CONFIG, fix_scale=True)
    n = min(args.frames, len(frames))
    rows, est, gt, ts, init_frame, closed, n_ok = [], [], [], [], None, [], 0
    t0 = time.perf_counter()
    for i, ((img_l, img_r), samples) in enumerate(zip(frames[:n], cs.imu_slices(imu, n))):
        loops = slam.loopcloser.n_loops_closed
        state, pose = slam.track_stereo(img_l, img_r, i * 0.05, imu=samples)
        closed += [i] if slam.loopcloser.n_loops_closed > loops else []
        if slam.world.imu_initialized and init_frame is None:
            init_frame = i
        n_ok += state == "OK"
        rows.append(f"{i}:{state[0]}:{slam.world.n_kf}:{int(slam.world.imu_initialized)}:{slam.loopcloser.n_loops_closed}")
        if state == "OK" and pose is not None and init_frame is not None and i > init_frame:
            R, t = poses[i]
            est.append(-np.asarray(pose[0]).T @ np.asarray(pose[1]))
            gt.append(-R.T @ t)
            ts.append(i * 0.05)
        if i % 25 == 24:
            print(" ".join(rows[-25:]), flush=True)
    out = dict(noise_scale=k, state=slam.get_tracking_state(), tracked=n_ok, init_frame=init_frame,
               loops=slam.loopcloser.n_loops_closed, closed_at=closed, n_kf=slam.world.n_kf,
               seconds=time.perf_counter() - t0)
    if len(est) >= 3:
        out["ate_unscaled_m"] = float(ate.ate_rmse(np.asarray(ts), np.asarray(est), np.asarray(ts), np.asarray(gt),
                                                   with_scale=False)[0])
    print(out, flush=True)


if __name__ == "__main__":
    main()
