"""The JAX package's own monocular System on chip_smoke.py's phase 15
scenes: TUM-VI's cam0 (configs/TUMVI_fisheye_stereo_inertial.yaml, a
512x512 KB8 camera, 1000 features) alone, synchronous.

* ``--scene a``: ``System(..., "monocular", enable_loop_closing=False)``
  on the 25 frames of phase 13 (a)'s corridor (tests/test_fisheye.py's);
* ``--scene b``: ``"monocular-inertial"`` on phase 13 (b)'s 45-frame arc
  with the body's IMU stream through IMU.T_b_c1 and phase 11's
  initialisation window (init_min_kfs 8, init_min_time 1.0);
* ``--scene c``: ``"monocular"`` with loop closing, the Atlas and 256
  keyframes, the loop closer at phase 9's LoopCloserConfig with the scale
  free, on phase 14's circle (the ring world along
  circle_trajectory_with_imu(150)).

It prints each frame's (frame, state, keyframes, IMU initialised, loops),
then what phase 15 gates the port on: the final state, the frames
tracked, the first frame tracked (the initialisation), the keyframes, the
IMU-initialisation frame, the loops and their frames, and the
scale-aligned ATE and the fitted scale over the frames tracked (after the
IMU initialisation with the IMU).  These readings are the level phase
15's gates are set at.

Run from the repository root on the CPU (a few minutes for a and b, about
ten for c): ``python -m tests.fisheye_mono_reference --scene c``;
``--frames N`` stops early.
"""
import argparse
import time

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

import chip_smoke as cs  # noqa: E402
from orb_slam3_fast_tpu.backend.loopcloser import LoopCloserConfig  # noqa: E402
from orb_slam3_fast_tpu.eval import ate  # noqa: E402
from orb_slam3_fast_tpu.slam.system import System  # noqa: E402


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--scene", choices=("a", "b", "c"), default="a")
    parser.add_argument("--frames", type=int, default=None)
    args = parser.parse_args()
    inertial = args.scene == "b"
    sensor = "monocular-inertial" if inertial else "monocular"
    if args.scene == "c":
        pairs, poses, _ = cs.fisheye_loop_frames()
        slam = System(cs.FISHEYE_CONFIG, sensor, max_keyframes=256, enable_loop_closing=True, multi_map=True,
                      async_backend=False)
        slam.loopcloser.cfg = LoopCloserConfig(**cs.LOOP_CONFIG, fix_scale=False)
        imu = None
    else:
        pairs, poses, imu = cs.fisheye_frames(cs.FISHEYE_VI_FRAMES if inertial else cs.FISHEYE_FRAMES, imu=inertial)
        slam = System(cs.FISHEYE_CONFIG, sensor, enable_loop_closing=False, multi_map=False, async_backend=False)
        if inertial:
            slam.tracker.icfg = slam.tracker.icfg._replace(init_min_kfs=8, init_min_time=1.0)
    n = min(args.frames or len(pairs), len(pairs))
    samples = cs.imu_slices(imu, n) if inertial else [()] * n
    lc = slam.loopcloser
    rows, est, gt, ts, first_ok, init_frame, closed, n_ok = [], [], [], [], None, None, [], 0
    t0 = time.perf_counter()
    for i, ((img, _), (R, t), smp) in enumerate(zip(pairs[:n], poses[:n], samples)):
        loops = lc.n_loops_closed if lc else 0
        state, pose = slam.track_monocular(img, i * 0.05, imu=smp)
        if lc and lc.n_loops_closed > loops:
            closed.append(i)
        if inertial and slam.world.imu_initialized and init_frame is None:
            init_frame = i
        n_ok += state == "OK"
        if state == "OK" and first_ok is None:
            first_ok = i
        rows.append(f"{i}:{state[0]}:{slam.world.n_kf}:{int(slam.world.imu_initialized)}:{lc.n_loops_closed if lc else 0}")
        if state == "OK" and pose is not None and (not inertial or (init_frame is not None and i > init_frame)):
            est.append(-np.asarray(pose[0]).T @ np.asarray(pose[1]))
            gt.append(-R.T @ t)
            ts.append(i * 0.05)
        if i % 25 == 24 or i == n - 1:
            print(" ".join(rows[-(i % 25 + 1):]), flush=True)
    out = dict(scene=args.scene, sensor=sensor, frames=n, state=slam.get_tracking_state(), tracked=n_ok,
               first_ok=first_ok, n_kf=slam.world.n_kf, init_frame=init_frame, after_init=len(est) if inertial else None,
               loops=lc.n_loops_closed if lc else None, merges=lc.n_maps_merged if lc else None, closed_at=closed,
               seconds=time.perf_counter() - t0)
    if len(est) >= 3:
        rmse, _, s_fit = ate.ate_rmse(np.asarray(ts), np.asarray(est), np.asarray(ts), np.asarray(gt), with_scale=True)
        out.update(ate_m=float(rmse), scale=float(s_fit))
    print(out, flush=True)


if __name__ == "__main__":
    main()
