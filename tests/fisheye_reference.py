"""The JAX package's own System on chip_smoke.py's phase 13 scenes: the
TUM-VI rig (configs/TUMVI_fisheye_stereo_inertial.yaml: two 512x512 KB8
cameras, Stereo.T_c1_c2, 1000 features) on tests/test_fisheye.py's
corridor, synchronous, without loop closing: ``--sensor stereo`` on the 25
frames of phase 13 (a), ``--sensor stereo-inertial`` on the 45 frames of
phase 13 (b) with the body's IMU stream through IMU.T_b_c1 and phase 11's
initialisation window (init_min_kfs 8, init_min_time 1.0).  It prints each
frame's (frame, state, keyframes, IMU initialised), then what phase 13
gates the port on: the final state, the frames tracked, the keyframes, the
IMU-initialisation frame, and the unscaled ATE and the fitted scale over
the frames tracked (after the initialisation with the IMU).  These
readings are the level phase 13's gates fall to where the JAX package's own
System misses tests/test_fisheye.py's.

Run from the repository root on the CPU (a few minutes each):
``python -m tests.fisheye_reference --sensor stereo-inertial``.
"""
import argparse
import time

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

import chip_smoke as cs  # noqa: E402
from orb_slam3_fast_tpu.eval import ate  # noqa: E402
from orb_slam3_fast_tpu.slam.system import System  # noqa: E402


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--sensor", choices=("stereo", "stereo-inertial"), default="stereo")
    args = parser.parse_args()
    inertial = args.sensor == "stereo-inertial"
    frames, poses, imu = cs.fisheye_frames(cs.FISHEYE_VI_FRAMES if inertial else cs.FISHEYE_FRAMES, imu=inertial)
    slam = System(cs.FISHEYE_CONFIG, args.sensor, enable_loop_closing=False, multi_map=False, async_backend=False)
    if inertial:
        slam.tracker.icfg = slam.tracker.icfg._replace(init_min_kfs=8, init_min_time=1.0)
    samples = cs.imu_slices(imu, len(frames)) if inertial else [None] * len(frames)
    rows, est, gt, ts, init_frame, n_ok = [], [], [], [], None, 0
    t0 = time.perf_counter()
    for i, ((img_l, img_r), (R, t), smp) in enumerate(zip(frames, poses, samples)):
        state, pose = slam.track_stereo(img_l, img_r, i * 0.05, **({} if smp is None else {"imu": smp}))
        if inertial and slam.world.imu_initialized and init_frame is None:
            init_frame = i
        n_ok += state == "OK"
        rows.append(f"{i}:{state[0]}:{slam.world.n_kf}:{int(slam.world.imu_initialized)}")
        if state == "OK" and pose is not None and (not inertial or (init_frame is not None and i > init_frame)):
            est.append(-np.asarray(pose[0]).T @ np.asarray(pose[1]))
            gt.append(-R.T @ t)
            ts.append(i * 0.05)
    print(" ".join(rows), flush=True)
    out = dict(sensor=args.sensor, state=slam.get_tracking_state(), tracked=n_ok, n_kf=slam.world.n_kf,
               init_frame=init_frame, after_init=len(est) if inertial else None, seconds=time.perf_counter() - t0)
    if len(est) >= 3:
        est, gt, ts = np.asarray(est), np.asarray(gt), np.asarray(ts)
        out["ate_unscaled_m"] = float(ate.ate_rmse(ts, est, ts, gt, with_scale=False)[0])
        out["scale"] = float(ate.ate_rmse(ts, est, ts, gt, with_scale=True)[2])
    print(out, flush=True)


if __name__ == "__main__":
    main()
