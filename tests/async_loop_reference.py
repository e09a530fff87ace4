"""The JAX package's own default (async) monocular System on the loop
circle of chip_smoke.py's phase 10 (b): tests/test_loop_closing.py's
150-frame circle (chip_smoke.loop_frames, within one grey level of
tests/synthetic.render), the System with chip_smoke's loop overrides and
LoopCloserConfig and its async backend left at its default, each frame fed
at its timestamp (20 fps) or as soon as the last one is tracked.  Per run
it prints what phase 10 (b) gates the port on: the backend drained, its
worker errors, the final state, the frames tracked, the loops closed, the
global BAs completed and the scale-aligned ATE; then the least and the
largest of each over the runs.  These readings are the level phase 10
(b)'s gates fall to where the JAX package's own System misses them.

Run from the repository root on the CPU (about 5 minutes a run):
``python -m tests.async_loop_reference --runs 3``.
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


def run(frames, poses) -> dict:
    slam = System(cs.MONO_CONFIG, "monocular", tracker_overrides=dict(min_init_matches=60, motion_radius=25.0),
                  max_keyframes=256)
    slam.loopcloser.cfg = LoopCloserConfig(**cs.LOOP_CONFIG)
    b = slam.backend
    est, gt, ts = [], [], []
    t0 = time.perf_counter()
    for i, (img, (R, t)) in enumerate(zip(frames, poses)):
        wait = t0 + i * 0.05 - time.perf_counter()
        if wait > 0:
            time.sleep(wait)
        state, pose = slam.track_monocular(img, i * 0.05)
        if state == "OK" and pose is not None:
            est.append(-pose[0].T @ pose[1])
            gt.append(-R.T @ t)
            ts.append(i * 0.05)
    feed_s = time.perf_counter() - t0
    drained = b.wait_idle(timeout=600)
    slam.shutdown()
    rmse, _, _ = ate.ate_rmse(np.asarray(ts), np.asarray(est), np.asarray(ts), np.asarray(gt), with_scale=True)
    return dict(drained=drained, errors=len(b.errors), state=slam.get_tracking_state(), tracked=len(est),
                loops=slam.loopcloser.n_loops_closed, gba_completed=b.gba_completed, ate_m=float(rmse),
                n_kf=slam.world.n_kf, maps=len(slam.atlas.maps), feed_s=feed_s,
                error=b.errors[0].strip().splitlines()[-1] if b.errors else None)


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--runs", type=int, default=3)
    args = parser.parse_args()
    frames, poses = cs.loop_frames()
    rows = []
    for k in range(args.runs):
        rows.append(run(frames, poses))
        print(k, rows[-1], flush=True)
    for key in ("tracked", "loops", "gba_completed", "ate_m", "errors"):
        vals = [r[key] for r in rows]
        print(f"{key}: least {min(vals)}, largest {max(vals)}")
    print(f"final states: {[r['state'] for r in rows]}; drained: {[r['drained'] for r in rows]}")


if __name__ == "__main__":
    main()
