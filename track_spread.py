#!/usr/bin/env python3
"""Run-to-run spread of the Systems on one CUDA GPU, and their distance
from the same runs with the plain versions on the host.

Run from the root of a checkout: ``python3 track_spread.py`` measures that
checkout; ``python3 track_spread.py --root DIR`` measures the checkout at
DIR (for example a parent commit unpacked with ``git archive``), whose
``chip_smoke.py`` and port it imports.  ``--sensor stereo rgbd mono loop
async async-loop`` chooses the Systems (mono, loop and the async ones need
a checkout that has them) and ``--runs`` the card runs of each.  For each sensor it renders
chip_smoke.py's sequence (the 30-frame stereo corridor, the 25-frame RGB-D
one, the 40-frame mono one, the 150-frame circle of the loop scenario: the
mono System with loop closing and the Atlas; ``async``: the stereo
corridor through the default stereo System, whose local mapping runs on
the backend's worker thread, so that its runs differ by how far the worker
got before each frame: their spread is a reading, not zero and not a
bound; ``async-loop``: chip_smoke's phase 10 (b), the default mono System
fed the circle at 20 fps, each run's summary printed too: frames tracked,
loops closed, global BAs completed, ATE), runs the System over it
``--runs`` times on the card, each from a fresh System, and once on the
host, and prints:

- per card run, the largest per-frame translation difference from the host
  run (max |t_card - t_host| over the axes, in the run's units) and its
  frame, the largest rotation-entry difference, the largest share of this
  checkout's bounds (``chip_smoke.TRACK_DT`` and ``TRACK_DR``, the loop
  path's ``LOOP_DT`` and ``LOOP_DR``, which ``chip_smoke.compare_tracks``
  holds every frame to) that any frame takes,
  and the frames whose state differs from the host run's;
- the largest translation and rotation-entry differences between any two
  card runs.

The last line is one JSON object with these readings.  It exits nonzero
without a CUDA device or if a run fails its gates.
"""
from __future__ import annotations

import argparse
import importlib
import itertools
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent


def frame_diffs(track_a, track_b) -> tuple[np.ndarray, np.ndarray]:
    """Per frame, max |dt| and max |dR| over the entries."""
    pairs = list(zip(track_a, track_b))
    return (np.array([float(np.abs(ta - tb).max()) for (_, _, ta), (_, _, tb) in pairs]),
            np.array([float(np.abs(Ra - Rb).max()) for (_, Ra, _), (_, Rb, _) in pairs]))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", type=Path, default=HERE)
    parser.add_argument("--sensor", nargs="+", choices=("stereo", "rgbd", "mono", "loop", "async", "async-loop"),
                        default=["stereo", "rgbd"])
    parser.add_argument("--runs", type=int, default=5)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("track_spread: torch.cuda.is_available() is False; this script needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)

    sys.path.insert(0, str(HERE))
    here = importlib.import_module("chip_smoke")
    bounds = {"loop": (here.LOOP_DT, here.LOOP_DR)}  # this checkout's bounds; the rest TRACK_DT / TRACK_DR
    root = args.root.resolve()
    if root != HERE:  # the measured checkout's chip_smoke and port, its configs by relative path
        del sys.modules["chip_smoke"]
        sys.path.insert(0, str(root))
    os.chdir(root)
    cs = importlib.import_module("chip_smoke")
    from orb_slam3_fast_tpu_torch import _kernels

    _kernels.build()
    card, cpu = torch.device("cuda", 0), torch.device("cpu")
    report = {"root": str(root), "gpu": smi, "runs": args.runs, "sensors": {}}
    for sensor in args.sensor:
        if sensor == "mono":
            frames, poses = cs.mono_frames(cs.MONO_FRAMES)
            run = lambda dev: cs.run_mono(frames, poses, dev)[2]  # noqa: E731
        elif sensor == "loop":
            frames, poses = cs.loop_frames()
            run = lambda dev: cs.run_loop(frames, poses, dev)[2]  # noqa: E731
        elif sensor == "async":
            frames, poses = cs.corridor_frames(cs.SYS_FRAMES)
            run = lambda dev: cs.run_default_stereo(frames, poses, dev)[2]  # noqa: E731
        elif sensor == "async-loop":
            frames, poses = cs.loop_frames()

            def run(dev):
                _, summary, track = cs.run_default_loop(frames, poses, dev)
                summary.pop("kf_frames")
                print(f"async-loop run on {dev.type}: {summary}", flush=True)
                return track
        else:
            frames, poses = cs.corridor_frames(cs.SYS_FRAMES) if sensor == "stereo" else cs.rgbd_frames(cs.RGBD_FRAMES)
            run = lambda dev: cs.run_system(frames, poses, dev, sensor)[2]  # noqa: E731
        bound_dt, bound_dr = bounds.get(sensor, (here.TRACK_DT, here.TRACK_DR))
        host = run(cpu)
        cards = [run(card) for _ in range(args.runs)]
        per_run = []
        for k, tr in enumerate(cards):
            d, r = frame_diffs(tr, host)
            i = int(np.argmax(d))
            share = float(max((d / bound_dt).max(), (r / bound_dr).max()))
            states = [j for j, (a, b) in enumerate(zip(tr, host)) if a[0] != b[0]]
            per_run.append(dict(max_dt=float(d[i]), frame=i, max_dr=float(r.max()), bound_share=share,
                                state_differs=states))
            print(f"{sensor} card run {k}: from the host run max |dt| {d[i]:.6g} at frame {i}, max |dR| "
                  f"{r.max():.6g}, {share:.3f} of the bounds at worst; frames in another state: {states or 'none'}",
                  flush=True)
        diffs = [frame_diffs(a, b) for a, b in itertools.combinations(cards, 2)]
        pair_dt = max((float(d.max()) for d, _ in diffs), default=0.0)
        pair_dr = max((float(r.max()) for _, r in diffs), default=0.0)
        print(f"{sensor}: between two card runs max |dt| {pair_dt:.6g}, max |dR| {pair_dr:.6g}", flush=True)
        report["sensors"][sensor] = dict(frames=len(frames), card_vs_host=per_run, card_vs_card_dt=pair_dt,
                                         card_vs_card_dr=pair_dr)
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
