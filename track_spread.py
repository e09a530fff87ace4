#!/usr/bin/env python3
"""Run-to-run spread of the Systems on one CUDA GPU, and their distance
from the same runs with the plain versions on the host.

Run from the root of a checkout: ``python3 track_spread.py`` measures that
checkout; ``python3 track_spread.py --root DIR`` measures the checkout at
DIR (for example a parent commit unpacked with ``git archive``), whose
``chip_smoke.py`` and port it imports.  ``--sensor stereo rgbd mono loop
async async-loop`` chooses the Systems (mono, loop and the async ones need
a checkout that has them; ``vi-mono`` and ``vi-stereo`` are chip_smoke's
phase 11 (a) and (b), the mono- and stereo-inertial Systems on their 45
frames; ``fisheye`` and ``vi-fisheye`` its phase 13 (a) and (b), the
TUM-VI rig's stereo System on 25 frames and its stereo-inertial System on
45) and ``--runs`` the card runs of each.  For each sensor it renders
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

``--save-host DIR`` also writes each sensor's host run to
``DIR/<sensor>-<tag>.npz`` (``--tag``, by default the host's name) and
holds it against every other host's file there: how far the plain path
alone lands on two host CPUs, which sets a path's bound where the card
cannot meet TRACK_DT / TRACK_DR (chip_smoke's LOOP_DT, VI_BOUNDS).  With
``--runs 0`` it needs no card, so a host without one adds its file:
``python3 track_spread.py --sensor vi-mono vi-stereo --runs 0 --save-host
DIR`` there, then the same with ``--runs 2`` on the card's machine, DIR
copied along; ``--threads N`` sets the host run's torch threads, so two
host runs of one CPU at two thread counts, saved under two ``--tag``s,
show how far the plain path moves with its summation order alone.
``--trace`` prints, for each card run of the async sensors, every
frame's state, the backend's queue length after it (the keyframes queued
or in the worker), the keyframe count, the frame's inliers and its
``track_total``; ``--no-host`` skips the host run (and the distances from
it), for readings of the async Systems alone.  ``--per-call`` (inertial sensors) also runs, at each call
of kernels W, X and Y in the first card run, the plain version on the
same inputs on the card and prints how far the two land apart, frame by
frame: where a card run departs from the host's, whether one call or the
accumulation of many does it.  ``--e-digest`` first prints the digest of
kernel E's outputs on chip_smoke.py's phase-3 problems
(``chip_smoke.e_digests`` of this checkout, run on the measured
checkout's port: with ``--root`` at a parent commit, the numbers that
``chip_smoke.E_DIGESTS`` holds E to); ``--ba-ms`` times a whole local
and global BA on the same problems (``chip_smoke.ba_times``), so that two
checkouts measured in one call compare; ``--sensor`` with no name then
runs no System.

The last line is one JSON object with these readings.  It exits nonzero
without a CUDA device or if a run fails its gates.
"""
from __future__ import annotations

import argparse
import contextlib
import importlib
import itertools
import json
import os
import platform
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
VI = {"vi-mono": "monocular", "vi-stereo": "stereo"}  # the inertial sensors: chip_smoke's sensor names


def frame_diffs(track_a, track_b) -> tuple[np.ndarray, np.ndarray]:
    """Per frame, max |dt| and max |dR| over the entries."""
    pairs = list(zip(track_a, track_b))
    return (np.array([float(np.abs(ta - tb).max()) for (_, _, ta), (_, _, tb) in pairs]),
            np.array([float(np.abs(Ra - Rb).max()) for (_, Ra, _), (_, Rb, _) in pairs]))


def spread(track_a, track_b, bound_dt: float, bound_dr: float) -> dict:
    """Two runs' per-frame distance: the largest |dt| and its frame, the
    largest |dR|, the largest share of the bounds, the first frame beyond
    them and the frames whose state differs."""
    d, r = frame_diffs(track_a, track_b)
    i = int(np.argmax(d))
    over = np.nonzero((d > bound_dt) | (r > bound_dr))[0]
    return dict(max_dt=float(d[i]), frame=i, max_dr=float(r.max()),
                bound_share=float(max((d / bound_dt).max(), (r / bound_dr).max())),
                first_beyond=int(over[0]) if len(over) else None,
                state_differs=[j for j, (a, b) in enumerate(zip(track_a, track_b)) if a[0] != b[0]])


def save_host(out: Path, sensor: str, tag: str, host, bounds) -> dict:
    """Write this host's run to ``out`` and hold it against every other
    host's run of the sensor there."""
    out.mkdir(parents=True, exist_ok=True)
    np.savez(out / f"{sensor}-{tag}.npz", states=np.array([s for s, _, _ in host]),
             R=np.stack([R for _, R, _ in host]), t=np.stack([t for _, _, t in host]))
    found = {}
    for f in sorted(out.glob(f"{sensor}-*.npz")):
        other = f.stem[len(sensor) + 1:]
        if other == tag:
            continue
        z = np.load(f)
        found[other] = spread(host, list(zip(z["states"].tolist(), z["R"], z["t"])), *bounds)
        print(f"{sensor} host {tag} ({platform.processor() or platform.machine()}) against host {other}: "
              f"{found[other]}", flush=True)
    return found


@contextlib.contextmanager
def frame_trace(rows: list):
    """While open, each frame fed to a System appends (frame, state, the
    backend's queue length, keyframes, inliers, track_total ms) to
    ``rows``."""
    from orb_slam3_fast_tpu_torch.slam.system import System

    saved = {name: getattr(System, name) for name in ("track_monocular", "track_stereo")}

    def traced(fn):
        def wrapped(self, *a, **k):
            n_inl = len(self.tracker.stats["inliers"])
            out = fn(self, *a, **k)
            inl = self.tracker.stats["inliers"]
            rows.append((int(round(a[-1] / 0.05)), out[0], self.backend.queue_len() if self.backend else 0,
                         self.world.n_kf, inl[-1] if len(inl) > n_inl else None,
                         round(self.timers.spans["track_total"][-1], 1)))
            return out
        return wrapped

    for name, fn in saved.items():
        setattr(System, name, traced(fn))
    try:
        yield rows
    finally:
        for name, fn in saved.items():
            setattr(System, name, fn)


@contextlib.contextmanager
def per_call(records: list):
    """While open, each call of kernels W, X and Y through the modules the
    inertial tracker calls also runs the plain version on the same inputs;
    ``records`` gains (frame, call, distances) per call."""
    from orb_slam3_fast_tpu_torch.optim import imu_init, inertial, vi_ba
    from orb_slam3_fast_tpu_torch.slam.system import System

    frame = [None]

    def feeding(fn):
        def wrapped(self, *a, **k):
            frame[0] = int(round(a[-1] / 0.05))  # the timestamp, last positional argument; 20 fps
            return fn(self, *a, **k)
        return wrapped

    def gap(a, b):
        return float((a - b).abs().max())

    def w_diff(o, q):
        return dict(dp=gap(o[0].p, q[0].p), dR=gap(o[0].R, q[0].R), dv=gap(o[0].v, q[0].v),
                    inliers=(int(o[2]), int(q[2])), classified_otherwise=int((o[1] != q[1]).sum()))

    compare = {
        (inertial, "pose_inertial_optimization"): ("W", w_diff),
        (inertial, "pose_inertial_optimization_last_frame"): ("W last-frame", w_diff),
        (imu_init, "inertial_only_optimization"): (
            "X", lambda o, q: dict(scale=(float(o.scale), float(q.scale)), dRwg=gap(o.Rwg, q.Rwg),
                                   dbias=gap(o.bias, q.bias))),
        (imu_init, "scale_gravity_refinement"): (
            "X refinement", lambda o, q: dict(scale=(float(o[1]), float(q[1])), dRwg=gap(o[0], q[0]))),
        (vi_ba, "vi_bundle_adjust"): (
            "Y", lambda o, q: dict(dp=gap(o[1], q[1]), dR=gap(o[0], q[0]), dxw=gap(o[4], q[4]),
                                   classified_otherwise=int((o[5] != q[5]).sum()))),
    }
    saved = {key: getattr(*key) for key in compare}
    saved_feed = {name: getattr(System, name) for name in ("track_monocular", "track_stereo")}

    def hooked(key, name, diff):
        kernel, plain = saved[key], getattr(key[0], key[1] + "_plain")

        def call(*a, **k):
            out = kernel(*a, **k)
            records.append(dict(frame=frame[0], call=name, **diff(out, plain(*a, **k))))
            return out
        if hasattr(kernel, "launches"):  # the wrappers that carry their kernel's counter keep it
            call.launches = kernel.launches
        return call

    for key, (name, diff) in compare.items():
        setattr(*key, hooked(key, name, diff))
    for name, fn in saved_feed.items():
        setattr(System, name, feeding(fn))
    try:
        yield records
    finally:
        for key, fn in saved.items():
            setattr(*key, fn)
        for name, fn in saved_feed.items():
            setattr(System, name, fn)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", type=Path, default=HERE)
    parser.add_argument("--sensor", nargs="*", choices=("stereo", "rgbd", "mono", "loop", "async", "async-loop",
                                                        *VI, "fisheye", "vi-fisheye"), default=["stereo", "rgbd"])
    parser.add_argument("--runs", type=int, default=5)
    parser.add_argument("--save-host", type=Path, default=None)
    parser.add_argument("--tag", default=platform.node() or "host")
    parser.add_argument("--per-call", action="store_true")
    parser.add_argument("--trace", action="store_true")
    parser.add_argument("--no-host", action="store_true")
    parser.add_argument("--threads", type=int, default=None, help="the host run's torch threads")
    parser.add_argument("--e-digest", action="store_true", help="print kernel E's output digests first")
    parser.add_argument("--ba-ms", action="store_true", help="time a whole local and global BA first")
    args = parser.parse_args()
    if args.threads:
        torch.set_num_threads(args.threads)
    if args.runs > 0 and not torch.cuda.is_available():
        raise SystemExit("track_spread: torch.cuda.is_available() is False; card runs need a CUDA card")
    smi = "no card (host runs only)"
    if args.runs > 0:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    save_dir = args.save_host.resolve() if args.save_host else None

    sys.path.insert(0, str(HERE))
    here = importlib.import_module("chip_smoke")
    bounds = {"loop": (here.LOOP_DT, here.LOOP_DR),  # this checkout's bounds; the rest TRACK_DT / TRACK_DR
              **{s: here.VI_BOUNDS[v] for s, v in VI.items()}}
    if hasattr(here, "FISHEYE_BOUNDS"):
        bounds.update({"fisheye": here.FISHEYE_BOUNDS, "vi-fisheye": here.VI_BOUNDS["stereo"]})
    root = args.root.resolve()
    if root != HERE:  # the measured checkout's chip_smoke and port, its configs by relative path
        del sys.modules["chip_smoke"]
        sys.path.insert(0, str(root))
    os.chdir(root)
    cs = importlib.import_module("chip_smoke")
    from orb_slam3_fast_tpu_torch import _kernels

    if args.runs > 0:
        _kernels.build()
    card, cpu = torch.device("cuda", 0), torch.device("cpu")
    report = {"root": str(root), "gpu": smi, "runs": args.runs, "sensors": {}}
    if args.e_digest:
        report["e_digests"] = here.e_digests(card)
        print(f"kernel E's output digests with the port at {root}: {report['e_digests']}", flush=True)
    if args.ba_ms:
        report["ba_ms"] = here.ba_times(card)
        print(f"whole BAs with the port at {root}, ms: {report['ba_ms']}", flush=True)
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
                try:
                    cs.check_default_loop(summary)
                    verdict = "holds"
                except RuntimeError:
                    verdict = "FAILS"
                print(f"async-loop run on {dev.type}: {summary}; phase 10 (b)'s gates: {verdict}", flush=True)
                return track
        elif sensor in VI:
            vi_in = cs.vi_frames(VI[sensor])
            frames = vi_in[0]

            def run(dev):
                _, summary, track = cs.run_vi(*vi_in, dev, VI[sensor])
                print(f"{sensor} run on {dev.type}: {summary}", flush=True)
                return track
        elif sensor == "fisheye":
            frames, poses, _ = cs.fisheye_frames(cs.FISHEYE_FRAMES)
            run = lambda dev: cs.run_fisheye(frames, poses, dev)[2]  # noqa: E731
        elif sensor == "vi-fisheye":
            frames, poses, imu = cs.fisheye_frames(cs.FISHEYE_VI_FRAMES, imu=True)

            def run(dev):
                _, summary, track = cs.run_fisheye(frames, poses, dev, imu=imu)
                print(f"{sensor} run on {dev.type}: {summary}", flush=True)
                return track
        else:
            frames, poses = cs.corridor_frames(cs.SYS_FRAMES) if sensor == "stereo" else cs.rgbd_frames(cs.RGBD_FRAMES)
            run = lambda dev: cs.run_system(frames, poses, dev, sensor)[2]  # noqa: E731
        bound_dt, bound_dr = bounds.get(sensor, (here.TRACK_DT, here.TRACK_DR))
        entry = dict(frames=len(frames), bounds=[bound_dt, bound_dr])
        host = None if args.no_host else run(cpu)
        if save_dir is not None and host is not None:
            entry["host_vs_hosts"] = save_host(save_dir, sensor, args.tag, host, (bound_dt, bound_dr))
        calls = []
        cards = []
        for k in range(args.runs):
            rows = []
            with per_call(calls) if (args.per_call and sensor in VI and k == 0) else contextlib.nullcontext(), \
                    frame_trace(rows) if args.trace else contextlib.nullcontext():
                cards.append(run(card))
            if rows:
                print(f"{sensor} card run {k} per frame (frame, state, queue, keyframes, inliers, ms): "
                      + " ".join(f"{i}:{st[0]}:{q}:{nk}:{n}:{ms}" for i, st, q, nk, n, ms in rows), flush=True)
        for c in calls:
            print(f"{sensor} card run 0, frame {c['frame']}, {c['call']} against its plain version on the same "
                  f"inputs: {({k: v for k, v in c.items() if k not in ('frame', 'call')})}", flush=True)
        per_run = []
        for k, tr in enumerate(cards if host is not None else ()):
            sp = spread(tr, host, bound_dt, bound_dr)
            per_run.append(sp)
            print(f"{sensor} card run {k}: from the host run max |dt| {sp['max_dt']:.6g} at frame {sp['frame']}, "
                  f"max |dR| {sp['max_dr']:.6g}, {sp['bound_share']:.3f} of the bounds at worst, first frame beyond "
                  f"them {sp['first_beyond']}; frames in another state: {sp['state_differs'] or 'none'}", flush=True)
        diffs = [frame_diffs(a, b) for a, b in itertools.combinations(cards, 2)]
        pair_dt = max((float(d.max()) for d, _ in diffs), default=0.0)
        pair_dr = max((float(r.max()) for _, r in diffs), default=0.0)
        print(f"{sensor}: between two card runs max |dt| {pair_dt:.6g}, max |dR| {pair_dr:.6g}", flush=True)
        report["sensors"][sensor] = dict(entry, card_vs_host=per_run, card_vs_card_dt=pair_dt,
                                         card_vs_card_dr=pair_dr, per_call=calls)
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
