#!/usr/bin/env python3
"""Device profile of the stereo, RGB-D or monocular System on one CUDA GPU.

Run from the root of a checkout: ``python3 profile_system.py`` (the stereo
System), ``python3 profile_system.py --sensor rgbd``, ``--sensor mono``,
``--sensor reloc``, ``--sensor loop`` or ``--sensor async``.  It builds the
kernels, renders chip_smoke.py's sequence for the sensor on the host (the
30-frame stereo corridor, the 25-frame RGB-D one, the 40-frame mono one,
tests/test_reloc.py's scenario on the mono System: 30 frames, 3 blank ones,
frame 20 again, the loop scenario: the 150-frame circle through the mono
System with loop closing and the Atlas, or ``async``: the stereo corridor
through the default stereo System, its local mapping on the backend's
worker thread and its own CUDA stream, the wall time running until the
backend has drained) and runs the System
over it three times on the card, each time from a fresh System: a warm-up,
an untraced run, and a run under ``torch.profiler`` (CPU and CUDA
activity).  From the traced run alone it reports:

- its wall time over the frames (host clock, the card synchronised at
  the end), beside the untraced run's: their ratio is the tracer's cost;
- the device's busy time, the union of the intervals of every device
  operation in the trace (kernels, copies, sets);
- the device's idle share, 1 - busy / wall, and the number of device
  operations, in all and per frame;
- the operations with the most device time, and every launch of the
  port's hand-written kernels (``csrc/``) by name;
- by frame kind (ordinary: neither the first frame nor one that made a
  keyframe; keyframe): ``track_total`` of the untraced run, and the CUDA
  launches (the kernel launches, copies and sets of ``LAUNCHES``)
  that the traced run made within each frame's ``track`` call.

``--root DIR`` measures the checkout at DIR (for example a parent commit
unpacked with ``git archive``), whose ``chip_smoke.py`` and port it
imports, so that two checkouts measured in one call compare.

The last line is one JSON object with these numbers.  It exits nonzero
without a CUDA device, if the System loses track, or if the trace holds no
device operation.
"""
from __future__ import annotations

import argparse
import bisect
import collections
import importlib
import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
TOP = 15  # operations listed by device time
OURS = re.compile(r"^(?:void )?\(anonymous namespace\)::(\w+(?:<[^>(]*>)?)")
# the CUDA API calls that put work on the device: kernel launches, copies and sets
LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx", "cudaMemcpyAsync",
            "cudaMemsetAsync", "cudaMemcpy", "cudaMemset")
cs = None  # the measured checkout's chip_smoke, imported in main


def run_frames(frames, device, sensor: str, prof=None) -> tuple[float, list, list]:
    """(milliseconds of wall time for the System over ``frames``, each
    frame's ``track_total``, whether each frame made a keyframe); traced by
    ``prof`` when given, each frame's call inside a ``frame <i>`` range."""
    from orb_slam3_fast_tpu_torch.slam.system import System

    opts = dict(enable_loop_closing=False, multi_map=False, async_backend=False, device=device)
    if sensor == "async":  # every default: the async backend, loop closing, the Atlas
        slam = System(cs.SYS_CONFIG, "stereo", device=device)
        feed = slam.track_stereo
    elif sensor == "stereo":
        slam = System(cs.SYS_CONFIG, "stereo", **opts)
        feed = slam.track_stereo
    elif sensor == "rgbd":
        slam = System(cs.rgbd_settings(), "rgbd", **opts)
        feed = slam.track_rgbd
    elif sensor == "loop":  # chip_smoke.run_loop's System
        from orb_slam3_fast_tpu_torch.backend.loopcloser import LoopCloserConfig

        slam = System(cs.MONO_CONFIG, "monocular", tracker_overrides=dict(min_init_matches=60, motion_radius=25.0),
                      max_keyframes=256, **dict(opts, enable_loop_closing=True, multi_map=True))
        slam.loopcloser.cfg = LoopCloserConfig(**cs.LOOP_CONFIG)
        feed = slam.track_monocular
    else:  # mono and the relocalisation scenario, which ends relocalised (OK)
        slam = System(cs.MONO_CONFIG, "monocular", tracker_overrides=dict(min_init_matches=60), **opts)
        feed = slam.track_monocular
    torch.cuda.synchronize()
    if prof is not None:
        prof.start()
    t0 = time.perf_counter()
    made_kf = []
    for i, f in enumerate(frames):
        n_kf = slam.world.n_kf
        with torch.profiler.record_function(f"frame {i}"):
            feed(*f, i * 0.05)
        made_kf.append(slam.world.n_kf != n_kf)
    if slam.backend is not None:
        if not slam.backend.wait_idle(timeout=120) or slam.backend.errors:
            raise RuntimeError(f"the backend did not drain, or failed: {slam.backend.errors[:1]}")
        slam.shutdown()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    if prof is not None:
        prof.stop()
    if slam.get_tracking_state() != "OK":
        raise RuntimeError(f"the System ended in state {slam.get_tracking_state()}")
    if sensor == "loop" and slam.loopcloser.n_loops_closed < 1:
        raise RuntimeError("the loop scenario closed no loop")
    return wall_ms, list(slam.timers.spans["track_total"]), made_kf


def per_frame_counts(events, n: int, keep) -> list[int]:
    """The events that ``keep`` selects whose start lies inside each
    ``frame <i>`` range of a trace (the trace's one clock)."""
    frames = sorted((e.time_range.start, e.time_range.end, int(e.name.split()[1])) for e in events
                    if e.name.startswith("frame ") and e.name.split()[1].isdigit())
    starts = [f[0] for f in frames]
    counts = [0] * n
    for e in events:
        if keep(e):
            k = bisect.bisect_right(starts, e.time_range.start) - 1
            if k >= 0 and e.time_range.start <= frames[k][1]:
                counts[frames[k][2]] += 1
    return counts


def busy_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    return total + (cur_e - cur_s if cur_e is not None else 0.0)


def main() -> int:
    global cs
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--sensor", choices=("stereo", "rgbd", "mono", "reloc", "loop", "async"), default="stereo")
    parser.add_argument("--root", type=Path, default=HERE)
    args = parser.parse_args()
    sensor, root = args.sensor, args.root.resolve()
    sys.path.insert(0, str(root))  # the measured checkout's chip_smoke and port, its configs by relative path
    os.chdir(root)
    cs = importlib.import_module("chip_smoke")
    if not torch.cuda.is_available():
        raise SystemExit("profile_system: torch.cuda.is_available() is False; this script needs a CUDA card")
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from orb_slam3_fast_tpu_torch import _kernels

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    device = torch.device("cuda", 0)
    _kernels.build()
    if sensor in ("mono", "reloc"):
        imgs = cs.mono_frames(cs.MONO_FRAMES)[0]
        frames = [(img,) for img in imgs]
        if sensor == "reloc":
            blank = np.full((480, 640), 25.0, np.float32)
            frames = frames[: cs.RELOC_FRAMES] + [(blank,)] * 3 + [(imgs[cs.RELOC_REVISIT],)]
    elif sensor == "loop":
        frames = [(img,) for img in cs.loop_frames()[0]]
    else:
        frames, _ = cs.rgbd_frames(cs.RGBD_FRAMES) if sensor == "rgbd" else cs.corridor_frames(cs.SYS_FRAMES)
    run_frames(frames, device, sensor)  # warm-up: kernel loading, allocator, library handles
    untraced_ms, frame_ms, made_kf = run_frames(frames, device, sensor)
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    traced_ms, _, traced_kf = run_frames(frames, device, sensor, prof)

    events = prof.events()
    ops = [e for e in events if e.device_type == DeviceType.CUDA]
    if not ops:
        raise RuntimeError("the trace holds no device operation: time with CUDA events instead")
    busy_ms = busy_us((e.time_range.start, e.time_range.end) for e in ops) / 1e3
    by_name = collections.defaultdict(lambda: [0, 0.0])
    for e in ops:
        by_name[e.name][0] += 1
        by_name[e.name][1] += (e.time_range.end - e.time_range.start) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:TOP]
    # the kernels of csrc/ live in top-level anonymous namespaces (a template's name starts with its return type);
    # PyTorch's do not
    ours = sorted(((m.group(1), c, ms) for name, (c, ms) in by_name.items()
                   if (m := OURS.match(name))), key=lambda x: -x[2])
    n = len(frames)
    print(f"{sensor} System, {n} frames: traced {traced_ms:.3f} ms, untraced {untraced_ms:.3f} ms "
          f"(tracer cost x{traced_ms / untraced_ms:.3f})")
    print(f"device busy {busy_ms:.3f} ms of {traced_ms:.3f} ms traced wall: idle share {1 - busy_ms / traced_ms:.4f}; "
          f"{len(ops)} device operations, {len(ops) / n:.1f} per frame")
    for name, (count, ms) in top:
        print(f"  {ms:10.3f} ms {count:7d}x  {name[:100]}")
    print("hand-written kernels: " + ", ".join(f"{name} {ms:.3f} ms / {count}" for name, count, ms in ours))
    per_frame = per_frame_counts(events, n, lambda e: e.name in LAUNCHES)
    ops_frame = per_frame_counts(events, n, lambda e: e.device_type == DeviceType.CUDA)
    ordinary = [i for i in range(1, n) if not made_kf[i] and not traced_kf[i]]
    kinds = {"ordinary": ordinary, "keyframe": [i for i in range(n) if made_kf[i]]}
    by_kind = {kind: dict(frames=ids, track_total_ms=[frame_ms[i] for i in ids],
                          mean_ms=float(np.mean([frame_ms[i] for i in ids])) if ids else None,
                          median_ms=float(np.median([frame_ms[i] for i in ids])) if ids else None,
                          launches=[per_frame[i] for i in ids],
                          mean_launches=float(np.mean([per_frame[i] for i in ids])) if ids else None,
                          mean_device_ops=float(np.mean([ops_frame[i] for i in ids])) if ids else None)
               for kind, ids in kinds.items()}
    for kind, r in by_kind.items():
        if r["frames"]:
            print(f"{kind} frames ({len(r['frames'])}): track_total mean {r['mean_ms']:.3f} ms, median "
                  f"{r['median_ms']:.3f} ms (untraced run); CUDA launches per frame mean {r['mean_launches']:.1f}, "
                  f"device operations starting within the frame mean {r['mean_device_ops']:.1f} (traced run); "
                  f"launches each {r['launches']}")
    print(json.dumps({
        "root": str(root), "by_kind": by_kind,
        "sensor": sensor, "frames": n, "traced_wall_ms": traced_ms, "untraced_wall_ms": untraced_ms, "device_busy_ms": busy_ms,
        "device_idle_share": 1 - busy_ms / traced_ms, "device_ops": len(ops), "device_ops_per_frame": len(ops) / n,
        "top": [{"name": name, "count": count, "ms": ms} for name, (count, ms) in top],
        "kernels": [{"name": name, "count": count, "ms": ms} for name, count, ms in ours], "gpu": smi,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
