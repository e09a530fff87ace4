#!/usr/bin/env python3
"""Device profile of the stereo, RGB-D or monocular System on one CUDA GPU.

Run from the root of a checkout: ``python3 profile_system.py`` (the stereo
System), ``python3 profile_system.py --sensor rgbd``, ``--sensor mono``,
``--sensor reloc`` or ``--sensor loop``.  It builds the kernels, renders
chip_smoke.py's sequence for the sensor on the host (the 30-frame stereo
corridor, the 25-frame RGB-D one, the 40-frame mono one, tests/test_reloc.py's
scenario on the mono System: 30 frames, 3 blank ones, frame 20 again, or
the loop scenario: the 150-frame circle through the mono System with loop
closing and the Atlas) and runs the System
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
  port's hand-written kernels (``csrc/``) by name.

The last line is one JSON object with these numbers.  It exits nonzero
without a CUDA device, if the System loses track, or if the trace holds no
device operation.
"""
from __future__ import annotations

import argparse
import collections
import json
import subprocess
import sys
import time

import numpy as np
import torch

import chip_smoke as cs

TOP = 15  # operations listed by device time


def run_frames(frames, device, sensor: str, prof=None) -> float:
    """Milliseconds of wall time for the System over ``frames``; traced by
    ``prof`` when given."""
    from orb_slam3_fast_tpu_torch.slam.system import System

    opts = dict(enable_loop_closing=False, multi_map=False, async_backend=False, device=device)
    if sensor == "stereo":
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
    for i, f in enumerate(frames):
        feed(*f, i * 0.05)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    if prof is not None:
        prof.stop()
    if slam.get_tracking_state() != "OK":
        raise RuntimeError(f"the System ended in state {slam.get_tracking_state()}")
    if sensor == "loop" and slam.loopcloser.n_loops_closed < 1:
        raise RuntimeError("the loop scenario closed no loop")
    return wall_ms


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
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--sensor", choices=("stereo", "rgbd", "mono", "reloc", "loop"), default="stereo")
    sensor = parser.parse_args().sensor
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
        frames, _ = cs.corridor_frames(cs.SYS_FRAMES) if sensor == "stereo" else cs.rgbd_frames(cs.RGBD_FRAMES)
    run_frames(frames, device, sensor)  # warm-up: kernel loading, allocator, library handles
    untraced_ms = run_frames(frames, device, sensor)
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    traced_ms = run_frames(frames, device, sensor, prof)

    ops = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not ops:
        raise RuntimeError("the trace holds no device operation: time with CUDA events instead")
    busy_ms = busy_us((e.time_range.start, e.time_range.end) for e in ops) / 1e3
    by_name = collections.defaultdict(lambda: [0, 0.0])
    for e in ops:
        by_name[e.name][0] += 1
        by_name[e.name][1] += (e.time_range.end - e.time_range.start) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:TOP]
    # the kernels of csrc/ live in anonymous namespaces; PyTorch's do not
    ours = sorted(((name.split("::")[1].split("(")[0], c, ms) for name, (c, ms) in by_name.items()
                   if name.startswith("(anonymous namespace)::")), key=lambda x: -x[2])
    n = len(frames)
    print(f"{sensor} System, {n} frames: traced {traced_ms:.3f} ms, untraced {untraced_ms:.3f} ms "
          f"(tracer cost x{traced_ms / untraced_ms:.3f})")
    print(f"device busy {busy_ms:.3f} ms of {traced_ms:.3f} ms traced wall: idle share {1 - busy_ms / traced_ms:.4f}; "
          f"{len(ops)} device operations, {len(ops) / n:.1f} per frame")
    for name, (count, ms) in top:
        print(f"  {ms:10.3f} ms {count:7d}x  {name[:100]}")
    print("hand-written kernels: " + ", ".join(f"{name} {ms:.3f} ms / {count}" for name, count, ms in ours))
    print(json.dumps({
        "sensor": sensor, "frames": n, "traced_wall_ms": traced_ms, "untraced_wall_ms": untraced_ms, "device_busy_ms": busy_ms,
        "device_idle_share": 1 - busy_ms / traced_ms, "device_ops": len(ops), "device_ops_per_frame": len(ops) / n,
        "top": [{"name": name, "count": count, "ms": ms} for name, (count, ms) in top],
        "kernels": [{"name": name, "count": count, "ms": ms} for name, count, ms in ours], "gpu": smi,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
