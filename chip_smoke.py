#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``.  It imports only
the port (``orb_slam3_fast_tpu_torch``), never JAX, and runs five phases:

1. device: fails without CUDA; prints the card's name and power limit;
2. build: compiles the four kernels from ``orb_slam3_fast_tpu_torch/csrc``;
3. each kernel against its plain PyTorch version on the same CUDA tensors at
   the step's shapes (640x480 pyramid, 1024 keypoint slots, 1024 x 1024
   stereo, 4096 x 1024 window, 1024 edges), with CUDA-event times;
4. the stereo tracking step at 640x480 and 1280x720, 12 frames each, chained
   through the pose with constant-velocity prediction over a textured plane
   of known depth; every frame must match >= 30 landmarks, keep >= 30
   inliers and land within one pixel's worth of translation of the truth,
   and every kernel must have been launched; a per-stage split follows,
   and one frame is checked against the plain (CPU) step;
5. a JSON line of the kernels, then ``{"ok": true, "device": {...}}`` last.

Any failure raises, so the script exits nonzero without the last line.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

N_FRAMES = 12
WARMUP = 2
N_LM = 4096
SHIFT = 2  # px per frame, sideways pan
DISP_640 = 8  # px of disparity at 640 wide; the plane is at bf / disparity


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of ``fn()`` over ``reps`` runs, by CUDA events,
    after two warm-up runs."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# --- the scene ---------------------------------------------------------------


class Rig:
    """Pin-hole stereo rig for a W x H frame: fx = 0.7 W, baseline 0.1."""

    def __init__(self, w: int, h: int):
        self.w, self.h = w, h
        self.fx = self.fy = 0.7 * w
        self.cx, self.cy = w / 2.0, h / 2.0
        self.bf = 0.1 * self.fx
        self.disp = DISP_640 * w // 640
        self.z = self.bf / self.disp
        self.x0 = 8

    def t_true(self, k: int) -> np.ndarray:
        return np.array([-k * SHIFT * self.z / self.fx, 0.0, 0.0], np.float32)


def make_canvas(rng, rig: Rig) -> np.ndarray:
    """bench.py's texture recipe (noise plus bright rectangles) on a canvas
    wide enough for the whole pan."""
    h, w = rig.h, rig.w + rig.x0 + SHIFT * 16 + rig.disp + 8
    img = rng.uniform(0, 50, (h, w)).astype(np.float32)
    for _ in range(120 * (h * w) // (480 * 640)):
        cy, cx = rng.integers(20, h - 40), rng.integers(0, w - 24)
        img[cy : cy + rng.integers(8, 24), cx : cx + rng.integers(8, 24)] += rng.uniform(80, 170)
    return np.clip(img, 0, 255)


def frame(canvas: np.ndarray, rig: Rig, k: int, device):
    o = rig.x0 + k * SHIFT
    il = torch.as_tensor(canvas[:, o : o + rig.w].copy(), device=device)
    ir = torch.as_tensor(canvas[:, o + rig.disp : o + rig.disp + rig.w].copy(), device=device)
    return il, ir


def make_local_map(canvas, rig: Rig, cfg, device):
    """4096 landmark slots: plane points back-projected from the keypoints
    of reference frames, normal and distance band as WorldMap sets them
    (map/worldmap.py:171-174)."""
    from orb_slam3_fast_tpu_torch.frontend.tracker import LocalMap
    from orb_slam3_fast_tpu_torch.ops import extractor as ext

    pos, desc, normal, dmax = [], [], [], []
    for k in (0, 5, 10, 15):
        kp = ext.extract(frame(canvas, rig, k, device)[0], cfg)
        v = kp.valid
        xy = kp.xy[v]
        center = torch.tensor([k * SHIFT * rig.z / rig.fx, 0.0, 0.0], device=device)
        p = torch.stack(
            [(xy[:, 0] - rig.cx) * rig.z / rig.fx + center[0], (xy[:, 1] - rig.cy) * rig.z / rig.fy,
             torch.full_like(xy[:, 0], rig.z)], 1,
        )
        d = p - center
        dist = torch.linalg.vector_norm(d, dim=1)
        pos.append(p)
        desc.append(kp.desc[v])
        normal.append(d / dist[:, None])
        dmax.append(dist * cfg.scale_factor ** kp.level[v].float())
    pos, desc, normal, dmax = (torch.cat(x)[:N_LM] for x in (pos, desc, normal, dmax))
    n = pos.shape[0]
    pad = N_LM - n

    def padded(x):
        return torch.cat([x, torch.zeros((pad, *x.shape[1:]), dtype=x.dtype, device=device)]).contiguous()

    return LocalMap(
        pos=padded(pos), desc=padded(desc), normal=padded(normal),
        dmin=padded(dmax / cfg.scale_factor ** (cfg.n_levels - 1)), dmax=padded(dmax),
        mask=torch.arange(N_LM, device=device) < n,
    )


def setup(rig: Rig, device, seed: int = 0):
    """The scene, its local map and the step for ``rig``."""
    from orb_slam3_fast_tpu_torch.cameras.models import Camera
    from orb_slam3_fast_tpu_torch.frontend.tracker import StereoTrackingStep
    from orb_slam3_fast_tpu_torch.ops import extractor as ext

    cfg = ext.ExtractorConfig(n_features=1024)
    canvas = make_canvas(np.random.default_rng(seed), rig)
    lm = make_local_map(canvas, rig, cfg, device)
    step = StereoTrackingStep(Camera.pinhole(rig.fx, rig.fy, rig.cx, rig.cy), rig.bf, (rig.w, rig.h), cfg, device=device)
    return step, lm, canvas


def track(rig: Rig, step, lm, canvas, device, n_frames: int = N_FRAMES):
    """Track ``n_frames`` frames; returns per-frame (matches, inliers,
    translation error, rotation error, step ms or None)."""
    from orb_slam3_fast_tpu_torch.utils import lie

    T_prev = T = lie.SE3.identity(device)  # frame 0 starts at its true pose
    rows = []
    for k in range(n_frames):
        vel = T.compose(T_prev.inverse())
        T_pred = vel.compose(T)
        il, ir = frame(canvas, rig, k, device)
        timed = device.type == "cuda" and k >= WARMUP
        if timed:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
        res = step(il, ir, T_pred, lm)
        ms = None
        if timed:
            end.record()
            torch.cuda.synchronize()
            ms = start.elapsed_time(end)
        T_prev, T = T, res.T
        t = res.T.t.cpu().numpy()
        R = res.T.R.cpu().numpy()
        if not (np.isfinite(t).all() and np.isfinite(R).all()):
            raise RuntimeError(f"{rig.w}x{rig.h} frame {k}: non-finite pose")
        rows.append((int(res.n_matches), int(res.n_inliers), float(np.abs(t - rig.t_true(k)).max()),
                     float(np.abs(R - np.eye(3)).max()), ms))
    return rows


def check_sequence(rig: Rig, rows) -> None:
    """Every frame: >= 30 matches and inliers (min_map_inliers,
    frontend/tracker.py:48), translation error under one pixel's worth at
    the plane's depth (z / fx), rotation entries within 1e-3 of identity."""
    bound = rig.z / rig.fx
    for k, (m, n, et, er, _) in enumerate(rows):
        if m < 30 or n < 30 or et > bound or er > 1e-3:
            raise RuntimeError(
                f"{rig.w}x{rig.h} frame {k}: matches {m}, inliers {n}, |dt| {et:.3g} m "
                f"(bound {bound:.3g}), |dR| {er:.3g}"
            )


# --- phase 3: each kernel against its plain version ---------------------------


def compare_kernels(device) -> list[dict]:
    from orb_slam3_fast_tpu_torch.frontend.tracker import visible_landmarks
    from orb_slam3_fast_tpu_torch.ops import extractor as ext
    from orb_slam3_fast_tpu_torch.ops import fast
    from orb_slam3_fast_tpu_torch.ops import hamming as ham
    from orb_slam3_fast_tpu_torch.ops import image
    from orb_slam3_fast_tpu_torch.ops import matching as mat
    from orb_slam3_fast_tpu_torch.optim import pose_opt
    from orb_slam3_fast_tpu_torch.utils import lie

    rig = Rig(640, 480)
    cfg = ext.ExtractorConfig(n_features=1024)
    step, lm, canvas = setup(rig, device, seed=1)
    il, ir = frame(canvas, rig, 1, device)
    out = []

    # A: FAST + NMS on the 8 levels of one 640x480 image
    levels = image.build_pyramid(il, cfg.n_levels, cfg.scale_factor)
    err = 0.0
    for lv in levels:
        for k, p in zip(fast.fast_nms(lv, 20.0, 7.0, ext.EDGE_BORDER), fast.fast_nms_plain(lv, 20.0, 7.0, ext.EDGE_BORDER)):
            err = max(err, float((k - p).abs().max()))
        torch.cuda.synchronize()
    if err != 0.0:
        raise RuntimeError(f"fast_nms differs from its plain version by {err}")
    ms = cuda_ms(lambda: [fast.fast_nms(lv, 20.0, 7.0, ext.EDGE_BORDER) for lv in levels], 50)
    plain_ms = cuda_ms(lambda: [fast.fast_nms_plain(lv, 20.0, 7.0, ext.EDGE_BORDER) for lv in levels], 10)
    out.append(dict(name="fast_nms", route="cuda", source="orb_slam3_fast_tpu_torch/csrc/fast_nms.cu",
                    replaces="orb_slam3_fast_tpu/ops/fast.py:62", max_abs_err=err, ms=ms, plain_ms=plain_ms,
                    shapes="8 levels of 480x640, tolerance exact"))

    # B: angle + BRIEF for the 1024 slots of that image
    kp = ext.extract(il, cfg)
    blurs = [image.gaussian_blur(lv) for lv in levels]
    scales = torch.as_tensor(ext.slot_scales(cfg), device=device)
    xy = torch.round(kp.xy / scales[:, None]).long()  # level-local integer positions (sub < 0.5 px)
    lvl = kp.level
    a_k, d_k = ext.orb_describe(levels, blurs, xy, lvl)
    a_p, d_p = ext.orb_describe_plain(levels, blurs, xy, lvl)
    torch.cuda.synchronize()
    a_err = float((a_k - a_p).abs().max())
    bit_diff = float((ham.unpack_desc(d_k) != ham.unpack_desc(d_p)).float().mean())
    # the angle is a sum of 961 products in another order (~1e-5 rad); a
    # bit flips only where that moves a rotated sample across a rounding edge
    if a_err > 1e-3 or bit_diff > 1e-3:
        raise RuntimeError(f"orb_describe: angle err {a_err}, bit mismatch {bit_diff}")
    ms = cuda_ms(lambda: ext.orb_describe(levels, blurs, xy, lvl), 50)
    plain_ms = cuda_ms(lambda: ext.orb_describe_plain(levels, blurs, xy, lvl), 10)
    out.append(dict(name="orb_describe", route="cuda", source="orb_slam3_fast_tpu_torch/csrc/orb_describe.cu",
                    replaces="orb_slam3_fast_tpu/ops/extractor.py:297", max_abs_err=a_err, ms=ms, plain_ms=plain_ms,
                    shapes=f"1024 keypoints over 8 levels, angle tol 1e-3 rad, bit mismatch {bit_diff:.2e} <= 1e-3"))

    # C: stereo mode (1024 x 1024) and window mode (4096 x 1024)
    kp_r = ext.extract(ir, cfg)
    f32 = torch.float32
    sgate = ham.StereoGate(
        kp.xy[:, 0].contiguous(), kp.xy[:, 1].contiguous(), kp.level.to(f32), kp.valid.to(f32),
        kp_r.xy[:, 0].contiguous(), kp_r.xy[:, 1].contiguous(), (2.0 * step.slot_scales).contiguous(),
        kp_r.level.to(f32), kp_r.valid.to(f32), rig.bf / step.min_z,
    )
    uv, pred, vis = visible_landmarks(
        step.cam, torch.eye(3, device=device), torch.as_tensor(rig.t_true(1), device=device), lm.pos, lm.mask,
        lm.normal, lm.dmin, lm.dmax, (rig.w, rig.h),
    )
    wgate = ham.WindowGate(
        uv[:, 0].contiguous(), uv[:, 1].contiguous(), 3.0 * mat._pow_level(pred, step.scales), pred.to(f32),
        vis.to(f32), kp.xy[:, 0].contiguous(), kp.xy[:, 1].contiguous(), kp.level.to(f32), kp.valid.to(f32),
    )
    err = 0.0
    for da, db, gate in ((kp.desc, kp_r.desc, sgate), (lm.desc, kp.desc, wgate)):
        (bk, ck), (bp, cp) = ham.hamming_best2(da, db, gate), ham.hamming_best2_plain(da, db, gate)
        torch.cuda.synchronize()
        if not (torch.equal(bk.idx, bp.idx) and torch.equal(bk.idx2, bp.idx2)):
            raise RuntimeError("hamming_best2: indices differ from the plain version")
        if ck is not None and not torch.equal(ck, cp):
            raise RuntimeError("hamming_best2: column argmin differs from the plain version")
        err = max(err, float((bk.dist.double() - bp.dist.double()).abs().max()),
                  float((bk.dist2.double() - bp.dist2.double()).abs().nan_to_num(posinf=0.0).max()))
    if err != 0.0:
        raise RuntimeError(f"hamming_best2 distances differ by {err}")
    ms_s = cuda_ms(lambda: ham.hamming_best2(kp.desc, kp_r.desc, sgate), 50)
    ms_w = cuda_ms(lambda: ham.hamming_best2(lm.desc, kp.desc, wgate), 50)
    pms_s = cuda_ms(lambda: ham.hamming_best2_plain(kp.desc, kp_r.desc, sgate), 10)
    pms_w = cuda_ms(lambda: ham.hamming_best2_plain(lm.desc, kp.desc, wgate), 10)
    out.append(dict(name="hamming_best2", route="cuda", source="orb_slam3_fast_tpu_torch/csrc/hamming_best2.cu",
                    replaces="orb_slam3_fast_tpu/ops/hamming.py:28", max_abs_err=err, ms=ms_s + ms_w,
                    plain_ms=pms_s + pms_w,
                    shapes=f"stereo 1024x1024 {ms_s:.4f} ms (plain {pms_s:.4f}), window 4096x1024 "
                           f"{ms_w:.4f} ms (plain {pms_w:.4f}), tolerance exact"))

    # D: pose optimisation over the 1024 slots of frame 1
    kp_l, right_u = step.front(il, ir)
    T0 = lie.SE3(torch.eye(3, device=device), torch.as_tensor(rig.t_true(0), device=device))
    idx, accept = step.match_map(kp_l, T0, lm)
    obs = step.pose_obs(kp_l, right_u, idx, accept, lm)
    Tk, ik, nk = pose_opt.pose_optimization(step.cam, rig.bf, T0, obs)
    Tp, ip, np_ = pose_opt.pose_optimization_plain(step.cam, rig.bf, T0, obs)
    torch.cuda.synchronize()
    err = max(float((Tk.t - Tp.t).abs().max()), float((Tk.R - Tp.R).abs().max()))
    # sums in another order can flip a borderline LM accept: pose within
    # 1e-3 (m, and rotation entries), inlier counts within 2
    if err > 1e-3 or abs(int(nk) - int(np_)) > 2:
        raise RuntimeError(f"pose_lm: pose err {err}, inliers {int(nk)} vs {int(np_)}")
    ms = cuda_ms(lambda: pose_opt.pose_optimization(step.cam, rig.bf, T0, obs), 50)
    plain_ms = cuda_ms(lambda: pose_opt.pose_optimization_plain(step.cam, rig.bf, T0, obs), 5)
    out.append(dict(name="pose_lm", route="cuda", source="orb_slam3_fast_tpu_torch/csrc/pose_lm.cu",
                    replaces="orb_slam3_fast_tpu/optim/pose_opt.py:117", max_abs_err=err, ms=ms, plain_ms=plain_ms,
                    shapes=f"{int(obs.valid.sum())} active of 1024 edges, 4x10 LM, tolerance 1e-3"))
    return out


def stage_split(rig: Rig, device) -> dict:
    """Per-stage CUDA-event times of the step on one frame."""
    from orb_slam3_fast_tpu_torch.ops import extractor as ext
    from orb_slam3_fast_tpu_torch.optim import pose_opt
    from orb_slam3_fast_tpu_torch.utils import lie

    step, lm, canvas = setup(rig, device, seed=2)
    il, ir = frame(canvas, rig, 0, device)
    T0 = lie.SE3.identity(device)
    kp, right_u = step.front(il, ir)
    idx, accept = step.match_map(kp, T0, lm)
    obs = step.pose_obs(kp, right_u, idx, accept, lm)
    t_ext = cuda_ms(lambda: (ext.extract(il, step.cfg), ext.extract(ir, step.cfg)), 10)
    t_front = cuda_ms(lambda: step.front(il, ir), 10)
    t_map = cuda_ms(lambda: step.match_map(kp, T0, lm), 20)
    t_obs = cuda_ms(lambda: step.pose_obs(kp, right_u, idx, accept, lm), 20)
    t_pose = cuda_ms(lambda: pose_opt.pose_optimization(step.cam, step.bf, T0, obs), 20)
    return {"extract_x2_ms": t_ext, "stereo_match_refine_ms": t_front - t_ext,
            "visibility_projection_match_ms": t_map, "pose_obs_ms": t_obs, "pose_opt_ms": t_pose}


def main() -> int:
    # 1. device
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; this script needs a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    log(smi)
    device = torch.device("cuda", 0)
    log(f"device: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, python {sys.version.split()[0]}")

    # 2. build
    from orb_slam3_fast_tpu_torch import _kernels

    t0 = time.perf_counter()
    _, nvcc_out = _kernels.build()  # a fresh checkout has no library yet: this compiles
    _kernels.lib()
    log(f"build: {time.perf_counter() - t0:.1f} s (nvcc {' '.join(_kernels.NVCC_FLAGS)})")
    for line in nvcc_out.splitlines():
        if "registers" in line or ("spill" in line and "0 bytes spill" not in line):
            log(f"  ptxas {line.strip()}")

    from orb_slam3_fast_tpu_torch.ops import extractor as ext
    from orb_slam3_fast_tpu_torch.ops import fast
    from orb_slam3_fast_tpu_torch.ops import hamming as ham
    from orb_slam3_fast_tpu_torch.optim import pose_opt

    wrappers = {"fast_nms": fast.fast_nms, "orb_describe": ext.orb_describe,
                "hamming_best2": ham.hamming_best2, "pose_lm": pose_opt.pose_optimization}

    # 3. each kernel against its plain version
    kernels = compare_kernels(device)
    for k in kernels:
        log(f"kernel {k['name']}: max_abs_err {k['max_abs_err']:.3g}, {k['ms']:.4f} ms vs plain "
            f"{k['plain_ms']:.4f} ms ({k['shapes']})")

    # 4. the step at both sizes: the main path, with the launch counts
    rigs = [Rig(640, 480), Rig(1280, 720)]
    scenes = [setup(rig, device) for rig in rigs]
    for w in wrappers.values():
        w.launches = 0
    results = {(rig.w, rig.h): track(rig, *scene, device) for rig, scene in zip(rigs, scenes)}
    launches = {name: w.launches for name, w in wrappers.items()}
    for rig in rigs:
        check_sequence(rig, results[(rig.w, rig.h)])
    if min(launches.values()) < 1:
        raise RuntimeError(f"a kernel of the main path was never launched: {launches}")
    for (w, h), rows in results.items():
        ms = [r[4] for r in rows if r[4] is not None]
        log(f"step {w}x{h}: {len(rows)} frames, matches {min(r[0] for r in rows)}-{max(r[0] for r in rows)}, "
            f"inliers {min(r[1] for r in rows)}-{max(r[1] for r in rows)}, max |dt| "
            f"{max(r[2] for r in rows):.3g} m (bound {Rig(w, h).z / Rig(w, h).fx:.3g}), "
            f"step {np.mean(ms):.3f} ms mean / {np.median(ms):.3f} median over {len(ms)} frames "
            f"({1e3 / np.mean(ms):.1f} fps); per frame ms {[round(x, 3) for x in ms]}")
    log(f"launches in the main-path run: {launches}")

    for (w, h) in results:
        split = stage_split(Rig(w, h), device)
        log(f"stages {w}x{h}: " + ", ".join(f"{k} {v:.3f}" for k, v in split.items()))

    # the plain (CPU) step, which the tests hold against the JAX package,
    # agrees with the card on frame 1 at 640x480.  Last, because the host
    # threads it starts would slow the timed phases above.
    rig, cpu = Rig(640, 480), torch.device("cpu")
    rows_cpu = track(rig, *setup(rig, cpu), cpu, n_frames=2)
    m_g, n_g = results[(640, 480)][1][:2]
    m_c, n_c, et_c = rows_cpu[1][0], rows_cpu[1][1], rows_cpu[1][2]
    if abs(m_g - m_c) > 0.05 * m_c or abs(n_g - n_c) > 0.05 * n_c or et_c > rig.z / rig.fx:
        raise RuntimeError(f"card vs plain step: matches {m_g}/{m_c}, inliers {n_g}/{n_c}, cpu |dt| {et_c}")
    log(f"plain step on the host, frame 1 at 640x480: matches {m_c} (card {m_g}), inliers {n_c} (card {n_g})")

    # 5. results
    for k in kernels:
        k["launches"] = launches[k["name"]]
    log(json.dumps({"kernels": [{key: k[key] for key in ("name", "route", "source", "replaces", "launches",
                                                         "max_abs_err", "ms", "plain_ms")} for k in kernels]}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
