#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``.  It imports only
the port (``orb_slam3_fast_tpu_torch``), never JAX, and runs nine phases:

1. device: fails without CUDA; prints the card's name and power limit;
2. build: compiles the eighteen kernels (A-T, no K or O) from the 18
   sources of ``orb_slam3_fast_tpu_torch/csrc``, one nvcc per source in
   parallel, and the map's host C++ library, so that no timed frame pays
   for g++;
3. each kernel against its plain PyTorch version on the same CUDA tensors,
   with CUDA-event times, the least time the card could take for the same
   work (bytes or operations at the H100's published peaks) and, where one
   PyTorch call computes the same function, that call's time: A-D at the
   step's shapes (640x480 pyramid, 1024 keypoint slots, 1024 x 1024
   stereo, 4096 x 1024 window, 1024 edges); E and F on a local-BA problem
   at the mapper's caps (32 pose slots, 4096 landmarks, 16384
   observations), a whole BA through them, and F's failure flag on an
   indefinite system; G on 1024 matches; C's epipolar and mutual modes at
   768 x 768; H at 640x480 and 1280x720; I on kernel A's maps of those
   pyramids and on a tie-heavy map; J on 1024 stereo matches; L on 4096
   landmarks; the whole extraction on the card against the plain one; M on
   the 768 two-view matches of the mono corridor's frames 0 and 5 and on a
   planar pair (its F and H branches); N on a corridor frame's 768
   descriptors with the 10^4- and the 10^6-word vocabulary; P on 768 slots
   with 256 subsets and 20% outliers; Q (128 hypotheses) and R on the 768
   pair slots of a keyframe pair, with and without the scale; S on a
   70-keyframe essential graph; T and E at the circle's global-BA size (128
   pose slots, 4096 landmarks, ~30k observations), and a whole
   bundle_adjust_cg through E and T;
4. the stereo tracking step at 640x480 and 1280x720, 12 frames each, chained
   through the pose with constant-velocity prediction over a textured plane
   of known depth; every frame must match >= 30 landmarks, keep >= 30
   inliers and land within one pixel's worth of translation of the truth,
   and A-D and H-L must have been launched; a per-stage split follows;
5. the stereo ``System`` (configs/synthetic_stereo.yaml) with local mapping
   on 30 frames of the synthetic corridor: the gates of
   tests/test_slam_e2e.py's stereo test, >= 3 keyframes, a local BA and
   triangulated landmarks, every kernel A-L (C in its epipolar mode too)
   and N (keyframe indexing) launched on that path, M and P not; per-frame
   and per-BA times;
6. the RGB-D ``System`` (the same configuration loaded for RGB-D, virtual
   baseline bf = 32) on the 25 frames of tests/test_slam_e2e.py's RGB-D
   test, depth from the splats: its gates (final state OK, > 20 frames
   tracked, unscaled ATE < 0.40 m), at least the 3 keyframes and 2 local
   BAs the JAX tracker makes on the same frames, H, I, L and N launched and
   J, M and P not;
7. the monocular ``System`` (configs/synthetic_mono.yaml) on the 40 frames
   of tests/test_slam_e2e.py's mono test: its gates (final state OK, > 30
   tracked, >= 3 keyframes, > 200 landmarks, scale-aligned ATE < 0.15 m),
   M, N (at least once per keyframe) and C's window mode launched; then
   tests/test_reloc.py's scenario (30 frames, 3 blank ones ->
   RECENTLY_LOST, frame 20 again -> OK near its pose) with P and N
   launched;
9. (run before phase 8, whose host threads would slow it) the monocular
   System with loop closing and the Atlas (``System(..., "monocular",
   enable_loop_closing=True, multi_map=True)``) on tests/test_loop_closing.py's
   150-frame circle, rendered by a pool of worker processes: that test's
   gates (final OK, > 120 tracked, >= 1 loop, scale-aligned ATE < 0.20 m),
   Q, R, S, T, E, N and the mono path's kernels launched, T and not F inside
   the global BA; then tests/test_atlas.py's scenario (the same circle,
   frames 55-67 black, max_recently_lost 6): >= 2 maps, >= 1 merge, final
   OK, > 100 frames OK, the ATE of ``trajectory_world()`` < 0.5;
8. one frame of the plain (CPU) step, and the stereo, RGB-D and mono
   Systems, the relocalisation run and the loop scenario (all 150 frames)
   with the plain versions on the host, against the card; a JSON line of
   the kernels, then ``{"ok": true, "device": {...}}`` last.  The loop
   path is held to its own bound (``LOOP_DT`` / ``LOOP_DR``: two host CPUs
   running the plain path alone land 6.1e-3 apart over its 150 frames) and
   to closing its loop at the same frame as the host run.

Launch counts are zeroed just before each path of phases 4-7 and 9 and
read just after.  No path's host comparison is cut in depth.  Any failure
raises, so the script exits nonzero without the last line.
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
SYS_FRAMES = 30  # the System phase: test_slam_e2e.py's stereo sequence
SYS_CONFIG = "configs/synthetic_stereo.yaml"
N_LM = 4096
N_DLT = 1024  # kernel G's check: matches of two keyframes
RGBD_FRAMES = 25  # the RGB-D phase: test_slam_e2e.py's RGB-D sequence
RGBD_BF = 0.08 * 400.0  # its virtual baseline x fx
RGBD_MIN_KF, RGBD_MIN_BA = 3, 2  # what the JAX tracker + mapper make on those frames on the CPU
# (python -m tests.rgbd_reference_counts: keyframes at frames 0, 10, 15; 2 local BAs)
MONO_CONFIG = "configs/synthetic_mono.yaml"
MONO_FRAMES = 40  # the mono phase: test_slam_e2e.py's mono sequence
RELOC_FRAMES, RELOC_REVISIT = 30, 20  # test_reloc.py: 30 frames, 3 blank ones, frame 20 again
LOOP_FRAMES = 150  # tests/test_loop_closing.py's circle
ATLAS_BLACKOUT = range(55, 68)  # tests/test_atlas.py's sensor dropout
TRACK_DT, TRACK_DR = 2e-3, 1e-3  # a System's card run against its host run: t, rotation entries
# The loop path's own bound (150 frames of mono SLAM, map units of ~7.8 m): the plain path alone,
# run on two host CPUs, lands 6.1e-3 / 2.66e-3 apart at frames 44-137 (its float32 LU solves round
# differently per CPU and the drifting middle of the circle amplifies it; float64 solves repeat
# across CPUs), and the card 6.07e-3 / 2.76e-3 from the host run (PERF.md, the loop path's spread)
LOOP_DT, LOOP_DR = 1e-2, 5e-3
# The H100 SXM's published peaks (NVIDIA's data sheet): HBM3 bytes/s, and
# float32 outside the tensor cores, taken here for all scalar work.
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12
# The bounds of the kernels that solve small systems (G, M, P) count what a
# direct method needs, whatever algorithm the kernel runs: r n (n + 1) flops
# to form the n x n normal matrix of r rows, n^3 for its null vector by
# elimination, 200 for a 3x3 SVD (the closed-form symmetric eigenproblem).
SVD3_FLOPS = 200


def normal_flops(rows: int, n: int) -> int:
    return rows * n * (n + 1)


def null_flops(n: int) -> int:
    return n**3
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


def bound(nbytes: float, ops: float) -> dict:
    """The least time the card could take: the larger of the bytes the work
    must move (each input read once, each output written once) over the
    memory rate and its operations over the peak rate."""
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S * 1e3, ops / PEAK_OPS_PER_S * 1e3
    return dict(bound_ms=max(t_bytes, t_ops), bound_by="bytes" if t_bytes >= t_ops else "operations")


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


# --- the System's scene: numpy copies of tests/synthetic.py's helpers ----------
# (tests/synthetic.py imports jax, which the card's machine does not have)


def _frames_from_normals(normals):
    """Per-splat orthonormal in-plane tangent frames (e1, e2) from normals."""
    n = normals / np.maximum(np.linalg.norm(normals, axis=-1, keepdims=True), 1e-9)
    helper = np.where(np.abs(n[:, 2:3]) < 0.9, np.array([[0.0, 0.0, 1.0]]), np.array([[1.0, 0.0, 0.0]]))
    e1 = np.cross(n, helper)
    e1 /= np.maximum(np.linalg.norm(e1, axis=-1, keepdims=True), 1e-9)
    return e1.astype(np.float32), np.cross(n, e1).astype(np.float32)


def make_corridor_world(rng, n=800, half_w=4.0, half_h=3.0, length=40.0, tile=6):
    """Textured square splats on the four walls of a box corridor along +z
    (synthetic.make_corridor_world, the same draws from ``rng``)."""
    n4 = n // 4
    zs = rng.uniform(1.0, length, n)
    walls = [
        np.stack([np.full(n4, -half_w), rng.uniform(-half_h, half_h, n4), zs[:n4]], -1),
        np.stack([np.full(n4, half_w), rng.uniform(-half_h, half_h, n4), zs[n4: 2 * n4]], -1),
        np.stack([rng.uniform(-half_w, half_w, n4), np.full(n4, -half_h), zs[2 * n4: 3 * n4]], -1),
        np.stack([rng.uniform(-half_w, half_w, n - 3 * n4), np.full(n - 3 * n4, half_h), zs[3 * n4:]], -1),
    ]
    tilt = rng.uniform(0.7, 3.0, (n, 1))
    base = np.concatenate([np.tile([1.0, 0.0, 0.0], (n4, 1)), np.tile([-1.0, 0.0, 0.0], (n4, 1)),
                           np.tile([0.0, 1.0, 0.0], (n4, 1)), np.tile([0.0, -1.0, 0.0], (n - 3 * n4, 1))])
    e1, e2 = _frames_from_normals(base + tilt * np.array([[0.0, 0.0, -1.0]]))
    return {
        "centers": np.concatenate(walls).astype(np.float32),
        "sizes": rng.uniform(0.15, 0.4, n).astype(np.float32),
        "tex": rng.uniform(40.0, 230.0, (n, tile, tile)).astype(np.float32),
        "e1": e1,
        "e2": e2,
    }


def render(world, cam, R, t, wh=(640, 480), bg=30.0) -> np.ndarray:
    """Perspective render of the world-anchored textured quads seen from
    T_cw = (R, t) (synthetic.render): per pixel, the ray-plane hit of the
    nearest quad, its texture sampled bilinearly."""
    from orb_slam3_fast_tpu_torch.cameras import models as cm

    w, h = wh
    img = np.full((h, w), bg, dtype=np.float32)
    zbuf = np.full((h, w), np.inf, dtype=np.float32)
    R, t = np.asarray(R, np.float64), np.asarray(t, np.float64)
    centers = world["centers"].astype(np.float64)
    Xc = centers @ R.T + t
    tile = world["tex"].shape[1]
    e1, e2 = world["e1"].astype(np.float64), world["e2"].astype(np.float64)
    sizes = world["sizes"].astype(np.float64)
    uu, vv = np.meshgrid(np.arange(w, dtype=np.float64), np.arange(h, dtype=np.float64))
    grid = torch.as_tensor(np.stack([uu, vv], -1).reshape(-1, 2), dtype=torch.float32)
    all_dirs = cm.unproject(cam, grid).numpy().reshape(h, w, 3).astype(np.float64)
    half = 0.5 * sizes
    quad = np.array([[-1, -1], [1, -1], [1, 1], [-1, 1]], np.float64)
    corners_w = centers[:, None, :] + np.einsum("qa,iad->iqd", quad, np.stack([e1 * half[:, None], e2 * half[:, None]], 1))
    cc = corners_w @ R.T + t  # (n,4,3)
    uvq = cm.project(cam, torch.as_tensor(cc, dtype=torch.float32)).numpy()
    for i in range(len(centers)):
        if Xc[i, 2] < 0.5 or np.any(cc[i, :, 2] < 0.2):
            continue
        u0 = max(int(np.floor(uvq[i, :, 0].min())), 0)
        u1 = min(int(np.ceil(uvq[i, :, 0].max())) + 1, w)
        v0 = max(int(np.floor(uvq[i, :, 1].min())), 0)
        v1 = min(int(np.ceil(uvq[i, :, 1].max())) + 1, h)
        if u1 <= u0 or v1 <= v0 or (u1 - u0) * (v1 - v0) > 200_000:
            continue
        dirs = all_dirs[v0:v1, u0:u1]
        pc, a1, a2 = Xc[i], R @ e1[i], R @ e2[i]
        nc = np.cross(a1, a2)
        denom = dirs @ nc
        ok = np.abs(denom) > 1e-9
        lam = (pc @ nc) / np.where(ok, denom, 1.0)
        hit = dirs * lam[..., None]
        rel = hit - pc
        a = rel @ a1 / (half[i] * 2)
        b = rel @ a2 / (half[i] * 2)
        inside = ok & (lam > 0.2) & (np.abs(a) <= 0.5) & (np.abs(b) <= 0.5)
        if not inside.any():
            continue
        depth = hit[..., 2]
        zb = zbuf[v0:v1, u0:u1]
        vis = inside & (depth < zb)
        if not vis.any():
            continue
        txf = np.clip((a + 0.5) * tile - 0.5, 0.0, tile - 1.001)
        tyf = np.clip((b + 0.5) * tile - 0.5, 0.0, tile - 1.001)
        x0i, y0i = txf.astype(np.int32), tyf.astype(np.int32)
        wx, wy = txf - x0i, tyf - y0i
        T_ = world["tex"][i]
        x1i, y1i = np.minimum(x0i + 1, tile - 1), np.minimum(y0i + 1, tile - 1)
        val = (T_[y0i, x0i] * (1 - wy) * (1 - wx) + T_[y0i, x1i] * (1 - wy) * wx
               + T_[y1i, x0i] * wy * (1 - wx) + T_[y1i, x1i] * wy * wx)
        img[v0:v1, u0:u1][vis] = val[vis]
        zb[vis] = depth[vis]
    return img


def make_ring_world(rng, n=1800, r_wall=9.0, half_h=2.5, tile=6):
    """Splats on a cylinder wall around the origin and over the whole floor
    and ceiling disc, a closed scene for a loop (synthetic.make_ring_world,
    the same draws from ``rng``)."""
    n_wall = n // 2
    a = rng.uniform(0, 2 * np.pi, n_wall)
    wall = np.stack([r_wall * np.cos(a), r_wall * np.sin(a), rng.uniform(-half_h, half_h, n_wall)], -1)
    n_fc = n - n_wall
    a2 = rng.uniform(0, 2 * np.pi, n_fc)
    rr = r_wall * np.sqrt(rng.uniform(0.0, 1.0, n_fc))
    zf = np.where(rng.uniform(size=n_fc) < 0.5, -half_h, half_h)
    fc = np.stack([rr * np.cos(a2), rr * np.sin(a2), zf], -1)
    tilt = rng.uniform(0.7, 3.0, n_fc)
    normals = np.concatenate([
        np.stack([-np.cos(a), -np.sin(a), np.zeros(n_wall)], -1),  # the wall faces inward
        np.stack([-np.cos(a2), -np.sin(a2), -np.sign(zf) * tilt], -1),  # floor and ceiling tilted inward
    ])
    e1, e2 = _frames_from_normals(normals)
    return {
        "centers": np.concatenate([wall, fc]).astype(np.float32),
        "sizes": rng.uniform(0.25, 0.7, n).astype(np.float32),
        "tex": rng.uniform(40.0, 230.0, (n, tile, tile)).astype(np.float32),
        "e1": e1,
        "e2": e2,
    }


def circle_trajectory(n_frames, radius=4.0, frac=1.1):
    """The camera circling the origin at ``radius``, looking along the
    tangent; ``frac`` > 1 revisits the start (synthetic.circle_trajectory).
    A list of T_cw as (R, t) numpy float32 pairs."""
    poses = []
    for i in range(n_frames):
        a = 2 * np.pi * frac * i / n_frames
        c, s = np.cos(a), np.sin(a)
        center = np.array([radius * c, radius * s, 0.0], np.float32)
        R_wc = np.stack([np.array([c, s, 0.0], np.float32), np.array([0.0, 0.0, -1.0], np.float32),
                         np.array([-s, c, 0.0], np.float32)], axis=1)  # columns: right, down, forward
        R = R_wc.T
        poses.append((R, -R @ center))
    return poses


def arc_trajectory(n_frames, step=0.08, yaw_rate=0.004, lateral=0.0):
    """Forward motion with a slow yaw (synthetic.arc_trajectory): a list of
    T_cw as (R, t) numpy float32 pairs."""
    from orb_slam3_fast_tpu_torch.utils import lie

    poses = []
    T_wc = lie.SE3.identity("cpu")
    inc = lie.se3_exp(torch.tensor([step * 0.3, lateral, step, 0.0, yaw_rate, 0.0], dtype=torch.float32))
    for _ in range(n_frames):
        T_cw = T_wc.inverse()
        poses.append((T_cw.R.numpy(), T_cw.t.numpy()))
        T_wc = T_wc.compose(inc)
    return poses


def stereo_pair(world, cam, R, t, baseline, wh=(640, 480)):
    """The right camera sits +baseline along x of the left one."""
    return render(world, cam, R, t, wh), render(world, cam, R, np.asarray(t) - np.array([baseline, 0.0, 0.0]), wh)


def splat_depth(world, cam, R, t, wh=(640, 480)) -> np.ndarray:
    """The RGB-D test's depth map (tests/test_slam_e2e.py:102-116): each
    splat's square footprint at its centre's depth, far to near, 0 where no
    splat lies (invalid)."""
    from orb_slam3_fast_tpu_torch.cameras import models as cm

    w, h = wh
    Xc = world["centers"] @ np.asarray(R, np.float32).T + np.asarray(t, np.float32)
    uv = cm.project(cam, torch.as_tensor(Xc)).numpy()
    depth = np.zeros((h, w), np.float32)
    fx = float(cam.params[0])
    for j in np.argsort(-Xc[:, 2]):
        z = Xc[j, 2]
        if z < 0.5:
            continue
        u, v = uv[j]
        s = world["sizes"][j] * fx / z
        if s < 2:
            continue
        u0, v0, u1, v1 = int(u - s / 2), int(v - s / 2), int(u + s / 2), int(v + s / 2)
        depth[max(v0, 0) : max(v1, 0), max(u0, 0) : max(u1, 0)] = z
    return depth


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
    px = sum(lv.numel() for lv in levels)
    # per pixel: 4 bytes read, 8 written; 16 circle differences, 64
    # threshold tests, up to 64 adds, the run tests and 8 NMS maxima (~150)
    out.append(dict(name="fast_nms", route="cuda", source="orb_slam3_fast_tpu_torch/csrc/fast_nms.cu",
                    replaces="orb_slam3_fast_tpu/ops/fast.py:62", max_abs_err=err, ms=ms, plain_ms=plain_ms,
                    **bound(12 * px, 150 * px), library_ms=None, shapes="8 levels of 480x640, tolerance exact"))

    # B: angle + BRIEF for the 1024 slots of that image
    kp = ext.extract(il, cfg)
    blurs = [image.gaussian_blur(lv) for lv in levels]
    scales = torch.as_tensor(ext.slot_scales(cfg), device=device)
    xy = torch.round(kp.xy / scales[:, None]).to(torch.int32)  # level-local integer positions (sub < 0.5 px)
    desc_in = ext.describe_inputs(levels, blurs, kp.level)
    a_k, d_k = ext.orb_describe(*desc_in, xy)
    a_p, d_p = ext.orb_describe_plain(*desc_in, xy)
    torch.cuda.synchronize()
    a_err = float((a_k - a_p).abs().max())
    bit_diff = float((ham.unpack_desc(d_k) != ham.unpack_desc(d_p)).float().mean())
    # the angle is a sum of 961 products in another order (~1e-5 rad); a
    # bit flips only where that moves a rotated sample across a rounding edge
    if a_err > 1e-3 or bit_diff > 1e-3:
        raise RuntimeError(f"orb_describe: angle err {a_err}, bit mismatch {bit_diff}")
    ms = cuda_ms(lambda: ext.orb_describe(*desc_in, xy), 50)
    plain_ms = cuda_ms(lambda: ext.orb_describe_plain(*desc_in, xy), 10)
    n_kp = xy.shape[0]
    # per keypoint: the 31x31 and 29x29 patches read, 12 bytes in, 36 out;
    # 961 moment terms (4 flops) and 512 rotated samples (~10 flops)
    out.append(dict(name="orb_describe", route="cuda", source="orb_slam3_fast_tpu_torch/csrc/orb_describe.cu",
                    replaces="orb_slam3_fast_tpu/ops/extractor.py:297", max_abs_err=a_err, ms=ms, plain_ms=plain_ms,
                    **bound(n_kp * ((961 + 841) * 4 + 48), n_kp * (961 * 4 + 512 * 10)), library_ms=None,
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
    # every pair's gate (~8 operations); the distance (8 xor, 8 popcount,
    # 8 adds) where the gate lets it through: every pair in stereo mode
    n_s, n_w = kp.n * kp_r.n, int(ham.window_mask(wgate).sum())
    c_bytes = sum((a.shape[0] + b.shape[0]) * 52 + a.shape[0] * 16 for a, b in ((kp.desc, kp_r.desc), (lm.desc, kp.desc)))
    c_ops = 8 * (kp.n * kp_r.n + lm.desc.shape[0] * kp.n) + 24 * (n_s + n_w)
    out.append(dict(name="hamming_best2", route="cuda", source="orb_slam3_fast_tpu_torch/csrc/hamming_best2.cu",
                    replaces="orb_slam3_fast_tpu/ops/hamming.py:28", max_abs_err=err, ms=ms_s + ms_w,
                    plain_ms=pms_s + pms_w, nbytes=c_bytes, ops=c_ops, library_ms=None,
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
    n_edge = int(obs.valid.sum())
    # per active edge and LM iteration (4 x 10): residual, Jacobian and
    # normal-equation terms, ~150 flops; 30 bytes in and 1 out per slot
    out.append(dict(name="pose_lm", route="cuda", source="orb_slam3_fast_tpu_torch/csrc/pose_lm.cu",
                    replaces="orb_slam3_fast_tpu/optim/pose_opt.py:117", max_abs_err=err, ms=ms, plain_ms=plain_ms,
                    **bound(obs.xw.shape[0] * 31 + 96, n_edge * 40 * 150), library_ms=None,
                    shapes=f"{int(obs.valid.sum())} active of 1024 edges, 4x10 LM, tolerance 1e-3"))
    return out + compare_front_kernels(device, cfg, step, lm, il, ir, kp, kp_r)


def near(x: torch.Tensor, threshold: float, tol: float = 1e-5) -> torch.Tensor:
    """Where a float quantity lies within ``tol`` (relative) of a threshold."""
    return (x - threshold).abs() <= tol * max(abs(threshold), 1.0)


def visibility_borderline(R, t, lm, uv, wh, sf: float) -> torch.Tensor:
    """Landmark slots where one of kernel L's tests, or PredictScale's
    log(ratio) / log(sf), lies within 1e-5 of its threshold: there float
    rounding in another order may flip a flag or a level."""
    pos, normal, dmin, dmax = lm.pos, lm.normal, lm.dmin, lm.dmax
    xc = pos @ R.T + t
    po = pos + R.T @ t
    dist = po.norm(dim=1)
    q = torch.log(dmax / dist.clamp(min=1e-9)) / float(np.log(sf))  # unclamped: ratio < 1 is level 0 on both
    return (((q - q.round()).abs() <= 1e-5) | near(xc[:, 2], 0.05) | near(uv[:, 0], 0.0)
            | near(uv[:, 0], float(wh[0])) | near(uv[:, 1], 0.0) | near(uv[:, 1], float(wh[1]))
            | near(dist / (dmin * 0.8).clamp(min=1e-12), 1.0) | near(dist / (dmax * 1.2).clamp(min=1e-12), 1.0)
            | near((po * normal).sum(1) / dist.clamp(min=1e-9), 0.5))


def compare_front_kernels(device, cfg, step, lm, il, ir, kp, kp_r) -> list[dict]:
    """Phase 3 for H, I, J and L, and the whole extraction on the card
    against the plain one: H at 640x480 and 1280x720, I on kernel A's maps
    of those pyramids and on a tie-heavy map, J on the 1024 stereo matches
    of the step's frame, L on its 4096-slot local map at two poses."""
    from orb_slam3_fast_tpu_torch.frontend import tracker as trk
    from orb_slam3_fast_tpu_torch.ops import extractor as ext
    from orb_slam3_fast_tpu_torch.ops import fast, image
    from orb_slam3_fast_tpu_torch.ops import matching as mat
    from orb_slam3_fast_tpu_torch.utils import lie

    out = []
    big = Rig(1280, 720)
    images = {(640, 480): il, (1280, 720): frame(make_canvas(np.random.default_rng(5), big), big, 0, device)[0]}
    nl, sf = cfg.n_levels, cfg.scale_factor

    # H: levels within 1e-4 of F.interpolate's chain; each blur bit-equal to
    # gaussian_blur of the kernel's own level
    h_err = blur_err = 0.0
    blur_bad = h_bytes = h_ops = 0
    h_ms, h_pms, notes, maps = [], [], [], {}
    for (w, h), img in images.items():
        shapes, offs = image.pyramid_layout(h, w, nl, sf)
        lk, bk = image.pyramid_blur(img, nl, sf)
        lp, bp = image.pyramid_blur_plain(img, nl, sf)
        torch.cuda.synchronize()
        h_err = max(h_err, float((lk - lp).abs().max()))
        blur_err = max(blur_err, float((bk - bp).abs().max()))
        blur_bad += sum(int((b != image.gaussian_blur(lv)).sum())
                        for lv, b in zip(image.level_views(lk, shapes, offs), image.level_views(bk, shapes, offs)))
        h_ms.append(cuda_ms(lambda: image.pyramid_blur(img, nl, sf), 50))
        h_pms.append(cuda_ms(lambda: image.pyramid_blur_plain(img, nl, sf), 10))
        notes.append(f"{w}x{h} {h_ms[-1]:.4f} ms (plain {h_pms[-1]:.4f})")
        # the image read once, every level and blur written once; ~10 flops
        # of resize and 28 of blur per level pixel
        h_bytes += 4 * h * w + 8 * lk.numel()
        h_ops += 38 * lk.numel()
        raw, nms = torch.empty_like(lk), torch.empty_like(lk)
        for lv, r, m in zip(*(image.level_views(x, shapes, offs) for x in (lk, raw, nms))):
            fast.fast_nms(lv, cfg.ini_th_fast, cfg.min_th_fast, ext.EDGE_BORDER, out=(r, m))
        maps[(w, h)] = (nms, raw, shapes, offs)
    if not (h_err <= 1e-4 and blur_bad == 0):
        raise RuntimeError(f"pyramid_blur: levels differ by {h_err:.3g} (tolerance 1e-4), {blur_bad} blurred pixels "
                           "differ from gaussian_blur of the kernel's level")
    out.append(dict(name="pyramid_blur", route="cuda", source="orb_slam3_fast_tpu_torch/csrc/pyramid_blur.cu",
                    replaces="orb_slam3_fast_tpu/ops/image.py:59", max_abs_err=h_err, ms=sum(h_ms), plain_ms=sum(h_pms),
                    **bound(h_bytes, h_ops), library_ms=None,
                    shapes=f"8 levels + blurs of {', '.join(notes)}; levels within 1e-4 grey (F.interpolate on the "
                           f"card), blurs bit-equal to gaussian_blur of the kernel's level ({blur_err:.3g} from the "
                           "plain chain's)"))

    # I: exact on both pyramids' maps and on a tie-heavy map of small integers
    nms0, raw0, shapes0, offs0 = maps[(640, 480)]
    rng = np.random.default_rng(6)
    ties = torch.as_tensor((rng.integers(0, 4, nms0.numel()) * (rng.uniform(size=nms0.numel()) < 0.2))
                           .astype(np.float32), device=device)
    i_ms, i_pms, notes, i_bytes, i_ops = [], [], [], 0, 0
    for label, args in [(f"{w}x{h}", m) for (w, h), m in maps.items()] + [("ties", (ties, raw0, shapes0, offs0))]:
        got, want = ext.select_subpixel(*args, cfg), ext.select_subpixel_plain(*args, cfg)
        torch.cuda.synchronize()
        if not all(torch.equal(x, y) for x, y in zip(got, want)):
            raise RuntimeError(f"select_subpixel differs from its plain version on the {label} map")
        if label == "ties":
            notes.append(f"tie-heavy map exact ({int(want[3].sum())} valid)")
            continue
        i_ms.append(cuda_ms(lambda: ext.select_subpixel(*args, cfg), 50))
        i_pms.append(cuda_ms(lambda: ext.select_subpixel_plain(*args, cfg), 10))
        notes.append(f"{label} {i_ms[-1]:.4f} ms (plain {i_pms[-1]:.4f})")
        # the NMS map read once, 5 pre-NMS pixels per slot, 21 bytes out per
        # slot; K compares per pixel for the cell top-K, the bitonic sort of
        # each level's candidates, ~20 flops per slot
        n = got[0].shape[0]
        cand = [-(-h // cfg.cell) * -(-w // cfg.cell) * cfg.cand_per_cell for h, w in args[2]]
        sort_ops = sum(p * k * (k + 1) / 4 for p, k in ((1 << (c - 1).bit_length(), (c - 1).bit_length()) for c in cand))
        i_bytes += 4 * args[0].numel() + 20 * n + 21 * n
        i_ops += cfg.cand_per_cell * args[0].numel() + sort_ops + 20 * n
    out.append(dict(name="select_subpixel", route="cuda", source="orb_slam3_fast_tpu_torch/csrc/select_subpixel.cu",
                    replaces="orb_slam3_fast_tpu/ops/extractor.py:140", max_abs_err=0.0, ms=sum(i_ms),
                    plain_ms=sum(i_pms), **bound(i_bytes, i_ops), library_ms=None,
                    shapes=f"{', '.join(notes)}; 1024 slots, tolerance exact"))

    # the whole extraction: the card's kernels against the plain versions on
    # the card -- the same valid slots, angles within 1e-4 rad, at most 1%
    # of the slots' descriptor words differing
    for (w, h), img in images.items():
        kk, kpl = ext.extract(img, cfg), ext.extract_plain(img, cfg)
        torch.cuda.synchronize()
        same_valid = torch.equal(kk.valid, kpl.valid)
        v = kpl.valid
        xy_err = float((kk.xy - kpl.xy)[v].abs().max())
        ang_err = float((kk.angle - kpl.angle)[v].abs().max())
        words = int((kk.desc != kpl.desc)[v].sum())
        log(f"extract {w}x{h} on the card against the plain extractor on the card: valid slots equal {same_valid} "
            f"({int(v.sum())}), max |dxy| {xy_err:.3g} px, max |dangle| {ang_err:.3g} rad, {words} descriptor words "
            f"differ ({words / kk.n:.4f} of {kk.n} slots)")
        if not (same_valid and xy_err <= 1e-3 and ang_err <= 1e-4 and words <= 0.01 * kk.n):
            raise RuntimeError(f"extract {w}x{h}: the card's extraction differs from the plain one beyond the bounds")

    # J: 1024 stereo matches of the step's frame
    sm = mat.stereo_match(kp, kp_r, step.scales, bf=step.bf, min_z=step.min_z, slot_scale_r=step.slot_scales)
    args = (il, ir, kp.xy, sm.right_u, sm.valid)
    (uk, okk), (up, okp) = mat.stereo_subpixel_refine(*args), mat.stereo_subpixel_refine_plain(*args)
    sad, _ = mat.sad_table(*args[:4])
    two = torch.sort(sad, dim=1).values[:, :2]
    tie = (two[:, 1] - two[:, 0]) <= 1e-5 * two[:, 0].abs().clamp(min=1.0)
    both = okk & okp & ~tie
    j_err = float((uk - up)[both].abs().max()) if bool(both.any()) else 0.0
    if not (torch.equal(okk[~tie], okp[~tie]) and j_err <= 1e-3):
        raise RuntimeError(f"stereo_subpixel_refine: ok differs off near-tie rows, or u by {j_err:.3g} px")
    n = kp.n
    out.append(dict(name="stereo_subpixel_refine", route="cuda", source="orb_slam3_fast_tpu_torch/csrc/sad_refine.cu",
                    replaces="orb_slam3_fast_tpu/ops/matching.py:380", max_abs_err=j_err,
                    ms=cuda_ms(lambda: mat.stereo_subpixel_refine(*args), 50),
                    plain_ms=cuda_ms(lambda: mat.stereo_subpixel_refine_plain(*args), 10),
                    # 121 left and 231 right pixels per match, 13 bytes in, 5
                    # out; 11 offsets x 121 pixels x 3 flops
                    **bound(n * (352 * 4 + 18), n * (11 * 121 * 3 + 20)), library_ms=None,
                    shapes=f"{n} matches ({int(sm.valid.sum())} valid, {int(okp.sum())} refined); u within 1e-3 px, "
                           f"ok equal off the {int(tie.sum())} rows whose two least SADs lie within 1e-5"))

    # L: the 4096-slot local map at the step's pose and at a turned one
    wh = (640, 480)
    poses = [lie.SE3(torch.eye(3, device=device), torch.as_tensor(Rig(640, 480).t_true(1), device=device)),
             lie.se3_exp(torch.tensor([0.05, -0.02, 0.1, 0.02, -0.03, 0.01], device=device))]
    l_err, n_border, n_vis = 0.0, 0, []
    for T in poses:
        lm_args = (lm.pos, lm.mask, lm.normal, lm.dmin, lm.dmax, wh)
        (uvk, lvk, vk), (uvp, lvp, vp) = (trk.visible_landmarks(step.cam, T.R, T.t, *lm_args),
                                          trk.visible_landmarks_plain(step.cam, T.R, T.t, *lm_args))
        border = visibility_borderline(T.R, T.t, lm, uvp, wh, cfg.scale_factor)
        l_err = max(l_err, float((uvk - uvp)[lm.mask].abs().max()))
        n_border += int(border.sum())
        n_vis.append(int(vp.sum()))
        if not (torch.equal(lvk[~border], lvp[~border]) and torch.equal(vk[~border], vp[~border]) and l_err <= 1e-3):
            raise RuntimeError(f"visible_landmarks: uv differs by {l_err:.3g} px, or a level or flag off the "
                               "borderline rows")
    m = lm.pos.shape[0]
    T = poses[1]
    lm_args = (lm.pos, lm.mask, lm.normal, lm.dmin, lm.dmax, wh)
    out.append(dict(name="visible_landmarks", route="cuda", source="orb_slam3_fast_tpu_torch/csrc/visible_landmarks.cu",
                    replaces="orb_slam3_fast_tpu/frontend/tracker.py:92", max_abs_err=l_err,
                    ms=cuda_ms(lambda: trk.visible_landmarks(step.cam, T.R, T.t, *lm_args), 50),
                    plain_ms=cuda_ms(lambda: trk.visible_landmarks_plain(step.cam, T.R, T.t, *lm_args), 10),
                    # 33 bytes in and 17 out per slot; ~100 flops per slot
                    **bound(50 * m + 48, 100 * m), library_ms=None,
                    shapes=f"{m} slots at two poses ({n_vis} visible); uv within 1e-3 px, level and visible equal "
                           f"off the {n_border} borderline rows"))
    return out


def ba_problem(rng, device):
    """A seeded local-BA problem at the path's caps (MapperConfig: 12 + 8
    keyframes padded to K = 32, 4096 landmarks, 16384 observations): 20
    free poses and 8 fixed ones along a forward arc, the rest padding; every
    landmark seen from 4 random poses; 60% stereo edges, 10% outliers, 0.5
    px noise; free poses and landmarks perturbed from the truth."""
    from orb_slam3_fast_tpu_torch.optim import ba
    from orb_slam3_fast_tpu_torch.utils import lie

    K, live, fixed, M, obs_per_lm = 32, 20, 8, 4096, 4
    n_real = live + fixed
    R = np.tile(np.eye(3, dtype=np.float32), (K, 1, 1))
    t = np.zeros((K, 3), np.float32)
    for k in range(n_real):
        T = lie.se3_exp(torch.tensor([0.02 * k, 0.0, 0.1 * k, 0.0, 0.004 * k, 0.0])).inverse()
        R[k], t[k] = T.R.numpy(), T.t.numpy()
    X = np.stack([rng.uniform(-4, 4, M), rng.uniform(-3, 3, M), rng.uniform(5, 30, M)], -1).astype(np.float32)
    lm = np.repeat(np.arange(M), obs_per_lm).astype(np.int32)
    kf = rng.integers(0, n_real, len(lm)).astype(np.int32)
    xc = np.einsum("oij,oj->oi", R[kf], X[lm]) + t[kf]
    fx, cx, cy, bf = 400.0, 320.0, 240.0, 48.0
    u = fx * xc[:, 0] / xc[:, 2] + cx
    uv = np.stack([u, fx * xc[:, 1] / xc[:, 2] + cy, u - bf / xc[:, 2]], -1) + rng.normal(0, 0.5, (len(lm), 3))
    out = rng.uniform(size=len(lm)) < 0.1
    uv[out, :2] += rng.uniform(15, 40, (out.sum(), 2)) * rng.choice([-1, 1], (out.sum(), 2))
    stereo = rng.uniform(size=len(lm)) < 0.6
    uv[~stereo, 2] = -1.0
    pose_fixed = np.ones(K, bool)
    pose_fixed[fixed:n_real] = False
    t0 = t.copy()
    t0[~pose_fixed] += rng.normal(0, 0.02, ((~pose_fixed).sum(), 3)).astype(np.float32)
    return ba.make_problem(
        R, t0, pose_fixed, X + rng.normal(0, 0.05, X.shape).astype(np.float32), np.ones(M, bool), kf, lm,
        uv.astype(np.float32), (1.0 / 1.44 ** rng.integers(0, 4, len(lm))).astype(np.float32), stereo,
        np.ones(len(lm), bool), device=device,
    )


def corridor_keypoints(device):
    """Keypoints (768 features) of two corridor frames 6 cm apart, with F
    from their true poses: the inputs of kernel C's epipolar and mutual
    modes at the System's shapes."""
    from orb_slam3_fast_tpu_torch.cameras.models import Camera
    from orb_slam3_fast_tpu_torch.ops import extractor as ext

    cam = Camera.pinhole(400.0, 400.0, 320.0, 240.0)
    world = make_corridor_world(np.random.default_rng(1), n=900)
    poses = arc_trajectory(6, step=0.06, lateral=0.05)
    cfg = ext.ExtractorConfig(n_features=768)
    kps = [ext.extract(torch.as_tensor(render(world, cam, *poses[i])).to(device), cfg) for i in (0, 5)]
    (Ra, ta), (Rb, tb) = poses[0], poses[5]
    R_ba = Rb @ Ra.T  # a -> b
    t_ba = tb - R_ba @ ta
    tx = np.array([[0, -t_ba[2], t_ba[1]], [t_ba[2], 0, -t_ba[0]], [-t_ba[1], t_ba[0], 0]])
    Kinv = np.linalg.inv(cam.K().numpy().astype(np.float64))
    F_ab = (Kinv.T @ tx @ R_ba @ Kinv).astype(np.float32)  # x_b^T F x_a = 0
    return kps, torch.as_tensor(F_ab).to(device), torch.as_tensor(ext.level_sigma2(cfg)).to(device)


def compare_system_kernels(device) -> tuple[list[dict], dict]:
    """Phase 3 for the System's kernels: E + F on a BA problem at the path's
    caps, G on N_DLT matches, C's epipolar and mutual modes at 768 x 768,
    each against its plain version, with CUDA-event times; F's failure flag
    on an indefinite system.  Returns (E, F, G entries, C's two modes)."""
    from orb_slam3_fast_tpu_torch.cameras.models import Camera
    from orb_slam3_fast_tpu_torch.ops import hamming as ham
    from orb_slam3_fast_tpu_torch.ops import matching as mat
    from orb_slam3_fast_tpu_torch.ops import twoview
    from orb_slam3_fast_tpu_torch.optim import ba

    rng = np.random.default_rng(3)
    cam, bf = Camera.pinhole(400.0, 400.0, 320.0, 240.0), 48.0
    prob = ba_problem(rng, device)
    K, M, O = prob.R.shape[0], prob.xw.shape[0], prob.obs_kf.shape[0]
    out = []

    # E: the blocks; W scattered into Z for the comparison
    inl = torch.ones_like(prob.obs_valid)
    args = (cam, bf, prob.R, prob.t, prob.xw, prob, inl)
    bk, bp = ba.build_normal_blocks(*args), ba.build_normal_blocks_plain(*args)
    Zk = ba.coupling_to_dense(bk[4], prob)
    err_e = max(float((x - y).abs().max()) / max(float(y.abs().max()), 1e-12)
                for x, y in zip((*bk[:4], Zk, *bk[5:]), bp))
    # atomics sum in another order: every block within 1e-4 of its max
    if not err_e <= 1e-4:
        raise RuntimeError(f"ba_blocks: a block differs by {err_e:.3g} of its max from the plain version")
    # per observation: 28 bytes in, a 6x3 W (72 bytes) out, ~600 flops of
    # projection, Jacobians and block products; per pose 48 bytes in and 168
    # out, per landmark 13 in and 52 out
    e_bytes = O * (28 + 72) + K * (48 + 168) + M * (13 + 52)
    out.append(dict(name="ba_blocks", route="cuda", source="orb_slam3_fast_tpu_torch/csrc/ba_blocks.cu",
                    replaces="orb_slam3_fast_tpu/optim/ba.py:72", max_abs_err=err_e, **bound(e_bytes, 600 * O),
                    library_ms=None,
                    ms=cuda_ms(lambda: ba.build_normal_blocks(*args), 20),
                    plain_ms=cuda_ms(lambda: ba.build_normal_blocks_plain(*args), 5),
                    shapes=f"K={K} ({int((~prob.pose_fixed).sum())} free), M={M}, O={O}; error relative to each "
                           "block's max, tolerance 1e-4"))

    # F: the same blocks into the kernel and into a float64 plain solve
    lam = torch.tensor(1e-4, device=device)
    dk, lk, ok = ba.schur_solve(*bk[:6], prob, lam)
    if not bool(ok):
        raise RuntimeError("ba_schur: the Cholesky solve failed on a positive definite system")
    b64 = [x.double() for x in (*bk[:4], Zk, bk[5])]
    d64, l64 = ba.schur_solve_plain(*b64, prob.pose_fixed, prob.lm_valid, lam.double())
    err_f = max(float((dk.double() - d64).abs().max() / d64.abs().max()),
                float((lk.double() - l64).abs().max() / l64.abs().max()))
    d32, _ = ba.schur_solve_plain(*bp[:6], prob.pose_fixed, prob.lm_valid, lam)
    err_f32 = float((dk - d32).abs().max() / d32.abs().max())
    if not err_f <= 1e-4:
        raise RuntimeError(f"ba_schur: dp / dl differ by {err_f:.3g} (relative) from the float64 plain solve")
    # a reduced system that is not positive definite (every pose block
    # shifted below zero by twice its trace): the flag, and no step
    trace = bk[0].diagonal(dim1=1, dim2=2).sum(-1)
    bad = [bk[0] - 2.0 * trace[:, None, None] * torch.eye(6, device=device), *bk[1:6]]
    dz, lz, ok = ba.schur_solve(*bad, prob, lam)
    if bool(ok) or float(dz.abs().max()) != 0.0 or float(lz.abs().max()) != 0.0:
        raise RuntimeError("ba_schur: an indefinite system was not flagged, or left a step")
    # the library call: a Cholesky factorisation and solve of the same
    # float64 reduced system, which the plain path forms first
    Sd, bs, *_ = ba.reduced_system_plain(*b64, prob.pose_fixed, lam.double())
    lib_f = cuda_ms(lambda: torch.cholesky_solve(bs[:, None], torch.linalg.cholesky_ex(Sd)[0]), 20)
    # per landmark with n observations: n^2 6x3x6 products (216 flops each)
    # into S and 3x3 inverses; the 6K Cholesky (6K)^3 / 3; the blocks read
    # once (E's outputs), dp and dl written
    n_obs = torch.bincount(prob.obs_lm[prob.obs_valid].long(), minlength=M).double()
    f_ops = 216 * float((n_obs**2).sum()) + 60 * M + (6 * K) ** 3 / 3
    f_bytes = K * 168 + M * 52 + O * 72 + K * 24 + M * 12
    out.append(dict(name="ba_schur", route="cuda", source="orb_slam3_fast_tpu_torch/csrc/ba_schur.cu",
                    replaces="orb_slam3_fast_tpu/optim/ba.py:108", max_abs_err=err_f, **bound(f_bytes, f_ops),
                    library_ms=lib_f,
                    ms=cuda_ms(lambda: ba.schur_solve(*bk[:6], prob, lam), 20),
                    plain_ms=cuda_ms(lambda: ba.schur_solve_plain(*bp[:6], prob.pose_fixed, prob.lm_valid, lam), 5),
                    shapes=f"6K={6 * K}; error relative to the float64 plain solve of the same blocks, tolerance "
                           f"1e-4; {err_f32:.3g} against the float32 plain solve; an indefinite system flagged, "
                           "dp and dl zero"))

    # E + F: a whole bundle_adjust against the plain one
    Rk, tk, _, ik = ba.bundle_adjust(cam, bf, prob)
    Rp, tp, _, ip = ba.bundle_adjust_plain(cam, bf, prob)
    err_ba = max(float((tk - tp).abs().max()), float((Rk - Rp).abs().max()))
    flips = float((ik != ip).float().mean())
    if not (err_ba <= 1e-3 and flips <= 0.005):
        raise RuntimeError(f"bundle_adjust: pose err {err_ba:.3g}, inlier flags differing {flips:.4f}")
    ba_ms = cuda_ms(lambda: ba.bundle_adjust(cam, bf, prob), 3)
    ba_plain_ms = cuda_ms(lambda: ba.bundle_adjust_plain(cam, bf, prob), 2)
    out[-1]["shapes"] += (f"; bundle_adjust 5+10 LM via E+F {ba_ms:.3f} ms (plain {ba_plain_ms:.3f}), pose err "
                          f"{err_ba:.3g} (tolerance 1e-3), inlier flags differing {flips:.4f} (tolerance 0.005)")

    # G: 1024 matches of two keyframes 0.4 m apart
    g = torch.Generator().manual_seed(0)
    Xs = torch.stack([torch.rand(N_DLT, generator=g) * 8 - 4, torch.rand(N_DLT, generator=g) * 6 - 3,
                      2 + 20 * torch.rand(N_DLT, generator=g)], 1)
    P0 = torch.tensor([[1.0, 0, 0, 0], [0, 1, 0, 0], [0, 0, 1, 0]])
    P1 = torch.tensor([[1.0, 0, 0, -0.4], [0, 1, 0, 0.05], [0, 0, 1, 0.1]])
    x0 = Xs[:, :2] / Xs[:, 2:] + 1e-3 * torch.randn(N_DLT, 2, generator=g)
    xc1 = Xs + P1[:, 3]
    x1 = xc1[:, :2] / xc1[:, 2:] + 1e-3 * torch.randn(N_DLT, 2, generator=g)
    dlt = [a.to(device).contiguous() for a in (P0, P1, x0, x1)]
    Xk, Xp = twoview.triangulate_dlt(*dlt), twoview.triangulate_dlt_plain(*dlt)
    c1 = -P1[:, 3]
    cosp = (Xs * (Xs - c1)).sum(1) / (Xs.norm(dim=1) * (Xs - c1).norm(dim=1))
    good = (cosp < 0.9998).to(device)
    err_g = float(((Xk - Xp).norm(dim=1) / Xp.norm(dim=1))[good].max())
    if not err_g <= 1e-4:
        raise RuntimeError(f"triangulate_dlt: {err_g:.3g} relative on well-conditioned rows")
    # the library call: the batched SVD of the same (N,4,4) DLT systems
    P0d, P1d, x0d, x1d = dlt
    A = torch.stack([x0d[:, 0:1] * P0d[2] - P0d[0], x0d[:, 1:2] * P0d[2] - P0d[1], x1d[:, 0:1] * P1d[2] - P1d[0],
                     x1d[:, 1:2] * P1d[2] - P1d[1]], dim=1)
    lib_g = cuda_ms(lambda: torch.linalg.svd(A), 20)
    # per match: 16 bytes in, 12 out; the 4x4 system (16 flops), its normal
    # matrix and null vector, and the division by w
    out.append(dict(name="triangulate_dlt", route="cuda", source="orb_slam3_fast_tpu_torch/csrc/triangulate_dlt.cu",
                    replaces="orb_slam3_fast_tpu/ops/twoview.py:164", max_abs_err=err_g,
                    **bound(N_DLT * 28 + 96, N_DLT * (16 + normal_flops(4, 4) + null_flops(4) + 3)), library_ms=lib_g,
                    ms=cuda_ms(lambda: twoview.triangulate_dlt(*dlt), 50), plain_ms=cuda_ms(lambda: twoview.triangulate_dlt_plain(*dlt), 10),
                    shapes=f"{N_DLT} matches ({int(good.sum())} with parallax cos < 0.9998); relative error there, "
                           "tolerance 1e-4"))

    # C: epipolar and mutual modes, 768 x 768, exact
    (kp_a, kp_b), F_ab, sigma2 = corridor_keypoints(device)
    f32 = torch.float32
    xa = torch.cat([kp_a.xy, torch.ones_like(kp_a.xy[:, :1])], 1)
    lines = xa @ F_ab.T
    epi = ham.EpipolarGate(lines[:, 0].contiguous(), lines[:, 1].contiguous(), lines[:, 2].contiguous(),
                           lines[:, 0] ** 2 + lines[:, 1] ** 2, kp_a.valid.to(f32), kp_b.xy[:, 0].contiguous(),
                           kp_b.xy[:, 1].contiguous(), 3.84 * mat._pow_level(kp_b.level, sigma2), kp_b.valid.to(f32))
    mutual = ham.MutualGate(kp_a.valid.to(f32), kp_b.valid.to(f32))
    modes = {}
    for name, gate in (("epipolar", epi), ("mutual", mutual)):
        (bk_, ck), (bp_, cp) = ham.hamming_best2(kp_a.desc, kp_b.desc, gate), ham.hamming_best2_plain(kp_a.desc, kp_b.desc, gate)
        if not (all(torch.equal(x, y) for x, y in zip(bk_, bp_)) and torch.equal(ck, cp)):
            raise RuntimeError(f"hamming_best2 {name} mode differs from its plain version")
        gated = int((ham.epipolar_mask(gate) if name == "epipolar" else
                     (gate.valid_a[:, None] * gate.valid_b[None, :] > 0.5)).sum())
        modes[name] = dict(n=kp_a.n, m=kp_b.n, nbytes=(kp_a.n + kp_b.n) * 52 + kp_a.n * 16 + kp_b.n * 8,
                           ops=8 * kp_a.n * kp_b.n + 24 * gated,
                           ms=cuda_ms(lambda: ham.hamming_best2(kp_a.desc, kp_b.desc, gate), 50),
                           plain_ms=cuda_ms(lambda: ham.hamming_best2_plain(kp_a.desc, kp_b.desc, gate), 10),
                           accepted=int((bp_.dist < ham.INF_DIST).sum()))
    return out, modes


def mono_frames(n_frames: int, seed: int = 0):
    """The mono phase's input: test_slam_e2e.py's mono corridor (seed 0, 900
    splats, arc_trajectory(step=0.06, lateral=0.05)), rendered on the host;
    returns (images, true T_cw per frame)."""
    from orb_slam3_fast_tpu_torch.cameras.models import Camera

    cam = Camera.pinhole(400.0, 400.0, 320.0, 240.0)
    world = make_corridor_world(np.random.default_rng(seed), n=900)
    poses = arc_trajectory(n_frames, step=0.06, lateral=0.05)
    return [render(world, cam, R, t) for R, t in poses], poses


def planar_matches(rng, n: int = 768, n_valid: int = 300):
    """Two views of a textured plane (z = 4 + 0.3 x) 0.25 m apart with a
    small turn, 0.5 px noise, 10% of the matches wrong; the matches fill the
    first ``n_valid`` of ``n`` slots.  Returns (uv0, uv1, valid) on the
    host."""
    from orb_slam3_fast_tpu_torch.utils import lie

    X = np.stack([rng.uniform(-3, 3, n), rng.uniform(-2, 2, n), np.zeros(n)], -1)
    X[:, 2] = 4.0 + 0.3 * X[:, 0]
    T = lie.se3_exp(torch.tensor([0.25, 0.03, 0.05, 0.01, -0.04, 0.02]))
    X1 = X @ T.R.numpy().T + T.t.numpy()
    uv0 = 400.0 * X[:, :2] / X[:, 2:] + [320.0, 240.0] + rng.normal(0, 0.5, (n, 2))
    uv1 = 400.0 * X1[:, :2] / X1[:, 2:] + [320.0, 240.0] + rng.normal(0, 0.5, (n, 2))
    wrong = rng.uniform(size=n) < 0.1
    uv1[wrong] = rng.uniform([0, 0], [640, 480], (int(wrong.sum()), 2))
    valid = np.arange(n) < n_valid
    return uv0.astype(np.float32), uv1.astype(np.float32), valid


def pnp_problem(rng, n: int = 768, n_valid: int = 600, outliers: float = 0.2):
    """A relocalisation problem at the path's shapes: ``n`` slots, the first
    ``n_valid`` holding world points 2-8 m in front of a camera at a known
    pose, observed with 0.5 px noise at random pyramid levels, ``outliers``
    of them at random pixels.  Returns (xw, uv, inv_sigma2, valid, R, t) on
    the host."""
    from orb_slam3_fast_tpu_torch.utils import lie

    T = lie.se3_exp(torch.tensor([0.3, -0.1, 0.5, 0.05, -0.1, 0.03]))
    R, t = T.R.numpy(), T.t.numpy()
    xc = np.stack([rng.uniform(-3, 3, n), rng.uniform(-2, 2, n), rng.uniform(2, 8, n)], -1)
    xw = ((xc - t) @ R).astype(np.float32)
    uv = 400.0 * xc[:, :2] / xc[:, 2:] + [320.0, 240.0] + rng.normal(0, 0.5, (n, 2))
    bad = rng.uniform(size=n) < outliers
    uv[bad] = rng.uniform([0, 0], [640, 480], (int(bad.sum()), 2))
    valid = np.arange(n) < n_valid
    inv_s2 = (1.0 / 1.44 ** rng.integers(0, 4, n)).astype(np.float32)
    return xw, uv.astype(np.float32), inv_s2, valid, R, t


def rot_angle(Ra, Rb) -> float:
    """Angle in radians of Ra Rb^T, as atan2(|vee of its skew part|, (tr - 1) / 2):
    arccos of the trace alone would turn a 1e-6 orthonormality defect of
    float32 rotations into ~1e-3 rad."""
    Ra, Rb = (x.detach().double().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float64)
              for x in (Ra, Rb))
    M = Ra @ Rb.T
    w = 0.5 * np.array([M[2, 1] - M[1, 2], M[0, 2] - M[2, 0], M[1, 0] - M[0, 1]])
    return float(np.arctan2(np.linalg.norm(w), (np.trace(M) - 1.0) / 2.0))


def compare_mono_kernels(device) -> list[dict]:
    """Phase 3 for kernels M, N and P against their plain versions on the
    same CUDA tensors: M on the 768 two-view matches of frames 0 and 5 of the
    mono corridor and on a planar pair (the F and the H branch), N on the
    768 descriptors of a corridor frame with the default and the 10^6-word
    vocabulary, P on 768 slots with 256 subsets and 20% outliers."""
    from orb_slam3_fast_tpu_torch.cameras.models import Camera
    from orb_slam3_fast_tpu_torch.ops import extractor as ext
    from orb_slam3_fast_tpu_torch.ops import matching as mat
    from orb_slam3_fast_tpu_torch.ops import twoview
    from orb_slam3_fast_tpu_torch.optim import pnp
    from orb_slam3_fast_tpu_torch.vocab import vocabulary as voc_mod

    cam = Camera.pinhole(400.0, 400.0, 320.0, 240.0)
    cfg = ext.ExtractorConfig(n_features=768)
    imgs, _ = mono_frames(6)
    kp0, kp5 = (ext.extract(torch.as_tensor(imgs[i]).to(device), cfg) for i in (0, 5))
    out = []

    # M: the corridor pair (F) and a planar pair (H)
    idx, acc = mat.search_for_initialization(kp0, kp5, 100.0)
    uvp0, uvp1, vp = planar_matches(np.random.default_rng(7))
    cases = {"corridor 0-5": (kp0.xy, kp5.xy[idx].contiguous(), acc),
             "plane": tuple(torch.as_tensor(a).to(device) for a in (uvp0, uvp1, vp))}
    m_err, m_notes, m_ms, m_pms, m_lib, m_bytes, m_ops, branches = 0.0, [], 0.0, 0.0, 0.0, 0, 0, set()
    for label, (uv0, uv1, valid) in cases.items():
        samples = twoview._sample_hypotheses(5, valid)
        rk = twoview.reconstruct(cam, uv0, uv1, valid, 0, samples=samples)
        rp = twoview.reconstruct_plain(cam, uv0, uv1, valid, samples)
        torch.cuda.synchronize()
        ang = rot_angle(rk.R, rp.R)
        t_dir = float(1.0 - torch.abs(torch.dot(rk.t.double(), rp.t.double())))
        good_eq = float((rk.good == rp.good).float().mean())
        both = rk.good & rp.good
        x_err = float(((rk.X - rp.X).norm(dim=1) / rp.X.norm(dim=1))[both].max()) if bool(both.any()) else 0.0
        if not (bool(rk.success) == bool(rp.success) and bool(rk.used_h) == bool(rp.used_h) and ang <= 1e-3
                and t_dir <= 1e-3 and good_eq >= 0.99 and x_err <= 1e-3):
            raise RuntimeError(f"twoview_ransac {label}: success {bool(rk.success)}/{bool(rp.success)}, used_h "
                               f"{bool(rk.used_h)}/{bool(rp.used_h)}, R {ang:.3g} rad, t direction {t_dir:.3g}, "
                               f"good equal {good_eq:.4f}, X {x_err:.3g}")
        branches.add("H" if bool(rp.used_h) else "F")
        m_err = max(m_err, ang, t_dir, x_err)
        ms = cuda_ms(lambda: twoview.reconstruct(cam, uv0, uv1, valid, 0, samples=samples), 20)
        pms = cuda_ms(lambda: twoview.reconstruct_plain(cam, uv0, uv1, valid, samples), 5)
        # the library call: the batched SVDs of the (200,8,9) F and (200,16,9) H systems
        x0, x1, _ = twoview._camera_plane(cam, uv0, uv1)
        s0n, _ = twoview._normalize(x0, valid)
        s1n, _ = twoview._normalize(x1, valid)
        Af, Ah = twoview._f_rows(s0n[samples], s1n[samples]), twoview._h_rows(s0n[samples], s1n[samples])
        lib = cuda_ms(lambda: (torch.linalg.svd(Af), torch.linalg.svd(Ah)), 20)
        m_ms, m_pms, m_lib = m_ms + ms, m_pms + pms, m_lib + lib
        n, n_hyp, nv, n_good = uv0.shape[0], samples.shape[0], int(valid.sum()), int(rp.good.sum())
        # bytes: 17 per slot and the samples in; the chosen motion, its X and good flags (13 per slot) out.
        # operations: the Hartley normalisation (6 per valid point and view); per hypothesis the 8-point F
        # and H (their normal matrices and null vectors, F's rank-2 SVD, 4 3x3 products to denormalise,
        # H's inverse by the adjugate) and both transfer scores on every valid point (~90); the refit of
        # each model on its inliers (normal matrices, ~90 + 180, a null vector, a rescore), the 4 + 8
        # motions (2 SVDs, ~60 each), and per motion the triangulation (a 4x4 DLT) and CheckRT's tests
        # (~60) of the model's inliers; the inlier counts are at least the chosen motion's good points
        m_bytes += n * 17 + n_hyp * 32 + n * 13 + 60
        fit = normal_flops(8, 9) + normal_flops(16, 9) + 2 * null_flops(9) + SVD3_FLOPS + 4 * 45 + 45
        m_ops += (2 * 6 * nv + n_hyp * (fit + 90 * nv) + 2 * null_flops(9) + SVD3_FLOPS + n_good * (12 + 90 + 180 + 90)
                  + 2 * SVD3_FLOPS + 12 * 60 + 12 * n_good * (16 + normal_flops(4, 4) + null_flops(4) + 60))
        m_notes.append(f"{label}: {int(valid.sum())} valid of {n}, success {bool(rp.success)}, used_h "
                       f"{bool(rp.used_h)}, R {ang:.2e} rad, t dir {t_dir:.2e}, good equal {good_eq:.4f}, X "
                       f"{x_err:.2e}; {ms:.4f} ms (plain {pms:.4f}, svd {lib:.4f})")
    if branches != {"F", "H"}:
        raise RuntimeError(f"twoview_ransac: the two cases took branches {branches}, not both F and H")
    out.append(dict(name="twoview_ransac", route="cuda", source="orb_slam3_fast_tpu_torch/csrc/twoview_ransac.cu",
                    replaces="orb_slam3_fast_tpu/ops/twoview.py:304", max_abs_err=m_err, ms=m_ms, plain_ms=m_pms,
                    **bound(m_bytes, m_ops), library_ms=m_lib,
                    shapes="; ".join(m_notes) + "; tolerances: success and used_h equal, R 1e-3 rad, t direction "
                           "1e-3, good equal on >= 99%, X 1e-3 relative where both good; library = batched "
                           "torch.linalg.svd of the F and H systems"))

    # N: the 768 descriptors of frame 5 with the default and the 10^6-word vocabulary
    n_err, n_notes, n_ms, n_pms, n_bytes, n_ops = 0.0, [], 0.0, 0.0, 0, 0
    for label, voc in (("default 10^4", voc_mod.default_vocabulary()), ("huge 10^6", voc_mod.huge_vocabulary())):
        voc = voc.to(device)
        (wk, nk, bk), (wp, np_, bp) = (voc_mod.transform(voc, kp5.desc, kp5.valid),
                                       voc_mod.transform_plain(voc, kp5.desc, kp5.valid))
        torch.cuda.synchronize()
        rel = float(((bk - bp).abs() / bp.abs().clamp(min=1e-30))[bp != 0].max())
        if not (torch.equal(wk, wp) and torch.equal(nk, np_) and torch.equal(bk != 0, bp != 0) and rel <= 1e-5):
            raise RuntimeError(f"vocab_transform {label}: words / nodes differ, or the BoW's support, or a word "
                               f"by {rel:.3g} relative")
        n_err = max(n_err, rel)
        ms = cuda_ms(lambda: voc_mod.transform(voc, kp5.desc, kp5.valid), 50)
        pms = cuda_ms(lambda: voc_mod.transform_plain(voc, kp5.desc, kp5.valid), 10)
        n_ms, n_pms = n_ms + ms, n_pms + pms
        nv, B, D, W = int(kp5.valid.sum()), voc.branching, voc.depth, voc.n_words
        # bytes: 33 per slot in and 16 out (word, node); the tree rows the descent reads (33 bytes each),
        # B children of each distinct node it passes (the root, then the distinct ancestors of the words:
        # the node of level l - 1 above word w is w // B^(D - l)); the idf weight of each distinct word;
        # the (W,) BoW written once.  Operations: D x B Hamming distances of 24 integer operations per
        # valid descriptor, and a divide per non-zero word
        words = wp[kp5.valid]
        rows = B * (1 + sum(int(torch.unique(words // B ** (D - lvl)).numel()) for lvl in range(1, D)))
        n_bytes += kp5.n * 49 + rows * 33 + 4 * int(torch.unique(words).numel()) + 4 * W
        n_ops += nv * D * B * 24 + int((bp != 0).sum())
        n_notes.append(f"{label} ({nv} valid of {kp5.n}, {int((bp != 0).sum())} words): {ms:.4f} ms (plain "
                       f"{pms:.4f}), BoW within {rel:.2e} relative")
    out.append(dict(name="vocab_transform", route="cuda", source="orb_slam3_fast_tpu_torch/csrc/vocab_transform.cu",
                    replaces="orb_slam3_fast_tpu/vocab/vocabulary.py:258", max_abs_err=n_err, ms=n_ms, plain_ms=n_pms,
                    **bound(n_bytes, n_ops), library_ms=None,
                    shapes="; ".join(n_notes) + "; words and nodes exact, BoW 1e-5 relative per word on the same "
                           "support"))

    # P: 768 slots, 256 subsets, 20% outliers
    xw, uv, inv_s2, valid, R_true, t_true = (torch.as_tensor(a).to(device) for a in pnp_problem(np.random.default_rng(8)))
    subsets = pnp._sample_subsets(11, valid)
    rk = pnp.pnp_ransac(cam, xw, uv, inv_s2, valid, 0, subsets=subsets)
    rp = pnp.pnp_ransac_plain(cam, xw, uv, inv_s2, valid, subsets)
    torch.cuda.synchronize()
    scale = float(xw[valid].norm(dim=1).median())
    ang, dt = rot_angle(rk.R, rp.R), float((rk.t - rp.t).norm()) / scale
    if not (int(rk.n_inliers) == int(rp.n_inliers) and bool(rk.ok) == bool(rp.ok) and bool(rp.ok)
            and ang <= 1e-3 and dt <= 1e-3):
        raise RuntimeError(f"pnp_ransac: inliers {int(rk.n_inliers)}/{int(rp.n_inliers)}, ok {bool(rk.ok)}/"
                           f"{bool(rp.ok)}, R {ang:.3g} rad, t {dt:.3g} of the scene scale")
    inl_eq = float((rk.inliers == rp.inliers).float().mean())
    # the library call: the batched SVD of the (256,12,12) DLT systems
    ctr, spread = pnp._conditioning(xw, valid)
    xn = pnp.cam_models.unproject(cam, uv)[:, :2]
    Xh = torch.cat([(xw - ctr) / spread, torch.ones_like(xw[:, :1])], 1)[subsets]
    z = torch.zeros_like(Xh)
    A = torch.cat([torch.cat([Xh, z, -xn[subsets][..., 0:1] * Xh], -1), torch.cat([z, Xh, -xn[subsets][..., 1:2] * Xh], -1)], 1)
    lib = cuda_ms(lambda: torch.linalg.svd(A), 20)
    n, h, nv = xw.shape[0], subsets.shape[0], int(valid.sum())
    # bytes: 25 per slot and the subsets in; the pose, the mask and the flags out.  Operations: the
    # conditioning (6 per valid point); per subset the 12x12 DLT's normal matrix and null vector, and per
    # sign Procrustes (an SVD and ~100) and 4 GN steps on the 6 points (residuals and Jacobian ~54 per
    # point, the 6x6 normal matrix, its Cholesky and solves ~150, so3_exp ~60 and normalize_rotation's
    # SVD); 512 poses scored on every valid point (~45: transform, radtan projection, error) and the
    # winner's inlier mask
    gn = 6 * 54 + normal_flops(12, 6) + 144 + 150 + 60 + SVD3_FLOPS
    p_ops = 6 * nv + h * (normal_flops(12, 12) + null_flops(12) + 2 * (SVD3_FLOPS + 100 + 4 * gn)) + (2 * h + 1) * nv * 45
    out.append(dict(name="pnp_ransac", route="cuda", source="orb_slam3_fast_tpu_torch/csrc/pnp_ransac.cu",
                    replaces="orb_slam3_fast_tpu/optim/pnp.py:110", max_abs_err=max(ang, dt),
                    ms=cuda_ms(lambda: pnp.pnp_ransac(cam, xw, uv, inv_s2, valid, 0, subsets=subsets), 20),
                    plain_ms=cuda_ms(lambda: pnp.pnp_ransac_plain(cam, xw, uv, inv_s2, valid, subsets), 5),
                    **bound(n * 25 + h * 24 + 48 + n + 5, p_ops),
                    library_ms=lib,
                    shapes=f"{n} slots ({int(valid.sum())} valid, 20% outliers), {h} subsets: {int(rp.n_inliers)} "
                           f"inliers on both, ok on both, R {ang:.2e} rad, t {dt:.2e} of the scene scale, inlier "
                           f"masks equal on {inl_eq:.4f}, truth within {rot_angle(rp.R, R_true):.2e} rad; "
                           "tolerances: count and ok equal, pose 1e-3 rad and 1e-3 of the scene scale; library = "
                           "batched torch.linalg.svd of the (256,12,12) systems"))
    return out


LOOP_CONFIG = dict(min_covis_edge=30, temporal_gap=15)  # tests/test_loop_closing.py:35


def sim3_pairs(rng, n: int = 768, n_valid: int = 300, outliers: float = 0.25, s: float = 1.3):
    """Kernels Q and R's input at the loop verification's width: matched
    points of two keyframes in their camera frames (``n`` = kp_cap slots,
    ``n_valid`` live), xc1 = S12 xc2 with a share of the pairs replaced by
    random points, pixels with 0.5 px noise, levels 0-3.  Returns (the seven
    numpy arrays of ``sim3_ransac``, the true S12 tangent)."""
    from orb_slam3_fast_tpu_torch.utils import lie

    xi = np.array([0.2, -0.1, 0.3, 0.05, -0.1, 0.08, np.log(s)], np.float32)
    S = lie.sim3_exp(torch.as_tensor(xi))
    R, t, sc = S.R.numpy(), S.t.numpy(), float(S.s)
    xc2 = np.zeros((n, 3), np.float32)
    xc2[:n_valid] = np.stack([rng.uniform(-2, 2, n_valid), rng.uniform(-1.5, 1.5, n_valid),
                              rng.uniform(3, 8, n_valid)], -1)
    xc1 = (sc * xc2 @ R.T + t).astype(np.float32)
    bad = (rng.uniform(size=n) < outliers) & (np.arange(n) < n_valid)
    xc1[bad] = np.stack([rng.uniform(-2, 2, bad.sum()), rng.uniform(-1.5, 1.5, bad.sum()),
                         rng.uniform(3, 8, bad.sum())], -1)

    def proj(x):
        z = np.where(np.abs(x[:, 2]) < 1e-9, 1e-9, x[:, 2])
        return np.stack([400.0 * x[:, 0] / z + 320.0, 400.0 * x[:, 1] / z + 240.0], -1)

    uv1 = (proj(xc1) + rng.normal(0, 0.5, (n, 2))).astype(np.float32)
    uv2 = (proj(xc2) + rng.normal(0, 0.5, (n, 2))).astype(np.float32)
    is1 = (1.0 / 1.44 ** rng.integers(0, 4, n)).astype(np.float32)
    is2 = (1.0 / 1.44 ** rng.integers(0, 4, n)).astype(np.float32)
    return (xc1, xc2, uv1, uv2, is1, is2, np.arange(n) < n_valid), xi


def sim3_graph_problem(rng, K: int = 70):
    """Kernel S's input at the circle's size: the essential graph of K
    keyframes on a circle of radius 4, the odometry chain measured with
    noise and 1% scale drift (tests/test_pose_graph.py's construction), the
    estimates integrated from it, exact covisibility edges from each keyframe
    to the 2 to 4 before it, the exact loop edge (K-1, 0), keyframe 0 fixed.
    Returns the Sim3Graph's numpy fields and the true camera centres."""
    from orb_slam3_fast_tpu_torch.utils import lie

    Rg, tg = [], []
    for k in range(K):
        a = 2 * np.pi * k / K
        c, s = np.cos(a), np.sin(a)
        Rwc = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
        Rg.append(Rwc.T)
        tg.append(-Rwc.T @ np.array([4.0 * c, 4.0 * s, 0.0], np.float32))
    Rg, tg = np.stack(Rg), np.stack(tg)

    def rel(i, j):  # the true S_ij = S_iw S_jw^-1, scale 1
        R = Rg[i] @ Rg[j].T
        return R, tg[i] - R @ tg[j], 1.0

    odo = []
    for k in range(K - 1):
        R, t, s = rel(k + 1, k)
        dR = lie.so3_exp(torch.as_tensor(rng.normal(0, 0.01, 3), dtype=torch.float32)).numpy()
        odo.append((dR @ R, t + rng.normal(0, 0.02, 3).astype(np.float32), s * 1.01))
    R0, t0, s0 = [Rg[0]], [tg[0]], [1.0]
    for k in range(K - 1):
        R, t, s = odo[k]
        R0.append(R @ R0[k])
        t0.append(s * (R @ t0[k]) + t)
        s0.append(s * s0[k])
    edges = [(k + 1, k, *odo[k]) for k in range(K - 1)]
    edges += [(i, i - d, *rel(i, i - d)) for i in range(K) for d in (2, 3, 4) if i >= d]
    edges.append((K - 1, 0, *rel(K - 1, 0)))
    E = len(edges)
    fixed = np.zeros(K, bool)
    fixed[0] = True
    g = dict(R=np.stack(R0).astype(np.float32), t=np.stack(t0).astype(np.float32), s=np.asarray(s0, np.float32),
             edge_i=np.asarray([e[0] for e in edges], np.int32), edge_j=np.asarray([e[1] for e in edges], np.int32),
             meas_R=np.stack([e[2] for e in edges]).astype(np.float32),
             meas_t=np.stack([e[3] for e in edges]).astype(np.float32),
             meas_s=np.asarray([e[4] for e in edges], np.float32), edge_valid=np.ones(E, bool), fixed=fixed,
             edge_w=np.ones(E, np.float32))
    return g, -np.einsum("kji,kj->ki", Rg, tg)


def gba_problem(rng, device, K_live: int = 70, M_live: int = 3000, obs_per_lm: int = 10):
    """Kernels E and T's input at the circle's global-BA size: K_live
    keyframes on a circle of radius 4 looking along the tangent (padded to
    K = 128 pose slots, as the mapper pads), keyframe 0 fixed; M_live
    landmarks on the ring's wall and floor (padded to M = 4096), each seen
    from ``obs_per_lm`` keyframes that face it (~30k observations, padded
    to 32768); mono edges, 0.5 px noise, 5% outliers; poses and landmarks
    perturbed from the truth."""
    from orb_slam3_fast_tpu_torch.optim import ba

    K, M = 128, 4096
    R = np.tile(np.eye(3, dtype=np.float32), (K, 1, 1))
    t = np.zeros((K, 3), np.float32)
    for k, (Rk, tk) in enumerate(circle_trajectory(K_live, radius=4.0, frac=1.0)):
        R[k], t[k] = Rk, tk
    a = rng.uniform(0, 2 * np.pi, M)
    X = np.zeros((M, 3), np.float32)
    X[:M_live] = np.stack([9.0 * np.cos(a[:M_live]), 9.0 * np.sin(a[:M_live]), rng.uniform(-2.5, 2.5, M_live)], -1)
    kf, lm = [], []
    for m in range(M_live):
        xc = np.einsum("kij,j->ki", R[:K_live], X[m]) + t[:K_live]
        ok = np.nonzero((xc[:, 2] > 0.5) & (np.abs(xc[:, 0] / xc[:, 2]) < 0.8) & (np.abs(xc[:, 1] / xc[:, 2]) < 0.6))[0]
        if len(ok) < 2:
            continue
        sel = rng.choice(ok, min(obs_per_lm, len(ok)), replace=False)
        kf += sel.tolist()
        lm += [m] * len(sel)
    kf, lm = np.asarray(kf, np.int32), np.asarray(lm, np.int32)
    n = len(kf)
    O = int(2 ** np.ceil(np.log2(n)))
    xc = np.einsum("oij,oj->oi", R[kf], X[lm]) + t[kf]
    uv = np.stack([400.0 * xc[:, 0] / xc[:, 2] + 320.0, 400.0 * xc[:, 1] / xc[:, 2] + 240.0, np.full(n, -1.0)], -1)
    uv[:, :2] += rng.normal(0, 0.5, (n, 2))
    out = rng.uniform(size=n) < 0.05
    uv[out, :2] += rng.uniform(15, 40, (out.sum(), 2)) * rng.choice([-1, 1], (out.sum(), 2))
    pad = lambda v, fill: np.concatenate([v, np.full((O - n, *v.shape[1:]), fill, v.dtype)])  # noqa: E731
    pose_fixed = np.ones(K, bool)
    pose_fixed[1:K_live] = False
    t0 = t.copy()
    t0[~pose_fixed] += rng.normal(0, 0.02, ((~pose_fixed).sum(), 3)).astype(np.float32)
    lm_valid = np.zeros(M, bool)
    lm_valid[np.unique(lm)] = True
    return ba.make_problem(
        R, t0, pose_fixed, (X + rng.normal(0, 0.05, X.shape)).astype(np.float32), lm_valid, pad(kf, 0), pad(lm, 0),
        pad(uv.astype(np.float32), -1.0), pad((1.0 / 1.44 ** rng.integers(0, 4, n)).astype(np.float32), 1.0),
        np.zeros(O, bool), pad(np.ones(n, bool), False), device=device,
    )


def sim3_rel_err(Sa, Sb) -> float:
    """The largest difference of two Sim3s' rotation entries, translation
    (relative to its size) and scale (relative)."""
    tn = max(float(Sb.t.norm()), 1e-9)
    return max(float((Sa.R - Sb.R).abs().max()), float((Sa.t - Sb.t).norm()) / tn,
               abs(float(Sa.s) - float(Sb.s)) / abs(float(Sb.s)))


def compare_loop_kernels(device) -> list[dict]:
    """Phase 3 for loop closing's kernels, each against its plain version on
    the same CUDA tensors, with CUDA-event times: Q (128 hypotheses over the
    768 slots of a keyframe pair, with and without the scale) and R (the 15
    steps on those pairs), S (12 iterations on a 70-keyframe essential
    graph), T (32 CG iterations on a global-BA problem at the circle's size,
    128 pose slots, 4096 landmarks, ~30k observations); E at that size, and
    a whole bundle_adjust_cg through E and T against its plain run."""
    from orb_slam3_fast_tpu_torch.cameras.models import Camera
    from orb_slam3_fast_tpu_torch.optim import ba, ba_cg
    from orb_slam3_fast_tpu_torch.optim import pose_graph as pg
    from orb_slam3_fast_tpu_torch.optim import sim3
    from orb_slam3_fast_tpu_torch.utils import lie

    cam = Camera.pinhole(400.0, 400.0, 320.0, 240.0)
    out = []
    cases = {}  # fix_scale -> (pairs on the card, true tangent): a mono pair (s = 1.3) and a stereo one (s = 1)
    for fix, s_true in ((False, 1.3), (True, 1.0)):
        arrays, xi_true = sim3_pairs(np.random.default_rng(9), s=s_true)
        cases[fix] = ([torch.as_tensor(a).to(device) for a in arrays], xi_true)
    valid = cases[False][0][-1]
    n, nv = valid.shape[0], int(valid.sum())

    # Q: with and without the scale, the same 128 subsets
    subsets = sim3._sample_subsets(sim3.jax_seed(30 * 2654435761 + 5), valid)
    h = subsets.shape[0]
    q_err, q_notes, q_ms, q_pms = 0.0, [], 0.0, 0.0
    for fix in (False, True):
        pairs = cases[fix][0]
        rk = sim3.sim3_ransac(cam, cam, *pairs, 0, fix_scale=fix, subsets=subsets)
        rp = sim3.sim3_ransac_plain(cam, cam, *pairs, subsets, fix_scale=fix)
        torch.cuda.synchronize()
        err = sim3_rel_err(rk.S12, rp.S12)
        flips = int((rk.inliers != rp.inliers).sum())
        # a pair within float rounding of the chi2 threshold can count on one side only
        if not (abs(int(rk.n_inliers) - int(rp.n_inliers)) <= 1 and bool(rk.ok) == bool(rp.ok) and bool(rp.ok)
                and err <= 1e-4 and flips <= 1):
            raise RuntimeError(f"sim3_ransac fix_scale={fix}: inliers {int(rk.n_inliers)}/{int(rp.n_inliers)}, ok "
                               f"{bool(rk.ok)}/{bool(rp.ok)}, Sim3 {err:.3g}, masks differ on {flips}")
        q_err = max(q_err, err)
        ms = cuda_ms(lambda: sim3.sim3_ransac(cam, cam, *pairs, 0, fix_scale=fix, subsets=subsets), 50)
        pms = cuda_ms(lambda: sim3.sim3_ransac_plain(cam, cam, *pairs, subsets, fix_scale=fix), 10)
        q_ms, q_pms = q_ms + ms, q_pms + pms
        q_notes.append(f"fix_scale={fix}: {int(rp.n_inliers)} inliers on both, Sim3 {err:.2e}, {ms:.4f} ms (plain "
                       f"{pms:.4f})")
    # the library call: the batched SVD of the 128 Horn matrices M = yc^T xc, for both cases
    x, y = cases[False][0][1][subsets], cases[False][0][0][subsets]
    Mh = torch.einsum("hni,hnj->hij", y - y.mean(1, keepdim=True), x - x.mean(1, keepdim=True))
    lib_q = 2 * cuda_ms(lambda: torch.linalg.svd(Mh), 50)
    # per case: bytes 49 per slot and the subsets in, the Sim3, mask and flags out; operations: per
    # hypothesis Horn (centroids and M ~90, a 3x3 SVD, R, s and t ~80) and the two-sided test of every
    # valid pair (two Sim3 maps, two projections and errors, ~60), the winner's mask again
    q_ops = 2 * (h * (90 + SVD3_FLOPS + 80 + 60 * nv) + 60 * nv)
    out.append(dict(name="sim3_ransac", route="cuda", source="orb_slam3_fast_tpu_torch/csrc/sim3_ransac.cu",
                    replaces="orb_slam3_fast_tpu/optim/sim3.py:62", max_abs_err=q_err, ms=q_ms, plain_ms=q_pms,
                    **bound(2 * (n * 49 + h * 12 + 52 + n + 5), q_ops), library_ms=lib_q,
                    shapes=f"{n} slots ({nv} valid, 25% outliers), {h} subsets; " + "; ".join(q_notes) +
                           "; tolerances: count within 1, ok equal, Sim3 1e-4 (rotation entries, relative t and s), "
                           "masks differing on at most 1 pair; library = batched torch.linalg.svd of the (128,3,3) "
                           "Horn matrices, twice"))

    # R: from the RANSAC's start, with and without the scale
    r_err, r_notes, r_ms, r_pms, n_act = 0.0, [], 0.0, 0.0, 0
    for fix in (False, True):
        pairs, xi_true = cases[fix]
        S0 = sim3.sim3_ransac_plain(cam, cam, *pairs, subsets, fix_scale=fix).S12
        Sk, ik, nk = sim3.optimize_sim3(cam, cam, S0, *pairs, fix_scale=fix)
        Sp, ip, np_ = sim3.optimize_sim3_plain(cam, cam, S0, *pairs, fix_scale=fix)
        torch.cuda.synchronize()
        err = sim3_rel_err(Sk, Sp)
        flips = int((ik != ip).sum())
        if not (abs(int(nk) - int(np_)) <= 1 and err <= 2e-4 and flips <= 1):
            raise RuntimeError(f"optimize_sim3 fix_scale={fix}: inliers {int(nk)}/{int(np_)}, Sim3 {err:.3g}, "
                               f"masks differ on {flips}")
        r_err = max(r_err, err)
        n_act += int(np_)
        ms = cuda_ms(lambda: sim3.optimize_sim3(cam, cam, S0, *pairs, fix_scale=fix), 20)
        pms = cuda_ms(lambda: sim3.optimize_sim3_plain(cam, cam, S0, *pairs, fix_scale=fix), 3)
        r_ms, r_pms = r_ms + ms, r_pms + pms
        r_notes.append(f"fix_scale={fix}: {int(np_)} inliers on both, Sim3 {err:.2e}, truth within "
                       f"{sim3_rel_err(Sp, lie.sim3_exp(torch.as_tensor(xi_true).to(device))):.2e}; {ms:.4f} ms "
                       f"(plain {pms:.4f})")
    # per case: bytes 49 per slot and the start in, the Sim3 and the mask out; operations per step and
    # pair under the mask: two maps, projections and residuals (~60), both 2x7 Jacobians (~130), the
    # Huber weights (~20), J^T W J and J^T W r (2 x 2 x 35 x 2 = 280); per step the 7x7 Cholesky and
    # solves (~250), sim3_exp (~300) and an SVD; the two gates on the valid pairs (~60 each)
    step = 60 + 130 + 20 + 280
    r_ops = 15 * (step * (nv + n_act) // 2) + 2 * 15 * (250 + 300 + SVD3_FLOPS) + 2 * 2 * 60 * nv
    out.append(dict(name="sim3_refine", route="cuda", source="orb_slam3_fast_tpu_torch/csrc/sim3_refine.cu",
                    replaces="orb_slam3_fast_tpu/optim/sim3.py:134", max_abs_err=r_err, ms=r_ms, plain_ms=r_pms,
                    **bound(2 * (n * 49 + 52 + 52 + n + 4), r_ops), library_ms=None,
                    shapes=f"{n} slots ({nv} valid), 5 + 10 steps; " + "; ".join(r_notes) +
                           "; tolerances: count within 1, Sim3 2e-4 (float32 residuals summed in float64 in "
                           "another order), masks differing on at most 1 pair; no single library call"))

    # S: 12 iterations on the drifted circle's essential graph
    g_np, c_true = sim3_graph_problem(np.random.default_rng(10))
    g = pg.Sim3Graph(**{k: torch.as_tensor(v).to(device) for k, v in g_np.items()})
    Kg, Eg = g.R.shape[0], g.edge_i.shape[0]
    gk, gp = pg.optimize_sim3_graph(g), pg.optimize_sim3_graph_plain(g)
    torch.cuda.synchronize()
    if int(pg.optimize_sim3_graph.last_fail) != 0:
        raise RuntimeError("optimize_sim3_graph: the Cholesky failed on a positive definite system")
    s_err = max(float((gk[0] - gp[0]).abs().max()), float((gk[1] - gp[1]).abs().max()),
                float((gk[2] - gp[2]).abs().max()))
    centres = lambda R, t, s: (-torch.einsum("kji,kj->ki", R, t) / s[:, None]).cpu().numpy()  # noqa: E731
    ate_before = float(np.sqrt(((centres(g.R, g.t, g.s) - c_true) ** 2).sum(1).mean()))
    ate_after = float(np.sqrt(((centres(*gk) - c_true) ** 2).sum(1).mean()))
    if not (s_err <= 1e-3 and ate_after < 0.25 * ate_before):
        raise RuntimeError(f"optimize_sim3_graph: {s_err:.3g} from the plain version, centres {ate_before:.3g} -> "
                           f"{ate_after:.3g} m")
    # the library call: a Cholesky factorisation and solve of the (7K)^2 system the plain version forms
    r, Ji, Jj = pg.edge_jacobians(g.R, g.t, g.s, g)
    Hd, rhs = pg.dense_normal_system(r, Ji, Jj, g.edge_i, g.edge_j, g.edge_w, g.fixed, 1e-6)
    lib_s = cuda_ms(lambda: torch.cholesky_solve(rhs[:, None], torch.linalg.cholesky_ex(Hd)[0]), 20)
    # bytes: the vertices (52 per vertex) and edges (64 each) in, the vertices out.  Operations per
    # iteration: each edge's residual and its 14 directional derivatives (sim3_exp twice, three
    # compositions and sim3_log, ~1500 flops a direction, 15 with the value), its four 7x7 blocks and
    # two gradients (4 x 49 x 14 + 2 x 7 x 14); the (7K)^3 / 3 Cholesky and 2 (7K)^2 substitutions; per
    # vertex sim3_exp, the composition and an SVD (~700)
    nK = 7 * Kg
    s_ops = 12 * (Eg * (15 * 1500 + 4 * 49 * 14 + 2 * 7 * 14) + nK**3 / 3 + 2 * nK**2 + Kg * 700)
    out.append(dict(name="sim3_graph", route="cuda", source="orb_slam3_fast_tpu_torch/csrc/sim3_graph.cu",
                    replaces="orb_slam3_fast_tpu/optim/pose_graph.py:152", max_abs_err=s_err,
                    ms=cuda_ms(lambda: pg.optimize_sim3_graph(g), 5),
                    plain_ms=cuda_ms(lambda: pg.optimize_sim3_graph_plain(g), 2),
                    **bound(Kg * (52 + 1) + Eg * 64 + Kg * 52, s_ops), library_ms=lib_s,
                    shapes=f"K={Kg} vertices (7K = {nK}), {Eg} edges, 12 iterations: {s_err:.2e} from the plain "
                           f"version (tolerance 1e-3: float64 dual numbers against float32 forward mode), camera "
                           f"centres {ate_before:.3f} -> {ate_after:.3f} m from the truth; library = "
                           "torch.linalg.cholesky_ex + cholesky_solve of one iteration's float64 (7K)^2 system"))

    # E at the global BA's size, then T on its blocks
    gprob = gba_problem(np.random.default_rng(11), device)
    K, M, O = gprob.R.shape[0], gprob.xw.shape[0], gprob.obs_kf.shape[0]
    inl = torch.ones_like(gprob.obs_valid)
    args = (cam, 0.0, gprob.R, gprob.t, gprob.xw, gprob, inl)
    bk = ba_cg.build_blocks(*args)
    bp = ba.build_normal_blocks_plain(*args, per_obs=True)
    torch.cuda.synchronize()
    err_e = max(float((x - y).abs().max()) / max(float(y.abs().max()), 1e-12) for x, y in zip(bk, bp))
    if not err_e <= 1e-4:
        raise RuntimeError(f"ba_blocks at the global BA's size: a block differs by {err_e:.3g} of its max")
    e_gba = (f"; at the global BA's size (K={K}, M={M}, O={O}, {int(gprob.obs_valid.sum())} live observations) "
             f"{cuda_ms(lambda: ba_cg.build_blocks(*args), 20):.4f} ms, every block within {err_e:.2e} of its max "
             "(tolerance 1e-4)")
    lam = torch.tensor(1e-4, device=device)
    dk, lk = ba_cg.implicit_schur_solve(*bk[:5], gprob, bk[5], lam)
    dp, lp = ba_cg.implicit_schur_solve_plain(*bk[:5], gprob.obs_kf, gprob.obs_lm, bk[5], gprob.pose_fixed,
                                              gprob.lm_valid, lam)
    torch.cuda.synchronize()
    t_err = max(float((dk - dp).abs().max() / dp.abs().max()), float((lk - lp).abs().max() / lp.abs().max()))
    if not t_err <= 1e-4:
        raise RuntimeError(f"implicit_schur_solve: dp / dl differ by {t_err:.3g} (relative) from the plain version")
    live = gprob.obs_valid & ~gprob.pose_fixed[gprob.obs_kf.long()]
    n_live, n_lm = int(live.sum()), int(gprob.lm_valid.sum())
    n_free = int((~gprob.pose_fixed).sum())
    # bytes: the blocks (Hpp, Hll, bp, bl, w_lm), W (72 per observation), the observation and CSR
    # indices (16 per observation), the flags in once; dp and dl out.  Operations: setup per live
    # observation W V^-1 W^T and W V^-1 bl (~330), per landmark a 3x3 inverse (~60), per free pose a 6x6
    # inverse (~500); per CG iteration two passes over the live observations (36 flops each) and the
    # pose blocks (72) and vector updates (~60 per pose entry); the back-substitution (36 per observation)
    t_ops = 330 * n_live + 60 * n_lm + 500 * n_free + 32 * (72 * n_live + n_free * (72 + 360) + 15 * n_lm) \
        + 36 * n_live + 15 * n_lm
    t_bytes = K * 168 + M * 52 + O * (72 + 16) + 4 * (M + K + 2) + K + M + 4 + K * 24 + M * 12
    ms_t = cuda_ms(lambda: ba_cg.implicit_schur_solve(*bk[:5], gprob, bk[5], lam), 20)
    pms_t = cuda_ms(lambda: ba_cg.implicit_schur_solve_plain(*bk[:5], gprob.obs_kf, gprob.obs_lm, bk[5],
                                                             gprob.pose_fixed, gprob.lm_valid, lam), 3)
    # E + T: a whole bundle_adjust_cg (8 + 12 LM iterations) against the plain one
    Rk, tk, xk, ik, _ = ba_cg.bundle_adjust_cg(cam, 0.0, gprob, iters1=8, iters2=12)
    Rp, tp, xp, ip, _ = ba_cg.bundle_adjust_cg_plain(cam, 0.0, gprob, iters1=8, iters2=12)
    torch.cuda.synchronize()
    err_gba = max(float((tk - tp).abs().max()), float((Rk - Rp).abs().max()))
    flips = float((ik != ip).float().mean())
    if not (err_gba <= 1e-3 and flips <= 0.005):
        raise RuntimeError(f"bundle_adjust_cg: pose err {err_gba:.3g}, inlier flags differing {flips:.4f}")
    gba_ms = cuda_ms(lambda: ba_cg.bundle_adjust_cg(cam, 0.0, gprob, iters1=8, iters2=12), 2)
    gba_plain_ms = cuda_ms(lambda: ba_cg.bundle_adjust_cg_plain(cam, 0.0, gprob, iters1=8, iters2=12), 1)
    out.append(dict(name="ba_pcg", route="cuda", source="orb_slam3_fast_tpu_torch/csrc/ba_pcg.cu",
                    replaces="orb_slam3_fast_tpu/optim/ba_cg.py:81", max_abs_err=t_err, ms=ms_t, plain_ms=pms_t,
                    **bound(t_bytes, t_ops), library_ms=None,
                    shapes=f"K={K} ({n_free} free), M={M} ({n_lm} live), O={O} ({n_live} live of free poses), 32 "
                           f"CG iterations in {3 + 3 * 32 + 1} launches: dp / dl within {t_err:.2e} of the plain "
                           "float64 version (relative to their max, tolerance 1e-4); bundle_adjust_cg 8+12 LM via "
                           f"E+T {gba_ms:.3f} ms (plain {gba_plain_ms:.3f}), pose err {err_gba:.3g} (tolerance 1e-3), "
                           f"inlier flags differing {flips:.4f} (tolerance 0.005); no single library call", e_gba=e_gba))
    return out


def _render_circle(i: int) -> np.ndarray:
    """Frame i of the loop scenario (run in a worker process)."""
    from orb_slam3_fast_tpu_torch.cameras.models import Camera

    world = make_ring_world(np.random.default_rng(0))
    R, t = circle_trajectory(LOOP_FRAMES, radius=4.0, frac=1.12)[i]
    return render(world, Camera.pinhole(400.0, 400.0, 320.0, 240.0), R, t)


def loop_frames():
    """The loop scenario's input: tests/test_loop_closing.py's circle
    (make_ring_world(seed 0), circle_trajectory(150, radius=4.0,
    frac=1.12)), rendered on the host by one worker process per core;
    returns (images, true T_cw per frame)."""
    import multiprocessing
    import os
    from concurrent.futures import ProcessPoolExecutor

    with ProcessPoolExecutor(max(1, min(8, os.cpu_count() or 1)), mp_context=multiprocessing.get_context("spawn")) as ex:
        frames = list(ex.map(_render_circle, range(LOOP_FRAMES)))
    return frames, circle_trajectory(LOOP_FRAMES, radius=4.0, frac=1.12)


def run_loop(frames, poses, device, blackout=()):
    """The monocular System with loop closing and the Atlas
    (configs/synthetic_mono.yaml, min_init_matches 60, motion_radius 25,
    256 keyframes, LoopCloserConfig(min_covis_edge=30, temporal_gap=15)) on
    the circle.  Without ``blackout``, tests/test_loop_closing.py:60-65's
    gates: final state OK, > 120 frames tracked, >= 1 loop closed,
    scale-aligned ATE < 0.20 m.  With it (black frames there and
    max_recently_lost 6, tests/test_atlas.py:34-79), that test's gates: >= 2
    maps, >= 1 merge, final state OK, > 100 frames OK, the scale-aligned ATE
    of ``trajectory_world()`` < 0.5.  The global BAs are wrapped to count the
    launches of kernels F and T inside them.  Returns the System, a summary
    and the per-frame (state, R, t)."""
    from orb_slam3_fast_tpu_torch.backend.loopcloser import LoopCloserConfig
    from orb_slam3_fast_tpu_torch.eval import ate
    from orb_slam3_fast_tpu_torch.optim import ba, ba_cg
    from orb_slam3_fast_tpu_torch.slam.system import System

    overrides = dict(min_init_matches=60, motion_radius=25.0)
    if len(blackout):
        overrides["max_recently_lost"] = 6
    slam = System(MONO_CONFIG, "monocular", tracker_overrides=overrides, max_keyframes=256, enable_loop_closing=True,
                  multi_map=True, async_backend=False, device=device)
    slam.loopcloser.cfg = LoopCloserConfig(**LOOP_CONFIG)
    gba_launches = {"F": 0, "T": 0, "gba": 0}
    run_gba = slam.mapper._run_gba

    def counted_gba(*a, **kw):
        f0, t0 = ba.schur_solve.launches, ba_cg.implicit_schur_solve.launches
        done = run_gba(*a, **kw)
        gba_launches["F"] += ba.schur_solve.launches - f0
        gba_launches["T"] += ba_cg.implicit_schur_solve.launches - t0
        gba_launches["gba"] += 1
        return done

    slam.mapper._run_gba = counted_gba
    black = np.zeros((480, 640), np.float32)
    est, gt, ts, track, max_maps, gt_by_ts, closed_at = [], [], [], [], 1, {}, []
    for i, (img, (R, t)) in enumerate(zip(frames, poses)):
        n_closed = slam.loopcloser.n_loops_closed + slam.loopcloser.n_maps_merged
        state, pose = slam.track_monocular(black if i in blackout else img, i * 0.05)
        if slam.loopcloser.n_loops_closed + slam.loopcloser.n_maps_merged > n_closed:
            closed_at.append(i)
        if pose is None:
            pose = (np.eye(3, dtype=np.float32), np.zeros(3, np.float32))
        track.append((state, *pose))
        max_maps = max(max_maps, len(slam.atlas.maps))
        if state == "OK" and i not in blackout:
            est.append(-pose[0].T @ pose[1])
            gt.append(-R.T @ t)
            ts.append(i * 0.05)
            gt_by_ts[round(i * 0.05, 4)] = gt[-1]
    if device.type == "cuda":
        torch.cuda.synchronize()
    if len(blackout):  # the saved trajectory, through the merged keyframe poses
        est, gt, ts = [], [], []
        for tsv, R, t, ok in slam.tracker.trajectory_world():
            if ok and round(tsv, 4) in gt_by_ts:
                est.append(-R.T @ t)
                gt.append(gt_by_ts[round(tsv, 4)])
                ts.append(tsv)
    est, gt, ts = np.asarray(est), np.asarray(gt), np.asarray(ts)
    rmse, _, s_fit = ate.ate_rmse(ts, est, ts, gt, with_scale=True)
    lc = slam.loopcloser
    summary = dict(state=slam.get_tracking_state(), tracked=len(gt_by_ts), ate_m=rmse, scale=s_fit,
                   n_kf=slam.tracker.world.n_kf, landmarks=int(slam.tracker.world.lm_valid.sum()),
                   loops=lc.n_loops_closed, merges=lc.n_maps_merged, closed_at=closed_at, maps=max_maps,
                   gba=gba_launches["gba"],
                   gba_launches_F=gba_launches["F"], gba_launches_T=gba_launches["T"])
    if len(blackout):
        ok = summary["maps"] >= 2 and summary["merges"] >= 1 and summary["tracked"] > 100 and rmse < 0.5
    else:
        ok = summary["tracked"] > 120 and summary["loops"] >= 1 and rmse < 0.20
    if not (ok and summary["state"] == "OK"):
        raise RuntimeError(f"{'Atlas' if len(blackout) else 'loop'} scenario gates failed: {summary}")
    return slam, summary, track


def run_mono(frames, poses, device):
    """The monocular System (configs/synthetic_mono.yaml, min_init_matches
    60 as tests/test_slam_e2e.py:17) on its corridor, and that test's gates
    (tests/test_slam_e2e.py:42-49): final state OK, > 30 of 40 frames
    tracked, >= 3 keyframes, > 200 live landmarks, scale-aligned ATE <
    0.15 m.  Returns the System, a summary dict and the per-frame (state, R,
    t), identity before initialisation."""
    from orb_slam3_fast_tpu_torch.eval import ate
    from orb_slam3_fast_tpu_torch.slam.system import System

    slam = System(MONO_CONFIG, "monocular", tracker_overrides=dict(min_init_matches=60), max_keyframes=256,
                  enable_loop_closing=False, multi_map=False, async_backend=False, device=device)
    est, gt, ts, track, kf_frames, init_frame = [], [], [], [], [], None
    for i, (img, (R, t)) in enumerate(zip(frames, poses)):
        n_kf = slam.world.n_kf
        state, pose = slam.track_monocular(img, i * 0.05)
        if pose is None:
            pose = (np.eye(3, dtype=np.float32), np.zeros(3, np.float32))
        track.append((state, *pose))
        if slam.world.n_kf > n_kf:
            kf_frames.append(i)
        if state == "OK":
            init_frame = i if init_frame is None else init_frame
            est.append(-pose[0].T @ pose[1])
            gt.append(-R.T @ t)
            ts.append(i * 0.05)
    if device.type == "cuda":
        torch.cuda.synchronize()
    est, gt, ts = np.asarray(est), np.asarray(gt), np.asarray(ts)
    rmse, _, s_fit = ate.ate_rmse(ts, est, ts, gt, with_scale=True)
    summary = dict(state=slam.get_tracking_state(), tracked=len(est), ate_m=rmse, scale=s_fit, n_kf=slam.world.n_kf,
                   landmarks=int(slam.world.lm_valid.sum()), init_frame=init_frame, kf_frames=kf_frames,
                   local_ba=slam.mapper.n_local_ba, indexed=int(slam.kfdb.valid.sum()))
    if not (summary["state"] == "OK" and summary["tracked"] > int(len(frames) * 30 / 40) and summary["n_kf"] >= 3
            and summary["landmarks"] > 200 and rmse < 0.15):
        raise RuntimeError(f"mono System gates failed: {summary}")
    return slam, summary, track


def run_reloc(frames, poses, device):
    """tests/test_reloc.py's scenario on the mono System: 30 frames, every
    keyframe indexed, 3 blank frames -> RECENTLY_LOST, then frame 20 again
    -> OK, the camera centre within 0.5 of frame 20's (the test's scale
    bound).  Returns (per-frame (state, R, t), the relocalised frame's
    track_total ms, summary)."""
    from orb_slam3_fast_tpu_torch.slam.system import System

    slam = System(MONO_CONFIG, "monocular", tracker_overrides=dict(min_init_matches=60), max_keyframes=256,
                  enable_loop_closing=False, multi_map=False, async_backend=False, device=device)
    track = []
    for i in range(RELOC_FRAMES):
        track.append(slam.track_monocular(frames[i], i * 0.05))
    if not (slam.get_tracking_state() == "OK" and int(slam.kfdb.valid.sum()) == slam.world.n_kf):
        raise RuntimeError(f"reloc: state {slam.get_tracking_state()}, {int(slam.kfdb.valid.sum())} indexed of "
                           f"{slam.world.n_kf} keyframes")
    last_R, last_t = track[-1][1]
    pose_before = -last_R.T @ last_t
    blank = np.full((480, 640), 25.0, np.float32)
    for j in range(3):
        track.append(slam.track_monocular(blank, (RELOC_FRAMES + j) * 0.05))
    if slam.get_tracking_state() != "RECENTLY_LOST":
        raise RuntimeError(f"reloc: {slam.get_tracking_state()} after the blank frames")
    state, pose = slam.track_monocular(frames[RELOC_REVISIT], (RELOC_FRAMES + 4) * 0.05)
    track.append((state, pose))
    reloc_ms = slam.timers.spans["track_total"][-1]
    if state != "OK":
        raise RuntimeError("reloc: relocalisation failed")
    R20, t20 = poses[RELOC_REVISIT]
    R29, t29 = poses[RELOC_FRAMES - 1]
    c_gt = -R20.T @ t20 * np.linalg.norm(pose_before) / max(np.linalg.norm(-R29.T @ t29), 1e-9)
    err = float(np.linalg.norm(-pose[0].T @ pose[1] - c_gt))
    if err >= 0.5:
        raise RuntimeError(f"reloc: relocalised pose off by {err:.3f} (bound 0.5)")
    track = [(s, *(p if p is not None else (np.eye(3, dtype=np.float32), np.zeros(3, np.float32))))
             for s, p in track]
    return track, reloc_ms, dict(n_kf=slam.world.n_kf, landmarks=int(slam.world.lm_valid.sum()), err=err,
                                 ref_kf=slam.tracker.ref_kf)


def corridor_frames(n_frames: int):
    """The System phase's input: test_slam_e2e.py's stereo corridor (seed 1,
    900 splats, arc_trajectory(step=0.06, lateral=0.05), 0.12 m baseline),
    rendered on the host; returns (frames, true T_cw per frame)."""
    from orb_slam3_fast_tpu_torch.cameras.models import Camera

    cam = Camera.pinhole(400.0, 400.0, 320.0, 240.0)
    world = make_corridor_world(np.random.default_rng(1), n=900)
    poses = arc_trajectory(n_frames, step=0.06, lateral=0.05)
    return [stereo_pair(world, cam, R, t, 0.12) for R, t in poses], poses


def rgbd_settings():
    """configs/synthetic_stereo.yaml loaded for RGB-D, bf replaced by the
    RGB-D test's virtual baseline (there is no RGB-D configuration file)."""
    import dataclasses

    from orb_slam3_fast_tpu_torch.slam.settings import Settings

    return dataclasses.replace(Settings.from_yaml(SYS_CONFIG, "rgbd"), bf=RGBD_BF)


def rgbd_frames(n_frames: int):
    """The RGB-D phase's input: test_slam_e2e.py's RGB-D corridor (seed 2,
    900 splats, arc_trajectory(step=0.06, lateral=0.05)), image and splat
    depth rendered on the host; returns (frames, true T_cw per frame)."""
    from orb_slam3_fast_tpu_torch.cameras.models import Camera

    cam = Camera.pinhole(400.0, 400.0, 320.0, 240.0)
    world = make_corridor_world(np.random.default_rng(2), n=900)
    poses = arc_trajectory(n_frames, step=0.06, lateral=0.05)
    return [(render(world, cam, R, t), splat_depth(world, cam, R, t)) for R, t in poses], poses


def run_system(frames, poses, device, sensor: str = "stereo"):
    """The stereo or RGB-D System on its corridor, as test_slam_e2e.py
    drives the JAX tracker, and that test's gates.  Stereo: final state OK,
    > 25 of 30 frames tracked, unscaled ATE < 0.10 m, |scale - 1| < 0.1,
    and mapping (>= 3 keyframes, a local BA, triangulated landmarks).
    RGB-D: final state OK, > 20 of 25 frames tracked, unscaled ATE < 0.40
    m, and at least the keyframes and local BAs of the JAX package on the
    same frames.  Returns the System, a summary dict and the per-frame
    (state, R, t)."""
    from orb_slam3_fast_tpu_torch.eval import ate
    from orb_slam3_fast_tpu_torch.slam.system import System

    opts = dict(enable_loop_closing=False, multi_map=False, async_backend=False, device=device)
    if sensor == "stereo":
        slam = System(SYS_CONFIG, "stereo", **opts)
        feed = slam.track_stereo
    else:
        slam = System(rgbd_settings(), "rgbd", **opts)
        feed = slam.track_rgbd
    est, gt, ts, track, kf_frames = [], [], [], [], []
    for i, (f, (R, t)) in enumerate(zip(frames, poses)):
        n_kf = slam.world.n_kf
        state, pose = feed(*f, i * 0.05)
        track.append((state, *pose))
        if slam.world.n_kf > n_kf:
            kf_frames.append(i)
        if state == "OK" and pose is not None:
            est.append(-pose[0].T @ pose[1])
            gt.append(-R.T @ t)
            ts.append(i * 0.05)
    if device.type == "cuda":
        torch.cuda.synchronize()
    est, gt, ts = np.asarray(est), np.asarray(gt), np.asarray(ts)
    rmse, _, _ = ate.ate_rmse(ts, est, ts, gt, with_scale=False)
    _, _, s_fit = ate.ate_rmse(ts, est, ts, gt, with_scale=True)
    summary = dict(state=slam.get_tracking_state(), tracked=len(est), ate_m=rmse, scale=s_fit, n_kf=slam.world.n_kf,
                   landmarks=int(slam.world.lm_valid.sum()), local_ba=slam.mapper.n_local_ba,
                   triangulated=slam.mapper.n_triangulated, kf_frames=kf_frames)
    if sensor == "stereo":
        ok = (summary["tracked"] > int(len(frames) * 25 / 30) and rmse < 0.10 and abs(s_fit - 1) < 0.1
              and summary["n_kf"] >= 3 and summary["local_ba"] >= 1 and summary["triangulated"] > 0)
    else:
        ok = (summary["tracked"] > int(len(frames) * 20 / 25) and rmse < 0.40 and summary["n_kf"] >= RGBD_MIN_KF
              and summary["local_ba"] >= RGBD_MIN_BA)
    if not (ok and summary["state"] == "OK"):
        raise RuntimeError(f"{sensor} System gates failed: {summary}")
    return slam, summary, track


def compare_tracks(track_c, track_p, bound_dt: float = TRACK_DT, bound_dr: float = TRACK_DR) -> tuple[list[str], str]:
    """Per-frame (state, R, t) of a run on the card against the same run with
    the plain versions on the host, at the whole-path tests' tolerances: the
    same state, t within ``TRACK_DT`` and rotation entries within
    ``TRACK_DR`` (the loop path: ``LOOP_DT``, ``LOOP_DR``).  Every kernel
    sums in a fixed order, so a run on the card repeats exactly
    (``track_spread.py`` measures it; PERF.md).  Returns
    (failures, summary)."""
    bad, dt, dr = [], [], []
    for i, ((sc, Rc, tc), (sp, Rp, tp)) in enumerate(zip(track_c, track_p)):
        dt.append(float(np.abs(tc - tp).max()))
        dr.append(float(np.abs(Rc - Rp).max()))
        if sc != sp or dt[-1] > bound_dt or dr[-1] > bound_dr:
            bad.append(f"frame {i}: card {sc} {tc} vs plain {sp} {tp}, |dR| {dr[-1]:.3g}")
    over = [i for i, (a, b) in enumerate(zip(dt, dr)) if a > TRACK_DT or b > TRACK_DR]
    return bad, (f"{len(track_c)} frames, max |dt| {max(dt):.3g} at frame {int(np.argmax(dt))} (bound {bound_dt:g}), "
                 f"max |dR| {max(dr):.3g} (bound {bound_dr:g}); {len(over)} frames beyond {TRACK_DT:g} / "
                 f"{TRACK_DR:g}" + (f" (frames {over[0]}-{over[-1]})" if over else ""))


def check_system_against_plain(card, plain, bound_dt: float = TRACK_DT,
                               bound_dr: float = TRACK_DR) -> tuple[list[str], str]:
    """A System on the card against its run with the plain versions on the
    host (the path the tests hold against the JAX package): the frames as
    ``compare_tracks`` holds them, the same keyframe count, live landmarks
    within 3%, and a loop closed at the same frames.  Returns (failures,
    summary)."""
    (slam_c, sum_c, track_c), (slam_p, sum_p, track_p) = card, plain
    bad, summary = compare_tracks(track_c, track_p, bound_dt, bound_dr)
    if sum_c["n_kf"] != sum_p["n_kf"] or abs(sum_c["landmarks"] - sum_p["landmarks"]) > 0.03 * sum_p["landmarks"] \
            or sum_c.get("closed_at") != sum_p.get("closed_at"):
        bad.append(f"map: card {sum_c} vs plain {sum_p}")
    return bad, (f"{summary}; keyframes {sum_c['n_kf']} / {sum_p['n_kf']}, landmarks {sum_c['landmarks']} / "
                 f"{sum_p['landmarks']}")


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


WRAPPER_NAMES = ("fast_nms", "orb_describe", "hamming_best2", "pose_lm", "ba_blocks", "ba_schur", "triangulate_dlt",
                 "pyramid_blur", "select_subpixel", "stereo_subpixel_refine", "visible_landmarks", "twoview_ransac",
                 "vocab_transform", "pnp_ransac", "sim3_ransac", "sim3_refine", "sim3_graph", "ba_pcg")
SYSTEM_KERNELS = WRAPPER_NAMES[:11]  # the stereo System runs A-L, N to index its keyframes, and not M or P
STEP_KERNELS = ("fast_nms", "orb_describe", "hamming_best2", "pose_lm", "pyramid_blur", "select_subpixel",
                "stereo_subpixel_refine", "visible_landmarks")
# the RGB-D path runs every kernel but J; G only where triangulation finds
# matches, which the RGB-D gates do not require
RGBD_KERNELS = ("fast_nms", "orb_describe", "hamming_best2", "pose_lm", "ba_blocks", "ba_schur", "pyramid_blur",
                "select_subpixel", "visible_landmarks", "vocab_transform")
# mono: no stereo match (J) and no PnP unless lost; relocalisation: PnP and the BoW of the lost frame
MONO_KERNELS = ("fast_nms", "orb_describe", "hamming_best2", "pose_lm", "ba_blocks", "ba_schur", "triangulate_dlt",
                "pyramid_blur", "select_subpixel", "visible_landmarks", "twoview_ransac", "vocab_transform")
RELOC_KERNELS = MONO_KERNELS + ("pnp_ransac",)
# loop closing: Q, R, S, T on top of the mono path (E in every BA, N for the queries and the keyframes)
LOOP_KERNELS = MONO_KERNELS + ("sim3_ransac", "sim3_refine", "sim3_graph", "ba_pcg")


def wrappers() -> dict:
    """Each kernel's wrapper, by the kernel's name."""
    from orb_slam3_fast_tpu_torch.frontend import tracker as trk
    from orb_slam3_fast_tpu_torch.ops import extractor as ext
    from orb_slam3_fast_tpu_torch.ops import fast, image
    from orb_slam3_fast_tpu_torch.ops import hamming as ham
    from orb_slam3_fast_tpu_torch.ops import matching as mat
    from orb_slam3_fast_tpu_torch.ops import twoview
    from orb_slam3_fast_tpu_torch.optim import ba, ba_cg, pnp, pose_opt, sim3
    from orb_slam3_fast_tpu_torch.optim import pose_graph as pg
    from orb_slam3_fast_tpu_torch.vocab import vocabulary as voc_mod

    return dict(zip(WRAPPER_NAMES, (fast.fast_nms, ext.orb_describe, ham.hamming_best2, pose_opt.pose_optimization,
                                    ba.build_normal_blocks, ba.schur_solve, twoview.triangulate_dlt,
                                    image.pyramid_blur, ext.select_subpixel, mat.stereo_subpixel_refine,
                                    trk.visible_landmarks, twoview.reconstruct, voc_mod.transform,
                                    pnp.pnp_ransac, sim3.sim3_ransac, sim3.optimize_sim3, pg.optimize_sim3_graph,
                                    ba_cg.implicit_schur_solve)))


def reset_counts() -> None:
    from orb_slam3_fast_tpu_torch.ops import hamming as ham

    for w in wrappers().values():
        w.launches = 0
    ham.hamming_best2.mode_launches = [0, 0, 0, 0]


def read_counts() -> dict:
    from orb_slam3_fast_tpu_torch.ops import hamming as ham

    counts = {name: w.launches for name, w in wrappers().items()}
    counts.update({f"hamming_best2[{m}]": n for m, n in zip(ham.MODE_NAMES, ham.hamming_best2.mode_launches)})
    return counts


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
    log(f"build: {time.perf_counter() - t0:.1f} s (one nvcc per source, in parallel; {' '.join(_kernels.NVCC_FLAGS)})")
    for line in nvcc_out.splitlines():
        if line.startswith("==") or "registers" in line or ("spill" in line and "0 bytes spill" not in line):
            log(f"  ptxas {line.strip()}")
    from orb_slam3_fast_tpu_torch import native

    t0 = time.perf_counter()
    host_lib = native.get_lib()  # built at first use otherwise: inside the System's first tracked frame
    log(f"host map library: {'g++, loaded' if host_lib else 'unavailable, numpy fallback'} "
        f"in {time.perf_counter() - t0:.1f} s")

    # 3. each kernel against its plain version
    t0 = time.perf_counter()
    kernels = compare_kernels(device)
    system_kernels, c_modes = compare_system_kernels(device)
    kernels += system_kernels + compare_mono_kernels(device) + compare_loop_kernels(device)
    e_entry, t_entry = (next(k for k in kernels if k["name"] == name) for name in ("ba_blocks", "ba_pcg"))
    e_entry["shapes"] += t_entry.pop("e_gba")
    c = next(k for k in kernels if k["name"] == "hamming_best2")
    for mode, r in c_modes.items():
        for key in ("ms", "plain_ms", "nbytes", "ops"):
            c[key] += r[key]
        c["shapes"] += (f", {mode} {r['n']}x{r['m']} {r['ms']:.4f} ms (plain {r['plain_ms']:.4f}, "
                        f"{r['accepted']} rows with a candidate)")
    c.update(bound(c.pop("nbytes"), c.pop("ops")))
    for k in kernels:
        lib = "none" if k["library_ms"] is None else f"{k['library_ms']:.4f} ms"
        log(f"kernel {k['name']}: max_abs_err {k['max_abs_err']:.3g}, {k['ms']:.4f} ms vs plain "
            f"{k['plain_ms']:.4f} ms, bound {k['bound_ms']:.5f} ms ({k['bound_by']}), library call {lib} "
            f"({k['shapes']})")
    log(f"phase 3: {time.perf_counter() - t0:.1f} s")

    # 4. the tracking step at both sizes: its path, with the launch counts
    t0 = time.perf_counter()
    rigs = [Rig(640, 480), Rig(1280, 720)]
    scenes = [setup(rig, device) for rig in rigs]
    reset_counts()
    results = {(rig.w, rig.h): track(rig, *scene, device) for rig, scene in zip(rigs, scenes)}
    step_launches = read_counts()
    for rig in rigs:
        check_sequence(rig, results[(rig.w, rig.h)])
    missing = [n for n in STEP_KERNELS if step_launches[n] < 1]
    if missing:
        raise RuntimeError(f"kernels of the step's path never launched: {missing} ({step_launches})")
    for (w, h), rows in results.items():
        ms = [r[4] for r in rows if r[4] is not None]
        log(f"step {w}x{h}: {len(rows)} frames, matches {min(r[0] for r in rows)}-{max(r[0] for r in rows)}, "
            f"inliers {min(r[1] for r in rows)}-{max(r[1] for r in rows)}, max |dt| "
            f"{max(r[2] for r in rows):.3g} m (bound {Rig(w, h).z / Rig(w, h).fx:.3g}), "
            f"step {np.mean(ms):.3f} ms mean / {np.median(ms):.3f} median over {len(ms)} frames "
            f"({1e3 / np.mean(ms):.1f} fps); per frame ms {[round(x, 3) for x in ms]}")
    log(f"launches in the step's run: {step_launches}")
    for (w, h) in results:
        split = stage_split(Rig(w, h), device)
        log(f"stages {w}x{h}: " + ", ".join(f"{k} {v:.3f}" for k, v in split.items()))
    log(f"phase 4: {time.perf_counter() - t0:.1f} s")

    # 5. the stereo System with local mapping: its path, with the launch counts
    t0 = time.perf_counter()
    frames, poses = corridor_frames(SYS_FRAMES)
    log(f"System scene: {SYS_FRAMES} stereo pairs rendered on the host in {time.perf_counter() - t0:.1f} s")
    reset_counts()
    t1 = time.perf_counter()
    card_run = run_system(frames, poses, device)
    slam, summary, _ = card_run
    sys_s = time.perf_counter() - t1
    sys_launches = read_counts()
    missing = [n for n in (*SYSTEM_KERNELS, "vocab_transform", "hamming_best2[epipolar]") if sys_launches[n] < 1]
    if missing or sys_launches["twoview_ransac"] or sys_launches["pnp_ransac"]:
        raise RuntimeError(f"the System's path: kernels never launched {missing}, or M or P launched ({sys_launches})")
    spans, mspans = slam.timers.spans, slam.mapper.timers.spans
    log(f"System: {summary}, {sys_s:.2f} s for {SYS_FRAMES} frames")
    log(f"System track_total ms per frame: {[round(x, 3) for x in spans['track_total']]}")
    log(f"System map_local_ba ms per keyframe: {[round(x, 3) for x in mspans['map_local_ba']]}")
    log("System stage means:\n" + slam.print_time_stats())
    log(f"launches in the System's run: {sys_launches}")
    log(f"phase 5: {time.perf_counter() - t0:.1f} s")

    # 6. the RGB-D System: its path, with the launch counts
    t0 = time.perf_counter()
    rgbd_in, rgbd_poses = rgbd_frames(RGBD_FRAMES)
    log(f"RGB-D scene: {RGBD_FRAMES} images and depth maps rendered on the host in {time.perf_counter() - t0:.1f} s")
    reset_counts()
    t1 = time.perf_counter()
    rgbd_run = run_system(rgbd_in, rgbd_poses, device, "rgbd")
    slam_d, summary_d, _ = rgbd_run
    rgbd_s = time.perf_counter() - t1
    rgbd_launches = read_counts()
    missing = [n for n in RGBD_KERNELS if rgbd_launches[n] < 1]
    if missing or any(rgbd_launches[n] for n in ("stereo_subpixel_refine", "twoview_ransac", "pnp_ransac")):
        raise RuntimeError(f"the RGB-D path: kernels never launched {missing}, or J, M or P launched ({rgbd_launches})")
    spans, mspans = slam_d.timers.spans, slam_d.mapper.timers.spans
    log(f"RGB-D System: {summary_d}, {rgbd_s:.2f} s for {RGBD_FRAMES} frames (gates: > 20 tracked, ATE < 0.40 m, "
        f">= {RGBD_MIN_KF} keyframes, >= {RGBD_MIN_BA} local BAs)")
    log(f"RGB-D track_total ms per frame: {[round(x, 3) for x in spans['track_total']]}")
    log(f"RGB-D map_local_ba ms per keyframe: {[round(x, 3) for x in mspans.get('map_local_ba', [])]}")
    log("RGB-D stage means:\n" + slam_d.print_time_stats())
    log(f"launches in the RGB-D System's run: {rgbd_launches}")
    log(f"phase 6: {time.perf_counter() - t0:.1f} s")

    # 7. the monocular System, then relocalisation: their paths, with the launch counts
    t0 = time.perf_counter()
    mono_in, mono_poses = mono_frames(MONO_FRAMES)
    log(f"mono scene: {MONO_FRAMES} images rendered on the host in {time.perf_counter() - t0:.1f} s")
    reset_counts()
    t1 = time.perf_counter()
    mono_run = run_mono(mono_in, mono_poses, device)
    slam_m, summary_m, _ = mono_run
    mono_s = time.perf_counter() - t1
    mono_launches = read_counts()
    missing = [n for n in (*MONO_KERNELS, "hamming_best2[window]") if mono_launches[n] < 1]
    if missing or mono_launches["vocab_transform"] < summary_m["n_kf"] or mono_launches["pnp_ransac"]:
        raise RuntimeError(f"the mono path: kernels never launched {missing}, N fewer times than keyframes, or P "
                           f"launched ({mono_launches})")
    spans, mspans = slam_m.timers.spans, slam_m.mapper.timers.spans
    log(f"mono System: {summary_m}, {mono_s:.2f} s for {MONO_FRAMES} frames (gates: final OK, > 30 tracked, >= 3 "
        "keyframes, > 200 landmarks, scale-aligned ATE < 0.15 m; the JAX tracker on the CPU: init at frame 5, 35 "
        "tracked, 16 keyframes, 926 landmarks, ATE 0.0078 m)")
    log(f"mono track_total ms per frame: {[round(x, 3) for x in spans['track_total']]}")
    log(f"mono map_local_ba ms per keyframe after initialisation: {[round(x, 3) for x in mspans.get('map_local_ba', [])]}")
    log("mono stage means:\n" + slam_m.print_time_stats())
    log(f"launches in the mono System's run: {mono_launches}")
    reset_counts()
    t1 = time.perf_counter()
    reloc_track, reloc_ms, reloc_sum = run_reloc(mono_in, mono_poses, device)
    reloc_launches = read_counts()
    missing = [n for n in RELOC_KERNELS if reloc_launches[n] < 1]
    if missing:
        raise RuntimeError(f"the relocalisation path: kernels never launched {missing} ({reloc_launches})")
    log(f"relocalisation: {reloc_sum}, the revisit of frame {RELOC_REVISIT} relocalised in {reloc_ms:.3f} ms "
        f"(track_total), {time.perf_counter() - t1:.2f} s for the scenario")
    log(f"launches in the relocalisation run: {reloc_launches}")
    log(f"phase 7: {time.perf_counter() - t0:.1f} s")

    # 9. loop closing and the Atlas on the card (run before the host replicas of phase 8, whose host
    # threads would slow it): their paths, with the launch counts
    t0 = time.perf_counter()
    loop_in, loop_poses = loop_frames()
    log(f"loop scene: {LOOP_FRAMES} images rendered on the host in {time.perf_counter() - t0:.1f} s")
    reset_counts()
    t1 = time.perf_counter()
    loop_run = run_loop(loop_in, loop_poses, device)
    slam_l, summary_l, _ = loop_run
    loop_s = time.perf_counter() - t1
    loop_launches = read_counts()
    missing = [n for n in LOOP_KERNELS if loop_launches[n] < 1]
    if missing or summary_l["gba_launches_F"] or summary_l["gba_launches_T"] < 1:
        raise RuntimeError(f"the loop path: kernels never launched {missing}, or F launched inside the global BA, or "
                           f"T not ({summary_l}, {loop_launches})")
    spans, mspans, lspans = slam_l.timers.spans, slam_l.mapper.timers.spans, slam_l.loopcloser.timers.spans
    closing = int(np.argmax(spans["track_total"]))
    log(f"loop scenario: {summary_l}, {loop_s:.2f} s for {LOOP_FRAMES} frames (gates: final OK, > 120 tracked, >= 1 "
        "loop, scale-aligned ATE < 0.20 m)")
    log(f"loop track_total ms per frame: {[round(x, 3) for x in spans['track_total']]}")
    log(f"loop-closure frame {closing}: track_total {spans['track_total'][closing]:.3f} ms; " +
        ", ".join(f"{k} {v[-1]:.3f} ms" for k, v in lspans.items() if k != "loop_detect" and k != "loop_verify") +
        f"; loop_detect {sum(lspans.get('loop_detect', [])):.3f} ms and loop_verify "
        f"{sum(lspans.get('loop_verify', [])):.3f} ms over the run ({len(lspans.get('loop_verify', []))} verifications)")
    log("loop stage means:\n" + slam_l.print_time_stats())
    log(f"launches in the loop run: {loop_launches}")
    reset_counts()
    t1 = time.perf_counter()
    _, summary_a, _ = run_loop(loop_in, loop_poses, device, blackout=ATLAS_BLACKOUT)
    atlas_launches = read_counts()
    log(f"Atlas scenario: {summary_a}, {time.perf_counter() - t1:.2f} s (gates: >= 2 maps, >= 1 merge, final OK, > 100 "
        "frames OK, ATE of trajectory_world < 0.5)")
    log(f"launches in the Atlas run: {atlas_launches}")
    log(f"phase 9: {time.perf_counter() - t0:.1f} s")

    # 8. the plain (CPU) step, which the tests hold against the JAX package,
    # agrees with the card on frame 1 at 640x480.  Last, because the host
    # threads it starts would slow the timed phases above.
    rig, cpu = Rig(640, 480), torch.device("cpu")
    rows_cpu = track(rig, *setup(rig, cpu), cpu, n_frames=2)
    m_g, n_g = results[(640, 480)][1][:2]
    m_c, n_c, et_c = rows_cpu[1][0], rows_cpu[1][1], rows_cpu[1][2]
    if abs(m_g - m_c) > 0.05 * m_c or abs(n_g - n_c) > 0.05 * n_c or et_c > rig.z / rig.fx:
        raise RuntimeError(f"card vs plain step: matches {m_g}/{m_c}, inliers {n_g}/{n_c}, cpu |dt| {et_c}")
    log(f"plain step on the host, frame 1 at 640x480: matches {m_c} (card {m_g}), inliers {n_c} (card {n_g})")
    # every path's plain host run against its card run; all are logged before any failure raises
    failures = []
    for label, card, plain_run, bounds in (
        ("stereo System", card_run, lambda: run_system(frames, poses, cpu), ()),
        ("RGB-D System", rgbd_run, lambda: run_system(rgbd_in, rgbd_poses, cpu, "rgbd"), ()),
        ("mono System", mono_run, lambda: run_mono(mono_in, mono_poses, cpu), ()),
        ("loop scenario", loop_run, lambda: run_loop(loop_in, loop_poses, cpu), (LOOP_DT, LOOP_DR)),
    ):
        t0 = time.perf_counter()
        bad, summary = check_system_against_plain(card, plain_run(), *bounds)
        log(f"plain {label} on the host against the card: {summary}, {len(bad)} failing "
            f"({time.perf_counter() - t0:.1f} s)")
        failures += [f"{label} {b}" for b in bad]
    t0 = time.perf_counter()
    plain_reloc, _, plain_reloc_sum = run_reloc(mono_in, mono_poses, cpu)
    bad, summary = compare_tracks(reloc_track, plain_reloc)
    if plain_reloc_sum["ref_kf"] != reloc_sum["ref_kf"]:
        bad.append(f"card {reloc_sum} vs plain {plain_reloc_sum}")
    log(f"plain relocalisation on the host against the card: {summary}; relocalisation keyframe "
        f"{reloc_sum['ref_kf']} / {plain_reloc_sum['ref_kf']}, {len(bad)} failing ({time.perf_counter() - t0:.1f} s)")
    failures += [f"relocalisation {b}" for b in bad]
    if failures:
        raise RuntimeError("card against the plain host runs:\n" + "\n".join(failures))

    # results: launches are those of the run whose path runs the kernel: the
    # stereo System for A-L, the mono System for M and N, relocalisation for
    # P; every path's beside them
    runs = {"step": step_launches, "stereo_system": sys_launches, "rgbd_system": rgbd_launches,
            "mono_system": mono_launches, "relocalisation": reloc_launches, "loop": loop_launches,
            "atlas": atlas_launches}
    main_run = {"twoview_ransac": "mono_system", "vocab_transform": "mono_system", "pnp_ransac": "relocalisation",
                "sim3_ransac": "loop", "sim3_refine": "loop", "sim3_graph": "loop", "ba_pcg": "loop"}
    for k in kernels:
        k["launches"] = runs[main_run.get(k["name"], "stereo_system")][k["name"]]
        k["launches_by_path"] = {path: counts[k["name"]] for path, counts in runs.items()}
    log(json.dumps({"kernels": [{key: k[key] for key in ("name", "route", "source", "replaces", "launches",
                                                         "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                                                         "library_ms", "launches_by_path", "shapes")}
                                for k in kernels]}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
