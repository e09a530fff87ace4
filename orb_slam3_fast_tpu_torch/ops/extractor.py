"""ORB extraction: pyramid -> FAST + NMS -> selection -> subpixel ->
intensity-centroid angle -> rotated BRIEF.

Counterpart of ``orb_slam3_fast_tpu/ops/extractor.py`` (``_extract`` and the
functions it calls).  Descriptors are packed: (N, 8) int32, bit k of the
JAX package's (N, 256) int8 row is bit k % 32 of word k // 32
(``ops.hamming.pack_desc``).  ``orb_describe`` is the wrapper of kernel B
(``csrc/orb_describe.cu``); ``orb_describe_plain`` computes the same with
``extract_patches`` + ``ic_angles_from_patches`` + ``brief_from_patches``.

Kernel B -- source note.
  Replaces: ``extract_patches`` + ``ic_angles_from_patches`` +
  ``brief_from_patches`` (``orb_slam3_fast_tpu/ops/extractor.py:297-358``),
  whose TPU form is a one-hot bf16 batched matmul standing in for a gather.
  Bound on the card: latency of scattered reads.  Per keypoint it reads
  ~800 pixels of the level image and 512 of the blurred one, and does ~3k
  flops; 1024 keypoints are 1024 warps, a few microseconds of memory
  traffic, so the kernel is launch- and latency-bound.
  Design: one warp per keypoint, launched once per image over all eight
  levels, which are passed as one flat buffer with a per-keypoint offset
  and row width.  Lane u (< 31) sums column u of the 31x31 circular patch
  into the two moments, a warp reduction gives ``atan2(m01, m10)``; then
  each lane rotates 8 of the 256 pattern pairs (no FMA contraction, round
  half to even as ``jnp.round``), clamps to the 29x29 window, rounds both
  samples to bf16 as the reference's one-hot bf16 matmul does, and a
  ``__ballot_sync`` per 32 pairs packs the bits.
"""
from __future__ import annotations

import functools
import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from orb_slam3_fast_tpu_torch import _kernels
from orb_slam3_fast_tpu_torch.ops import fast as fast_ops
from orb_slam3_fast_tpu_torch.ops import image as image_ops
from orb_slam3_fast_tpu_torch.ops.hamming import pack_desc

EDGE_BORDER = 16  # reference minBorder = EDGE_THRESHOLD - 3 (ORBextractor.cc:762)
PATCH_RADIUS = 15  # HALF_PATCH_SIZE (ORBextractor.cc:73)
BRIEF_RADIUS = 14  # |rotated pattern offset| <= 13 (+0.5 rounding) < 14
_BRIEF_PD = 2 * BRIEF_RADIUS + 1  # 29


class ExtractorConfig(NamedTuple):
    n_features: int = 1024
    n_levels: int = 8
    scale_factor: float = 1.2
    ini_th_fast: float = 20.0
    min_th_fast: float = 7.0
    cell: int = 32  # selection cell
    cand_per_cell: int = 8


class Keypoints(NamedTuple):
    """Fixed-capacity keypoint batch; coordinates in level-0 pixels."""

    xy: torch.Tensor  # (N,2) float32 [x, y]
    level: torch.Tensor  # (N,) int64
    angle: torch.Tensor  # (N,) float32 radians
    response: torch.Tensor  # (N,) float32
    desc: torch.Tensor  # (N,8) int32, packed 256-bit rotated BRIEF
    valid: torch.Tensor  # (N,) bool

    @property
    def n(self) -> int:
        return self.xy.shape[0]


def per_level_budget(n_features: int, n_levels: int, scale_factor: float) -> list[int]:
    """Geometric per-level feature budget (ORBextractor.cc:427-446)."""
    factor = 1.0 / scale_factor
    n_first = n_features * (1 - factor) / (1 - factor**n_levels)
    budget = []
    acc = 0
    for l in range(n_levels - 1):
        k = int(round(n_first * factor**l))
        budget.append(k)
        acc += k
    budget.append(max(n_features - acc, 0))
    return budget


def make_brief_pattern(seed: int = 42, n_bits: int = 256, radius: float = 13.0) -> np.ndarray:
    """(n_bits, 4) int32 [x1,y1,x2,y2], i.i.d. N(0, (2r/5)^2) clipped to the
    radius disc; the same numpy draw as the JAX package, so bit-identical."""
    rng = np.random.default_rng(seed)
    pts = np.empty((n_bits * 2, 2), dtype=np.float64)
    got = 0
    while got < n_bits * 2:
        cand = rng.normal(0.0, radius * 2 / 5, size=(n_bits * 4, 2))
        keep = cand[np.linalg.norm(cand, axis=1) <= radius]
        take = min(len(keep), n_bits * 2 - got)
        pts[got : got + take] = keep[:take]
        got += take
    p = np.round(pts).astype(np.int32)
    return np.concatenate([p[:n_bits], p[n_bits:]], axis=1)


BRIEF_PATTERN = make_brief_pattern()


def _circular_umax(radius: int = PATCH_RADIUS) -> np.ndarray:
    """Half-width of the circular patch per row (ORBextractor.cc:452-469)."""
    umax = np.zeros(radius + 1, dtype=np.int32)
    vmax = int(math.floor(radius * math.sqrt(2.0) / 2 + 1))
    vmin = int(math.ceil(radius * math.sqrt(2.0) / 2))
    for v in range(vmax + 1):
        umax[v] = int(round(math.sqrt(radius * radius - v * v)))
    v0 = 0
    for v in range(radius, vmin - 1, -1):
        while umax[v0] == umax[v0 + 1]:
            v0 += 1
        umax[v] = v0
        v0 += 1
    return umax


def _circular_mask(radius: int = PATCH_RADIUS) -> np.ndarray:
    """(2r+1, 2r+1) bool circular mask from ``_circular_umax``."""
    umax = _circular_umax(radius)
    d = 2 * radius + 1
    m = np.zeros((d, d), dtype=bool)
    for v in range(-radius, radius + 1):
        u = umax[abs(v)]
        m[v + radius, radius - u : radius + u + 1] = True
    return m


CIRC_MASK = _circular_mask()
_ys, _xs = np.mgrid[-PATCH_RADIUS : PATCH_RADIUS + 1, -PATCH_RADIUS : PATCH_RADIUS + 1]
IC_X = (_xs * CIRC_MASK).astype(np.float32)
IC_Y = (_ys * CIRC_MASK).astype(np.float32)


def _top_k(x: torch.Tensor, k: int):
    """``lax.top_k`` order: largest first, ties by the lower index."""
    v, i = torch.sort(x, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k]


def select_keypoints(score: torch.Tensor, n_target: int, cell: int, cand_per_cell: int):
    """Spatially even top-response selection: the best ``cand_per_cell`` of
    every cell, then the global best ``n_target`` under the priority
    rank * 1e6 - response.  Returns (xy (n,2) int64, resp (n,), valid (n,))."""
    h, w = score.shape
    ph, pw = (-h) % cell, (-w) % cell
    sp = F.pad(score, (0, pw, 0, ph))
    gh, gw = (h + ph) // cell, (w + pw) // cell
    cells = sp.reshape(gh, cell, gw, cell).permute(0, 2, 1, 3).reshape(gh * gw, cell * cell)
    top_v, top_i = _top_k(cells, cand_per_cell)  # (C, K)
    cid = torch.arange(gh * gw, device=score.device)[:, None]
    py = (cid // gw) * cell + top_i // cell
    px = (cid % gw) * cell + top_i % cell
    rank = torch.arange(cand_per_cell, device=score.device, dtype=torch.float32)[None, :]
    prio = rank * 1.0e6 - torch.clamp(top_v, max=0.99e6)
    prio = torch.where(top_v > 0.0, prio, torch.full_like(prio, torch.inf))
    sel_v, sel = _top_k(-prio.reshape(-1), n_target)
    xy = torch.stack([px.reshape(-1)[sel], py.reshape(-1)[sel]], dim=-1)
    return xy, top_v.reshape(-1)[sel], torch.isfinite(-sel_v)


def subpixel_refine(score: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """Parabolic offsets in [-0.5, 0.5] on the dense pre-NMS response."""
    h, w = score.shape
    x, y = xy[:, 0], xy[:, 1]
    flat = score.reshape(-1)

    def at(dy, dx):
        return flat[torch.clamp(y + dy, 0, h - 1) * w + torch.clamp(x + dx, 0, w - 1)]

    c = at(0, 0)
    xm, xp = at(0, -1), at(0, 1)
    ym, yp = at(-1, 0), at(1, 0)
    dx_den = 2.0 * c - xp - xm
    dy_den = 2.0 * c - yp - ym
    zero = torch.zeros_like(c)
    ox = torch.where(dx_den > 1e-6, 0.5 * (xp - xm) / torch.clamp(dx_den, min=1e-6), zero)
    oy = torch.where(dy_den > 1e-6, 0.5 * (yp - ym) / torch.clamp(dy_den, min=1e-6), zero)
    return torch.stack([torch.clamp(ox, -0.5, 0.5), torch.clamp(oy, -0.5, 0.5)], dim=-1)


def _flatten_levels(levels: list[torch.Tensor]):
    """One flat buffer of all levels, with per-level offsets and widths."""
    sizes = [lv.numel() for lv in levels]
    offs = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int64)
    dev = levels[0].device
    flat = torch.cat([lv.reshape(-1) for lv in levels])
    return (
        flat,
        torch.as_tensor(offs, device=dev),
        torch.as_tensor([lv.shape[1] for lv in levels], dtype=torch.int64, device=dev),
    )


def extract_patches(levels: list[torch.Tensor], xy: torch.Tensor, level: torch.Tensor, radius: int):
    """(N, 2r+1, 2r+1) square patches centred on level-local integer ``xy``
    (callers keep them ``radius`` px inside their level)."""
    flat, offs, widths = _flatten_levels(levels)
    d = 2 * radius + 1
    o = torch.arange(-radius, radius + 1, device=xy.device)
    w = widths[level][:, None, None]
    idx = offs[level][:, None, None] + (xy[:, 1, None, None] + o[None, :, None]) * w + (
        xy[:, 0, None, None] + o[None, None, :]
    )
    return flat[idx.reshape(-1)].reshape(-1, d, d)


def ic_angles_from_patches(patches: torch.Tensor) -> torch.Tensor:
    """Intensity-centroid orientation of (N,31,31) patches (IC_Angle)."""
    icx = torch.as_tensor(IC_X, device=patches.device)
    icy = torch.as_tensor(IC_Y, device=patches.device)
    m10 = torch.sum(patches * icx, dim=(1, 2))
    m01 = torch.sum(patches * icy, dim=(1, 2))
    return torch.atan2(m01, m10)


def brief_from_patches(patches: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    """Rotated BRIEF on (N,29,29) blurred patches -> (N,256) int8 in {0,1}.
    Nearest sampling of the rotated pattern; both samples are rounded to
    bf16 before the compare, as the reference's one-hot bf16 matmul does."""
    n = patches.shape[0]
    pat = torch.as_tensor(BRIEF_PATTERN, dtype=torch.float32, device=patches.device)
    ca, sa = torch.cos(angle)[:, None], torch.sin(angle)[:, None]
    x1 = pat[None, :, 0] * ca - pat[None, :, 1] * sa
    y1 = pat[None, :, 0] * sa + pat[None, :, 1] * ca
    x2 = pat[None, :, 2] * ca - pat[None, :, 3] * sa
    y2 = pat[None, :, 2] * sa + pat[None, :, 3] * ca
    ix = torch.clamp(torch.round(torch.cat([x1, x2], 1)).long() + BRIEF_RADIUS, 0, _BRIEF_PD - 1)
    iy = torch.clamp(torch.round(torch.cat([y1, y2], 1)).long() + BRIEF_RADIUS, 0, _BRIEF_PD - 1)
    v = torch.gather(patches.reshape(n, -1), 1, iy * _BRIEF_PD + ix).to(torch.bfloat16)
    return (v[:, :256] < v[:, 256:]).to(torch.int8)


def orb_describe_plain(levels, blurs, xy: torch.Tensor, level: torch.Tensor):
    """Plain version of kernel B: (angle (N,) float32, desc (N,8) int32)."""
    angle = ic_angles_from_patches(extract_patches(levels, xy, level, PATCH_RADIUS))
    bits = brief_from_patches(extract_patches(blurs, xy, level, BRIEF_RADIUS), angle)
    return angle, pack_desc(bits)


@functools.lru_cache(maxsize=8)
def _describe_consts(device: torch.device):
    pattern = torch.as_tensor(BRIEF_PATTERN, dtype=torch.int32, device=device).contiguous()
    umax = torch.as_tensor(_circular_umax(), dtype=torch.int32, device=device)
    return pattern, umax


def orb_describe(levels: list[torch.Tensor], blurs: list[torch.Tensor], xy: torch.Tensor, level: torch.Tensor):
    """Kernel B on CUDA tensors, its plain version on CPU ones.

    levels / blurs: per-level (H_l,W_l) float32 images and their blurs.
    xy: (N,2) int64 level-local keypoint coordinates, at least
    ``EDGE_BORDER`` px inside their level; level: (N,) int64.
    Returns (angle (N,) float32, desc (N,8) int32).
    """
    if xy.device.type == "cpu":
        return orb_describe_plain(levels, blurs, xy, level)
    img_flat, offs, widths = _flatten_levels(levels)
    blur_flat, _, _ = _flatten_levels(blurs)
    kp_off = offs[level].contiguous()
    kp_w = widths[level].to(torch.int32)
    kp_xy = xy.to(torch.int32).contiguous()
    pattern, umax = _describe_consts(xy.device)
    _kernels.require_cuda(
        "orb_describe", img=(img_flat, torch.float32), blur=(blur_flat, torch.float32),
        kp_off=(kp_off, torch.int64), kp_xy=(kp_xy, torch.int32),
    )
    n = xy.shape[0]
    angle = torch.empty(n, dtype=torch.float32, device=xy.device)
    desc = torch.empty((n, 8), dtype=torch.int32, device=xy.device)
    _kernels.launch(
        "orb_describe_launch", xy.device,
        img_flat.data_ptr(), blur_flat.data_ptr(), kp_off.data_ptr(), kp_w.data_ptr(),
        kp_xy.data_ptr(), pattern.data_ptr(), umax.data_ptr(), n,
        angle.data_ptr(), desc.data_ptr(),
    )
    orb_describe.launches += 1
    return angle, desc


orb_describe.launches = 0


def total_capacity(cfg: ExtractorConfig) -> int:
    return sum(per_level_budget(cfg.n_features, cfg.n_levels, cfg.scale_factor))


def slot_levels(cfg: ExtractorConfig) -> np.ndarray:
    """Per-slot pyramid level: budgets[l] slots per level, in level order."""
    budgets = per_level_budget(cfg.n_features, cfg.n_levels, cfg.scale_factor)
    return np.concatenate([np.full(n, l, dtype=np.int32) for l, n in enumerate(budgets)])


def slot_scales(cfg: ExtractorConfig) -> np.ndarray:
    """Per-slot scale factor sf**level."""
    return (cfg.scale_factor ** slot_levels(cfg).astype(np.float32)).astype(np.float32)


BASE_SIGMA = 1.0  # px at level 0 (reference mvLevelSigma2 convention)


def level_sigma2(cfg: ExtractorConfig) -> np.ndarray:
    """Per-level keypoint variance (reference mvLevelSigma2) for chi2 gates."""
    return (BASE_SIGMA**2 * cfg.scale_factor ** (2.0 * np.arange(cfg.n_levels))).astype(np.float32)


@functools.lru_cache(maxsize=8)
def _slot_consts(cfg: ExtractorConfig, device: torch.device):
    return (
        torch.as_tensor(slot_levels(cfg), dtype=torch.int64, device=device),
        torch.as_tensor(slot_scales(cfg), device=device),
    )


def extract(img: torch.Tensor, cfg: ExtractorConfig = ExtractorConfig()) -> Keypoints:
    """ORB extraction on one (H,W) float32 image in [0, 255].

    Dense stages run per level (kernel A for FAST + NMS); the keypoint
    stages run once over all levels (kernel B for angle + BRIEF).
    """
    levels = image_ops.build_pyramid(img, cfg.n_levels, cfg.scale_factor)
    budgets = per_level_budget(cfg.n_features, cfg.n_levels, cfg.scale_factor)
    xy_parts, resp_parts, valid_parts, sub_parts, blurs = [], [], [], [], []
    for lvl_img, n_l in zip(levels, budgets):
        h, w = lvl_img.shape
        score_raw_inb, score = fast_ops.fast_nms(lvl_img, cfg.ini_th_fast, cfg.min_th_fast, EDGE_BORDER)
        xy, resp, valid = select_keypoints(score, n_l, cfg.cell, cfg.cand_per_cell)
        # clamp invalid / padded selections into the border-safe interior
        xyq = torch.stack(
            [
                torch.clamp(xy[:, 0], EDGE_BORDER, w - EDGE_BORDER - 1),
                torch.clamp(xy[:, 1], EDGE_BORDER, h - EDGE_BORDER - 1),
            ],
            dim=1,
        )
        sub_parts.append(subpixel_refine(score_raw_inb, xyq))
        blurs.append(image_ops.gaussian_blur(lvl_img))
        xy_parts.append(xyq)
        resp_parts.append(resp)
        valid_parts.append(valid)
    xy_all = torch.cat(xy_parts)
    level, k_scale = _slot_consts(cfg, img.device)
    angle, desc = orb_describe(levels, blurs, xy_all, level)
    return Keypoints(
        xy=(xy_all.to(torch.float32) + torch.cat(sub_parts)) * k_scale[:, None],
        level=level,
        angle=angle,
        response=torch.cat(resp_parts),
        desc=desc,
        valid=torch.cat(valid_parts),
    )
