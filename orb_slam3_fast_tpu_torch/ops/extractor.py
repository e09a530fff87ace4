"""ORB extraction: pyramid -> FAST + NMS -> selection -> subpixel ->
intensity-centroid angle -> rotated BRIEF.

Counterpart of ``orb_slam3_fast_tpu/ops/extractor.py`` (``_extract`` and the
functions it calls).  Descriptors are packed: (N, 8) int32, bit k of the
JAX package's (N, 256) int8 row is bit k % 32 of word k // 32
(``ops.hamming.pack_desc``).  ``extract`` runs kernel H
(``ops.image.pyramid_blur``), kernel A per level, kernel I and kernel B on
one set of flat per-image buffers; ``extract_plain`` runs their plain
versions.  ``select_subpixel`` is the wrapper of kernel I
(``csrc/select_subpixel.cu``), ``select_subpixel_plain`` computes the same
with ``select_keypoints`` + ``subpixel_refine``; ``orb_describe`` is the
wrapper of kernel B (``csrc/orb_describe.cu``), ``orb_describe_plain``
computes the same with ``extract_patches`` + ``ic_angles_from_patches`` +
``brief_from_patches``.

Kernel I -- source note.
  Replaces: ``select_keypoints`` and ``subpixel_refine``
  (``orb_slam3_fast_tpu/ops/extractor.py:140-207``), per level a cell
  top-k, a global top-k and five gathers: ~35 PyTorch operations a level
  in the plain version, with sorts.
  Bound on the card: latency of the level sort.  The bytes are the NMS
  maps read once (3.8 MB at 640x480) and ~40 bytes per slot, ~1 us; the
  work is 8 compares per pixel and a sort of each level's candidates.
  Design: two launches per image over all levels.  (1) One 256-thread CTA
  per 32x32 cell of any level keeps 4 pixels a thread in registers as
  64-bit keys (value, 1023 - in-cell index), a total order, so K rounds of
  a block-wide max give ``lax.top_k``'s best K with its tie rule.  (2) One
  1024-thread CTA per level sorts its cells' candidates on (ordered
  priority, flat index) with a bitonic sort in shared memory (up to 8,192
  keys, 64 KB), takes the first n_l, clamps them into the descriptor
  border and fits the parabolic offsets on the dense pre-NMS map in the
  plain version's operation order (no FMA), so the output equals the plain
  version's, invalid slots (priority +inf) included.

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


def select_subpixel_plain(nms: torch.Tensor, raw: torch.Tensor, shapes, offsets, cfg: ExtractorConfig):
    """Plain version of kernel I: per level, ``select_keypoints`` on the NMS
    map, the selection clamped into the descriptor border and
    ``subpixel_refine`` on the dense pre-NMS map.  ``nms`` / ``raw`` are flat
    buffers of all levels (kernel H's layout).  Returns, in slot order,
    (level-local xy (N,2) int32, level-0 subpixel xy (N,2) float32,
    response (N,), valid (N,))."""
    budgets = per_level_budget(cfg.n_features, cfg.n_levels, cfg.scale_factor)
    xy_parts, sub_parts, resp_parts, valid_parts = [], [], [], []
    for score, score_raw, n_l in zip(image_ops.level_views(nms, shapes, offsets),
                                     image_ops.level_views(raw, shapes, offsets), budgets):
        h, w = score.shape
        xy, resp, valid = select_keypoints(score, n_l, cfg.cell, cfg.cand_per_cell)
        # clamp invalid / padded selections into the border-safe interior
        xyq = torch.stack(
            [
                torch.clamp(xy[:, 0], EDGE_BORDER, w - EDGE_BORDER - 1),
                torch.clamp(xy[:, 1], EDGE_BORDER, h - EDGE_BORDER - 1),
            ],
            dim=1,
        )
        sub_parts.append(subpixel_refine(score_raw, xyq))
        xy_parts.append(xyq)
        resp_parts.append(resp)
        valid_parts.append(valid)
    xy_lvl = torch.cat(xy_parts)
    k_scale = torch.as_tensor(slot_scales(cfg), device=nms.device)
    xy = (xy_lvl.to(torch.float32) + torch.cat(sub_parts)) * k_scale[:, None]
    return xy_lvl.to(torch.int32), xy, torch.cat(resp_parts), torch.cat(valid_parts)


@functools.lru_cache(maxsize=16)
def _select_host(shapes, offsets, cfg: ExtractorConfig):
    """Host arrays of kernel I's level table (kept alive by the cache while
    their pointers are in use) and its scratch size."""
    budgets = per_level_budget(cfg.n_features, cfg.n_levels, cfg.scale_factor)
    scales = cfg.scale_factor ** np.arange(cfg.n_levels)
    level_scale = np.asarray([slot_scales(cfg)[sum(budgets[:l])] if budgets[l] else scales[l]
                              for l in range(cfg.n_levels)], np.float32)
    cells = sum(-(-h // cfg.cell) * -(-w // cfg.cell) for h, w in shapes)
    cand = [-(-h // cfg.cell) * -(-w // cfg.cell) * cfg.cand_per_cell for h, w in shapes]
    return (np.asarray(shapes, np.int32).reshape(-1), np.asarray(offsets, np.int64), np.asarray(budgets, np.int32),
            level_scale, cells, cand, sum(budgets))


SELECT_MAX_CANDIDATES = 16384  # one level's cells x candidates, sorted in one CTA's shared memory (128 KB)


def select_subpixel(nms: torch.Tensor, raw: torch.Tensor, shapes, offsets, cfg: ExtractorConfig):
    """Kernel I on CUDA tensors, its plain version on CPU ones: the
    selection and subpixel refinement of every level of one image, from
    kernel A's flat NMS and pre-NMS maps.  ``shapes`` / ``offsets``: the
    ``image.pyramid_layout``.  Returns (level-local xy (N,2) int32, level-0
    subpixel xy (N,2) float32, response (N,), valid (N,) bool)."""
    if nms.device.type == "cpu":
        return select_subpixel_plain(nms, raw, shapes, offsets, cfg)
    _kernels.require_cuda("select_subpixel", nms=(nms, torch.float32), raw=(raw, torch.float32))
    if cfg.cell != fast_ops.FALLBACK_CELL:
        raise ValueError(f"select_subpixel: the kernel takes {fast_ops.FALLBACK_CELL}-px cells, got {cfg.cell}")
    hw, offs, budgets, level_scale, cells, cand, n = _select_host(tuple(shapes), tuple(offsets), cfg)
    total = sum(h * w for h, w in shapes)
    if nms.shape != (total,) or raw.shape != (total,):
        raise ValueError(f"select_subpixel: nms and raw must be flat buffers of the layout's {total} pixels")
    if max(cand) > SELECT_MAX_CANDIDATES or any(b > c for b, c in zip(budgets, cand)):
        raise ValueError(f"select_subpixel: candidates per level {cand} exceed {SELECT_MAX_CANDIDATES} or "
                         f"fall short of the budgets {budgets.tolist()}")
    dev = nms.device
    cand_v = torch.empty(cells * cfg.cand_per_cell, dtype=torch.float32, device=dev)
    cand_i = torch.empty(cells * cfg.cand_per_cell, dtype=torch.int32, device=dev)
    xy_lvl = torch.empty((n, 2), dtype=torch.int32, device=dev)
    xy = torch.empty((n, 2), dtype=torch.float32, device=dev)
    resp = torch.empty(n, dtype=torch.float32, device=dev)
    valid = torch.empty(n, dtype=torch.bool, device=dev)
    _kernels.launch(
        "select_subpixel_launch", dev,
        nms.data_ptr(), raw.data_ptr(), hw.ctypes.data, offs.ctypes.data, budgets.ctypes.data,
        level_scale.ctypes.data, cfg.n_levels, cfg.cell, cfg.cand_per_cell, EDGE_BORDER,
        cand_v.data_ptr(), cand_i.data_ptr(), xy_lvl.data_ptr(), xy.data_ptr(), resp.data_ptr(), valid.data_ptr(),
    )
    select_subpixel.launches.add()
    return xy_lvl, xy, resp, valid


select_subpixel.launches = _kernels.LaunchCounter()


def describe_inputs(levels: list[torch.Tensor], blurs: list[torch.Tensor], level: torch.Tensor):
    """``orb_describe``'s inputs from per-level images, their blurs and each
    keypoint's level: (levels flat, blurs flat, in kernel H's layout;
    per-keypoint offset of its level, per-keypoint row width)."""
    offs = np.concatenate([[0], np.cumsum([lv.numel() for lv in levels])[:-1]])
    dev = level.device
    kp_off = torch.as_tensor(offs, dtype=torch.int64, device=dev)[level].contiguous()
    kp_w = torch.as_tensor([lv.shape[1] for lv in levels], dtype=torch.int32, device=dev)[level].contiguous()
    return torch.cat([lv.reshape(-1) for lv in levels]), torch.cat([b.reshape(-1) for b in blurs]), kp_off, kp_w


def extract_patches(flat: torch.Tensor, kp_off: torch.Tensor, kp_w: torch.Tensor, xy: torch.Tensor, radius: int):
    """(N, 2r+1, 2r+1) square patches centred on level-local integer ``xy``
    of the level at ``kp_off`` (row width ``kp_w``) in a flat buffer
    (callers keep them ``radius`` px inside their level)."""
    d = 2 * radius + 1
    o = torch.arange(-radius, radius + 1, device=xy.device)
    w = kp_w.long()[:, None, None]
    xy = xy.long()
    idx = kp_off[:, None, None] + (xy[:, 1, None, None] + o[None, :, None]) * w + (
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


def orb_describe_plain(img_flat, blur_flat, kp_off, kp_w, xy: torch.Tensor):
    """Plain version of kernel B: (angle (N,) float32, desc (N,8) int32)."""
    angle = ic_angles_from_patches(extract_patches(img_flat, kp_off, kp_w, xy, PATCH_RADIUS))
    bits = brief_from_patches(extract_patches(blur_flat, kp_off, kp_w, xy, BRIEF_RADIUS), angle)
    return angle, pack_desc(bits)


@functools.lru_cache(maxsize=8)
def _describe_consts(device: torch.device):
    pattern = torch.as_tensor(BRIEF_PATTERN, dtype=torch.int32, device=device).contiguous()
    umax = torch.as_tensor(_circular_umax(), dtype=torch.int32, device=device)
    return pattern, umax


def orb_describe(img_flat: torch.Tensor, blur_flat: torch.Tensor, kp_off: torch.Tensor, kp_w: torch.Tensor,
                 xy: torch.Tensor):
    """Kernel B on CUDA tensors, its plain version on CPU ones.

    img_flat / blur_flat: every level and its blur in one flat float32
    buffer each (kernel H's layout); kp_off: (N,) int64 offset of each
    keypoint's level there; kp_w: (N,) int32 its row width; xy: (N,2) int32
    level-local keypoint coordinates, at least ``EDGE_BORDER`` px inside
    their level.  Returns (angle (N,) float32, desc (N,8) int32).
    """
    if xy.device.type == "cpu":
        return orb_describe_plain(img_flat, blur_flat, kp_off, kp_w, xy)
    kp_xy = xy.to(torch.int32).contiguous()
    pattern, umax = _describe_consts(xy.device)
    _kernels.require_cuda(
        "orb_describe", img=(img_flat, torch.float32), blur=(blur_flat, torch.float32),
        kp_off=(kp_off, torch.int64), kp_w=(kp_w, torch.int32), kp_xy=(kp_xy, torch.int32),
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
    orb_describe.launches.add()
    return angle, desc


orb_describe.launches = _kernels.LaunchCounter()


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


@functools.lru_cache(maxsize=16)
def _slot_consts(cfg: ExtractorConfig, shapes, offsets, device: torch.device):
    """Per-slot level, and the offset and row width of each slot's level in
    the flat buffers (kernel B's inputs)."""
    lv = slot_levels(cfg)
    return (
        torch.as_tensor(lv, dtype=torch.int64, device=device),
        torch.as_tensor(np.asarray(offsets, np.int64)[lv], device=device),
        torch.as_tensor(np.asarray([w for _, w in shapes], np.int32)[lv], device=device),
    )


def _extract(img: torch.Tensor, cfg: ExtractorConfig, pyramid, fast_nms, select, describe) -> Keypoints:
    shapes, offsets = image_ops.pyramid_layout(*img.shape, cfg.n_levels, cfg.scale_factor)
    levels, blurs = pyramid(img, cfg.n_levels, cfg.scale_factor)
    raw, nms = torch.empty_like(levels), torch.empty_like(levels)
    for lvl_img, r, m in zip(*(image_ops.level_views(x, shapes, offsets) for x in (levels, raw, nms))):
        fast_nms(lvl_img, cfg.ini_th_fast, cfg.min_th_fast, EDGE_BORDER, out=(r, m))
    xy_lvl, xy, resp, valid = select(nms, raw, shapes, offsets, cfg)
    level, kp_off, kp_w = _slot_consts(cfg, shapes, offsets, img.device)
    angle, desc = describe(levels, blurs, kp_off, kp_w, xy_lvl)
    return Keypoints(xy=xy, level=level, angle=angle, response=resp, desc=desc, valid=valid)


def extract(img: torch.Tensor, cfg: ExtractorConfig = ExtractorConfig()) -> Keypoints:
    """ORB extraction on one (H,W) float32 image in [0, 255]: kernel H
    (pyramid and blurs), kernel A per level (FAST + NMS), kernel I
    (selection and subpixel refinement over all levels) and kernel B (angle
    and BRIEF over all levels), all on one set of flat per-image buffers.
    """
    return _extract(img, cfg, image_ops.pyramid_blur, fast_ops.fast_nms, select_subpixel, orb_describe)


def extract_plain(img: torch.Tensor, cfg: ExtractorConfig = ExtractorConfig()) -> Keypoints:
    """``extract`` through every kernel's plain version, on any device: the
    yardstick of the whole extraction on the card."""
    return _extract(img, cfg, image_ops.pyramid_blur_plain, fast_ops.fast_nms_plain, select_subpixel_plain,
                    orb_describe_plain)
