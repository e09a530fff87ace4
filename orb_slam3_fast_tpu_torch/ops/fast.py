"""FAST-16 corner detection with per-cell threshold fallback and 3x3 NMS.

Counterpart of ``orb_slam3_fast_tpu/ops/fast.py``.  The plain functions
(``fast_score_maps``, ``fast_with_fallback``, ``nonmax_3x3``) follow the JAX
arithmetic step for step, wrap-around ``roll`` included; ``fast_nms`` is the
wrapper of kernel A (``csrc/fast_nms.cu``), which computes what
``fast_nms_plain`` computes.

Kernel A -- source note.
  Replaces: ``fast_score_maps`` + ``fast_with_fallback`` + ``nonmax_3x3``
  (``orb_slam3_fast_tpu/ops/fast.py:62-126``) and the EDGE_BORDER masks of
  ``_extract`` (``ops/extractor.py:384-396``).
  Bound on the card: device-memory bytes.  Per pixel it does 16 circle reads
  and ~100 integer/float operations against 4 bytes read and 8 written;
  the JAX version makes ~30 full-image passes (16 shifted copies, masks,
  sums, cell max, 8 NMS shifts).
  Design: two launches per pyramid level.  (1) One 32x32 block per 32x32
  fallback cell loads a 38x38 shared-memory tile (3-px halo), computes both
  thresholds' run-of-9 masks and SAD scores from one read of the 16 circle
  pixels, and chooses between the 20 and 7 scores with a block-wide
  ``__syncthreads_or`` over "has a corner at 20" -- the cell flag never goes
  to memory.  (2) A 34x34 tile (1-px halo) of that score gives the strict
  3x3 NMS and the border mask; it writes the dense pre-NMS score (for
  ``subpixel_refine``) and the NMS score.  Launched once per level (eight
  shapes per image).
"""
from __future__ import annotations

import numpy as np
import torch

from orb_slam3_fast_tpu_torch import _kernels

# radius-3 Bresenham circle, clockwise from 12 o'clock (dy, dx); the bit
# order of the 16-bit masks follows this order.
CIRCLE = np.array(
    [
        (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
        (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
    ],
    dtype=np.int32,
)
FALLBACK_CELL = 32


def _shift2d(img: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """out[y, x] = img[y + dy, x + dx], wrapping around as the reference's
    ``roll`` does; callers zero the border where the wrap lands."""
    return torch.roll(img, shifts=(-dy, -dx), dims=(0, 1))


def _has_run9(mask16: torch.Tensor) -> torch.Tensor:
    """int32 16-bit circle masks -> bool: a circular run of >= 9 set bits."""
    m = mask16 | (mask16 << 16)
    r = m & (m >> 1)
    r = r & (r >> 2)
    r = r & (r >> 4)
    r = r & (m >> 8)
    return (r & 0xFFFF) != 0


def _border_mask(h: int, w: int, b: int, device) -> torch.Tensor:
    yy = torch.arange(h, device=device)[:, None]
    xx = torch.arange(w, device=device)[None, :]
    return (yy >= b) & (yy < h - b) & (xx >= b) & (xx < w - b)


def fast_score_maps(img: torch.Tensor, thresholds: tuple) -> list[torch.Tensor]:
    """FAST responses at several thresholds from one set of 16 shifted reads;
    the 3-px border is zero."""
    h, w = img.shape
    n_th = len(thresholds)
    bright_mask = [torch.zeros((h, w), dtype=torch.int32, device=img.device) for _ in range(n_th)]
    dark_mask = [torch.zeros((h, w), dtype=torch.int32, device=img.device) for _ in range(n_th)]
    bright_sum = [torch.zeros_like(img) for _ in range(n_th)]
    dark_sum = [torch.zeros_like(img) for _ in range(n_th)]
    zero = torch.zeros((), dtype=img.dtype, device=img.device)
    for k in range(16):
        dy, dx = int(CIRCLE[k, 0]), int(CIRCLE[k, 1])
        diff = _shift2d(img, dy, dx) - img
        for i, t in enumerate(thresholds):
            b = diff > t
            d = diff < -t
            bright_mask[i] = bright_mask[i] | (b.to(torch.int32) << k)
            dark_mask[i] = dark_mask[i] | (d.to(torch.int32) << k)
            bright_sum[i] = bright_sum[i] + torch.where(b, diff - t, zero)
            dark_sum[i] = dark_sum[i] + torch.where(d, -diff - t, zero)
    inb = _border_mask(h, w, 3, img.device)
    out = []
    for i in range(n_th):
        score = torch.where(_has_run9(bright_mask[i]), bright_sum[i], zero) + torch.where(
            _has_run9(dark_mask[i]), dark_sum[i], zero
        )
        out.append(torch.where(inb, score, zero))
    return out


def nonmax_3x3(score: torch.Tensor) -> torch.Tensor:
    """Strict 3x3 non-maximum suppression."""
    neigh = torch.full_like(score, -torch.inf)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy or dx:
                neigh = torch.maximum(neigh, _shift2d(score, dy, dx))
    return torch.where(score > neigh, score, torch.zeros_like(score))


def fast_with_fallback(img: torch.Tensor, ini_th: float, min_th: float) -> torch.Tensor:
    """Detect at ``ini_th``; in 32x32 cells where nothing fires, use the
    ``min_th`` response (ORBextractor.cc:810-825)."""
    s_hi, s_lo = fast_score_maps(img, (ini_th, min_th))
    h, w = img.shape
    c = FALLBACK_CELL
    ph, pw = (-h) % c, (-w) % c
    hi_pad = torch.nn.functional.pad(s_hi, (0, pw, 0, ph))
    gh, gw = (h + ph) // c, (w + pw) // c
    cell_has_hi = hi_pad.reshape(gh, c, gw, c).amax(dim=(1, 3)) > 0
    cell_mask = cell_has_hi.repeat_interleave(c, 0).repeat_interleave(c, 1)[:h, :w]
    return torch.where(cell_mask, s_hi, s_lo)


def fast_nms_plain(img: torch.Tensor, ini_th: float, min_th: float, border: int):
    """Plain version of kernel A: (dense pre-NMS score, NMS score), both zero
    within ``border`` px of the edge."""
    raw = fast_with_fallback(img, ini_th, min_th)
    nms = nonmax_3x3(raw)
    inb = _border_mask(*img.shape, border, img.device)
    zero = torch.zeros((), dtype=raw.dtype, device=raw.device)
    return torch.where(inb, raw, zero), torch.where(inb, nms, zero)


def fast_nms(img: torch.Tensor, ini_th: float, min_th: float, border: int):
    """Kernel A on a CUDA level image, its plain version on a CPU one.
    Returns (dense pre-NMS score, NMS score) of shape (H,W) float32."""
    if img.device.type == "cpu":
        return fast_nms_plain(img, ini_th, min_th, border)
    _kernels.require_cuda("fast_nms", img=(img, torch.float32))
    if img.dim() != 2 or border < 1:
        raise ValueError("fast_nms: needs an (H,W) image and a border of at least 1 px")
    h, w = img.shape
    raw = torch.empty_like(img)
    raw_inb = torch.empty_like(img)
    nms = torch.empty_like(img)
    _kernels.launch(
        "fast_nms_launch", img.device,
        img.data_ptr(), raw.data_ptr(), raw_inb.data_ptr(), nms.data_ptr(),
        h, w, border, float(ini_th), float(min_th),
    )
    fast_nms.launches += 1
    return raw_inb, nms


fast_nms.launches = 0
