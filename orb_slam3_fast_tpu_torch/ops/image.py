"""Image primitives: scale pyramid, separable Gaussian blur, bilinear resize.

Counterpart of ``orb_slam3_fast_tpu/ops/image.py``.  ``pyramid_blur`` is the
wrapper of kernel H (``csrc/pyramid_blur.cu``); ``pyramid_blur_plain``
computes the same with ``build_pyramid`` and ``gaussian_blur``.  Both return
every level and every blur in one flat buffer per image, level after level
(offsets from ``pyramid_layout``), the layout kernels A, I and B read.

Kernel H -- source note.
  Replaces: ``build_pyramid`` + ``resize_bilinear`` + ``gaussian_blur``
  (``orb_slam3_fast_tpu/ops/image.py:28-70``), eight chained resizes and a
  blur per level, which the plain version issues as ~33 PyTorch operations
  per level.
  Bound on the card: device-memory bytes, and at these sizes launch latency.
  A 640x480 image moves ~9 MB over all levels (the input read once, each
  level and blur written once), ~2.6 us at 3.35 TB/s; the arithmetic is ~38
  flops per level pixel.
  Design: one launch per level.  A 32x32 output tile loads a 38x38 shared
  tile of its level (3-px halo, reflect-101 at the level's edges); for
  level l > 0 those pixels are resized from level l-1 in device memory with
  PyTorch's own bilinear expressions (half-pixel centres, scale in/out in
  float), the halo's included, so no launch waits on a neighbour's tile.
  The vertical pass then the horizontal one sum the 7 taps in order from
  zero with ``__fmul_rn`` / ``__fadd_rn`` (no FMA contraction): the blur is
  bit-equal to ``gaussian_blur`` of the same level, which matters because
  BRIEF rounds blurred samples to bf16 and compares them.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from orb_slam3_fast_tpu_torch import _kernels

BLUR_KSIZE, BLUR_SIGMA = 7, 2.0


def gaussian_kernel1d(ksize: int, sigma: float) -> np.ndarray:
    r = ksize // 2
    x = np.arange(-r, r + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def gaussian_blur(img: torch.Tensor, ksize: int = BLUR_KSIZE, sigma: float = BLUR_SIGMA) -> torch.Tensor:
    """Separable Gaussian blur of an (H,W) image, reflect-101 border (as
    OpenCV's BORDER_REFLECT_101).  Taps are summed in the reference's order."""
    k = gaussian_kernel1d(ksize, sigma).tolist()
    r = ksize // 2
    h, w = img.shape
    x = F.pad(img[None, None], (0, 0, r, r), mode="reflect")[0, 0]
    v = torch.zeros_like(img)
    for i in range(ksize):
        v = v + k[i] * x[i : i + h]
    x = F.pad(v[None, None], (r, r, 0, 0), mode="reflect")[0, 0]
    out = torch.zeros_like(img)
    for i in range(ksize):
        out = out + k[i] * x[:, i : i + w]
    return out


def resize_bilinear(img: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """Bilinear resize with half-pixel centres (cv::resize INTER_LINEAR)."""
    return F.interpolate(
        img[None, None], size=out_hw, mode="bilinear", align_corners=False, antialias=False
    )[0, 0]


def pyramid_shapes(h: int, w: int, n_levels: int, scale_factor: float) -> list[tuple[int, int]]:
    shapes = []
    for l in range(n_levels):
        s = 1.0 / (scale_factor**l)
        shapes.append((int(round(h * s)), int(round(w * s))))
    return shapes


def build_pyramid(img: torch.Tensor, n_levels: int = 8, scale_factor: float = 1.2) -> list[torch.Tensor]:
    """Scale pyramid; level 0 is the input, each level resized from the one
    before it (the reference's chain)."""
    h, w = img.shape
    shapes = pyramid_shapes(h, w, n_levels, scale_factor)
    levels = [img]
    for l in range(1, n_levels):
        levels.append(resize_bilinear(levels[-1], shapes[l]))
    return levels


@functools.lru_cache(maxsize=16)
def pyramid_layout(h: int, w: int, n_levels: int, scale_factor: float):
    """(shapes, offsets): per-level (H_l, W_l) and the element offset of each
    level in the flat per-image buffer, as tuples of host ints."""
    shapes = tuple(pyramid_shapes(h, w, n_levels, scale_factor))
    sizes = [hl * wl for hl, wl in shapes]
    return shapes, tuple(int(o) for o in np.concatenate([[0], np.cumsum(sizes)[:-1]]))


def level_views(flat: torch.Tensor, shapes, offsets) -> list[torch.Tensor]:
    """The (H_l, W_l) views of each level in a flat buffer."""
    return [flat[o : o + hl * wl].view(hl, wl) for (hl, wl), o in zip(shapes, offsets)]


def pyramid_blur_plain(img: torch.Tensor, n_levels: int = 8, scale_factor: float = 1.2):
    """Plain version of kernel H: (levels, blurs), each one flat float32
    buffer of all levels in the ``pyramid_layout`` order."""
    levels = build_pyramid(img, n_levels, scale_factor)
    return torch.cat([lv.reshape(-1) for lv in levels]), torch.cat([gaussian_blur(lv).reshape(-1) for lv in levels])


@functools.lru_cache(maxsize=16)
def _layout_host(h: int, w: int, n_levels: int, scale_factor: float):
    """The layout and the Gaussian taps as host arrays for the C entry point
    (kept alive by the cache while their pointers are in use)."""
    shapes, offs = pyramid_layout(h, w, n_levels, scale_factor)
    return (np.asarray(shapes, np.int32).reshape(-1), np.asarray(offs, np.int64),
            gaussian_kernel1d(BLUR_KSIZE, BLUR_SIGMA), sum(hl * wl for hl, wl in shapes))


def pyramid_blur(img: torch.Tensor, n_levels: int = 8, scale_factor: float = 1.2):
    """Kernel H on a CUDA (H,W) float32 image, its plain version on a CPU
    one.  Returns (levels, blurs): flat float32 buffers of every level and
    every level's blur, offsets from ``pyramid_layout``."""
    if img.device.type == "cpu":
        return pyramid_blur_plain(img, n_levels, scale_factor)
    _kernels.require_cuda("pyramid_blur", img=(img, torch.float32))
    if img.dim() != 2:
        raise ValueError("pyramid_blur: needs an (H,W) image")
    shapes, offs, taps, total = _layout_host(*img.shape, n_levels, float(scale_factor))
    if min(shapes) <= BLUR_KSIZE // 2:
        raise ValueError(f"pyramid_blur: level {shapes.reshape(-1, 2).tolist()} too small for the blur's border")
    levels = torch.empty(total, dtype=torch.float32, device=img.device)
    blurs = torch.empty_like(levels)
    _kernels.launch(
        "pyramid_blur_launch", img.device,
        img.data_ptr(), shapes.ctypes.data, offs.ctypes.data, n_levels, taps.ctypes.data,
        levels.data_ptr(), blurs.data_ptr(),
    )
    pyramid_blur.launches.add()
    return levels, blurs


pyramid_blur.launches = _kernels.LaunchCounter()
