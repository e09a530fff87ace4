"""Image primitives: scale pyramid, separable Gaussian blur, bilinear resize.

Counterpart of ``orb_slam3_fast_tpu/ops/image.py``.  Plain PyTorch; a fused
resize + blur kernel is queued work (ROADMAP.md, K2).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def gaussian_kernel1d(ksize: int, sigma: float) -> np.ndarray:
    r = ksize // 2
    x = np.arange(-r, r + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def gaussian_blur(img: torch.Tensor, ksize: int = 7, sigma: float = 2.0) -> torch.Tensor:
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
