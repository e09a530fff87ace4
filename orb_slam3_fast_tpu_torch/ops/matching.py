"""Matchers of the stereo tracking step: rectified stereo matching, SAD
subpixel disparity refinement, and projection matching against the local map.

Counterpart of ``stereo_match``, ``stereo_subpixel_refine``,
``search_by_projection`` and ``_pow_level`` of
``orb_slam3_fast_tpu/ops/matching.py``.  The gated best-2 searches run in
kernel C (``ops.hamming.hamming_best2``); their epilogues (ratio, dedup,
mutual check, median prune) are plain PyTorch.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from orb_slam3_fast_tpu_torch.ops import hamming as ham
from orb_slam3_fast_tpu_torch.ops.extractor import Keypoints


def _pow_level(level: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """``table[level]`` of a geometric table, computed as the reference does
    (``table[0] * exp(level * ln(table[1] / table[0]))``) so that window
    radii round the same way."""
    ratio = torch.log(table[1] / torch.clamp(table[0], min=1e-12))
    return table[0] * torch.exp(level.to(torch.float32) * ratio)


def _median(x: torch.Tensor) -> torch.Tensor:
    """``jnp.median``: NaN if any element is NaN, else the mean of the middle
    pair for an even count (``torch.median`` returns the lower one)."""
    s, _ = torch.sort(x)
    n = x.shape[0]
    med = (s[(n - 1) // 2] + s[n // 2]) * 0.5
    return torch.where(torch.isnan(x).any(), torch.full_like(med, torch.nan), med)


def search_by_projection(
    kp: Keypoints,
    proj_uv: torch.Tensor,
    proj_valid: torch.Tensor,
    proj_desc: torch.Tensor,
    pred_level: torch.Tensor,
    level_scales: torch.Tensor,
    radius: float = 3.0,
    th_dist: int = ham.TH_HIGH,
    ratio: float = 0.8,
):
    """Project-and-match for local-map tracking (SearchByProjection).

    Rows are map points (M), columns frame keypoints (N); the window is
    ``radius * scale[pred_level]`` and the keypoint level must lie within one
    of ``pred_level``.  Returns (match_idx (M,), accept (M,))."""
    r = radius * _pow_level(pred_level, level_scales)
    f32 = torch.float32
    gate = ham.WindowGate(
        proj_uv[:, 0].contiguous(), proj_uv[:, 1].contiguous(), r, pred_level.to(f32),
        proj_valid.to(f32), kp.xy[:, 0].contiguous(), kp.xy[:, 1].contiguous(),
        kp.level.to(f32), kp.valid.to(f32),
    )
    b, _ = ham.hamming_best2(proj_desc, kp.desc, gate)
    accept = ham.ratio_gate(b, ratio, th_dist)
    accept = ham.resolve_duplicate_targets(b.idx, b.dist, accept, kp.n)
    return b.idx, accept


class StereoMatches(NamedTuple):
    right_u: torch.Tensor  # (N,) right-image u of the match (-1 invalid)
    depth: torch.Tensor  # (N,) depth (-1 invalid)
    valid: torch.Tensor  # (N,) bool


def stereo_match(
    kp_l: Keypoints,
    kp_r: Keypoints,
    level_scales: torch.Tensor,
    bf: float,
    min_z: float,
    max_disp_frac: float = 1.0,
    th_dist: int = (ham.TH_HIGH + ham.TH_LOW) // 2,
    row_slack: float = 2.0,
    slot_scale_r: torch.Tensor | None = None,
) -> StereoMatches:
    """Rectified stereo matching (Frame::ComputeStereoMatches).

    Soft row-band, disparity [1, bf/min_z] and level gates added to the
    Hamming distance as 10000 * excess, best-2, L->R / R->L mutual check,
    then the 2.1x median-distance prune."""
    f32 = torch.float32
    max_d = bf / min_z
    if slot_scale_r is not None:
        band_r = row_slack * slot_scale_r
    else:
        log_sf = torch.log(level_scales[1] / torch.clamp(level_scales[0], min=1e-9))
        band_r = row_slack * torch.exp(kp_r.level.to(f32) * log_sf)
    gate = ham.StereoGate(
        kp_l.xy[:, 0].contiguous(), kp_l.xy[:, 1].contiguous(), kp_l.level.to(f32), kp_l.valid.to(f32),
        kp_r.xy[:, 0].contiguous(), kp_r.xy[:, 1].contiguous(), band_r.contiguous(),
        kp_r.level.to(f32), kp_r.valid.to(f32), max_d * max_disp_frac,
    )
    b, rl_idx = ham.hamming_best2(kp_l.desc, kp_r.desc, gate)
    accept = (b.dist <= th_dist) & ham.mutual_consistency(b.idx, rl_idx)
    # median-distance prune; like jnp.median, any unaccepted slot makes the
    # median NaN, which then reads as TH_HIGH
    dist_f = torch.where(accept, b.dist, torch.full_like(b.dist, ham.INF_DIST))
    med = torch.nan_to_num(_median(torch.where(accept, dist_f, torch.nan)), nan=float(ham.TH_HIGH))
    accept = accept & (dist_f <= 2.1 * med)
    ur = kp_r.xy[b.idx, 0]
    disparity = torch.clamp(kp_l.xy[:, 0] - ur, min=1.0)
    neg = torch.full_like(ur, -1.0)
    depth = torch.where(accept, bf / disparity, neg)
    accept = accept & (depth > 0) & (depth < 1e6)
    return StereoMatches(torch.where(accept, ur, neg), torch.where(accept, depth, neg), accept)


def stereo_subpixel_refine(
    img_l: torch.Tensor,
    img_r: torch.Tensor,
    xy_l: torch.Tensor,
    right_u: torch.Tensor,
    valid: torch.Tensor,
    win: int = 5,
    search: int = 5,
):
    """SAD sliding-window subpixel disparity refinement (Frame.cc:1005-1056):
    an 11x11 patch, normalised by its centre pixel, at 11 integer offsets
    around the Hamming match, polished by a parabola.  Returns
    (refined right-u, ok); ok is False where the minimum lies on the edge of
    the search range."""
    h, w = img_l.shape
    d = 2 * win + 1
    dev = img_l.device
    yy = torch.clamp(torch.round(xy_l[:, 1]).long(), win, h - win - 1)
    xl = torch.clamp(torch.round(xy_l[:, 0]).long(), win + search, w - win - search - 1)
    xr0 = torch.clamp(torch.round(right_u).long(), win + search, w - win - search - 1)
    oy, ox = torch.meshgrid(torch.arange(-win, win + 1, device=dev), torch.arange(-win, win + 1, device=dev), indexing="ij")
    oy, ox = oy.reshape(-1)[None, :], ox.reshape(-1)[None, :]
    c = (d * d) // 2
    pl = img_l.reshape(-1)[(yy[:, None] + oy) * w + (xl[:, None] + ox)]
    pl = pl - pl[:, c : c + 1]
    flat_r = img_r.reshape(-1)
    sads = []
    for k in range(-search, search + 1):
        pr = flat_r[(yy[:, None] + oy) * w + (xr0[:, None] + k + ox)]
        pr = pr - pr[:, c : c + 1]
        sads.append(torch.sum(torch.abs(pl - pr), dim=-1))
    sad = torch.stack(sads, dim=-1)  # (N, 2s+1)
    best = torch.argmin(sad, dim=-1)
    interior = (best > 0) & (best < 2 * search)
    bi = torch.clamp(best, 1, 2 * search - 1)
    cc = torch.gather(sad, 1, bi[:, None])[:, 0]
    m = torch.gather(sad, 1, (bi - 1)[:, None])[:, 0]
    p = torch.gather(sad, 1, (bi + 1)[:, None])[:, 0]
    denom = torch.clamp(m + p - 2.0 * cc, min=1e-6)
    delta = torch.clamp(0.5 * (m - p) / denom, -1.0, 1.0)
    refined = xr0.to(torch.float32) + (bi - search).to(torch.float32) + delta
    ok = valid & interior
    return torch.where(ok, refined, right_u), ok

