"""Matchers of the Systems: rectified stereo matching, SAD subpixel
disparity refinement, the windowed match of mono initialisation, projection
matching against the local map and from the last frame, the unconstrained
mutual match, and the epipolar search for triangulation.

Counterpart of ``stereo_match``, ``stereo_subpixel_refine``,
``search_for_initialization``, ``search_by_projection``, ``search_frame_to_frame``,
``search_descriptors_mutual``, ``search_for_triangulation`` and
``_pow_level`` of ``orb_slam3_fast_tpu/ops/matching.py``.  The gated best-2
searches run in kernel C (``ops.hamming.hamming_best2``); their epilogues
(ratio, dedup, rotation histogram, mutual check, median prune) are plain
PyTorch.  ``stereo_subpixel_refine`` is the wrapper of kernel J
(``csrc/sad_refine.cu``); ``stereo_subpixel_refine_plain`` computes the same
from ``sad_table``.

Kernel J -- source note.
  Replaces: ``stereo_subpixel_refine``
  (``orb_slam3_fast_tpu/ops/matching.py:380``), whose TPU form gathers
  eleven (N, 121) patch blocks and reduces each: ~60 PyTorch operations in
  the plain version.
  Bound on the card: latency.  Per keypoint it reads 121 left and 231
  right pixels (1.4 KB) and does ~4k flops; 1024 keypoints are 1.4 MB and
  4 Mflop, well under a microsecond of either.
  Design: one warp per keypoint.  The left patch, minus its centre, sits in
  registers (4 pixels a lane); for each of the 11 offsets the lanes sum
  |left - right| over their pixels and a butterfly reduction gives every
  lane the SAD, so the 11 SADs never leave registers.  Lane 0 takes the
  first minimum (``torch.argmin``'s tie rule) and the clamped parabola in
  the plain version's operation order; rounding is ``rintf`` (half to even,
  as ``torch.round``).  The plain SAD's summation order on the card is
  PyTorch's, so the two agree to float rounding, not bit for bit.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from orb_slam3_fast_tpu_torch import _kernels
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


def search_for_initialization(kp0: Keypoints, kp1: Keypoints, window: float = 100.0, ratio: float = 0.9,
                              check_rotation: bool = True):
    """Monocular-initialisation matcher (SearchForInitialization,
    ORBmatcher.cc:618-764): level-0 keypoints of two frames within a square
    window, ratio test, dedup, rotation histogram.  Kernel C's window mode
    with the level-0 test folded into the validity flags: rows carry level 0
    and radius ``window``, so the mode's band [-1, 1] and its square window
    are exactly this mask.  Returns (match_idx, accept) per keypoint of kp0."""
    f32 = torch.float32
    gate = ham.WindowGate(
        kp0.xy[:, 0].contiguous(), kp0.xy[:, 1].contiguous(), torch.full_like(kp0.xy[:, 0], window),
        torch.zeros_like(kp0.xy[:, 0]), (kp0.valid & (kp0.level == 0)).to(f32),
        kp1.xy[:, 0].contiguous(), kp1.xy[:, 1].contiguous(), kp1.level.to(f32),
        (kp1.valid & (kp1.level == 0)).to(f32),
    )
    b, _ = ham.hamming_best2(kp0.desc, kp1.desc, gate)
    accept = ham.ratio_gate(b, ratio, ham.TH_LOW)
    accept = ham.resolve_duplicate_targets(b.idx, b.dist, accept, kp1.n)
    if check_rotation:
        accept = ham.rotation_consistency(kp0.angle, kp1.angle[b.idx], accept)
    return b.idx, accept


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


def search_frame_to_frame(
    kp_cur: Keypoints,
    proj_uv: torch.Tensor,
    proj_valid: torch.Tensor,
    desc_last: torch.Tensor,
    level_last: torch.Tensor,
    angle_last: torch.Tensor,
    level_scales: torch.Tensor,
    radius: float = 15.0,
    check_rotation: bool = True,
):
    """Motion-model matcher (SearchByProjection(Current, Last),
    ORBmatcher.cc:1594-1806): the last frame's landmarks projected into the
    current frame, window ``radius * scale[level_last]``, keypoint level
    within one of ``level_last``; accept at distance <= TH_HIGH, dedup, then
    the rotation histogram.  Returns (match_idx, accept) per landmark row."""
    f32 = torch.float32
    r = radius * _pow_level(level_last, level_scales)
    gate = ham.WindowGate(
        proj_uv[:, 0].contiguous(), proj_uv[:, 1].contiguous(), r, level_last.to(f32),
        proj_valid.to(f32), kp_cur.xy[:, 0].contiguous(), kp_cur.xy[:, 1].contiguous(),
        kp_cur.level.to(f32), kp_cur.valid.to(f32),
    )
    b, _ = ham.hamming_best2(desc_last, kp_cur.desc, gate)
    accept = b.dist <= ham.TH_HIGH
    accept = ham.resolve_duplicate_targets(b.idx, b.dist, accept, kp_cur.n)
    if check_rotation:
        accept = ham.rotation_consistency(angle_last, kp_cur.angle[b.idx], accept)
    return b.idx, accept


def search_descriptors_mutual(desc_a, valid_a, desc_b, valid_b, th: int = ham.TH_LOW, ratio: float = 0.75):
    """Unconstrained mutual best match (the BoW-free stand-in for
    SearchByBoW, ORBmatcher.cc:230-404): ratio test a->b and the b->a
    argmin must map back.  Returns (match_idx, accept) per row of a."""
    f32 = torch.float32
    gate = ham.MutualGate(valid_a.to(f32).contiguous(), valid_b.to(f32).contiguous())
    b_ab, ba_idx = ham.hamming_best2(desc_a, desc_b, gate)
    accept = ham.ratio_gate(b_ab, ratio, th) & ham.mutual_consistency(b_ab.idx, ba_idx)
    return b_ab.idx, accept


def search_for_triangulation(
    kp_a: Keypoints,
    kp_b: Keypoints,
    free_a: torch.Tensor,
    free_b: torch.Tensor,
    F_ab: torch.Tensor,
    level_sigma2: torch.Tensor,
    th: int = ham.TH_LOW,
    ratio: float = 1.0,
):
    """Epipolar-constrained matching of unmatched keypoints between two
    keyframes (SearchForTriangulation, ORBmatcher.cc:886-1106): candidates
    whose squared distance to the epipolar line of the a-point is below
    3.84 * sigma2[level_b] (ORBmatcher.cc:1067), best-2 both ways, ratio and
    mutual check.  ``F_ab`` maps a-points to lines in b (x_b^T F x_a = 0).
    Returns (match_idx, accept) per keypoint of a."""
    f32 = torch.float32
    xa = torch.cat([kp_a.xy, torch.ones_like(kp_a.xy[:, :1])], dim=-1)
    lines = xa @ F_ab.to(f32).T  # (Na,3) the line of each a-point in image b
    gate = ham.EpipolarGate(
        lines[:, 0].contiguous(), lines[:, 1].contiguous(), lines[:, 2].contiguous(),
        lines[:, 0] ** 2 + lines[:, 1] ** 2, (free_a & kp_a.valid).to(f32),
        kp_b.xy[:, 0].contiguous(), kp_b.xy[:, 1].contiguous(),
        3.84 * _pow_level(kp_b.level, level_sigma2), (free_b & kp_b.valid).to(f32),
    )
    b_ab, ba_idx = ham.hamming_best2(kp_a.desc, kp_b.desc, gate)
    accept = ham.ratio_gate(b_ab, ratio, th) & ham.mutual_consistency(b_ab.idx, ba_idx)
    return b_ab.idx, accept


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


def sad_table(img_l: torch.Tensor, img_r: torch.Tensor, xy_l: torch.Tensor, right_u: torch.Tensor,
              win: int = 5, search: int = 5):
    """The SADs of the plain refinement: an 11x11 patch, each minus its
    centre pixel, at ``2 * search + 1`` integer offsets around the rounded
    match.  Returns (sad (N, 2s+1), rounded match column xr0 (N,) int64)."""
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
    return torch.stack(sads, dim=-1), xr0


def stereo_subpixel_refine_plain(img_l, img_r, xy_l, right_u, valid, win: int = 5, search: int = 5):
    """Plain version of kernel J: (refined right-u, ok)."""
    sad, xr0 = sad_table(img_l, img_r, xy_l, right_u, win, search)
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
    the search range.  Kernel J on CUDA tensors, its plain version on CPU
    ones."""
    if img_l.device.type == "cpu":
        return stereo_subpixel_refine_plain(img_l, img_r, xy_l, right_u, valid, win, search)
    if (win, search) != (5, 5):
        raise ValueError(f"stereo_subpixel_refine: the kernel takes win=5, search=5, got {win}, {search}")
    _kernels.require_cuda(
        "stereo_subpixel_refine", img_l=(img_l, torch.float32), img_r=(img_r, torch.float32),
        xy_l=(xy_l, torch.float32), right_u=(right_u, torch.float32), valid=(valid, torch.bool),
    )
    n = xy_l.shape[0]
    if img_l.shape != img_r.shape or img_l.dim() != 2 or xy_l.shape != (n, 2) or right_u.shape != (n,) or \
            valid.shape != (n,):
        raise ValueError("stereo_subpixel_refine: needs two (H,W) images of one shape, (N,2) xy, (N,) right-u and valid")
    u = torch.empty(n, dtype=torch.float32, device=img_l.device)
    ok = torch.empty(n, dtype=torch.bool, device=img_l.device)
    _kernels.launch(
        "sad_refine_launch", img_l.device,
        img_l.data_ptr(), img_r.data_ptr(), img_l.shape[0], img_l.shape[1], xy_l.data_ptr(), right_u.data_ptr(),
        valid.data_ptr(), n, u.data_ptr(), ok.data_ptr(),
    )
    stereo_subpixel_refine.launches.add()
    return u, ok


stereo_subpixel_refine.launches = _kernels.LaunchCounter()
