"""Matchers of the Systems: rectified stereo matching, SAD subpixel
disparity refinement, the fisheye two-camera stereo match with its
triangulation, the windowed match of mono initialisation, projection
matching against the local map and from the last frame, the unconstrained
mutual match, and the epipolar search for triangulation.

Counterpart of ``stereo_match``, ``stereo_subpixel_refine``,
``fisheye_stereo_match``, ``search_for_initialization``,
``search_by_projection``, ``search_frame_to_frame``,
``search_descriptors_mutual``, ``search_for_triangulation`` and
``_pow_level`` of ``orb_slam3_fast_tpu/ops/matching.py``.  The gated best-2
searches run in kernel C (``ops.hamming.hamming_best2``) and their epilogues
(threshold, ratio, mutual check, dedup, rotation histogram, median prune and
depth) in one launch of kernel AD (``ops.hamming.match_epilogue``), but for
the fisheye match, whose gates and triangulation run in kernel AB.
``stereo_subpixel_refine`` is the wrapper of kernel J
(``csrc/sad_refine.cu``); ``stereo_subpixel_refine_plain`` computes the same
from ``sad_table``.  ``fisheye_stereo_gate`` is the wrapper of kernel AB
(``csrc/fisheye_stereo.cu``), ``fisheye_stereo_gate_plain`` its plain
version.

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

Kernel AB -- source note.
  Replaces: ``fisheye_stereo_match`` (``orb_slam3_fast_tpu/ops/
  matching.py:305``, K26) after its Hamming stage: the ratio and mutual
  gates, the KB8 unprojection of both keypoint sets, the parallax gate, the
  batched SVD DLT and the depth and two-view chi2 gates, ~80 elementwise
  XLA operations over the left keypoint slots.  The Hamming stage (the
  full matrix, best-2 both ways) is kernel C's mutual mode (K6).
  Bound on the card: latency.  Per left slot it reads ~60 bytes and writes
  17, and does ~2k flops (two 10-step Newton unprojections, two KB8
  projections, a 4x4 float64 Jacobi eigensolve): ~1000 slots are 80 KB
  and 2 Mflop, well under a microsecond of either.
  Design: one thread per left keypoint slot, the rig (both KB8 cameras,
  P1 = [I | 0], P2 = [R_rl | t_rl], the gates' constants) passed by value;
  the unprojection and projection are ``csrc/camera.cuh``'s KB8 functions,
  the DLT kernel G's ``jacobi::dlt_triangulate``; the products and sums
  that decide a gate round one by one (``__f*_rn``), as the plain version
  computes them, so a slot flips only where its value lies within float
  rounding of a cut.  It launches once per fisheye frame, beside one
  kernel C launch in mutual mode.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from orb_slam3_fast_tpu_torch import _kernels
from orb_slam3_fast_tpu_torch.cameras import models as cam_models
from orb_slam3_fast_tpu_torch.ops import hamming as ham
from orb_slam3_fast_tpu_torch.ops.extractor import Keypoints


def _pow_level(level: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """``table[level]`` of a geometric table, computed as the reference does
    (``table[0] * exp(level * ln(table[1] / table[0]))``) so that window
    radii round the same way."""
    ratio = torch.log(table[1] / torch.clamp(table[0], min=1e-12))
    return table[0] * torch.exp(level.to(torch.float32) * ratio)


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
    angles = (kp0.angle.contiguous(), kp1.angle.contiguous()) if check_rotation else None
    return b.idx, ham.match_epilogue(b, ham.TH_LOW, ratio=ratio, dedup_m=kp1.n, angles=angles)


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
    return b.idx, ham.match_epilogue(b, th_dist, ratio=ratio, dedup_m=kp.n)


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
    angles = (angle_last.contiguous(), kp_cur.angle.contiguous()) if check_rotation else None
    return b.idx, ham.match_epilogue(b, ham.TH_HIGH, inclusive=True, dedup_m=kp_cur.n, angles=angles)


def search_descriptors_mutual(desc_a, valid_a, desc_b, valid_b, th: int = ham.TH_LOW, ratio: float = 0.75):
    """Unconstrained mutual best match (the BoW-free stand-in for
    SearchByBoW, ORBmatcher.cc:230-404): ratio test a->b and the b->a
    argmin must map back.  Returns (match_idx, accept) per row of a."""
    f32 = torch.float32
    gate = ham.MutualGate(valid_a.to(f32).contiguous(), valid_b.to(f32).contiguous())
    b_ab, ba_idx = ham.hamming_best2(desc_a, desc_b, gate)
    return b_ab.idx, ham.match_epilogue(b_ab, th, ratio=ratio, col=ba_idx)


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
    return b_ab.idx, ham.match_epilogue(b_ab, th, ratio=ratio, col=ba_idx)


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
    then the 2.1x median-distance prune; like ``jnp.median``, any unaccepted
    slot makes the median NaN, which then reads as TH_HIGH."""
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
    return StereoMatches(*ham.match_epilogue(b, th_dist, inclusive=True, col=rl_idx,
                                             stereo=(kp_l.xy.contiguous(), kp_r.xy.contiguous(), bf)))


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


# --- fisheye (KB8) two-camera stereo -------------------------------------------------------------------------


class FisheyeStereoMatches(NamedTuple):
    depth: torch.Tensor  # (Nl,) left-camera z of the triangulated point (-1 invalid)
    x3d: torch.Tensor  # (Nl,3) triangulated point in the LEFT camera frame
    idx: torch.Tensor  # (Nl,) matched right keypoint index
    valid: torch.Tensor  # (Nl,) bool


def fisheye_stereo_gate_plain(cam_l, cam_r, kp_l: Keypoints, kp_r: Keypoints, b: ham.Best2, col: torch.Tensor,
                              R_rl: torch.Tensor, t_rl: torch.Tensor, level_sigma2: torch.Tensor,
                              ratio: float = 0.7, th_dist: int = ham.TH_HIGH,
                              min_parallax_cos: float = 0.9998) -> FisheyeStereoMatches:
    """Plain version of kernel AB: the gates and triangulation of
    ``fisheye_stereo_match`` given the left rows' best-2 ``b`` and the right
    columns' best left row ``col``."""
    from orb_slam3_fast_tpu_torch.ops import twoview

    accept = ham.ratio_gate(b, ratio, th_dist) & ham.mutual_consistency(b.idx, col)
    # bearings (unit-z rays) in each camera
    r1 = cam_models.unproject(cam_l, kp_l.xy)
    r2 = cam_models.unproject(cam_r, kp_r.xy)[b.idx]
    # parallax between the rays expressed in the LEFT frame (R_lr = R_rl^T)
    r2_in_l = torch.einsum("ji,nj->ni", R_rl, r2)
    cosp = torch.sum(r1 * r2_in_l, dim=-1) / (torch.linalg.vector_norm(r1, dim=-1) *
                                              torch.linalg.vector_norm(r2_in_l, dim=-1))
    accept = accept & (cosp < min_parallax_cos)
    # batched DLT: P1 = [I|0], P2 = [R_rl|t_rl], normalised coordinates = the rays' xy
    P1 = torch.cat([torch.eye(3, device=R_rl.device), torch.zeros((3, 1), device=R_rl.device)], dim=1)
    P2 = torch.cat([R_rl, t_rl[:, None]], dim=1)
    X = twoview.triangulate_dlt_plain(P1, P2, r1[:, :2], r2[:, :2])  # (Nl,3) left frame
    z1 = X[:, 2]
    xc2 = torch.einsum("ij,nj->ni", R_rl, X) + t_rl
    uv1 = cam_models.project(cam_l, X)
    uv2 = cam_models.project(cam_r, xc2)
    s2_l = level_sigma2[kp_l.level]
    s2_r = level_sigma2[kp_r.level][b.idx]
    e1 = torch.sum((uv1 - kp_l.xy) ** 2, dim=-1)
    e2 = torch.sum((uv2 - kp_r.xy[b.idx]) ** 2, dim=-1)
    accept = (accept & (z1 > 0.05) & (xc2[:, 2] > 0.05) & (e1 <= 5.991 * s2_l) & (e2 <= 5.991 * s2_r)
              & torch.isfinite(X).all(dim=-1))
    return FisheyeStereoMatches(torch.where(accept, z1, torch.full_like(z1, -1.0)), X, b.idx, accept)


def fisheye_stereo_gate(cam_l, cam_r, kp_l: Keypoints, kp_r: Keypoints, b: ham.Best2, col: torch.Tensor,
                        R_rl: torch.Tensor, t_rl: torch.Tensor, level_sigma2: torch.Tensor,
                        ratio: float = 0.7, th_dist: int = ham.TH_HIGH,
                        min_parallax_cos: float = 0.9998) -> FisheyeStereoMatches:
    """Kernel AB on CUDA tensors, its plain version on CPU ones.  ``cam_l``,
    ``cam_r`` (KB8), ``R_rl`` and ``t_rl`` stay on the host and are read as
    scalars."""
    if kp_l.xy.device.type == "cpu":
        return fisheye_stereo_gate_plain(cam_l, cam_r, kp_l, kp_r, b, col, R_rl, t_rl, level_sigma2, ratio, th_dist,
                                         min_parallax_cos)
    return _fisheye_kernel(cam_l, cam_r, kp_l, kp_r, b, col, R_rl, t_rl, level_sigma2, ratio, th_dist,
                           min_parallax_cos)


def _fisheye_kernel(cam_l, cam_r, kp_l, kp_r, b, col, R_rl, t_rl, level_sigma2, ratio, th_dist, min_parallax_cos):
    """Kernel AB's launch."""
    if cam_l.kind != cam_models.KB8 or cam_r.kind != cam_models.KB8:
        raise ValueError("fisheye_stereo_gate: kernel AB takes two KB8 cameras")
    f32, i64 = torch.float32, torch.int64
    dev = kp_l.xy.device
    idx = b.idx.to(i64).contiguous()
    dist, dist2 = b.dist.to(torch.int32).contiguous(), b.dist2.to(torch.int32).contiguous()
    col = col.to(i64).contiguous()
    sigma2 = level_sigma2.to(device=dev, dtype=f32).contiguous()
    _kernels.require_cuda(
        "fisheye_stereo_gate", xy_l=(kp_l.xy, f32), level_l=(kp_l.level, i64), xy_r=(kp_r.xy, f32),
        level_r=(kp_r.level, i64), idx=(idx, i64), dist=(dist, torch.int32), dist2=(dist2, torch.int32),
        col=(col, i64), sigma2=(sigma2, f32),
    )
    n, m = kp_l.xy.shape[0], kp_r.xy.shape[0]
    if kp_l.xy.shape != (n, 2) or kp_r.xy.shape != (m, 2) or idx.shape != (n,) or col.shape != (m,):
        raise ValueError("fisheye_stereo_gate: needs (N,2) and (M,2) keypoints, (N,) best-2 and (M,) column argmin")
    cams16 = np.asarray(cam_l.params.tolist() + cam_r.params.tolist(), np.float32)
    Rt = np.asarray(torch.cat([R_rl.reshape(9), t_rl.reshape(3)]).tolist(), np.float32)
    depth = torch.empty(n, dtype=f32, device=dev)
    x3d = torch.empty((n, 3), dtype=f32, device=dev)
    valid = torch.empty(n, dtype=torch.bool, device=dev)
    _kernels.launch(
        "fisheye_stereo_launch", dev, kp_l.xy.data_ptr(), kp_l.level.data_ptr(), kp_r.xy.data_ptr(),
        kp_r.level.data_ptr(), idx.data_ptr(), dist.data_ptr(), dist2.data_ptr(), col.data_ptr(), sigma2.data_ptr(),
        n, cams16.ctypes.data, Rt.ctypes.data, float(ratio), int(th_dist), float(min_parallax_cos),
        depth.data_ptr(), x3d.data_ptr(), valid.data_ptr(),
    )
    fisheye_stereo_gate.launches.add()
    return FisheyeStereoMatches(depth, x3d, idx, valid)


fisheye_stereo_gate.launches = _kernels.LaunchCounter()


def fisheye_stereo_match(cam_l, cam_r, kp_l: Keypoints, kp_r: Keypoints, R_rl: torch.Tensor, t_rl: torch.Tensor,
                         level_sigma2: torch.Tensor, ratio: float = 0.7, th_dist: int = ham.TH_HIGH,
                         min_parallax_cos: float = 0.9998) -> FisheyeStereoMatches:
    """Non-rectified two-camera (fisheye) stereo matching and triangulation
    (Frame::ComputeStereoFishEyeMatches + KannalaBrandt8::TriangulateMatches):
    the Hamming best-2 both ways (kernel C, mutual mode), then the ratio and
    mutual gates, the parallax gate (cos < ``min_parallax_cos``), the DLT of
    the two rays and the depth and chi2 gates in both views (kernel AB).
    ``R_rl, t_rl`` map left-camera points to the right camera (Stereo.T_c1_c2
    inverted).  Returns per-LEFT-keypoint results."""
    f32 = torch.float32
    gate = ham.MutualGate(kp_l.valid.to(f32).contiguous(), kp_r.valid.to(f32).contiguous())
    b, col = ham.hamming_best2(kp_l.desc, kp_r.desc, gate)
    return fisheye_stereo_gate(cam_l, cam_r, kp_l, kp_r, b, col, R_rl, t_rl, level_sigma2, ratio, th_dist,
                               min_parallax_cos)

