"""Hamming matching primitives on packed 256-bit descriptors.

Counterpart of ``orb_slam3_fast_tpu/ops/hamming.py``.  Descriptors live
packed as (N, 8) int32: bit k of the JAX package's (N, 256) int8 row is bit
k % 32 of word k // 32 (``pack_desc`` / ``unpack_desc``).  The best /
second-best helpers keep JAX's tie rules: argmin takes the lowest index, and
``resolve_duplicate_targets`` keeps the lowest row.

``hamming_best2`` is the wrapper of kernel C (``csrc/hamming_best2.cu``);
``hamming_best2_plain`` builds the (N, M) matrix and computes the same.

Kernel C -- source note.
  Replaces: ``hamming_matrix`` + ``masked_best2`` / ``penalized_best2``
  (``orb_slam3_fast_tpu/ops/hamming.py:28-69``) and the gated searches of
  ``stereo_match`` (``ops/matching.py:199-243``, K7) and
  ``search_by_projection`` (``ops/matching.py:77-90``, K9), where the TPU
  form is an int8 MXU matmul on unpacked bits plus (N, M) penalty and mask
  matrices.
  Bound on the card: integer throughput.  Each (row, column) pair costs 8
  XOR + popcounts and ~20 gate operations; the descriptors (32 KB per 1024
  rows) sit in L1/L2, and the (N, M) matrix is never written.
  Design: one warp per row, lanes stride over the columns keeping a
  lexicographic (value, index) top-2, merged by a shuffle butterfly, so ties
  go to the lowest index as ``argmin`` does.  Four modes, one per gate:
  * stereo (``StereoGate``) reproduces the soft penalty ``d + 10000 * pen``
    in float32 without FMA contraction;
  * window (``WindowGate``) applies the projection window, level band and
    validity mask (``search_by_projection``, ``search_frame_to_frame``);
  * epipolar (``EpipolarGate``, K13 ``search_for_triangulation``): the
    squared distance of column point (x, y) to row line (a, b, c),
    ``(a x + b y + c)^2 / (a^2 + b^2)``, below the column's chi2 band, in
    the plain version's op order without FMA contraction, so both agree
    bit for bit;
  * mutual (``MutualGate``, K6 ``search_descriptors_mutual``): validity
    only.
  Every mode but window also returns the per-column argmin of the gated
  value (the b->a half of a mutual check) through a packed 64-bit (value
  bits, row) ``atomicMin``, first in shared memory per block, then once per
  column and block in device memory; an all-masked column gives row 0, as
  ``argmin`` over a constant column does.  Those modes take at most 6144
  columns (48 KB of shared memory).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from orb_slam3_fast_tpu_torch import _kernels

TH_HIGH = 100  # ORBmatcher.cc:34
TH_LOW = 50  # ORBmatcher.cc:35
HISTO_LENGTH = 30  # ORBmatcher.cc:36
INF_DIST = 10_000
_MAX_SHARED = 48 * 1024


def pack_desc(bits: torch.Tensor) -> torch.Tensor:
    """(N,256) {0,1} -> (N,8) int32, bit k -> word k // 32, bit k % 32."""
    n = bits.shape[0]
    shifts = torch.arange(32, device=bits.device, dtype=torch.int64)
    words = (bits.reshape(n, 8, 32).to(torch.int64) << shifts).sum(dim=-1)
    return torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)


def unpack_desc(words: torch.Tensor) -> torch.Tensor:
    """(N,8) int32 -> (N,256) int8 in {0,1}."""
    shifts = torch.arange(32, device=words.device, dtype=torch.int64)
    bits = ((words.to(torch.int64) & 0xFFFFFFFF)[..., None] >> shifts) & 1
    return bits.reshape(words.shape[0], 256).to(torch.int8)


def hamming_matrix(da: torch.Tensor, db: torch.Tensor) -> torch.Tensor:
    """(N,8)x(M,8) packed -> (N,M) int32 Hamming distances.  The product of
    unpacked {0,1} bits is exact in float32 (sums <= 256)."""
    a = unpack_desc(da).to(torch.float32)
    b = unpack_desc(db).to(torch.float32)
    dot = a @ b.T
    return (a.sum(-1, keepdim=True) + b.sum(-1)[None, :] - 2.0 * dot).to(torch.int32)


class Best2(NamedTuple):
    idx: torch.Tensor  # (N,) argmin over M
    dist: torch.Tensor  # (N,) best distance
    dist2: torch.Tensor  # (N,) second-best distance
    idx2: torch.Tensor  # (N,) second-best index


def _best2(d: torch.Tensor, excluded) -> Best2:
    rows = torch.arange(d.shape[0], device=d.device)
    i1 = torch.argmin(d, dim=-1)
    d1 = d[rows, i1]
    d_wo = d.clone()
    d_wo[rows, i1] = excluded
    i2 = torch.argmin(d_wo, dim=-1)
    return Best2(i1, d1, d_wo[rows, i2], i2)


def masked_best2(dist: torch.Tensor, mask: torch.Tensor) -> Best2:
    """Row-wise best and second-best under a boolean candidate mask."""
    return _best2(torch.where(mask, dist, torch.full_like(dist, INF_DIST)), INF_DIST)


def penalized_best2(d_eff: torch.Tensor) -> Best2:
    """Row-wise best and second-best of an additively penalised matrix."""
    return _best2(d_eff, torch.inf)


def ratio_gate(b: Best2, ratio: float, th: int) -> torch.Tensor:
    """Accept if best < th and best < ratio * second-best."""
    return (b.dist < th) & (b.dist.to(torch.float32) < ratio * b.dist2.to(torch.float32))


def mutual_consistency(best_ab: torch.Tensor, best_ba: torch.Tensor) -> torch.Tensor:
    """Accept a->b only if b->a maps back: best_ba[best_ab[i]] == i."""
    return best_ba[best_ab] == torch.arange(best_ab.shape[0], device=best_ab.device)


def resolve_duplicate_targets(idx: torch.Tensor, dist: torch.Tensor, accept: torch.Tensor, m: int):
    """Keep, per target column, only the lowest-distance accepted row, and
    the lowest row among equals."""
    d = torch.where(accept, dist, torch.full_like(dist, INF_DIST))
    col_best = torch.full((m,), INF_DIST, dtype=d.dtype, device=d.device).scatter_reduce(
        0, idx, d, reduce="amin"
    )
    keep = accept & (d <= col_best[idx])
    row_ids = torch.arange(idx.shape[0], device=idx.device)
    big = torch.full_like(row_ids, 1 << 30)
    col_best_row = torch.full((m,), 1 << 30, dtype=row_ids.dtype, device=idx.device).scatter_reduce(
        0, idx, torch.where(keep, row_ids, big), reduce="amin"
    )
    return keep & (row_ids == col_best_row[idx])


# --- kernel C ---------------------------------------------------------------


class StereoGate(NamedTuple):
    """Soft gate of ``stereo_match``: rows are left keypoints, columns right
    ones; every tensor float32."""

    xl: torch.Tensor  # (N,)
    yl: torch.Tensor
    level_l: torch.Tensor
    valid_l: torch.Tensor  # 1.0 / 0.0
    xr: torch.Tensor  # (M,)
    yr: torch.Tensor
    band_r: torch.Tensor  # row band half-width row_slack * scale
    level_r: torch.Tensor
    valid_r: torch.Tensor
    max_disp: float


class WindowGate(NamedTuple):
    """Mask of ``search_by_projection``: rows are landmarks, columns
    keypoints; every tensor float32."""

    u: torch.Tensor  # (M_lm,) projected position
    v: torch.Tensor
    radius: torch.Tensor  # radius * scale[pred_level]
    pred_level: torch.Tensor
    valid: torch.Tensor  # 1.0 / 0.0
    kx: torch.Tensor  # (N_kp,)
    ky: torch.Tensor
    k_level: torch.Tensor
    k_valid: torch.Tensor


_BIG = 10000.0  # soft-gate penalty per unit of excess (INF_DIST)
_STEREO, _WINDOW, _EPIPOLAR, _MUTUAL = range(4)  # kernel C's modes


def stereo_cost(d: torch.Tensor, g: StereoGate) -> torch.Tensor:
    """d + 10000 * pen with the reference's relu penalties, in its order."""
    z = torch.zeros((), dtype=torch.float32, device=d.device)
    yl, xl, ll = g.yl[:, None], g.xl[:, None], g.level_l[:, None]
    pen = torch.maximum(yl - (g.yr + g.band_r)[None, :], z)
    pen = pen + torch.maximum((g.yr - g.band_r)[None, :] - yl, z)
    pen = pen + torch.maximum((g.xr + 1.0)[None, :] - xl, z)
    pen = pen + torch.maximum(xl - (g.xr + g.max_disp)[None, :], z)
    pen = pen + torch.maximum(torch.abs(ll - g.level_r[None, :]) - 1.0, z)
    pen = pen + (1.0 - g.valid_l)[:, None]
    pen = pen + (1.0 - g.valid_r)[None, :]
    return d.to(torch.float32) + _BIG * pen


class EpipolarGate(NamedTuple):
    """Epipolar band of ``search_for_triangulation``: rows are keypoints of
    keyframe a, columns keypoints of keyframe b; every tensor float32."""

    a: torch.Tensor  # (N,) epipolar line of the row point in image b
    b: torch.Tensor
    c: torch.Tensor
    den: torch.Tensor  # (N,) a^2 + b^2
    valid_a: torch.Tensor  # (N,) 1.0 / 0.0
    x: torch.Tensor  # (M,) column point
    y: torch.Tensor
    band: torch.Tensor  # (M,) 3.84 * sigma2[level_b]
    valid_b: torch.Tensor


class MutualGate(NamedTuple):
    """Validity-only gate of ``search_descriptors_mutual``; float32."""

    valid_a: torch.Tensor  # (N,)
    valid_b: torch.Tensor  # (M,)


def _valid_outer(va: torch.Tensor, vb: torch.Tensor) -> torch.Tensor:
    return va[:, None] * vb[None, :] > 0.5


def epipolar_mask(g: EpipolarGate) -> torch.Tensor:
    num = (g.a[:, None] * g.x[None, :] + g.b[:, None] * g.y[None, :]) + g.c[:, None]
    dsq = (num * num) / torch.clamp(g.den, min=1e-12)[:, None]
    return (dsq < g.band[None, :]) & _valid_outer(g.valid_a, g.valid_b)


def window_mask(g: WindowGate) -> torch.Tensor:
    dx = torch.abs(g.u[:, None] - g.kx[None, :])
    dy = torch.abs(g.v[:, None] - g.ky[None, :])
    lvl_ok = (g.k_level[None, :] >= g.pred_level[:, None] - 1.0) & (
        g.k_level[None, :] <= g.pred_level[:, None] + 1.0
    )
    valid = (g.valid[:, None] > 0.5) & (g.k_valid[None, :] > 0.5)
    return (dx <= g.radius[:, None]) & (dy <= g.radius[:, None]) & lvl_ok & valid


def hamming_best2_plain(desc_a: torch.Tensor, desc_b: torch.Tensor, gate):
    """Plain version of kernel C.  Returns (Best2, column argmin or None):
    StereoGate -> float32 distances of d + 10000 * pen and the per-column
    argmin of that matrix; WindowGate -> int32 masked distances and None;
    EpipolarGate, MutualGate -> int32 masked distances and the per-column
    argmin of the masked matrix."""
    d = hamming_matrix(desc_a, desc_b)
    if isinstance(gate, StereoGate):
        d_eff = stereo_cost(d, gate)
        return penalized_best2(d_eff), torch.argmin(d_eff, dim=0)
    if isinstance(gate, WindowGate):
        return masked_best2(d, window_mask(gate)), None
    mask = epipolar_mask(gate) if isinstance(gate, EpipolarGate) else _valid_outer(gate.valid_a, gate.valid_b)
    dm = torch.where(mask, d, torch.full_like(d, INF_DIST))
    return _best2(dm, INF_DIST), torch.argmin(dm, dim=0)


def hamming_best2(desc_a: torch.Tensor, desc_b: torch.Tensor, gate):
    """Kernel C on CUDA tensors, its plain version on CPU ones (same
    contract as ``hamming_best2_plain``)."""
    if desc_a.device.type == "cpu":
        return hamming_best2_plain(desc_a, desc_b, gate)
    max_disp = 0.0
    if isinstance(gate, StereoGate):
        mode = _STEREO
        row_f = torch.stack([gate.xl, gate.yl, gate.level_l, gate.valid_l, torch.zeros_like(gate.xl)], 1)
        col_f = torch.stack([gate.xr, gate.yr, gate.band_r, gate.level_r, gate.valid_r], 1)
        max_disp = float(gate.max_disp)
    elif isinstance(gate, WindowGate):
        mode = _WINDOW
        row_f = torch.stack([gate.u, gate.v, gate.radius, gate.pred_level, gate.valid], 1)
        col_f = torch.stack([gate.kx, gate.ky, gate.k_level, gate.k_valid, torch.zeros_like(gate.kx)], 1)
    elif isinstance(gate, EpipolarGate):
        mode = _EPIPOLAR
        row_f = torch.stack([gate.a, gate.b, gate.c, gate.den, gate.valid_a], 1)
        col_f = torch.stack([gate.x, gate.y, gate.band, gate.valid_b, torch.zeros_like(gate.x)], 1)
    else:
        mode = _MUTUAL
        za, zb = torch.zeros_like(gate.valid_a), torch.zeros_like(gate.valid_b)
        row_f = torch.stack([gate.valid_a, za, za, za, za], 1)
        col_f = torch.stack([gate.valid_b, zb, zb, zb, zb], 1)
    col_argmin = mode != _WINDOW
    n, m = desc_a.shape[0], desc_b.shape[0]
    _kernels.require_cuda(
        "hamming_best2", desc_a=(desc_a, torch.int32), desc_b=(desc_b, torch.int32),
        row_f=(row_f, torch.float32), col_f=(col_f, torch.float32),
    )
    if desc_a.shape[1:] != (8,) or desc_b.shape[1:] != (8,) or m < 1:
        raise ValueError("hamming_best2: needs (N,8) and (M,8) packed descriptors, M >= 1")
    if desc_a.data_ptr() % 16 or desc_b.data_ptr() % 16:
        raise ValueError("hamming_best2: descriptors must be 16-byte aligned (read as int4)")
    if col_argmin and m * 8 > _MAX_SHARED:
        raise ValueError(f"hamming_best2: this mode takes at most {_MAX_SHARED // 8} columns")
    dev = desc_a.device
    idx = torch.empty(n, dtype=torch.int32, device=dev)
    idx2 = torch.empty(n, dtype=torch.int32, device=dev)
    dist = torch.empty(n, dtype=torch.float32, device=dev)
    dist2 = torch.empty(n, dtype=torch.float32, device=dev)
    col_key = torch.full((m if col_argmin else 1,), -1, dtype=torch.int64, device=dev)
    _kernels.launch(
        "hamming_best2_launch", dev,
        desc_a.data_ptr(), desc_b.data_ptr(), n, m, mode,
        row_f.data_ptr(), col_f.data_ptr(), max_disp,
        idx.data_ptr(), dist.data_ptr(), dist2.data_ptr(), idx2.data_ptr(), col_key.data_ptr(),
    )
    hamming_best2.launches.add(MODE_NAMES[mode])
    col = col_key & 0xFFFFFFFF if col_argmin else None
    if mode == _STEREO:
        return Best2(idx.long(), dist, dist2, idx2.long()), col
    return Best2(idx.long(), dist.to(torch.int32), dist2.to(torch.int32), idx2.long()), col


hamming_best2.launches = _kernels.LaunchCounter()  # counted per mode too, by the names below
MODE_NAMES = ("stereo", "window", "epipolar", "mutual")  # by the kernel's mode number


def rotation_consistency(angle_a: torch.Tensor, angle_b: torch.Tensor, accept: torch.Tensor) -> torch.Tensor:
    """Rotation-histogram filter: keep matches in the 3 most populated of 30
    angle-difference bins (second and third only above 0.1x the first)."""
    two_pi = 2.0 * torch.pi
    rot = torch.remainder(angle_a - angle_b, two_pi)
    bins = torch.clamp(torch.round(rot * (HISTO_LENGTH / two_pi)).long(), 0, HISTO_LENGTH) % HISTO_LENGTH
    counts = torch.zeros(HISTO_LENGTH, dtype=torch.int64, device=accept.device).index_add_(
        0, bins, accept.long()
    )
    top_val, top_idx = torch.sort(counts, descending=True, stable=True)
    top_val, top_idx = top_val[:3].float(), top_idx[:3]
    keep2 = top_val[1] >= 0.1 * top_val[0]
    keep3 = top_val[2] >= 0.1 * top_val[0]
    good = (bins == top_idx[0]) & (top_val[0] > 0)
    good |= (bins == top_idx[1]) & keep2 & (top_val[1] > 0)
    good |= (bins == top_idx[2]) & keep3 & (top_val[2] > 0)
    return accept & good
