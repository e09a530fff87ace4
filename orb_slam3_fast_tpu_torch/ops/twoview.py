"""Two-view geometry: batched DLT triangulation, and the two-view
reconstruction that bootstraps a monocular map.

Counterpart of ``orb_slam3_fast_tpu/ops/twoview.py`` (TwoViewReconstruction,
GeometricTools::Triangulate).  ``reconstruct`` evaluates every hypothesis of
both models at once: 200 sampled 8-point F (rank 2) and 8-point DLT H on
Hartley-normalised coordinates, symmetric-transfer scores, the best of each
refitted on its inliers, the RH > 0.45 preference, 4 E-motions and 8
Faugeras H-motions scored by ``_check_rt``, and the JAX package's quality
and dominance verdict with its fallback to the other model.

``triangulate_dlt`` is the wrapper of kernel G (``csrc/triangulate_dlt.cu``),
``triangulate_dlt_plain`` the JAX code, an SVD per match.
``reconstruct`` runs kernel M (``csrc/twoview_ransac.cu``) on CUDA tensors
and ``reconstruct_plain`` on CPU ones; both take their (200, 8) sample
indices from ``_sample_hypotheses``, drawn on the host, so the card and the
host score the same hypotheses.

Kernel G -- source note.
  Replaces: ``triangulate_dlt`` (``orb_slam3_fast_tpu/ops/twoview.py:164``,
  K14), a batched (N,4,4) ``jnp.linalg.svd`` on rows padded to 256 * 2^k.
  Bound on the card: latency.  A local-mapping pass triangulates a few
  hundred matches per neighbour, ~1 kflop each; a batched library SVD pays
  several launches and a workspace per call.
  Design: one thread per match builds the 4x4 ``A`` as the reference does,
  forms ``A^T A`` in float64 (the H100 has full-rate fp64 units) and runs
  the cyclic Jacobi of ``csrc/jacobi.cuh`` on it until the off-diagonal
  squares fall below 1e-32 of the diagonal's (at most 30 sweeps); the
  eigenvector of the least eigenvalue is the right singular vector of the
  least singular value.  Its sign is arbitrary, as the SVD's is, and
  cancels in ``X[:3] / w``; ``|w| < 1e-12`` is guarded as in the reference.

Kernel M -- source note.
  Replaces: ``reconstruct`` (``orb_slam3_fast_tpu/ops/twoview.py:304``, with
  ``:36-291``, K15), one jitted program of vmapped float32 SVDs (200 x
  (8,9) and (16,9), 200 x 3x3, 12 x (N,4,4)), (200, N) score matrices and
  a sort per motion.
  Bound on the card: latency.  It reads ~20 KB and does ~10 Mflop (the
  (200, N) scores and 12 x N triangulations), microseconds at the card's
  rates; what limits it is the serial float64 Jacobi of one thread.
  Design: three launches from one entry point.  ``fit_score``: one CTA per
  hypothesis block-reduces the Hartley normalisation, thread 0 solves the
  8x9 F system and thread 1 the 16x9 H system as the least eigenvector of
  A^T A (float64 Jacobi), F loses its least right-singular direction
  (``F - F v3 v3^T`` = u diag(s1, s2, 0) v^T), both are denormalised, and
  all threads score all points against both (``Hinv`` by the adjugate),
  block-reduced.  ``refit``: one CTA per model takes the first maximum, its
  inliers, the normalisation and the 9x9 A^T A over them in float64,
  solves, rescores, and keeps the refit or the sampled best by the rule of
  ``twoview.py:357-362``.  ``check_rt``: one CTA per motion derives it
  from the 3x3 SVD (Jacobi on M^T M, ``u = M v / s``, the third u of F as
  u1 x u2), triangulates its points with the shared 4x4 DLT, applies
  ``_check_rt``'s tests in order, block-reduces the count and the quality,
  and takes the parallax from a bitonic sort of the counted cosines in
  shared memory.  The verdict over the 12 motions stays a few tensor
  operations.  The SVD's signs are its own, so F and H equal the plain
  version's up to sign (no score sees it) and the motions are equal as a
  set; the choice is an argmax over distinct motions.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from orb_slam3_fast_tpu_torch import _kernels
from orb_slam3_fast_tpu_torch.cameras import models as cam_models

SIGMA = 1.0  # reference mSigma
TH_F = 3.841  # CheckFundamental per-direction chi2 (1 DoF)
TH_SCORE_F = 5.991
TH_H = 5.991  # CheckHomography chi2 (2 DoF)
N_ITERS = 200


def triangulate_dlt_plain(P0: torch.Tensor, P1: torch.Tensor, x0: torch.Tensor, x1: torch.Tensor) -> torch.Tensor:
    """Plain version of kernel G.  P: (...,3,4) projections, x: (N,2)
    normalised coordinates; returns (...,N,3) points."""
    A = torch.stack(
        [x0[:, 0:1] * P0[..., None, 2, :] - P0[..., None, 0, :], x0[:, 1:2] * P0[..., None, 2, :] - P0[..., None, 1, :],
         x1[:, 0:1] * P1[..., None, 2, :] - P1[..., None, 0, :], x1[:, 1:2] * P1[..., None, 2, :] - P1[..., None, 1, :]],
        dim=-2,
    )  # (...,N,4,4)
    _, _, vt = torch.linalg.svd(A)
    X = vt[..., -1, :]
    w = X[..., 3:]
    return X[..., :3] / torch.where(torch.abs(w) < 1e-12, torch.full_like(w, 1e-12), w)


def triangulate_dlt(P0: torch.Tensor, P1: torch.Tensor, x0: torch.Tensor, x1: torch.Tensor) -> torch.Tensor:
    """Kernel G on CUDA tensors, its plain version on CPU ones."""
    if x0.device.type == "cpu":
        return triangulate_dlt_plain(P0, P1, x0, x1)
    f32 = torch.float32
    P0, P1 = P0.to(f32).contiguous(), P1.to(f32).contiguous()
    _kernels.require_cuda(
        "triangulate_dlt", P0=(P0, f32), P1=(P1, f32), x0=(x0, f32), x1=(x1, f32),
    )
    n = x0.shape[0]
    if P0.shape != (3, 4) or P1.shape != (3, 4) or x0.shape != (n, 2) or x1.shape != (n, 2):
        raise ValueError("triangulate_dlt: needs (3,4) projections and (N,2) points")
    X = torch.empty((n, 3), dtype=f32, device=x0.device)
    _kernels.launch(
        "triangulate_dlt_launch", x0.device, P0.data_ptr(), P1.data_ptr(), x0.data_ptr(), x1.data_ptr(), n,
        X.data_ptr(),
    )
    triangulate_dlt.launches.add()
    return X


triangulate_dlt.launches = _kernels.LaunchCounter()


# --- two-view reconstruction -----------------------------------------------------


class TwoViewResult(NamedTuple):
    success: torch.Tensor  # () bool
    R: torch.Tensor  # (3,3) T_c1_c0 rotation
    t: torch.Tensor  # (3,) unit-norm translation
    X: torch.Tensor  # (N,3) triangulated points in cam0
    good: torch.Tensor  # (N,) triangulation validity
    used_h: torch.Tensor  # () bool: which model was selected


def _sample_hypotheses(seed: int, valid: torch.Tensor, n_iters: int = N_ITERS) -> torch.Tensor:
    """(n_iters, 8) int64 indices drawn with replacement among the valid
    matches, uniformly (the distribution of ``jax.random.choice(key, n,
    (n_iters, 8), p=valid / sum)``), from a CPU ``torch.Generator`` seeded
    with ``seed``; returned on ``valid``'s device."""
    p = valid.detach().cpu().to(torch.float64)
    if not bool(p.any()):
        return torch.zeros((n_iters, 8), dtype=torch.int64, device=valid.device)
    g = torch.Generator().manual_seed(int(seed))
    idx = torch.multinomial(p / p.sum(), n_iters * 8, replacement=True, generator=g)
    return idx.reshape(n_iters, 8).to(valid.device)


def _normalize(pts: torch.Tensor, valid: torch.Tensor):
    """Hartley normalisation (TwoViewReconstruction.cc:374-410)."""
    n = torch.clamp(valid.sum(), min=1)
    z = torch.zeros((), device=pts.device)
    mean = torch.where(valid[:, None], pts, z).sum(0) / n
    meandev = torch.where(valid[:, None], torch.abs(pts - mean), z).sum(0) / n
    s = 1.0 / torch.clamp(meandev, min=1e-8)
    o = torch.ones((), device=pts.device)
    T = torch.stack([torch.stack([s[0], z, -mean[0] * s[0]]), torch.stack([z, s[1], -mean[1] * s[1]]),
                     torch.stack([z, z, o])])
    return (pts - mean) * s, T


def _null_vector(A: torch.Tensor) -> torch.Tensor:
    """The right singular vector of the least singular value, (...,9)."""
    return torch.linalg.svd(A, full_matrices=A.shape[-2] < A.shape[-1])[2][..., -1, :]


def _rank2(F: torch.Tensor) -> torch.Tensor:
    u, s, vt = torch.linalg.svd(F)
    s = torch.cat([s[..., :2], torch.zeros_like(s[..., 2:])], dim=-1)
    return u @ torch.diag_embed(s) @ vt


def _f_rows(x0: torch.Tensor, x1: torch.Tensor) -> torch.Tensor:
    return torch.stack([x1[..., 0] * x0[..., 0], x1[..., 0] * x0[..., 1], x1[..., 0], x1[..., 1] * x0[..., 0],
                        x1[..., 1] * x0[..., 1], x1[..., 1], x0[..., 0], x0[..., 1], torch.ones_like(x0[..., 0])], -1)


def _h_rows(x0: torch.Tensor, x1: torch.Tensor) -> torch.Tensor:
    z, o = torch.zeros_like(x0[..., 0]), torch.ones_like(x0[..., 0])
    r1 = torch.stack([x0[..., 0], x0[..., 1], o, z, z, z, -x1[..., 0] * x0[..., 0], -x1[..., 0] * x0[..., 1],
                      -x1[..., 0]], -1)
    r2 = torch.stack([z, z, z, x0[..., 0], x0[..., 1], o, -x1[..., 1] * x0[..., 0], -x1[..., 1] * x0[..., 1],
                      -x1[..., 1]], -1)
    return torch.cat([r1, r2], dim=-2)


def _fit_f8(x0: torch.Tensor, x1: torch.Tensor) -> torch.Tensor:
    """Normalised 8-point F per sample: (...,8,2) x2 -> (...,3,3), rank 2."""
    return _rank2(_null_vector(_f_rows(x0, x1)).reshape(*x0.shape[:-2], 3, 3))


def _fit_h8(x0: torch.Tensor, x1: torch.Tensor) -> torch.Tensor:
    """8-point DLT homography (ComputeH21): (...,8,2) x2 -> (...,3,3)."""
    return _null_vector(_h_rows(x0, x1)).reshape(*x0.shape[:-2], 3, 3)


def _refit_f(x0, x1, inlier, valid):
    """Least-squares F on all inliers (other rows zeroed)."""
    m = inlier & valid
    xn0, T0 = _normalize(x0, m)
    xn1, T1 = _normalize(x1, m)
    F = _rank2(_null_vector(_f_rows(xn0, xn1) * m[:, None].to(x0.dtype)).reshape(3, 3))
    return T1.T @ F @ T0


def _refit_h(x0, x1, inlier, valid):
    m = inlier & valid
    xn0, T0 = _normalize(x0, m)
    xn1, T1 = _normalize(x1, m)
    w = m.to(x0.dtype).repeat(2)[:, None]
    H = _null_vector(_h_rows(xn0, xn1) * w).reshape(3, 3)
    return torch.linalg.inv(T1) @ H @ T0


def _homog(x: torch.Tensor) -> torch.Tensor:
    return torch.cat([x, torch.ones_like(x[:, :1])], dim=-1)


def _score_f(F, x0, x1, valid, sigma2):
    """Symmetric epipolar-transfer score (CheckFundamental, :545-637) of
    (...,3,3) models: (score (...), inliers (...,N))."""
    x0h, x1h = _homog(x0), _homog(x1)
    l1 = x0h @ F.transpose(-1, -2)  # lines in image 1
    l0 = x1h @ F  # lines in image 0
    d1 = torch.sum(l1 * x1h, -1) ** 2 / torch.clamp(l1[..., 0] ** 2 + l1[..., 1] ** 2, min=1e-12)
    d0 = torch.sum(l0 * x0h, -1) ** 2 / torch.clamp(l0[..., 0] ** 2 + l0[..., 1] ** 2, min=1e-12)
    c1, c0 = d1 / sigma2, d0 / sigma2
    in1, in0 = c1 <= TH_F, c0 <= TH_F
    z = torch.zeros((), device=x0.device)
    s = torch.where(in1, TH_SCORE_F - c1, z) + torch.where(in0, TH_SCORE_F - c0, z)
    return torch.where(valid, s, z).sum(-1), in0 & in1 & valid


def _dehomog(p: torch.Tensor) -> torch.Tensor:
    w = p[..., 2:]
    return p[..., :2] / torch.where(torch.abs(w) < 1e-12, torch.full_like(w, 1e-12), w)


def _score_h(H, x0, x1, valid, sigma2):
    """Symmetric homography-transfer score (CheckHomography, :462-545)."""
    x0h, x1h = _homog(x0), _homog(x1)
    p1 = _dehomog(x0h @ H.transpose(-1, -2))
    p0 = _dehomog(x1h @ torch.linalg.inv(H).transpose(-1, -2))
    c1 = torch.sum((x1 - p1) ** 2, -1) / sigma2
    c0 = torch.sum((x0 - p0) ** 2, -1) / sigma2
    in1, in0 = c1 <= TH_H, c0 <= TH_H
    z = torch.zeros((), device=x0.device)
    s = torch.where(in1, TH_H - c1, z) + torch.where(in0, TH_H - c0, z)
    return torch.where(valid, s, z).sum(-1), in0 & in1 & valid


def _check_rt(R, t, x0, x1, valid, sigma2, th2: float = 4.0):
    """Score motions (...,3,3), (...,3) by triangulating every match
    (CheckRT, TwoViewReconstruction.cc:845-947), on the normalised plane.
    The cheirality test rejects only points with parallax; ``n_good``
    counts points passing cheirality and reprojection; the triangulated flag
    also needs parallax and positive depths; the parallax is the acos of the
    ascending counted cosines at min(50, n_good - 1); the quality sums
    2 th2 - (e0 + e1) / sigma2 over the counted points.  Returns (n_good,
    tri, parallax_deg, X, quality)."""
    P0 = torch.eye(3, 4, device=x0.device).expand(*R.shape[:-2], 3, 4)
    P1 = torch.cat([R, t[..., None]], dim=-1)
    X = triangulate_dlt_plain(P0, P1, x0, x1)
    finite = torch.isfinite(X).all(-1)
    o1 = -(R.transpose(-1, -2) @ t[..., None])[..., 0]
    n0, n1 = X, X - o1[..., None, :]
    cosp = (n0 * n1).sum(-1) / torch.clamp(torch.linalg.vector_norm(n0, dim=-1) * torch.linalg.vector_norm(n1, dim=-1),
                                           min=1e-12)
    has_par = cosp < 0.99998
    z0 = X[..., 2]
    Xc1 = X @ R.transpose(-1, -2) + t[..., None, :]
    z1 = Xc1[..., 2]
    cheirality_ok = ~((z0 <= 0) & has_par) & ~((z1 <= 0) & has_par)
    z0s = torch.where(torch.abs(z0) < 1e-9, torch.full_like(z0, 1e-9), z0)
    z1s = torch.where(torch.abs(z1) < 1e-9, torch.full_like(z1, 1e-9), z1)
    e0 = torch.sum((X[..., :2] / z0s[..., None] - x0) ** 2, -1)
    e1 = torch.sum((Xc1[..., :2] / z1s[..., None] - x1) ** 2, -1)
    counted = valid & finite & cheirality_ok & (e0 < th2 * sigma2) & (e1 < th2 * sigma2)
    n_good = counted.sum(-1).to(torch.int32)
    tri = counted & has_par & (z0 > 0) & (z1 > 0)
    cos_sorted = torch.sort(torch.where(counted, cosp, torch.full_like(cosp, 2.0)), dim=-1).values
    k = torch.clamp(torch.minimum(torch.full_like(n_good, 50), n_good - 1), 0, cosp.shape[-1] - 1)
    kth = torch.gather(cos_sorted, -1, k[..., None].long())[..., 0]
    parallax = torch.where(n_good > 0, torch.rad2deg(torch.arccos(torch.clamp(kth, -1.0, 1.0))), torch.zeros_like(kth))
    z = torch.zeros((), device=x0.device)
    q = torch.where(counted, 2.0 * th2 - (e0 + e1) / max(float(sigma2), 1e-18), z).sum(-1)
    return n_good, tri, parallax, X, q


def _motions_from_f(F: torch.Tensor):
    """E = F on the normalised plane; its 4 motions (DecomposeE, :637-668)."""
    u, _, vt = torch.linalg.svd(F)
    W = torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]], device=F.device)
    R1, R2 = u @ W @ vt, u @ W.T @ vt
    R1 = R1 * torch.sign(torch.linalg.det(R1))
    R2 = R2 * torch.sign(torch.linalg.det(R2))
    t = u[:, 2] / torch.clamp(torch.linalg.vector_norm(u[:, 2]), min=1e-12)
    return torch.stack([R1, R1, R2, R2]), torch.stack([t, -t, t, -t])


def _motions_from_h(H: torch.Tensor):
    """Faugeras' decomposition of a homography into 8 motions
    (ReconstructH, TwoViewReconstruction.cc:668-830)."""
    U, w, Vt = torch.linalg.svd(H)
    s = torch.linalg.det(U) * torch.linalg.det(Vt)
    d1, d2, d3 = w[0], w[1], w[2]
    den13 = torch.clamp(d1 * d1 - d3 * d3, min=1e-12)
    aux1 = torch.sqrt(torch.clamp((d1 * d1 - d2 * d2) / den13, min=0.0))
    aux3 = torch.sqrt(torch.clamp((d2 * d2 - d3 * d3) / den13, min=0.0))
    sgn1, sgn3, sgn_s = (1.0, 1.0, -1.0, -1.0), (1.0, -1.0, 1.0, -1.0), (1.0, -1.0, -1.0, 1.0)
    prod = torch.sqrt(torch.clamp((d1 * d1 - d2 * d2) * (d2 * d2 - d3 * d3), min=0.0))
    aux_st = prod / torch.clamp((d1 + d3) * d2, min=1e-12)
    ct = (d2 * d2 + d1 * d3) / torch.clamp((d1 + d3) * d2, min=1e-12)
    aux_sp = prod / torch.clamp((d1 - d3) * d2, min=1e-12)
    cp = (d1 * d3 - d2 * d2) / torch.clamp((d1 - d3) * d2, min=1e-12)
    z, o = torch.zeros_like(d1), torch.ones_like(d1)
    Rs, ts = [], []
    for case in range(2):  # d' = d2, then d' = -d2
        for i in range(4):
            x1, x3 = sgn1[i] * aux1, sgn3[i] * aux3
            if case == 0:
                st = sgn_s[i] * aux_st
                Rp = torch.stack([torch.stack([ct, z, -st]), torch.stack([z, o, z]), torch.stack([st, z, ct])])
                tp = torch.stack([x1, z, -x3]) * (d1 - d3)
            else:
                sp = sgn_s[i] * aux_sp
                Rp = torch.stack([torch.stack([cp, z, sp]), torch.stack([z, -o, z]), torch.stack([sp, z, -cp])])
                tp = torch.stack([x1, z, x3]) * (d1 + d3)
            Rs.append(s * U @ Rp @ Vt)
            t = U @ tp
            ts.append(t / torch.clamp(torch.linalg.vector_norm(t), min=1e-12))
    return torch.stack(Rs), torch.stack(ts)


def _camera_plane(cam: cam_models.Camera, uv0: torch.Tensor, uv1: torch.Tensor):
    """Both views' points on the normalised plane, and sigma^2 in its units."""
    x0 = cam_models.unproject(cam, uv0)[:, :2].contiguous()
    x1 = cam_models.unproject(cam, uv1)[:, :2].contiguous()
    f_mean = (float(cam.params[0]) + float(cam.params[1])) * 0.5
    return x0, x1, (SIGMA / f_mean) ** 2


def _verdict(Rall, tall, ngood, goods, parallax, Xs, qual, SF, SH, valid, inl_f, inl_h,
             min_triangulated: int, min_parallax_deg: float) -> TwoViewResult:
    """The choice among the 12 motions (TwoViewReconstruction::Reconstruct,
    :44-130, with the JAX package's extensions, ``twoview.py:363-424``):
    RH > 0.45 prefers H; per model the best motion by quality, gated by
    count, 90%-dominance on count, quality or parallax, and parallax; the
    other model where the preferred one fails."""
    prefer_h = SH / torch.clamp(SH + SF, min=1e-12) > 0.45
    idx = torch.arange(12, device=Rall.device)

    def model_verdict(sel, inl, dom):
        qq = torch.where(sel, qual, torch.full_like(qual, -1.0))
        ng = torch.where(sel, ngood, torch.full_like(ngood, -1))
        b = torch.argmax(qq)
        nb = ng[b]
        other = idx != b
        ns = torch.where(other, ng, torch.full_like(ng, -1)).max()
        qs = torch.where(other, qq, torch.full_like(qq, -1.0)).max()
        ps = torch.where(sel & other, parallax, torch.full_like(parallax, -1.0)).max()
        nmin = torch.clamp((0.9 * (valid & inl).sum().to(torch.int32).to(torch.float32)).to(torch.int32),
                           min=min_triangulated)
        dominant = ((ns.to(torch.float32) < dom * nb.to(torch.float32)) | (qs < 0.6 * qq[b])
                    | (ps < 0.5 * parallax[b]))
        return (nb >= nmin) & dominant & (parallax[b] > min_parallax_deg), b

    # dominance thresholds: ReconstructF 0.7 (:586), ReconstructH 0.75 (:805)
    ok_f, best_fi = model_verdict(idx < 4, inl_f, 0.7)
    ok_h, best_hi = model_verdict(idx >= 4, inl_h, 0.75)
    use_h = torch.where(prefer_h, ok_h | ~ok_f, ~ok_f & ok_h)
    best = torch.where(use_h, best_hi, best_fi)
    return TwoViewResult(success=torch.where(use_h, ok_h, ok_f), R=Rall[best], t=tall[best], X=Xs[best],
                         good=goods[best], used_h=use_h)


def reconstruct_plain(cam, uv0, uv1, valid, samples: torch.Tensor, min_triangulated: int = 50,
                      min_parallax_deg: float = 1.0) -> TwoViewResult:
    """Plain version of kernel M: the JAX program in PyTorch, on the given
    (I, 8) hypothesis samples."""
    x0, x1, sigma2 = _camera_plane(cam, uv0, uv1)
    s0n, T0 = _normalize(x0, valid)
    s1n, T1 = _normalize(x1, valid)
    Fs = T1.T @ _fit_f8(s0n[samples], s1n[samples]) @ T0
    Hs = torch.linalg.inv(T1) @ _fit_h8(s0n[samples], s1n[samples]) @ T0
    score_f, _ = _score_f(Fs, x0, x1, valid, sigma2)
    score_h, _ = _score_h(Hs, x0, x1, valid, sigma2)
    best_f, best_h = Fs[torch.argmax(score_f)], Hs[torch.argmax(score_h)]
    # refit on the best hypothesis' inliers; keep it unless it scores lower
    _, inl_f = _score_f(best_f, x0, x1, valid, sigma2)
    _, inl_h = _score_h(best_h, x0, x1, valid, sigma2)
    ref_f, ref_h = _refit_f(x0, x1, inl_f, valid), _refit_h(x0, x1, inl_h, valid)
    score_fr, _ = _score_f(ref_f, x0, x1, valid, sigma2)
    score_hr, _ = _score_h(ref_h, x0, x1, valid, sigma2)
    SF, SH = torch.maximum(score_f.max(), score_fr), torch.maximum(score_h.max(), score_hr)
    best_f = torch.where(score_fr >= score_f.max(), ref_f, best_f)
    best_h = torch.where(score_hr >= score_h.max(), ref_h, best_h)
    _, inl_f = _score_f(best_f, x0, x1, valid, sigma2)
    _, inl_h = _score_h(best_h, x0, x1, valid, sigma2)
    Rf, tf = _motions_from_f(best_f)
    Rh, th = _motions_from_h(best_h)
    Rall, tall = torch.cat([Rf, Rh]), torch.cat([tf, th])
    # CheckRT runs over each model's own RANSAC inliers
    inl_all = torch.where(torch.arange(12, device=x0.device)[:, None] >= 4, inl_h[None, :], inl_f[None, :])
    ngood, goods, parallax, Xs, qual = _check_rt(Rall, tall, x0, x1, valid & inl_all, sigma2)
    return _verdict(Rall, tall, ngood, goods, parallax, Xs, qual, SF, SH, valid, inl_f, inl_h, min_triangulated,
                    min_parallax_deg)


def reconstruct(cam: cam_models.Camera, uv0: torch.Tensor, uv1: torch.Tensor, valid: torch.Tensor, seed: int,
                n_iters: int = N_ITERS, min_triangulated: int = 50, min_parallax_deg: float = 1.0,
                samples: torch.Tensor | None = None) -> TwoViewResult:
    """Two-view bootstrap from matched pixel keypoints (N slots, ``valid``
    marking the matches): TwoViewReconstruction::Reconstruct (:44-130).
    The hypotheses are ``samples`` or ``_sample_hypotheses(seed, valid,
    n_iters)``.  Kernel M on CUDA tensors (``cam`` a host pin-hole Camera),
    ``reconstruct_plain`` on CPU ones."""
    if samples is None:
        samples = _sample_hypotheses(seed, valid, n_iters)
    if uv0.device.type == "cpu":
        return reconstruct_plain(cam, uv0, uv1, valid, samples, min_triangulated, min_parallax_deg)
    if cam.kind != cam_models.PINHOLE:
        raise NotImplementedError("kernel M takes pin-hole cameras; KB8 waits for ROADMAP §A item 15 (the monocular "
                                  "fisheye rig)")
    x0, x1, sigma2 = _camera_plane(cam, uv0, uv1)
    samples = samples.to(torch.int32).contiguous()
    f32 = torch.float32
    _kernels.require_cuda("reconstruct", x0=(x0, f32), x1=(x1, f32), valid=(valid, torch.bool),
                          samples=(samples, torch.int32))
    n, n_hyp = x0.shape[0], samples.shape[0]
    if x1.shape != (n, 2) or valid.shape != (n,) or samples.shape != (n_hyp, 8) or not 1 <= n <= 2048:
        raise ValueError("reconstruct: needs (N,2) points of both views, (N,) valid, (I,8) samples, 1 <= N <= 2048")
    dev = x0.device
    e = lambda *s, dtype=f32: torch.empty(s, dtype=dtype, device=dev)  # noqa: E731
    hyp, hyp_score = e(2, n_hyp, 9), e(2, n_hyp)
    model, model_score, inl = e(2, 9), e(2), e(2, n, dtype=torch.bool)
    Rall, tall, Xs, goods = e(12, 3, 3), e(12, 3), e(12, n, 3), e(12, n, dtype=torch.bool)
    ngood, parallax, qual = e(12, dtype=torch.int32), e(12), e(12)
    _kernels.launch(
        "twoview_ransac_launch", dev, x0.data_ptr(), x1.data_ptr(), valid.data_ptr(), samples.data_ptr(), n, n_hyp,
        float(sigma2), hyp.data_ptr(), hyp_score.data_ptr(), model.data_ptr(), model_score.data_ptr(), inl.data_ptr(),
        Rall.data_ptr(), tall.data_ptr(), Xs.data_ptr(), goods.data_ptr(), ngood.data_ptr(), parallax.data_ptr(),
        qual.data_ptr(),
    )
    reconstruct.launches.add()
    return _verdict(Rall, tall, ngood, goods, parallax, Xs, qual, model_score[0], model_score[1], valid, inl[0],
                    inl[1], min_triangulated, min_parallax_deg)


reconstruct.launches = _kernels.LaunchCounter()
