"""Batched PnP RANSAC for relocalisation.

Counterpart of ``orb_slam3_fast_tpu/optim/pnp.py`` (the reference's
MLPnPsolver with its RANSAC loop, min set 6, chi2 5.991): every hypothesis
at once.  256 six-point subsets, each solved by a conditioned 12x12 DLT
whose null vector gives two sign candidates, both projected onto SO(3) by
Procrustes, un-conditioned and polished by 4 Gauss-Newton steps on their
six points; the 512 poses are scored on all points and the first maximum
wins.  Subsets come from ``_sample_subsets`` (Gumbel top-6 among the valid
points), drawn on the host, so the card and the host score the same
hypotheses.

``pnp_ransac`` runs kernel P (``csrc/pnp_ransac.cu``) on CUDA tensors and
``pnp_ransac_plain`` on CPU ones.

Kernel P -- source note.
  Replaces: ``pnp_ransac`` (``orb_slam3_fast_tpu/optim/pnp.py:110``, with
  ``:38-106``, K18), one jitted program of 256 vmapped (12,12) SVDs, 512
  3x3 SVDs per GN step, ``jax.jacfwd`` per step and a (512, N) score.
  Bound on the card: latency.  It reads ~25 KB and does ~5 Mflop (the
  (512, N) score dominates); the serial float64 solves of one thread per
  hypothesis are what limit it.
  Design: two launches from one entry point.  One CTA per hypothesis
  block-reduces the conditioning (centre, spread) over the valid points;
  thread 0 builds the 12x12 DLT on the six conditioned points and takes
  its null vector as the least eigenvector of A^T A (the float64 Jacobi of
  ``csrc/jacobi.cuh``), and for each sign runs Procrustes (3x3 SVD by
  Jacobi, singular values sorted as the SVD sorts them, the determinant
  fix on the least one), ``t = P[:, 3] / mean(s)``, the un-conditioning
  ``t_m = spread t - R ctr``, then 4 GN steps with the closed-form 12x6
  Jacobian of (x/z, y/z) for a left increment [w, v], ``J^T J + 1e-8 I``
  solved by a 6x6 Cholesky, the so3_exp update and ``normalize_rotation``.
  All threads then score both poses on all points (pin-hole + radtan
  projection, or a KB8 camera's in the kernel's KB8 instance,
  ``csrc/camera.cuh``; err^2 * inv_sigma2 < 5.991, z > 0, valid),
  block-reduced.
  A second launch takes the first maximum of the 512 counts, writes its
  inlier mask and ``ok = n >= min_inliers & finite``.  The null vector's
  sign is the eigen-solver's, so the two candidates of a subset may come
  in the other order than the plain version's: among poses with the same
  count the first maximum may differ; the count and ``ok`` do not.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from orb_slam3_fast_tpu_torch import _kernels
from orb_slam3_fast_tpu_torch.cameras import models as cam_models
from orb_slam3_fast_tpu_torch.optim.pose_opt import KB8_KIND, RADTAN_KIND
from orb_slam3_fast_tpu_torch.utils import lie

CHI2_MONO = 5.991  # MLPnPsolver.h RansacParameters th2 (2-DoF 95%)
MIN_SET = 6
N_HYP = 256


class PnPResult(NamedTuple):
    R: torch.Tensor  # (3,3) T_cw rotation
    t: torch.Tensor  # (3,)
    inliers: torch.Tensor  # (N,) bool
    n_inliers: torch.Tensor  # () int32
    ok: torch.Tensor  # () bool


def _sample_subsets(seed: int, valid: torch.Tensor, n_hyp: int = N_HYP) -> torch.Tensor:
    """(n_hyp, 6) int64 indices of valid points, each row without
    replacement: the top 6 of Gumbel noise masked to the valid points (the
    distribution of the JAX package's draw), from a CPU ``torch.Generator``
    seeded with ``seed``; returned on ``valid``'s device."""
    g = torch.Generator().manual_seed(int(seed))
    u = torch.rand((n_hyp, valid.shape[0]), generator=g, dtype=torch.float64)
    gumbel = -torch.log(-torch.log(torch.clamp(u, min=1e-300)))
    gumbel = torch.where(valid.detach().cpu()[None, :], gumbel, torch.full_like(gumbel, -torch.inf))
    return torch.topk(gumbel, MIN_SET, dim=1).indices.to(valid.device)


def _procrustes(M: torch.Tensor):
    """Closest proper rotations to (...,3,3) M (orthogonal Procrustes with the
    determinant fix on the least singular direction) and the mean singular
    value."""
    u, s, vt = torch.linalg.svd(M)
    d = torch.sign(torch.linalg.det(u @ vt))
    one = torch.ones_like(d)
    return (u * torch.stack([one, one, d], -1)[..., None, :]) @ vt, s.mean(-1)


def _solve_dlt(xw: torch.Tensor, xn: torch.Tensor):
    """6-point DLT of P = [R|t] (world -> normalised plane) per subset:
    (...,6,3), (...,6,2) -> both sign candidates, R (...,2,3,3), t (...,2,3)."""
    X = torch.cat([xw, torch.ones_like(xw[..., :1])], dim=-1)  # (...,6,4)
    z = torch.zeros_like(X)
    A = torch.cat([torch.cat([X, z, -xn[..., 0:1] * X], -1), torch.cat([z, X, -xn[..., 1:2] * X], -1)], dim=-2)
    p = torch.linalg.svd(A)[2][..., -1, :].reshape(*xw.shape[:-2], 3, 4)
    P = torch.stack([p, -p], dim=-3)  # (...,2,3,4)
    R, scale = _procrustes(P[..., :3])
    return R, P[..., 3] / torch.clamp(scale, min=1e-12)[..., None]


def _residual(R, t, xw, xn):
    """(x/z, y/z) - xn of the subset's points at (R, t), |z| < 1e-6 held at
    1e-6 as the JAX residual does; (...,12)."""
    xc = xw @ R.transpose(-1, -2) + t[..., None, :]
    zc = xc[..., 2]
    z = torch.where(torch.abs(zc) < 1e-6, torch.full_like(zc, 1e-6), zc)
    return (xc[..., :2] / z[..., None] - xn).flatten(-2)


def gn_jacobian(R, t, xw) -> torch.Tensor:
    """Closed-form Jacobian (...,12,6) of the residual at a left increment
    [w, v] (``exp(w) (R x + t) + v``) at zero: d(x/z, y/z)/d xc times
    [-hat(xc) | I]; where |z| < 1e-6 the held z has no derivative."""
    xc = xw @ R.transpose(-1, -2) + t[..., None, :]
    x, y, zc = xc[..., 0], xc[..., 1], xc[..., 2]
    held = torch.abs(zc) < 1e-6
    z = torch.where(held, torch.full_like(zc, 1e-6), zc)
    iz = 1.0 / z
    dz = torch.where(held, torch.zeros_like(zc), iz * iz)
    zero = torch.zeros_like(x)
    du = torch.stack([iz, zero, -x * dz], -1)  # d(x/z)/d xc
    dv = torch.stack([zero, iz, -y * dz], -1)
    D = torch.stack([du, dv], -2)  # (...,6,2,3)
    J = torch.cat([D @ -lie.hat(xc), D], dim=-1)  # (...,6,2,6)
    return J.flatten(-3, -2)


def _refine_gn(R, t, xw, xn, iters: int = 4):
    """Gauss-Newton on the subset's own points (the MLPnP solver's
    ``mlpnp_gn``, MLPnPsolver.h:169-178), left-increment updates."""
    eye = 1e-8 * torch.eye(6, device=R.device)
    for _ in range(iters):
        r = _residual(R, t, xw, xn)
        J = gn_jacobian(R, t, xw)
        Jt = J.transpose(-1, -2)
        dx = -torch.linalg.solve(Jt @ J + eye, (Jt @ r[..., None]))[..., 0]
        dR = lie.so3_exp(dx[..., :3])
        R, t = lie.normalize_rotation(dR @ R), (dR @ t[..., None])[..., 0] + dx[..., 3:]
    return R, t


def _conditioning(xw: torch.Tensor, valid: torch.Tensor):
    """Centre and spread of the valid world points (the DLT runs on
    (x - ctr) / spread)."""
    n = torch.clamp(valid.sum(), min=1)
    z = torch.zeros((), device=xw.device)
    ctr = torch.where(valid[:, None], xw, z).sum(0) / n
    spread = torch.sqrt(torch.where(valid, ((xw - ctr) ** 2).sum(-1), z).sum() / n)
    return ctr, torch.clamp(spread, min=1e-6)


def _score(cam, R, t, xw, uv, inv_sigma2, valid):
    """(H, N) inlier flags of poses (H,3,3), (H,3)."""
    xc = torch.einsum("hij,nj->hni", R, xw) + t[:, None, :]
    err2 = ((cam_models.project(cam, xc) - uv[None]) ** 2).sum(-1) * inv_sigma2[None]
    return (err2 < CHI2_MONO) & (xc[..., 2] > 0.0) & valid[None]


def pnp_ransac_plain(cam, xw, uv, inv_sigma2, valid, subsets: torch.Tensor, min_inliers: int = 15) -> PnPResult:
    """Plain version of kernel P: the JAX program in PyTorch, on the given
    (H, 6) subsets."""
    xn_all = cam_models.unproject(cam, uv)[:, :2]
    ctr, spread = _conditioning(xw, valid)
    Rs, ts = _solve_dlt(((xw - ctr) / spread)[subsets], xn_all[subsets])  # (H,2,3,3), (H,2,3)
    # R((x - ctr) / s) + t == (R x + (s t - R ctr)) / s, the 1/s dropping out of the projection
    ts = spread * ts - Rs @ ctr
    sub_w, sub_n = xw[subsets][:, None].expand(-1, 2, -1, -1), xn_all[subsets][:, None].expand(-1, 2, -1, -1)
    Rs, ts = _refine_gn(Rs, ts, sub_w, sub_n)
    Rs, ts = Rs.reshape(-1, 3, 3), ts.reshape(-1, 3)
    inl = _score(cam, Rs, ts, xw, uv, inv_sigma2, valid)
    scores = inl.sum(1).to(torch.int32)
    best = torch.argmax(scores)
    R, t = Rs[best], ts[best]
    n_inl = scores[best]
    finite = torch.isfinite(R).all() & torch.isfinite(t).all()
    return PnPResult(R, t, inl[best], n_inl, (n_inl >= min_inliers) & finite)


def pnp_ransac(cam: cam_models.Camera, xw: torch.Tensor, uv: torch.Tensor, inv_sigma2: torch.Tensor,
               valid: torch.Tensor, seed: int, n_hyp: int = N_HYP, min_inliers: int = 15,
               subsets: torch.Tensor | None = None) -> PnPResult:
    """All-hypotheses PnP RANSAC: xw (N,3) world points, uv (N,2) pixels,
    inv_sigma2 (N,) per-point information, valid (N,) candidates; the
    subsets are ``subsets`` or ``_sample_subsets(seed, valid, n_hyp)``.
    Kernel P on CUDA tensors (``cam`` a host pin-hole or KB8 Camera), the
    plain version on CPU ones."""
    if subsets is None:
        subsets = _sample_subsets(seed, valid, n_hyp)
    if xw.device.type == "cpu":
        return pnp_ransac_plain(cam, xw, uv, inv_sigma2, valid, subsets, min_inliers)
    return _kernel(cam, xw, uv, inv_sigma2, valid, subsets, min_inliers)


def _kernel(cam, xw, uv, inv_sigma2, valid, subsets: torch.Tensor, min_inliers: int) -> PnPResult:
    """Kernel P's launch."""
    f32 = torch.float32
    subsets = subsets.to(torch.int32).contiguous()
    xn = cam_models.unproject(cam, uv)[:, :2].contiguous()
    _kernels.require_cuda("pnp_ransac", xw=(xw, f32), uv=(uv, f32), xn=(xn, f32), inv_sigma2=(inv_sigma2, f32),
                          valid=(valid, torch.bool), subsets=(subsets, torch.int32))
    n, h = xw.shape[0], subsets.shape[0]
    if xw.shape != (n, 3) or uv.shape != (n, 2) or inv_sigma2.shape != (n,) or valid.shape != (n,) or \
            subsets.shape != (h, MIN_SET):
        raise ValueError("pnp_ransac: needs (N,3) xw, (N,2) uv, (N,) inv_sigma2 and valid, (H,6) subsets")
    dev = xw.device
    params = cam.params.tolist()
    # fx fy cx cy k1 k2 p1 p2 k3 (pin-hole) or fx fy cx cy k1 k2 k3 k4 0 (KB8), on the host
    cam9 = torch.tensor(params + [0.0] * (9 - len(params)), dtype=f32)
    kb8 = cam.kind == cam_models.KB8
    kind = KB8_KIND if kb8 else RADTAN_KIND  # a pin-hole camera runs the radial-tangential code
    hyp_R, hyp_t, counts = (torch.empty(s, dtype=f32, device=dev) for s in ((2 * h, 9), (2 * h, 3), (2 * h,)))
    R, t = torch.empty((3, 3), dtype=f32, device=dev), torch.empty(3, dtype=f32, device=dev)
    inliers = torch.empty(n, dtype=torch.bool, device=dev)
    n_inl = torch.empty((), dtype=torch.int32, device=dev)
    ok = torch.empty((), dtype=torch.bool, device=dev)
    _kernels.launch(
        "pnp_ransac_launch", dev, xw.data_ptr(), uv.data_ptr(), xn.data_ptr(), inv_sigma2.data_ptr(),
        valid.data_ptr(), subsets.data_ptr(), n, h, cam9.numpy().ctypes.data, kind, min_inliers, hyp_R.data_ptr(),
        hyp_t.data_ptr(), counts.data_ptr(), R.data_ptr(), t.data_ptr(), inliers.data_ptr(), n_inl.data_ptr(),
        ok.data_ptr(),
    )
    pnp_ransac.launches.add(camera="kb8" if kb8 else "")
    return PnPResult(R, t, inliers, n_inl, ok)


pnp_ransac.launches = _kernels.LaunchCounter()  # camera instance "kb8" for a KB8 camera
