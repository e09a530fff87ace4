"""Sim3 between two keyframes: Horn's closed form, the batched RANSAC and
the Gauss-Newton refinement of loop verification.

Counterpart of ``orb_slam3_fast_tpu/optim/sim3.py`` (the reference's
Sim3Solver: 3-point Horn inside a RANSAC with the two-image reprojection
check; Optimizer::OptimizeSim3: one Sim3 vertex with paired forward and
inverse projection edges, Huber delta sqrt(10), 5 iterations, an inlier
re-gate, 10 more).  Every hypothesis is solved and scored at once.  The
hypotheses' point triples come from ``_sample_subsets`` (Gumbel top-3
among the valid pairs), drawn on the host from a seeded CPU generator, so
the card and the host score the same hypotheses; a caller may pass them in
as ``subsets``.

``sim3_ransac`` runs kernel Q (``csrc/sim3_ransac.cu``) and
``optimize_sim3`` kernel R (``csrc/sim3_refine.cu``) on CUDA tensors, and
their plain versions on CPU ones.  Both kernels take a template instance
per camera kind (``csrc/camera.cuh``): pin-hole cameras run the
instructions they always ran, radial-tangential ones the distorted
projection, KB8 ones (the TUM-VI rig's loop closing) the Kannala-Brandt
projection and its closed-form Jacobian; the two cameras are of one kind,
as the loop closer's always are.

Kernel Q -- source note.
  Replaces: ``sim3_ransac`` (``orb_slam3_fast_tpu/optim/sim3.py:62``,
  K19), one jitted program of 128 vmapped Horn solves (a 3x3 SVD each)
  and a (128, N) two-sided reprojection score.
  Bound on the card: latency.  It reads ~30 bytes per pair (~23 KB at
  N = 768) and does ~100 flops per hypothesis and pair (~10 Mflop); 128
  CTAs cover the card's 132 SMs once.  A KB8 pair adds two ``atan2f``,
  two divisions and two degree-9 polynomials to the ~100 flops.
  Design: two launches.  One CTA per hypothesis: thread 0 runs Horn on
  its three pairs in float64 (centroids, M = yc^T xc, the 3x3 SVD of
  ``csrc/jacobi.cuh``, the determinant sign on the least singular
  direction, the symmetric scale, 1 under ``fix_scale``) and writes the
  float32 Sim3 to shared memory; every thread then maps its pairs both
  ways, projects them through the cameras (their kind's instance) and counts the
  chi2 < 9.210, z > 0, valid pairs; the count is a fixed-order block
  reduction.  A selection CTA takes the first maximum (``argmax``'s
  choice), writes its Sim3, its inlier mask and ``ok``: count >=
  min_inliers with a finite Sim3 and 1e-3 < s < 1e3.

Kernel R -- source note.
  Replaces: ``optimize_sim3`` (``orb_slam3_fast_tpu/optim/sim3.py:134``,
  K19): 15 Gauss-Newton steps, each a ``jax.jacfwd`` of the (4N,)
  residual, a (4N, 7) Jacobian product and a float32 7x7 solve.
  Bound on the card: latency.  ~300 flops per pair and step (~3.5 Mflop
  at N = 768), 15 dependent steps.
  Design: one CTA of 256 threads runs the whole schedule: 5 steps, the
  chi2 re-gate, 10 steps, the final gate.  Per step every thread takes its
  pairs: both residuals, the closed-form Jacobians of
  ``pair_jacobians`` (forward: d proj(y) [I | -hat(y) | y]; inverse:
  -d proj(q) (R^T / s) [I | -hat(x1) | x1]), the Huber IRLS weight
  (delta = sqrt(10)) times 1 / sigma^2 and the mask, and its share of the
  28 + 7 sums of J^T W J and J^T W r in float64; the sums are fixed-order
  block reductions, so a run repeats bit for bit.  Thread 0 pins the scale
  row and column under ``fix_scale``, adds 1e-6 I, solves the 7x7 system
  by a float64 Cholesky, applies ``sim3_exp(dx)`` on the left in float64
  (the four branches of ``_sim3_W_coeffs``) and re-orthonormalises R by
  the 3x3 SVD.  The JAX package's float32 LU becomes a float64 Cholesky:
  the step agrees to float32 rounding.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from orb_slam3_fast_tpu_torch import _kernels
from orb_slam3_fast_tpu_torch.cameras import models as cam_models
from orb_slam3_fast_tpu_torch.optim.pose_opt import CAMERA_NAMES, KB8_KIND, PINHOLE_KIND, RADTAN_KIND
from orb_slam3_fast_tpu_torch.utils import lie

CHI2_SIM3 = 9.210  # Sim3Solver.cc mvnMaxError scale (2-DoF 99%)
HUBER_SIM3 = 10.0**0.5  # Optimizer.cc:2208 deltaHuber
FREE_SCALE = "free_scale"  # the launch counters' mode of a solve with the scale free
N_HYP = 128
MIN_SET = 3


def jax_seed(key: int) -> int:
    """The seed the JAX package's ``PRNGKey(key)`` keeps of a key wider than
    32 bits: its low word (``loopcloser.py:427`` passes k * 2654435761 + c)."""
    return int(key) & 0xFFFFFFFF


def horn_sim3(x: torch.Tensor, y: torch.Tensor, fix_scale: bool = False) -> lie.Sim3:
    """Closed-form similarity y = s R x + t from paired points (...,N,3),
    N >= 3 (Sim3Solver::ComputeSim3, Sim3Solver.cc:319-404), by the SVD
    form of orthogonal Procrustes; ``fix_scale`` pins s = 1."""
    mx, my = x.mean(-2), y.mean(-2)
    xc, yc = x - mx[..., None, :], y - my[..., None, :]
    M = torch.einsum("...ni,...nj->...ij", yc, xc)
    u, _, vt = torch.linalg.svd(M)
    d = torch.sign(torch.linalg.det(u @ vt))
    one = torch.ones_like(d)
    R = (u * torch.stack([one, one, d], -1)[..., None, :]) @ vt
    s = torch.sqrt(torch.sum(yc * yc, dim=(-1, -2)) / torch.clamp(torch.sum(xc * xc, dim=(-1, -2)), min=1e-12))
    if fix_scale:
        s = torch.ones_like(s)
    t = my - s[..., None] * torch.einsum("...ij,...j->...i", R, mx)
    return lie.Sim3(R, t, s)


class Sim3Result(NamedTuple):
    S12: lie.Sim3  # maps keyframe-2 camera coordinates to keyframe-1 camera coordinates
    inliers: torch.Tensor  # (N,) bool
    n_inliers: torch.Tensor  # () int32
    ok: torch.Tensor  # () bool


def _sample_subsets(seed: int, valid: torch.Tensor, n_hyp: int = N_HYP) -> torch.Tensor:
    """(n_hyp, 3) int64 indices of valid pairs, each row without
    replacement: the top 3 of Gumbel noise masked to the valid pairs (the
    distribution of the JAX package's draw), from a CPU ``torch.Generator``
    seeded with ``seed``; returned on ``valid``'s device."""
    g = torch.Generator().manual_seed(int(seed))
    u = torch.rand((n_hyp, valid.shape[0]), generator=g, dtype=torch.float64)
    gumbel = -torch.log(-torch.log(torch.clamp(u, min=1e-300)))
    gumbel = torch.where(valid.detach().cpu()[None, :], gumbel, torch.full_like(gumbel, -torch.inf))
    return torch.topk(gumbel, MIN_SET, dim=1).indices.to(valid.device)


def _two_sided(cam1, cam2, S: lie.Sim3, xc1, xc2, uv1, uv2):
    """Residuals of the forward (keyframe 2 -> 1) and inverse (1 -> 2)
    projections and the two depths (EdgeSim3ProjectXYZ /
    EdgeInverseSim3ProjectXYZ, OptimizableTypes.h:192-240)."""
    x2_in_1 = S.apply(xc2)
    x1_in_2 = S.inverse().apply(xc1)
    r1 = cam_models.project(cam1, x2_in_1) - uv1
    r2 = cam_models.project(cam2, x1_in_2) - uv2
    return r1, r2, x2_in_1[..., 2], x1_in_2[..., 2]


def sim3_ransac_plain(cam1, cam2, xc1, xc2, uv1, uv2, inv_sigma2_1, inv_sigma2_2, valid, subsets,
                      fix_scale: bool = False, min_inliers: int = 20) -> Sim3Result:
    """Plain version of kernel Q: the JAX program in PyTorch on the given
    (H, 3) subsets."""
    S_h = horn_sim3(xc2[subsets], xc1[subsets], fix_scale=fix_scale)
    S_b = lie.Sim3(S_h.R[:, None], S_h.t[:, None], S_h.s[:, None])
    r1, r2, z1, z2 = _two_sided(cam1, cam2, S_b, xc1[None], xc2[None], uv1[None], uv2[None])
    e1 = torch.sum(r1 * r1, -1) * inv_sigma2_1[None]
    e2 = torch.sum(r2 * r2, -1) * inv_sigma2_2[None]
    inl = (e1 < CHI2_SIM3) & (e2 < CHI2_SIM3) & valid[None] & (z1 > 0) & (z2 > 0)
    scores = inl.sum(1).to(torch.int32)
    best = torch.argmax(scores)
    S = lie.Sim3(S_h.R[best], S_h.t[best], S_h.s[best])
    finite = torch.isfinite(S.R).all() & torch.isfinite(S.t).all() & torch.isfinite(S.s) & (S.s > 1e-3) & (S.s < 1e3)
    return Sim3Result(S, inl[best], scores[best], (scores[best] >= min_inliers) & finite)


def _cams18(cam1, cam2, name: str) -> tuple[torch.Tensor, int]:
    """Kernels Q's and R's 18 host camera slots and the cameras' kind
    (``csrc/camera.cuh``): per camera fx fy cx cy and k1 k2 p1 p2 k3 (1,
    radial-tangential, where either camera has distortion, else 0) or k1 k2
    k3 k4 0 (2, KB8)."""
    kinds = {cam1.kind, cam2.kind}
    if len(kinds) != 1 or not kinds <= {cam_models.PINHOLE, cam_models.KB8}:
        raise ValueError(f"{name}: needs two pin-hole or two KB8 cameras, got {cam1.kind} and {cam2.kind}")
    c = []
    for cam in (cam1, cam2):
        params = [float(x) for x in cam.params.tolist()]  # free when the camera lives on the host
        c += params + [0.0] * (9 - len(params))
    if cam1.kind == cam_models.KB8:
        kind = KB8_KIND
    else:
        kind = RADTAN_KIND if any(c[4:9] + c[13:18]) else PINHOLE_KIND
    return torch.tensor(c, dtype=torch.float32), kind


def _check_pairs(name, xc1, xc2, uv1, uv2, is1, is2, valid, **more):
    f32 = torch.float32
    _kernels.require_cuda(name, xc1=(xc1, f32), xc2=(xc2, f32), uv1=(uv1, f32), uv2=(uv2, f32),
                          inv_sigma2_1=(is1, f32), inv_sigma2_2=(is2, f32), valid=(valid, torch.bool), **more)
    n = xc1.shape[0]
    if xc1.shape != (n, 3) or xc2.shape != (n, 3) or uv1.shape != (n, 2) or uv2.shape != (n, 2) or \
            is1.shape != (n,) or is2.shape != (n,) or valid.shape != (n,):
        raise ValueError(f"{name}: needs (N,3) points, (N,2) pixels and (N,) weights and flags")
    return n


def _pack_sim3(S: lie.Sim3) -> torch.Tensor:
    """R (9) | t (3) | s (1) as one float32 vector on S's device."""
    return torch.cat([S.R.reshape(9), S.t.reshape(3), S.s.reshape(1)]).to(torch.float32).contiguous()


def _unpack_sim3(v: torch.Tensor) -> lie.Sim3:
    return lie.Sim3(v[:9].view(3, 3), v[9:12], v[12])


def sim3_ransac(cam1: cam_models.Camera, cam2: cam_models.Camera, xc1: torch.Tensor, xc2: torch.Tensor,
                uv1: torch.Tensor, uv2: torch.Tensor, inv_sigma2_1: torch.Tensor, inv_sigma2_2: torch.Tensor,
                valid: torch.Tensor, seed: int, n_hyp: int = N_HYP, fix_scale: bool = False, min_inliers: int = 20,
                subsets: torch.Tensor | None = None) -> Sim3Result:
    """Batched 3-point Sim3 RANSAC between two keyframes: matched points in
    each keyframe's camera frame (N,3) and their pixels (N,2), per-pair
    information and validity; the subsets are ``subsets`` or
    ``_sample_subsets(seed, valid, n_hyp)``.  Kernel Q on CUDA tensors
    (host cameras of one kind), the plain version on CPU ones."""
    if subsets is None:
        subsets = _sample_subsets(seed, valid, n_hyp)
    if xc1.device.type == "cpu":
        return sim3_ransac_plain(cam1, cam2, xc1, xc2, uv1, uv2, inv_sigma2_1, inv_sigma2_2, valid, subsets,
                                 fix_scale, min_inliers)
    return _ransac_kernel(cam1, cam2, xc1, xc2, uv1, uv2, inv_sigma2_1, inv_sigma2_2, valid, subsets, fix_scale,
                          min_inliers)


def _ransac_kernel(cam1, cam2, xc1, xc2, uv1, uv2, inv_sigma2_1, inv_sigma2_2, valid, subsets, fix_scale: bool,
                   min_inliers: int) -> Sim3Result:
    """Kernel Q's launch."""
    cams, kind = _cams18(cam1, cam2, "kernel Q")
    subsets = subsets.to(torch.int32).contiguous()
    n = _check_pairs("sim3_ransac", xc1, xc2, uv1, uv2, inv_sigma2_1, inv_sigma2_2, valid,
                     subsets=(subsets, torch.int32))
    h = subsets.shape[0]
    if subsets.shape != (h, MIN_SET):
        raise ValueError("sim3_ransac: needs (H,3) subsets")
    dev = xc1.device
    hyp = torch.empty((h, 13), dtype=torch.float32, device=dev)
    counts = torch.empty(h, dtype=torch.int32, device=dev)
    S = torch.empty(13, dtype=torch.float32, device=dev)
    inliers = torch.empty(n, dtype=torch.bool, device=dev)
    n_inl = torch.empty((), dtype=torch.int32, device=dev)
    ok = torch.empty((), dtype=torch.bool, device=dev)
    _kernels.launch(
        "sim3_ransac_launch", dev, xc1.data_ptr(), xc2.data_ptr(), uv1.data_ptr(), uv2.data_ptr(),
        inv_sigma2_1.data_ptr(), inv_sigma2_2.data_ptr(), valid.data_ptr(), subsets.data_ptr(), n, h,
        cams.numpy().ctypes.data, kind, int(fix_scale), min_inliers, hyp.data_ptr(), counts.data_ptr(),
        S.data_ptr(), inliers.data_ptr(), n_inl.data_ptr(), ok.data_ptr(),
    )
    sim3_ransac.launches.add(mode="" if fix_scale else FREE_SCALE, camera=CAMERA_NAMES[kind])
    return Sim3Result(_unpack_sim3(S), inliers, n_inl, ok)


# camera instance "radtan" or "kb8" (CAMERA_NAMES); mode FREE_SCALE where the scale is free (monocular)
sim3_ransac.launches = _kernels.LaunchCounter()


# ---------------------------------------------------------------------------
# OptimizeSim3: Gauss-Newton on the 7-DoF tangent, Huber IRLS
# ---------------------------------------------------------------------------


def _point_jacobian(x: torch.Tensor) -> torch.Tensor:
    """d (exp(xi) x) / d xi at xi = 0 for sim(3) tangents [rho, phi, sigma]:
    [I | -hat(x) | x], (...,3,7)."""
    eye = torch.eye(3, dtype=x.dtype, device=x.device).expand(*x.shape[:-1], 3, 3)
    return torch.cat([eye, -lie.hat(x), x[..., None]], dim=-1)


def pair_jacobians(cam1, cam2, S: lie.Sim3, xc1, xc2, uv1, uv2):
    """Residuals (N,2) and closed-form Jacobians (N,2,7) of both projection
    edges for a left increment S <- sim3_exp(xi) S at xi = 0: the forward
    edge maps y = S x2, d y / d xi = [I | -hat(y) | y]; the inverse edge maps
    q = S^-1 x1, and (exp(xi) S)^-1 x1 = S^-1 exp(-xi) x1 gives
    d q / d xi = -(R^T / s) [I | -hat(x1) | x1].  Returns (r1, r2, J1, J2,
    z1, z2); ``torch.func.jacfwd`` of the residual gives the same J
    (tests/test_torch_sim3.py)."""
    y = S.apply(xc2)
    q = S.inverse().apply(xc1)
    r1 = cam_models.project(cam1, y) - uv1
    r2 = cam_models.project(cam2, q) - uv2
    J1 = cam_models.project_jac(cam1, y) @ _point_jacobian(y)
    dq = -(S.R.transpose(-1, -2) / S.s[..., None, None]) @ _point_jacobian(xc1)
    J2 = cam_models.project_jac(cam2, q) @ dq
    return r1, r2, J1, J2, y[..., 2], q[..., 2]


def _gn_step(cam1, cam2, S: lie.Sim3, xc1, xc2, uv1, uv2, is1, is2, mask, fix_scale: bool) -> lie.Sim3:
    """One Gauss-Newton step: Huber IRLS weights on the current residuals,
    the 7x7 normal equations in float64, 1e-6 damping, the scale pinned
    under ``fix_scale`` (VertexSim3Expmap _fix_scale), the update applied on
    the left and R re-orthonormalised."""
    r1, r2, J1, J2, _, _ = pair_jacobians(cam1, cam2, S, xc1, xc2, uv1, uv2)
    m = mask.to(r1.dtype)
    c1 = torch.sqrt(torch.sum(r1 * r1, -1) * is1)
    c2 = torch.sqrt(torch.sum(r2 * r2, -1) * is2)
    w1 = torch.clamp(HUBER_SIM3 / torch.clamp(c1, min=1e-9), max=1.0) * is1 * m
    w2 = torch.clamp(HUBER_SIM3 / torch.clamp(c2, min=1e-9), max=1.0) * is2 * m
    f64 = torch.float64
    J1d, J2d, w1d, w2d = J1.to(f64), J2.to(f64), w1.to(f64), w2.to(f64)
    H = torch.einsum("n,nri,nrj->ij", w1d, J1d, J1d) + torch.einsum("n,nri,nrj->ij", w2d, J2d, J2d)
    b = torch.einsum("n,nri,nr->i", w1d, J1d, r1.to(f64)) + torch.einsum("n,nri,nr->i", w2d, J2d, r2.to(f64))
    if fix_scale:
        H[6, :] = 0.0
        H[:, 6] = 0.0
        H[6, 6] = 1.0
        b[6] = 0.0
    H = H + 1e-6 * torch.eye(7, dtype=f64, device=H.device)
    dx = -torch.linalg.solve(H, b)
    Sn = lie.sim3_exp(dx.to(S.t.dtype)).compose(S)
    return lie.Sim3(lie.normalize_rotation(Sn.R), Sn.t, Sn.s)


def _gate(cam1, cam2, S, xc1, xc2, uv1, uv2, is1, is2, mask, chi2_th):
    r1, r2, z1, z2 = _two_sided(cam1, cam2, S, xc1, xc2, uv1, uv2)
    c1 = torch.sum(r1 * r1, -1) * is1
    c2 = torch.sum(r2 * r2, -1) * is2
    return mask & (c1 < chi2_th) & (c2 < chi2_th) & (z1 > 0) & (z2 > 0)


def optimize_sim3_plain(cam1, cam2, S0: lie.Sim3, xc1, xc2, uv1, uv2, inv_sigma2_1, inv_sigma2_2, valid,
                        fix_scale: bool = False, iters: int = 15, chi2_th: float = CHI2_SIM3):
    """Plain version of kernel R.  Returns (S12, inliers (N,), n_inliers)."""
    half = iters // 3
    args = (xc1, xc2, uv1, uv2, inv_sigma2_1, inv_sigma2_2)
    S, mask = S0, valid
    for _ in range(half):
        S = _gn_step(cam1, cam2, S, *args, mask, fix_scale)
    mask = _gate(cam1, cam2, S, *args, mask, chi2_th)
    for _ in range(iters - half):
        S = _gn_step(cam1, cam2, S, *args, mask, fix_scale)
    inl = _gate(cam1, cam2, S, *args, mask, chi2_th)
    return S, inl, inl.sum().to(torch.int32)


def optimize_sim3(cam1: cam_models.Camera, cam2: cam_models.Camera, S0: lie.Sim3, xc1: torch.Tensor,
                  xc2: torch.Tensor, uv1: torch.Tensor, uv2: torch.Tensor, inv_sigma2_1: torch.Tensor,
                  inv_sigma2_2: torch.Tensor, valid: torch.Tensor, fix_scale: bool = False, iters: int = 15,
                  chi2_th: float = CHI2_SIM3):
    """OptimizeSim3 (Optimizer.cc:2164-2425): ``iters // 3`` steps, the
    chi2 re-gate of the pairs, the rest, and the final gate.  Returns (S12,
    inliers (N,), n_inliers ()).  Kernel R on CUDA tensors (host cameras of
    one kind, S0 on the card), the plain version on CPU ones."""
    if xc1.device.type == "cpu":
        return optimize_sim3_plain(cam1, cam2, S0, xc1, xc2, uv1, uv2, inv_sigma2_1, inv_sigma2_2, valid,
                                   fix_scale, iters, chi2_th)
    return _refine_kernel(cam1, cam2, S0, xc1, xc2, uv1, uv2, inv_sigma2_1, inv_sigma2_2, valid, fix_scale, iters,
                          chi2_th)


def _refine_kernel(cam1, cam2, S0: lie.Sim3, xc1, xc2, uv1, uv2, inv_sigma2_1, inv_sigma2_2, valid, fix_scale: bool,
                   iters: int, chi2_th: float):
    """Kernel R's launch."""
    cams, kind = _cams18(cam1, cam2, "kernel R")
    s0 = _pack_sim3(S0)
    n = _check_pairs("optimize_sim3", xc1, xc2, uv1, uv2, inv_sigma2_1, inv_sigma2_2, valid,
                     S0=(s0, torch.float32))
    dev = xc1.device
    S = torch.empty(13, dtype=torch.float32, device=dev)
    inliers = torch.empty(n, dtype=torch.bool, device=dev)
    n_inl = torch.empty((), dtype=torch.int32, device=dev)
    _kernels.launch(
        "sim3_refine_launch", dev, xc1.data_ptr(), xc2.data_ptr(), uv1.data_ptr(), uv2.data_ptr(),
        inv_sigma2_1.data_ptr(), inv_sigma2_2.data_ptr(), valid.data_ptr(), s0.data_ptr(), n,
        cams.numpy().ctypes.data, kind, int(fix_scale), iters, float(chi2_th), S.data_ptr(), inliers.data_ptr(),
        n_inl.data_ptr(),
    )
    optimize_sim3.launches.add(mode="" if fix_scale else FREE_SCALE, camera=CAMERA_NAMES[kind])
    return _unpack_sim3(S), inliers, n_inl


optimize_sim3.launches = _kernels.LaunchCounter()  # as sim3_ransac's
