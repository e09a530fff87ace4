"""Pose-only optimisation (motion-only BA) with chi2 outlier reclassification.

Counterpart of ``orb_slam3_fast_tpu/optim/pose_opt.py``: one SE3 pose, unary
mono / stereo reprojection edges with Huber weights (delta^2 = 5.991 mono,
7.815 stereo), 4 rounds of 10 Levenberg-Marquardt iterations (damping reset
each round), inliers classified by chi2 at the final pose.  ``T_cw`` maps
world -> camera and an update multiplies on the left: ``T <- exp(xi) * T``.

What the reference computes, and so what the port computes: its rounds run
``lax.scan`` over one Python closure, and JAX reuses the first round's
trace of that body, so every round optimises with the round-0 inlier mask
(all slots; outliers are only down-weighted by Huber).  The chi2
reclassification between rounds reaches only the returned mask.

``pose_optimization`` is the wrapper of kernel D (``csrc/pose_lm.cu``);
``pose_optimization_plain`` is the same algorithm in PyTorch, with the
closed-form projection Jacobian in place of ``jax.jacfwd``.

Kernel D -- source note.
  Replaces: ``_lm_rounds`` / ``pose_optimization``
  (``orb_slam3_fast_tpu/optim/pose_opt.py:43-128``), a jitted scan of 40
  iterations.
  Bound on the card: latency.  The work is 40 x 2 passes over ~1k edges
  (~150 flops each) and 40 tiny 6x6 solves -- microseconds of arithmetic;
  as separate PyTorch ops it is ~100 launches per iteration.
  Design: one CTA of 512 threads runs all rounds and iterations.  Threads
  stride over the edges and accumulate the 21 + 6 + 1 sums of J^T W J,
  J^T W r and the cost (closed-form pin-hole Jacobian, [I | -hat(xc)]
  chained with d(u, v, u_r)/d(xc)); a warp-shuffle + shared-memory
  reduction feeds thread 0, which damps H + lam * diag(H) + 1e-8 I, solves
  it by a 6x6 Cholesky in double, applies se3_exp on the left and, after a
  second pass for the cost at the candidate pose, accepts or rejects
  (lam * 0.5 / lam * 4, clamped to [1e-7, 1e4]).  A last pass classifies
  the edges by chi2.  The camera's kind is a template parameter
  (``csrc/camera.cuh``): a pin-hole camera with radial-tangential
  distortion takes an instance that distorts the normalised point and
  chains the distortion's closed-form 2x2 Jacobian, a Kannala-Brandt
  (KB8) camera one that projects through the KB8 polynomial and chains its
  closed-form 2x3 Jacobian (the plain version's ``torch.func.jacfwd``), and
  one without distortion runs the instructions it always ran.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from orb_slam3_fast_tpu_torch import _kernels
from orb_slam3_fast_tpu_torch.cameras import models as cam_models
from orb_slam3_fast_tpu_torch.utils import lie

CHI2_MONO = 5.991  # Optimizer.cc:858 (2-DoF 95%)
CHI2_STEREO = 7.815  # Optimizer.cc:863 (3-DoF 95%)


class PoseObs(NamedTuple):
    """Batched unary reprojection edges of one frame (fixed capacity N)."""

    xw: torch.Tensor  # (N,3) landmark world positions
    uv: torch.Tensor  # (N,3) observed [u, v, u_r]; u_r = -1 for mono edges
    inv_sigma2: torch.Tensor  # (N,) 1 / sigma^2 of the keypoint's level
    is_stereo: torch.Tensor  # (N,) bool
    valid: torch.Tensor  # (N,) bool


def _residuals(cam, bf, T: lie.SE3, obs: PoseObs):
    """(N,3) residuals [du, dv, dur] (dur = 0 on mono edges), xc, z > 0.05."""
    xc = T.apply(obs.xw)
    r = obs.uv - cam_models.stereo_project(cam, xc, bf)
    r = torch.cat([r[:, :2], torch.where(obs.is_stereo, r[:, 2], torch.zeros_like(r[:, 2]))[:, None]], 1)
    return r, xc, xc[:, 2] > 0.05


def _chi2(r: torch.Tensor, inv_sigma2: torch.Tensor) -> torch.Tensor:
    return torch.sum(r * r, dim=-1) * inv_sigma2


def _huber_weight(chi2: torch.Tensor, delta2: torch.Tensor) -> torch.Tensor:
    """IRLS weight of the Huber kernel: 1 inside, delta / |r| outside."""
    return torch.where(chi2 <= delta2, torch.ones_like(chi2), torch.sqrt(delta2 / torch.clamp(chi2, min=1e-12)))


def _delta2(obs: PoseObs) -> torch.Tensor:
    return torch.where(
        obs.is_stereo,
        torch.full_like(obs.inv_sigma2, CHI2_STEREO),
        torch.full_like(obs.inv_sigma2, CHI2_MONO),
    )


def _cost(cam, bf, T: lie.SE3, obs: PoseObs, inlier: torch.Tensor):
    r, xc, pos_depth = _residuals(cam, bf, T, obs)
    active = obs.valid & inlier & pos_depth
    chi2 = _chi2(r, obs.inv_sigma2)
    w_huber = _huber_weight(chi2, _delta2(obs))
    cost = torch.sum(torch.where(active, w_huber * chi2, torch.zeros_like(chi2)))
    return cost, r, xc, active, w_huber


def _build_normal_eqs(cam, bf, T: lie.SE3, obs: PoseObs, inlier: torch.Tensor):
    cost, r, xc, active, w_huber = _cost(cam, bf, T, obs, inlier)
    w = torch.where(active, w_huber * obs.inv_sigma2, torch.zeros_like(w_huber))
    Jproj = cam_models.stereo_project_jac(cam, xc, bf)  # (N,3,3)
    Jproj = torch.cat([Jproj[:, :2], Jproj[:, 2:] * obs.is_stereo[:, None, None]], 1)
    eye = torch.eye(3, dtype=xc.dtype, device=xc.device).expand(xc.shape[0], 3, 3)
    dxc = torch.cat([eye, -lie.hat(xc)], dim=-1)  # (N,3,6) left-multiplied update
    J = -(Jproj @ dxc)  # d r / d xi
    J = torch.where(active[:, None, None], J, torch.zeros_like(J))
    H = torch.einsum("nij,n,nik->jk", J, w, J)
    g = -torch.einsum("nij,n,ni->j", J, w, r)
    return H, g, cost


def pose_optimization_plain(cam, bf: float, T0: lie.SE3, obs: PoseObs, n_rounds: int = 4, iters_per_round: int = 10):
    """Plain version of kernel D.  Returns (T, inlier (N,) bool, n_inliers)."""
    lm_inlier = torch.ones_like(obs.valid)  # the round-0 mask, in every round (see above)
    T = T0
    eye6 = torch.eye(6, dtype=obs.xw.dtype, device=obs.xw.device)
    for _ in range(n_rounds):
        lam = torch.tensor(1e-2, dtype=obs.xw.dtype, device=obs.xw.device)
        for _ in range(iters_per_round):
            H, g, cost = _build_normal_eqs(cam, bf, T, obs, lm_inlier)
            Hd = H + lam * torch.diag(torch.diag(H)) + 1e-8 * eye6
            dx = torch.linalg.solve(Hd, g)
            T_new = lie.se3_exp(dx).compose(T)
            cost_new = _cost(cam, bf, T_new, obs, lm_inlier)[0]
            accept = cost_new < cost
            T = lie.SE3(torch.where(accept, T_new.R, T.R), torch.where(accept, T_new.t, T.t))
            lam = torch.where(accept, torch.clamp(lam * 0.5, min=1e-7), torch.clamp(lam * 4.0, max=1e4))
    # chi2 classification at the final pose (Optimizer.cc:1009-1090)
    r, _, pos_depth = _residuals(cam, bf, T, obs)
    inlier = obs.valid & (_chi2(r, obs.inv_sigma2) <= _delta2(obs)) & pos_depth
    return T, inlier, inlier.sum()


PINHOLE_KIND, RADTAN_KIND, KB8_KIND = 0, 1, 2  # csrc/camera.cuh cam::Kind
CAMERA_NAMES = ("", "radtan", "kb8")  # the launch counters' camera instance, by kind


def kernel_camera(cam, bf: float, name: str):
    """The host (10,) float32 camera slots of kernels D, E, W, Y and AA
    (``csrc/camera.cuh``) and the camera's kind: [fx, fy, cx, cy, bf, k1,
    k2, p1, p2, k3] and 1 for a pin-hole camera with radial-tangential
    distortion (0 without), [fx, fy, cx, cy, bf, k1, k2, k3, k4, 0] and 2
    for KB8."""
    params = cam.params.tolist()  # free when the camera lives on the host
    if cam.kind == cam_models.KB8:
        return torch.tensor([*params[:4], float(bf), *params[4:8], 0.0], dtype=torch.float32), KB8_KIND
    if cam.kind != cam_models.PINHOLE:
        raise ValueError(f"{name}: unknown camera kind {cam.kind!r}")
    dist = [float(x) for x in params[4:9]] + [0.0] * (9 - len(params))
    kind = RADTAN_KIND if any(dist) else PINHOLE_KIND
    return torch.tensor([*params[:4], float(bf), *dist], dtype=torch.float32), kind


def pose_optimization(cam, bf: float, T0: lie.SE3, obs: PoseObs, n_rounds: int = 4, iters_per_round: int = 10):
    """Kernel D on CUDA tensors, its plain version on CPU ones.
    Returns (T, inlier (N,) bool, n_inliers () int)."""
    if obs.xw.device.type == "cpu":
        return pose_optimization_plain(cam, bf, T0, obs, n_rounds, iters_per_round)
    return _kernel(cam, bf, T0, obs, n_rounds, iters_per_round)


def _kernel(cam, bf: float, T0: lie.SE3, obs: PoseObs, n_rounds: int, iters_per_round: int):
    """Kernel D's launch."""
    cam10, kind = kernel_camera(cam, bf, "kernel D")
    f32 = torch.float32
    dev = obs.xw.device
    R0 = T0.R.to(f32).contiguous()
    t0 = T0.t.to(f32).contiguous()
    _kernels.require_cuda(
        "pose_optimization", xw=(obs.xw, f32), uv=(obs.uv, f32), inv_sigma2=(obs.inv_sigma2, f32),
        is_stereo=(obs.is_stereo, torch.bool), valid=(obs.valid, torch.bool), R0=(R0, f32), t0=(t0, f32),
    )
    n = obs.xw.shape[0]
    cam10 = cam10.to(dev)
    R = torch.empty((3, 3), dtype=f32, device=dev)
    t = torch.empty(3, dtype=f32, device=dev)
    inlier = torch.empty(n, dtype=torch.bool, device=dev)
    n_inl = torch.empty((), dtype=torch.int32, device=dev)
    _kernels.launch(
        "pose_lm_launch", dev,
        obs.xw.data_ptr(), obs.uv.data_ptr(), obs.inv_sigma2.data_ptr(), obs.is_stereo.data_ptr(),
        obs.valid.data_ptr(), n, cam10.data_ptr(), kind, R0.data_ptr(), t0.data_ptr(), n_rounds, iters_per_round,
        R.data_ptr(), t.data_ptr(), inlier.data_ptr(), n_inl.data_ptr(),
    )
    pose_optimization.launches.add(camera=CAMERA_NAMES[kind])
    return lie.SE3(R, t), inlier, n_inl


pose_optimization.launches = _kernels.LaunchCounter()  # by camera instance: "", "radtan", "kb8"
