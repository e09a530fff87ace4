"""Inertial factors and the visual-inertial frame optimisation.

Counterpart of ``orb_slam3_fast_tpu/optim/inertial.py``: the 9-D inertial
residual against the bias-corrected preintegrated deltas (EdgeInertial,
G2oTypes.cc:497-616), the 6-D bias random walk (EdgeGyroRW / EdgeAccRW),
the 15-D prior on the previous frame (ConstraintPoseImu), and the sliding
window of two of PoseInertialOptimizationLastKeyFrame / LastFrame
(Optimizer.cc:4544-5357): 4 rounds of 10 Levenberg-Marquardt iterations
with the chi2 reclassification between rounds (the inlier mask rides in the
scan's carry in the JAX package, so each round optimises with the mask of
the round before), returning the state, the inliers, their count and the
15x15 information carried to the next frame.  Body states follow the
reference: R_wb, p_wb, v_w, bias [bg, ba]; an update multiplies R on the
right and moves p in the body frame.

``pose_inertial_optimization`` and ``pose_inertial_optimization_last_frame``
are the wrappers of kernel W (``csrc/pose_inertial.cu``);
``*_plain`` are the same algorithms in PyTorch.  The plain versions take the
inertial, bias-walk and prior Jacobians with ``torch.func.jacfwd``, as the
JAX package takes them with ``jax.jacfwd``, and the reprojection Jacobian in
closed form (d xc / d theta = R_cb hat(R_wb^T (x - p)), d xc / d p = -R_cb).

Kernel W -- source note.
  Replaces: ``pose_inertial_optimization`` / ``..._last_frame``
  (``orb_slam3_fast_tpu/optim/inertial.py:123, 233``, K23), jitted scans of
  4 x 10 LM iterations over a 15-D (30-D) state with N visual edges (the
  frame's keypoint capacity), one inertial edge, the bias walk and the prior.
  Bound on the card: latency.  An iteration is two passes over N ~ 1k edges
  (~200 flops each), ~30 dual-number evaluations of the inertial edge and a
  15x15 (30x30) solve: microseconds of arithmetic in a chain of 40
  dependent steps; as PyTorch operations it is hundreds of launches per
  iteration.
  Design: one CTA of 256 threads runs all rounds and iterations.  Threads
  stride over the visual edges (projection through T_cb, the closed-form
  Jacobian of kernel D chained with the body-pose tangent; a distorted
  pin-hole camera takes its own instance through ``csrc/camera.cuh``) and
  sum the 21 + 6 + 1 terms of the pose block in float64, reduced by warp
  shuffles and then the warps in turn, so that a run repeats bit for bit
  (no floating-point atomics).  The inertial, bias-walk and prior
  residuals are ``csrc/inertial.cuh``'s, in float64 forward-mode dual
  numbers: thread k < 15 (30) evaluates them along tangent k, which gives
  the Jacobian column that ``jax.jacfwd`` gives.  The threads form the
  normal equations entry by entry, damp them as the JAX package does and
  solve them by Gaussian elimination with partial pivoting in float64
  shared memory (the counterpart of ``jnp.linalg.solve``'s LU; the block
  shares each column's row updates); thread 0 retracts; the candidate's
  cost takes another pass; accept and
  the damping schedule stay on the device.  After each round the edges are
  reclassified by chi2; at the end the information of the solved state is
  formed (and, for the last-frame form, the previous state marginalised
  out).  The prior-less call and the last-frame form are template
  instances, and so is the camera's kind (pin-hole, radial-tangential or
  KB8, ``csrc/camera.cuh``).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from orb_slam3_fast_tpu_torch import _kernels
from orb_slam3_fast_tpu_torch.cameras import models as cam_models
from orb_slam3_fast_tpu_torch.imu import preintegration as pre
from orb_slam3_fast_tpu_torch.optim.pose_opt import CAMERA_NAMES, CHI2_MONO, CHI2_STEREO, _huber_weight, kernel_camera
from orb_slam3_fast_tpu_torch.utils import lie


class BodyState(NamedTuple):
    """IMU body state: R_wb (3,3), p_wb (3,), v_w (3,), bias (6,) [bg, ba]."""

    R: torch.Tensor
    p: torch.Tensor
    v: torch.Tensor
    bias: torch.Tensor

    def to(self, device) -> "BodyState":
        return BodyState(*(torch.as_tensor(x, dtype=torch.float32).to(device) for x in self))


def pack_state(s: BodyState) -> torch.Tensor:
    """(..., 21) float32: R (9) | p | v | bias."""
    lead = s.R.shape[:-2]
    return torch.cat([s.R.reshape(*lead, 9), s.p, s.v, s.bias], -1).to(torch.float32).contiguous()


def unpack_state(v: torch.Tensor) -> BodyState:
    return BodyState(v[..., :9].reshape(*v.shape[:-1], 3, 3), v[..., 9:12], v[..., 12:15], v[..., 15:21])


def retract(s: BodyState, d: torch.Tensor) -> BodyState:
    """A 15-D tangent update [dtheta, dp, dv, dbg, dba] (VertexPose oplus,
    G2oTypes.h:78-240): R <- R Exp(dtheta), p <- p + R dp."""
    return BodyState(
        R=s.R @ pre.so3_exp(d[..., 0:3]),
        p=s.p + torch.einsum("...ij,...j->...i", s.R, d[..., 3:6]),
        v=s.v + d[..., 6:9],
        bias=s.bias + d[..., 9:15],
    )


def inertial_residual(si: BodyState, sj: BodyState, p: pre.Preintegrated) -> torch.Tensor:
    """9-D residual [er, ev, ep] of EdgeInertial (G2oTypes.cc:497-527)."""
    g = pre.gravity(si.R.device)
    dt = p.dT[..., None]
    dR = pre.delta_rotation(p, si.bias)
    dV = pre.delta_velocity(p, si.bias)
    dP = pre.delta_position(p, si.bias)
    RiT = si.R.transpose(-1, -2)
    er = pre.so3_log(dR.transpose(-1, -2) @ RiT @ sj.R)
    ev = torch.einsum("...ij,...j->...i", RiT, sj.v - si.v - g * dt) - dV
    ep = torch.einsum("...ij,...j->...i", RiT, sj.p - si.p - si.v * dt - 0.5 * g * dt * dt) - dP
    return torch.cat([er, ev, ep], -1)


def inertial_information(p: pre.Preintegrated) -> torch.Tensor:
    """(..., 9, 9) inverse of the rvp covariance block, symmetrised and
    regularised (EdgeInertial ctor, G2oTypes.cc:463-486)."""
    C = p.C[..., :9, :9]
    C = 0.5 * (C + C.transpose(-1, -2)) + 1e-9 * torch.eye(9, dtype=C.dtype, device=C.device)
    return torch.linalg.inv(C)


def walk_information(p: pre.Preintegrated) -> torch.Tensor:
    """(..., 6, 6) information of the bias random walk over the window."""
    C = p.C[..., 9:15, 9:15]
    return torch.linalg.inv(C + 1e-8 * torch.eye(6, dtype=C.dtype, device=C.device))


def bias_walk_residual(si: BodyState, sj: BodyState) -> torch.Tensor:
    """6-D random-walk residual [dbg, dba] (EdgeGyroRW / EdgeAccRW)."""
    return sj.bias - si.bias


class VIObs(NamedTuple):
    """Visual observations of one frame in body-state form (capacity N)."""

    xw: torch.Tensor  # (N,3)
    uv: torch.Tensor  # (N,3) [u, v, u_r] (u_r = -1 mono)
    inv_sigma2: torch.Tensor
    is_stereo: torch.Tensor
    valid: torch.Tensor


class PriorState(NamedTuple):
    """15-D marginalisation prior on the previous frame (ConstraintPoseImu,
    G2oTypes.h:698-781)."""

    state: BodyState
    H: torch.Tensor  # (15,15) information


def prior_residual(s: BodyState, prior: PriorState) -> torch.Tensor:
    er = pre.so3_log(prior.state.R.transpose(-1, -2) @ s.R)
    return torch.cat([er, s.p - prior.state.p, s.v - prior.state.v, s.bias - prior.state.bias], -1)


def camera_pose(T_cb: lie.SE3, R_wb, p_wb):
    """T_cw = T_cb T_bw from body states (..., 3, 3), (..., 3)."""
    R_bw = R_wb.transpose(-1, -2)
    t_bw = -torch.einsum("...ij,...j->...i", R_bw, p_wb)
    return T_cb.R @ R_bw, torch.einsum("ij,...j->...i", T_cb.R, t_bw) + T_cb.t


def visual_residuals(cam, bf, T_cb: lie.SE3, s: BodyState, xw, uv, is_stereo):
    """(N,3) residuals (u_r's zeroed on mono edges), camera points, z > 0.05."""
    R_cw, t_cw = camera_pose(T_cb, s.R, s.p)
    xc = torch.einsum("...ij,...j->...i", R_cw, xw) + t_cw
    r = uv - cam_models.stereo_project(cam, xc, bf)
    r = torch.cat([r[..., :2], torch.where(is_stereo, r[..., 2], torch.zeros_like(r[..., 2]))[..., None]], -1)
    return r, xc, xc[..., 2] > 0.05


def visual_pose_jacobian(cam, bf, T_cb: lie.SE3, R_wb, p_wb, xw, xc, is_stereo):
    """(N,3,6) d r / d [theta, p] of the body pose at the current state."""
    xb = torch.einsum("...ji,...j->...i", R_wb, xw - p_wb)  # R_wb^T (x - p)
    Jproj = cam_models.stereo_project_jac(cam, xc, bf)
    Jproj = torch.cat([Jproj[..., :2, :], Jproj[..., 2:, :] * is_stereo[..., None, None]], -2)
    dth = T_cb.R @ lie.hat(xb)
    dp = (-T_cb.R).expand(dth.shape)
    return -(Jproj @ torch.cat([dth, dp], -1))


def _delta2(is_stereo, like):
    return torch.where(is_stereo, torch.full_like(like, CHI2_STEREO), torch.full_like(like, CHI2_MONO))


def _weights(r, posd, obs: VIObs, inlier):
    chi2 = torch.sum(r * r, -1) * obs.inv_sigma2
    w_h = _huber_weight(chi2, _delta2(obs.is_stereo, chi2))
    return torch.where(obs.valid & inlier & posd, w_h * obs.inv_sigma2, torch.zeros_like(chi2))


def _classify(cam, bf, T_cb, s: BodyState, obs: VIObs):
    r, _, posd = visual_residuals(cam, bf, T_cb, s, obs.xw, obs.uv, obs.is_stereo)
    chi2 = torch.sum(r * r, -1) * obs.inv_sigma2
    return obs.valid & (chi2 <= _delta2(obs.is_stereo, chi2)) & posd


def _visual_blocks(cam, bf, T_cb, s: BodyState, obs: VIObs, inlier):
    """H (6,6), g (6,) and the IRLS cost sum w |r|^2 of the visual edges."""
    r, xc, posd = visual_residuals(cam, bf, T_cb, s, obs.xw, obs.uv, obs.is_stereo)
    w = _weights(r, posd, obs, inlier)
    J = visual_pose_jacobian(cam, bf, T_cb, s.R, s.p, obs.xw, xc, obs.is_stereo)
    H = torch.einsum("nij,n,nik->jk", J, w, J)
    g = -torch.einsum("nij,n,ni->j", J, w, r)
    return H, g, torch.sum(w * torch.sum(r * r, -1))


def _visual_cost(cam, bf, T_cb, s: BodyState, obs: VIObs, inlier):
    r, _, posd = visual_residuals(cam, bf, T_cb, s, obs.xw, obs.uv, obs.is_stereo)
    return torch.sum(_weights(r, posd, obs, inlier) * torch.sum(r * r, -1))


def _quad(r, M):
    return r @ M @ r


def _solve_damped(H, g, lam, eps):
    n = H.shape[0]
    eye = torch.eye(n, dtype=H.dtype, device=H.device)
    Hd = H + lam * torch.diag(torch.clamp(torch.diag(H), min=1e-6)) + eps * eye
    return torch.linalg.solve(Hd, g)


def _select(accept, a: BodyState, b: BodyState) -> BodyState:
    return BodyState(*(torch.where(accept, x, y) for x, y in zip(a, b)))


def pose_inertial_optimization_plain(cam, bf, T_cb: lie.SE3, s_prev: BodyState, preint: pre.Preintegrated,
                                     s0: BodyState, obs: VIObs, prior: PriorState | None = None,
                                     n_rounds: int = 4, iters: int = 10):
    """Plain version of kernel W, KF-anchored form: the previous state
    fixed, the current one free.  Returns (state, inlier, n_inliers, H)."""
    dev = obs.xw.device
    info9 = inertial_information(preint)
    walk = walk_information(preint)
    zero = torch.zeros(15, dtype=torch.float32, device=dev)

    def factors(d, s):
        sd = retract(s, d)
        parts = [inertial_residual(s_prev, sd, preint), bias_walk_residual(s_prev, sd)]
        if prior is not None:
            parts.append(prior_residual(sd, prior))
        return torch.cat(parts)

    def factor_terms(s, with_jac):
        f = factors(zero, s)
        ri, rb = f[:9], f[9:15]
        cost = _quad(ri, info9) + _quad(rb, walk)
        if prior is not None:
            cost = cost + _quad(f[15:30], prior.H)
        if not with_jac:
            return cost, None, None
        J = torch.func.jacfwd(lambda d: factors(d, s))(zero)
        Ji, Jb = J[:9], J[9:15]
        H = Ji.T @ info9 @ Ji + Jb.T @ walk @ Jb
        g = -(Ji.T @ info9 @ ri) - Jb.T @ walk @ rb
        if prior is not None:
            Jp = J[15:30]
            H = H + Jp.T @ prior.H @ Jp
            g = g - Jp.T @ prior.H @ f[15:30]
        return cost, H, g

    def normal_eqs(s, inlier):
        Hv, gv, cv = _visual_blocks(cam, bf, T_cb, s, obs, inlier)
        cf, Hf, gf = factor_terms(s, True)
        H = Hf.clone()
        H[:6, :6] += Hv
        g = gf.clone()
        g[:6] += gv
        return H, g, cv + cf

    inlier = torch.ones_like(obs.valid)
    s = s0
    for _ in range(n_rounds):
        lam = torch.tensor(1e-2, dtype=torch.float32, device=dev)
        for _ in range(iters):
            H, g, cost0 = normal_eqs(s, inlier)
            d = _solve_damped(H, g, lam, 1e-8)
            s1 = retract(s, d)
            cost1 = _visual_cost(cam, bf, T_cb, s1, obs, inlier) + factor_terms(s1, False)[0]
            accept = cost1 < cost0
            s = _select(accept, s1, s)
            lam = torch.where(accept, torch.clamp(lam * 0.5, min=1e-7), torch.clamp(lam * 5.0, max=1e5))
        inlier = _classify(cam, bf, T_cb, s, obs)
    H, _, _ = normal_eqs(s, inlier)
    H = 0.5 * (H + H.T)
    return s, inlier, inlier.sum(), H


def pose_inertial_optimization_last_frame_plain(cam, bf, T_cb: lie.SE3, s_prev: BodyState, prior_prev: PriorState,
                                                preint: pre.Preintegrated, s0: BodyState, obs: VIObs,
                                                n_rounds: int = 4, iters: int = 10):
    """Plain version of kernel W, last-frame form: the previous frame's
    state free under its prior, chained to the current one; the previous
    state is marginalised out of the solved 30x30 Hessian.  Returns
    (state, inlier, n_inliers, H_marg)."""
    dev = obs.xw.device
    info9 = inertial_information(preint)
    walk = walk_information(preint)
    zero = torch.zeros(30, dtype=torch.float32, device=dev)

    def factors(d, sp, sc):
        spd, scd = retract(sp, d[:15]), retract(sc, d[15:])
        return torch.cat([inertial_residual(spd, scd, preint), bias_walk_residual(spd, scd),
                          prior_residual(spd, prior_prev)])

    def factor_cost(f):
        return _quad(f[:9], info9) + _quad(f[9:15], walk) + _quad(f[15:30], prior_prev.H)

    def normal_eqs(sp, sc, inlier):
        Hv, gv, cv = _visual_blocks(cam, bf, T_cb, sc, obs, inlier)
        f = factors(zero, sp, sc)
        J = torch.func.jacfwd(lambda d: factors(d, sp, sc))(zero)
        Ji, Jb, Jp = J[:9], J[9:15], J[15:30]
        H = Ji.T @ info9 @ Ji + Jb.T @ walk @ Jb + Jp.T @ prior_prev.H @ Jp
        g = -(Ji.T @ info9 @ f[:9]) - Jb.T @ walk @ f[9:15] - Jp.T @ prior_prev.H @ f[15:30]
        H[15:21, 15:21] += Hv
        g[15:21] += gv
        return H, g, cv + factor_cost(f)

    inlier = torch.ones_like(obs.valid)
    sp, sc = s_prev, s0
    for _ in range(n_rounds):
        lam = torch.tensor(1e-2, dtype=torch.float32, device=dev)
        for _ in range(iters):
            H, g, cost0 = normal_eqs(sp, sc, inlier)
            d = _solve_damped(H, g, lam, 1e-8)
            sp1, sc1 = retract(sp, d[:15]), retract(sc, d[15:])
            cost1 = _visual_cost(cam, bf, T_cb, sc1, obs, inlier) + factor_cost(factors(zero, sp1, sc1))
            accept = cost1 < cost0
            sp, sc = _select(accept, sp1, sp), _select(accept, sc1, sc)
            lam = torch.where(accept, torch.clamp(lam * 0.5, min=1e-7), torch.clamp(lam * 5.0, max=1e5))
        inlier = _classify(cam, bf, T_cb, sc, obs)
    H, _, _ = normal_eqs(sp, sc, inlier)
    H = 0.5 * (H + H.T)
    H11 = H[:15, :15] + 1e-6 * torch.eye(15, dtype=H.dtype, device=dev)
    H12, H22 = H[:15, 15:], H[15:, 15:]
    H_marg = H22 - H12.T @ torch.linalg.solve(H11, H12)
    return sc, inlier, inlier.sum(), 0.5 * (H_marg + H_marg.T)


def _launch(cam, bf, T_cb, s_prev, prior, preint, s0, obs: VIObs, last: bool, n_rounds, iters):
    f32 = torch.float32
    dev = obs.xw.device
    cam10, kind = kernel_camera(cam, bf, "kernel W")
    _kernels.require_cuda(
        "pose_inertial_optimization", xw=(obs.xw, f32), uv=(obs.uv, f32), inv_sigma2=(obs.inv_sigma2, f32),
        is_stereo=(obs.is_stereo, torch.bool), valid=(obs.valid, torch.bool),
    )
    n = obs.xw.shape[0]
    tcb = torch.cat([T_cb.R.reshape(9), T_cb.t]).to(device=dev, dtype=f32).contiguous()
    sp = pack_state(s_prev.to(dev))
    s0p = pack_state(s0.to(dev))
    pre_p = pre.pack(preint.to(dev))
    prior_p = None
    if prior is not None:
        prior_p = torch.cat([pack_state(prior.state.to(dev)), prior.H.to(device=dev, dtype=f32).reshape(225)])
    state = torch.empty(21, dtype=f32, device=dev)
    inlier = torch.empty(n, dtype=torch.bool, device=dev)
    n_inl = torch.empty((), dtype=torch.int32, device=dev)
    H = torch.empty((15, 15), dtype=f32, device=dev)
    _kernels.launch(
        "pose_inertial_launch", dev, cam10.to(dev).data_ptr(), kind, tcb.data_ptr(), sp.data_ptr(),
        pre_p.data_ptr(), s0p.data_ptr(), 0 if prior_p is None else prior_p.data_ptr(), int(last),
        obs.xw.data_ptr(), obs.uv.data_ptr(), obs.inv_sigma2.data_ptr(), obs.is_stereo.data_ptr(),
        obs.valid.data_ptr(), n, n_rounds, iters, state.data_ptr(), inlier.data_ptr(), n_inl.data_ptr(), H.data_ptr(),
    )
    pose_inertial_optimization.launches.add("last_frame" if last else ("prior" if prior is not None else ""),
                                            camera=CAMERA_NAMES[kind])
    return unpack_state(state), inlier, n_inl, H


def pose_inertial_optimization(cam, bf, T_cb: lie.SE3, s_prev: BodyState, preint: pre.Preintegrated, s0: BodyState,
                               obs: VIObs, prior: PriorState | None = None, n_rounds: int = 4, iters: int = 10):
    """Kernel W (KF-anchored form) on CUDA tensors, its plain version on CPU
    ones.  Returns (state, inlier (N,) bool, n_inliers, H (15,15))."""
    if obs.xw.device.type == "cpu":
        return pose_inertial_optimization_plain(cam, bf, T_cb, s_prev, preint, s0, obs, prior, n_rounds, iters)
    return _launch(cam, bf, T_cb, s_prev, prior, preint, s0, obs, False, n_rounds, iters)


def pose_inertial_optimization_last_frame(cam, bf, T_cb: lie.SE3, s_prev: BodyState, prior_prev: PriorState,
                                          preint: pre.Preintegrated, s0: BodyState, obs: VIObs,
                                          n_rounds: int = 4, iters: int = 10):
    """Kernel W (last-frame form) on CUDA tensors, its plain version on CPU
    ones.  Returns (state, inlier, n_inliers, H_marg (15,15))."""
    if obs.xw.device.type == "cpu":
        return pose_inertial_optimization_last_frame_plain(cam, bf, T_cb, s_prev, prior_prev, preint, s0, obs,
                                                           n_rounds, iters)
    return _launch(cam, bf, T_cb, s_prev, prior_prev, preint, s0, obs, True, n_rounds, iters)


# modes: "" (no prior), "prior", "last_frame"; camera instances "", "radtan", "kb8"
pose_inertial_optimization.launches = _kernels.LaunchCounter()
