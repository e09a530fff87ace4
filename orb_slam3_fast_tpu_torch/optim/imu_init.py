"""IMU initialisation: the inertial-only optimisation of the gravity
direction, the scale, the keyframe velocities and one shared bias over a
keyframe chain whose poses stay fixed, and the later scale refinement.

Counterpart of ``orb_slam3_fast_tpu/optim/imu_init.py``
(Optimizer::InertialOptimization, Optimizer.cc:3108-3995, on the
EdgeInertialGS factor, G2oTypes.cc:618-656): the same parameter vector
[theta_g (2), log s, bias (6), velocities (3K)], the same informed start
(gravity from the rotated preintegrated velocity deltas, velocities from
position differences), the same LM schedule (40 iterations; 20 over the 3
parameters of the refinement) and the same masking of padding edges
(``edge_valid``).  ``gravity_alignment_transform`` stays plain.

``inertial_only_optimization`` and ``scale_gravity_refinement`` are the
wrappers of kernel X (``csrc/imu_init.cu``); ``*_plain`` are the same
algorithms in PyTorch with ``torch.func.jacfwd`` where the JAX package has
``jax.jacfwd``.

Kernel X -- source note.
  Replaces: ``inertial_only_optimization`` / ``scale_gravity_refinement``
  (``orb_slam3_fast_tpu/optim/imu_init.py:53, 159``, K24), jitted scans of
  40 (20) LM iterations with a dense (K-1)x9 by P Jacobian (P = 9 + 3K).
  Bound on the card: latency.  An iteration forms a P x P normal matrix
  (P <= 105 at K = 32) from (K-1) 9 x 15 edge blocks and factors it: ~0.4
  Mflop in a chain of 40 dependent steps.
  Design: one CTA of 512 threads.  The edge residuals are
  ``csrc/inertial.cuh``'s EdgeInertialGS in float64 dual numbers; thread
  (edge, direction) evaluates one of the 15 tangent directions an edge
  depends on (gravity 2, scale, bias 6, the two velocities), which is the
  nonzero part of the Jacobian column ``jax.jacfwd`` gives; the per-edge
  terms (information, Jacobian, its weighted copy, residual: 361 doubles
  an edge) live in a float64 scratch buffer in global memory, so the
  chain has no length limit.  The P x P float64 normal matrix lives in
  dynamic shared memory while it fits in 200 KB (P <= 159, K <= 50
  keyframes; 88 KB at P = 105, above the 48 KB default, so the entry
  point raises the kernel's limit with ``cudaFuncSetAttribute``), and in
  the scratch beyond; each thread owns entries and sums the edges into
  them in edge order (no atomics: a run repeats bit for bit).  The damped
  system is solved in place by Gaussian elimination with partial pivoting
  (``jnp.linalg.solve``'s LU), one warp searching each column's pivot and
  the block sharing its row updates; thread 0 substitutes, and the
  candidate's cost, the accept and the damping schedule stay on the device.
  Padding edges (``edge_valid`` False) have their information zeroed and
  contribute nothing, as in the JAX package.  The refinement is a second
  entry over 3 parameters with the velocities and the bias fixed.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from orb_slam3_fast_tpu_torch import _kernels
from orb_slam3_fast_tpu_torch.imu import preintegration as pre
from orb_slam3_fast_tpu_torch.optim.inertial import inertial_information
from orb_slam3_fast_tpu_torch.utils import forward_ad


class InertialInit(NamedTuple):
    Rwg: torch.Tensor  # (3,3) gravity direction (g_world = Rwg @ gI)
    scale: torch.Tensor  # ()
    vel: torch.Tensor  # (K,3)
    bias: torch.Tensor  # (6,) shared [bg, ba]


def _gi(device):
    return torch.tensor([0.0, 0.0, -pre.GRAVITY_VALUE], dtype=torch.float32, device=device)


def gs_residual(R_i, p_i, R_j, p_j, v_i, v_j, bias, Rwg, log_s, preint: pre.Preintegrated, scale_known: bool):
    """EdgeInertialGS (G2oTypes.cc:618-656), batched over leading edge
    axes: the inertial residual with the scaled positions and velocities
    and the estimated gravity direction."""
    s = torch.ones_like(log_s) if scale_known else torch.exp(log_s)
    g = Rwg @ _gi(Rwg.device)
    dt = preint.dT[..., None]
    dR = pre.delta_rotation(preint, bias)
    dV = pre.delta_velocity(preint, bias)
    dP = pre.delta_position(preint, bias)
    RiT = R_i.transpose(-1, -2)
    er = pre.so3_log(dR.transpose(-1, -2) @ RiT @ R_j)
    ev = torch.einsum("...ij,...j->...i", RiT, s * (v_j - v_i) - g * dt) - dV
    ep = torch.einsum("...ij,...j->...i", RiT, s * (p_j - p_i - v_i * dt) - 0.5 * g * dt * dt) - dP
    return torch.cat([er, ev, ep], -1)


def _rwg(theta2):
    return pre.so3_exp(torch.cat([theta2, torch.zeros_like(theta2[:1])]))


def _edge_infos(preints: pre.Preintegrated, edge_valid):
    infos = inertial_information(preints)
    if edge_valid is not None:
        infos = infos * edge_valid[:, None, None].to(infos.dtype)
    return infos


def _informed_start(R_wb, p_wb, preints: pre.Preintegrated, edge_valid):
    """The start of LocalMapping::InitializeIMU (LocalMapping.cc:1197-1221):
    gravity from the rotated preintegrated velocity deltas, velocities from
    position differences."""
    K = R_wb.shape[0]
    dev = R_wb.device
    n_e = K - 1
    ev_mask = edge_valid.to(torch.float32) if edge_valid is not None else torch.ones(n_e, device=dev)
    dV = pre.delta_velocity(preints, torch.zeros(6, dtype=torch.float32, device=dev))
    dirG = -torch.sum(torch.einsum("eij,ej->ei", R_wb[:-1], dV) * ev_mask[:, None], 0)
    dirG = dirG / torch.clamp(torch.linalg.vector_norm(dirG), min=1e-9)
    gI_hat = torch.tensor([0.0, 0.0, -1.0], dtype=torch.float32, device=dev)
    axis = torch.linalg.cross(gI_hat, dirG)
    s_norm = torch.linalg.vector_norm(axis)
    ang = torch.atan2(s_norm, torch.dot(gI_hat, dirG))
    theta0 = torch.where(s_norm > 1e-6, axis / torch.clamp(s_norm, min=1e-9) * ang, torch.zeros_like(axis))
    v_fd = (p_wb[1:] - p_wb[:-1]) / torch.clamp(preints.dT[:, None], min=1e-6)
    v0 = torch.cat([v_fd, v_fd[-1:]], 0)
    return torch.cat([theta0[:2], torch.zeros(7, dtype=torch.float32, device=dev), v0.reshape(-1)])


def inertial_only_optimization_plain(R_wb, p_wb, preints: pre.Preintegrated, prior_gyro: float = 1e2,
                                     prior_acc: float = 1e6, iters: int = 40, fix_scale: bool = False,
                                     edge_valid=None) -> InertialInit:
    """Plain version of kernel X's first entry."""
    K = R_wb.shape[0]
    dev = R_wb.device
    infos = _edge_infos(preints, edge_valid)

    def residuals(x):
        Rwg = _rwg(x[0:2])
        vel = x[9:].reshape(K, 3)
        return gs_residual(R_wb[:-1], p_wb[:-1], R_wb[1:], p_wb[1:], vel[:-1], vel[1:], x[3:9], Rwg, x[2], preints,
                           fix_scale)

    def cost_fn(x):
        r = residuals(x)
        c = torch.sum(torch.einsum("ei,eij,ej->e", r, infos, r))
        return c + prior_gyro * torch.sum(x[3:6] ** 2) + prior_acc * torch.sum(x[6:9] ** 2)

    x = _informed_start(R_wb, p_wb, preints, edge_valid)
    P = x.shape[0]
    prior_diag = torch.zeros(P, dtype=torch.float32, device=dev)
    prior_diag[3:6] = prior_gyro
    prior_diag[6:9] = prior_acc
    eye = torch.eye(P, dtype=torch.float32, device=dev)
    lam = torch.tensor(1e-3, dtype=torch.float32, device=dev)
    for _ in range(iters):
        r = residuals(x)
        with forward_ad.LOCK:
            J = torch.func.jacfwd(residuals)(x)  # (K-1, 9, P)
        H = torch.einsum("eip,eij,ejq->pq", J, infos, J) + torch.diag(2.0 * prior_diag)
        g = -torch.einsum("eip,eij,ej->p", J, infos, r) - 2.0 * prior_diag * x
        Hd = H + lam * torch.diag(torch.clamp(torch.diag(H), min=1e-6)) + 1e-9 * eye
        dx = torch.linalg.solve(Hd, g)
        accept = cost_fn(x + dx) < cost_fn(x)
        x = torch.where(accept, x + dx, x)
        lam = torch.where(accept, torch.clamp(lam * 0.5, min=1e-8), torch.clamp(lam * 5.0, max=1e6))
    scale = torch.ones((), device=dev) if fix_scale else torch.exp(x[2])
    return InertialInit(Rwg=_rwg(x[0:2]), scale=scale, vel=x[9:].reshape(K, 3), bias=x[3:9])


def scale_gravity_refinement_plain(R_wb, p_wb, vel, bias, preints: pre.Preintegrated, edge_valid=None,
                                   iters: int = 20):
    """Plain version of kernel X's second entry (ScaleRefinement): gravity
    direction and scale alone.  Returns (Rwg, scale)."""
    dev = R_wb.device
    infos = _edge_infos(preints, edge_valid)

    def residuals(x):
        return gs_residual(R_wb[:-1], p_wb[:-1], R_wb[1:], p_wb[1:], vel[:-1], vel[1:], bias, _rwg(x[0:2]), x[2],
                           preints, False)

    def cost(x):
        r = residuals(x)
        return torch.sum(torch.einsum("ei,eij,ej->e", r, infos, r))

    x = torch.zeros(3, dtype=torch.float32, device=dev)
    eye = torch.eye(3, dtype=torch.float32, device=dev)
    lam = torch.tensor(1e-3, dtype=torch.float32, device=dev)
    for _ in range(iters):
        r = residuals(x)
        with forward_ad.LOCK:
            J = torch.func.jacfwd(residuals)(x)
        H = torch.einsum("eip,eij,ejq->pq", J, infos, J)
        g = -torch.einsum("eip,eij,ej->p", J, infos, r)
        Hd = H + lam * torch.diag(torch.clamp(torch.diag(H), min=1e-6)) + 1e-9 * eye
        dx = torch.linalg.solve(Hd, g)
        accept = cost(x + dx) < cost(x)
        x = torch.where(accept, x + dx, x)
        lam = torch.where(accept, torch.clamp(lam * 0.5, min=1e-8), torch.clamp(lam * 5.0, max=1e6))
    return _rwg(x[0:2]), torch.exp(x[2])


def _check(name, R_wb, p_wb, preints, edge_valid, vel=None, bias=None):
    f32 = torch.float32
    K = R_wb.shape[0]
    dev = R_wb.device
    if K < 2 or R_wb.shape != (K, 3, 3) or p_wb.shape != (K, 3) or preints.dR.shape != (K - 1, 3, 3):
        raise ValueError(f"{name}: needs (K,3,3) rotations, (K,3) positions and K-1 stacked windows")
    ev = torch.ones(K - 1, dtype=torch.bool, device=dev) if edge_valid is None else edge_valid.to(dev)
    args = dict(R_wb=(R_wb.to(f32).contiguous(), f32), p_wb=(p_wb.to(f32).contiguous(), f32),
                edge_valid=(ev.contiguous(), torch.bool))
    _kernels.require_cuda(name, **args)
    pk = pre.pack(preints.to(dev))
    return args["R_wb"][0], args["p_wb"][0], pk, args["edge_valid"][0]


def inertial_only_optimization(R_wb, p_wb, preints: pre.Preintegrated, prior_gyro: float = 1e2,
                               prior_acc: float = 1e6, iters: int = 40, fix_scale: bool = False,
                               edge_valid=None) -> InertialInit:
    """Kernel X on CUDA tensors, its plain version on CPU ones: the
    inertial-only optimisation over a chain of K keyframes (fixed poses) and
    its K-1 stacked windows."""
    if R_wb.device.type == "cpu":
        return inertial_only_optimization_plain(R_wb, p_wb, preints, prior_gyro, prior_acc, iters, fix_scale,
                                                edge_valid)
    return _init_kernel(R_wb, p_wb, preints, prior_gyro, prior_acc, iters, fix_scale, edge_valid)


def _init_kernel(R_wb, p_wb, preints, prior_gyro, prior_acc, iters, fix_scale, edge_valid) -> InertialInit:
    dev = R_wb.device
    R, p, pk, ev = _check("inertial_only_optimization", R_wb, p_wb, preints, edge_valid)
    K = R.shape[0]
    out = torch.empty(16 + 3 * K, dtype=torch.float32, device=dev)  # Rwg | scale | vel | bias
    prior = np.asarray([prior_gyro, prior_acc], np.float32)
    work = torch.empty(imu_init_scratch_doubles(K, False), dtype=torch.float64, device=dev)
    _kernels.launch("imu_init_launch", dev, R.data_ptr(), p.data_ptr(), pk.data_ptr(), ev.data_ptr(), 0, 0, K,
                    prior.ctypes.data, iters, int(fix_scale), 0, work.data_ptr(), out.data_ptr())
    inertial_only_optimization.launches.add()
    return InertialInit(Rwg=out[:9].reshape(3, 3), scale=out[9], vel=out[10:10 + 3 * K].reshape(K, 3),
                        bias=out[10 + 3 * K:])


def scale_gravity_refinement(R_wb, p_wb, vel, bias, preints: pre.Preintegrated, edge_valid=None, iters: int = 20):
    """Kernel X's refinement entry on CUDA tensors, its plain version on CPU
    ones.  Returns (Rwg, scale)."""
    if R_wb.device.type == "cpu":
        return scale_gravity_refinement_plain(R_wb, p_wb, vel, bias, preints, edge_valid, iters)
    return _refine_kernel(R_wb, p_wb, vel, bias, preints, edge_valid, iters)


def _refine_kernel(R_wb, p_wb, vel, bias, preints, edge_valid, iters):
    dev = R_wb.device
    R, p, pk, ev = _check("scale_gravity_refinement", R_wb, p_wb, preints, edge_valid)
    K = R.shape[0]
    vel = vel.to(device=dev, dtype=torch.float32).contiguous()
    bias = bias.to(device=dev, dtype=torch.float32).contiguous()
    out = torch.empty(10, dtype=torch.float32, device=dev)
    prior = np.zeros(2, np.float32)
    work = torch.empty(imu_init_scratch_doubles(K, True), dtype=torch.float64, device=dev)
    _kernels.launch("imu_init_launch", dev, R.data_ptr(), p.data_ptr(), pk.data_ptr(), ev.data_ptr(),
                    vel.data_ptr(), bias.data_ptr(), K, prior.ctypes.data, iters, 0, 1, work.data_ptr(),
                    out.data_ptr())
    inertial_only_optimization.launches.add("refine")
    return out[:9].reshape(3, 3), out[9]


def imu_init_scratch_doubles(K: int, refine: bool) -> int:
    """Doubles of kernel X's scratch (csrc/imu_init.cu): 361 per edge
    (information, Jacobian, its weighted copy, residual, cost), and the
    system (P x (P + 1), the parameters, the candidate, the step and 2
    more), which the kernel keeps here when it does not fit in shared
    memory."""
    P = 3 if refine else 9 + 3 * K
    return 361 * (K - 1) + P * (P + 1) + 3 * P + 2


inertial_only_optimization.launches = _kernels.LaunchCounter()  # modes "" and "refine"


def gravity_alignment_transform(init: InertialInit):
    """World correction after initialisation (LocalMapping.cc:1310-1340 +
    Map::ApplyScaledRotation): x_new = s * R_gw @ x_old.  Returns (R_gw, s)."""
    return init.Rwg.T, init.scale
