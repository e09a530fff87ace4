"""Essential-graph optimisation on Sim3 (7-DoF) pose vertices, and the
rigid landmark correction that follows it.

Counterpart of ``orb_slam3_fast_tpu/optim/pose_graph.py``
(Optimizer::OptimizeEssentialGraph, Optimizer.cc:1518-1827: Sim3
vertices, EdgeSim3 over the spanning, covisibility and loop edges):
vertices are Sim3 arrays, edges a COO list, every Gauss-Newton iteration
evaluates all edge residuals and both 7x7 Jacobians at once, and
``_solve_normal_eqs`` solves the normal equations dense up to
``DENSE_MAX_K`` vertices and by block-Jacobi PCG on the implicit edge
operator above (``_FORCE_CG`` takes the PCG branch at any size).  The
yaw-only 4-DoF graph of inertial maps (``SE3Graph``,
``optimize_4dof_graph``) waits for ROADMAP §A item 10.

The JAX package takes both Jacobians with ``jax.jacfwd``; the plain
version here takes them in forward mode too: one ``torch.func.jvp`` over
14 copies of the edge list, one copy per tangent direction (7 for each
end).  Its dense
solve is float64 (the JAX package's is a float32 LU).

``optimize_sim3_graph`` runs kernel S (``csrc/sim3_graph.cu``) on CUDA
tensors for graphs of at most ``DENSE_MAX_K`` vertices, the plain version
on CPU ones; the PCG branch on the card waits for its kernel (ROADMAP §B).

Kernel S -- source note.
  Replaces: ``optimize_sim3_graph`` with the dense branch of
  ``_solve_normal_eqs`` (``orb_slam3_fast_tpu/optim/pose_graph.py:152``
  and ``:41-76``, K20): 12 iterations of a vmapped ``jax.jacfwd`` through
  sim3_exp, compose and sim3_log per edge, a scatter-add into a dense
  (K,K,7,7) matrix and a float32 LU of the (7K)^2 system.
  Bound on the card: latency.  The edges are a few hundred (~10^4 flops
  each with their derivatives); the (7K)^2 Cholesky (K ~ 50: 7K = 350,
  1.4e7 flops) has 7K dependent column steps.
  Design: three launches per iteration, one C entry point for the 12.
  (1) One warp per edge: lane d < 14 evaluates the residual
  ``log(S_ij^-1 exp(dx_i) S_i (exp(dx_j) S_j)^-1)`` at 0 in float64 dual
  numbers whose tangent is direction d (dx_i's for d < 7, dx_j's after),
  so it follows the branch of ``_sim3_W_coeffs`` and of the quaternion
  log that the point selects, exactly as ``jacfwd`` does; lane 0 writes
  r, each lane its column of J_i or J_j.  (2) One CTA of 1024 threads:
  the normal matrix in global memory, zeroed, then the edges in their
  order, each adding its four 7x7 blocks and two gradient pieces (a
  fixed-order sum per vertex pair); the gauge-fixed vertices' rows and
  columns become the identity, 1e-6 I is added, and the float64 Cholesky
  (right-looking, column by column, the trailing update spread over the
  threads) and two substitutions give dx; a pivot <= 0 zeroes dx and sets
  a flag.  (3) One thread per vertex: ``S <- sim3_exp(dx) S`` in float64
  and R re-orthonormalised by the 3x3 SVD.  Every sum has a fixed order,
  so a run repeats bit for bit.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from orb_slam3_fast_tpu_torch import _kernels
from orb_slam3_fast_tpu_torch.utils import lie

DENSE_MAX_K = 128  # above this vertex count the step takes the edge-operator PCG branch
_FORCE_CG = False  # test hook: the PCG branch at any size


class Sim3Graph(NamedTuple):
    """Pose-graph problem: K vertices, E edges."""

    R: torch.Tensor  # (K,3,3) S_iw rotation
    t: torch.Tensor  # (K,3)
    s: torch.Tensor  # (K,)
    edge_i: torch.Tensor  # (E,) int
    edge_j: torch.Tensor  # (E,) int
    meas_R: torch.Tensor  # (E,3,3) S_ij, mapping the j frame into the i frame
    meas_t: torch.Tensor  # (E,3)
    meas_s: torch.Tensor  # (E,)
    edge_valid: torch.Tensor  # (E,) bool
    fixed: torch.Tensor  # (K,) bool gauge-fixed vertices
    edge_w: torch.Tensor  # (E,) float32 edge weight (information scale)


def _edge_residual_sim3(dxi, dxj, Si: lie.Sim3, Sj: lie.Sim3, Sij: lie.Sim3) -> torch.Tensor:
    """e = log(S_ij^-1 exp(dx_i) S_i (exp(dx_j) S_j)^-1) (EdgeSim3::computeError
    with the measurement stored as S_ij)."""
    Si_u = lie.sim3_exp(dxi).compose(Si)
    Sj_u = lie.sim3_exp(dxj).compose(Sj)
    return lie.sim3_log(Sij.inverse().compose(Si_u).compose(Sj_u.inverse()))


def edge_jacobians(R, t, s, g: Sim3Graph):
    """Residuals (E,7) and Jacobians J_i, J_j (E,7,7) of every edge at the
    vertices (R, t, s), in forward mode: one ``torch.func.jvp`` over 14
    copies of the edge list, copy d carrying tangent direction d (dx_i's
    for d < 7, dx_j's after), so the 14 directions cost one batched pass.
    (Batched tensors also keep their dtype: forward mode promotes the
    tangents of 0-dim float32 tensors to float64.)"""
    E = g.edge_i.shape[0]
    ei, ej = g.edge_i.long().repeat(14), g.edge_j.long().repeat(14)
    Si = lie.Sim3(R[ei], t[ei], s[ei])
    Sj = lie.Sim3(R[ej], t[ej], s[ej])
    Sij = lie.Sim3(g.meas_R.repeat(14, 1, 1), g.meas_t.repeat(14, 1), g.meas_s.repeat(14))
    zero = torch.zeros((14 * E, 7), dtype=t.dtype, device=t.device)
    eye = torch.eye(7, dtype=t.dtype, device=t.device).repeat_interleave(E, dim=0)  # (7E,7): row d*E+e is e_d
    tan_i = torch.cat([eye, torch.zeros_like(eye)])
    tan_j = torch.cat([torch.zeros_like(eye), eye])
    r, dr = torch.func.jvp(lambda dxi, dxj: _edge_residual_sim3(dxi, dxj, Si, Sj, Sij), (zero, zero), (tan_i, tan_j))
    dr = dr.view(2, 7, E, 7).permute(0, 2, 3, 1)  # (end, edge, residual row, direction)
    return r[:E], dr[0], dr[1]


def _edge_blocks(r, Ji, Jj, edge_i, edge_j, w, K: int):
    """Per edge the weighted 7x7 blocks H_ii, H_jj, H_ij (float64) and the
    gradient b (K,D) summed per vertex."""
    f64 = torch.float64
    r, Ji, Jj, w = r.to(f64), Ji.to(f64), Jj.to(f64), w.to(f64)
    ei, ej = edge_i.long(), edge_j.long()
    Jiw = Ji * w[:, None, None]
    Jjw = Jj * w[:, None, None]
    Hii = torch.einsum("eri,erj->eij", Jiw, Ji)
    Hjj = torch.einsum("eri,erj->eij", Jjw, Jj)
    Hij = torch.einsum("eri,erj->eij", Jiw, Jj)
    bi = torch.einsum("eri,er->ei", Jiw, r)
    bj = torch.einsum("eri,er->ei", Jjw, r)
    b = torch.zeros((K, Ji.shape[-1]), dtype=f64, device=r.device).index_add_(0, ei, bi).index_add_(0, ej, bj)
    return Hii, Hjj, Hij, b


def dense_normal_system(r, Ji, Jj, edge_i, edge_j, w, fixed, damping):
    """The dense branch's (KD, KD) float64 system and right-hand side: the
    fixed vertices' rows and columns made the identity, ``damping`` on the
    diagonal."""
    K = fixed.shape[0]
    Hii, Hjj, Hij, b = _edge_blocks(r, Ji, Jj, edge_i, edge_j, w, K)
    D = Hii.shape[-1]
    ei, ej = edge_i.long(), edge_j.long()
    free_f = (~fixed).to(b.dtype)
    eye = torch.eye(D, dtype=b.dtype, device=b.device)
    H = torch.zeros((K * K, D, D), dtype=b.dtype, device=b.device)
    H.index_add_(0, ei * K + ei, Hii).index_add_(0, ej * K + ej, Hjj)
    H.index_add_(0, ei * K + ej, Hij).index_add_(0, ej * K + ei, Hij.transpose(-1, -2))
    H = H.view(K, K, D, D) * free_f[:, None, None, None] * free_f[None, :, None, None]
    diag = torch.arange(K, device=b.device)
    H[diag, diag] += (1.0 - free_f)[:, None, None] * eye + damping * eye
    return H.transpose(1, 2).reshape(K * D, K * D), -(b * free_f[:, None]).reshape(-1)


def _solve_normal_eqs(r, Ji, Jj, edge_i, edge_j, w, fixed, damping):
    """One Gauss-Newton solve of the pose-graph normal equations, in
    float64: dense for K <= DENSE_MAX_K (unless ``_FORCE_CG``), block-Jacobi
    PCG on the implicit edge operator above.  Returns dx (K,D), zero at the
    fixed vertices."""
    K = fixed.shape[0]
    free_f = (~fixed).to(torch.float64)
    if K <= DENSE_MAX_K and not _FORCE_CG:
        Hd, rhs = dense_normal_system(r, Ji, Jj, edge_i, edge_j, w, fixed, damping)
        return torch.linalg.solve(Hd, rhs).reshape(K, -1) * free_f[:, None]
    # the implicit PCG branch
    Hii, Hjj, Hij, b = _edge_blocks(r, Ji, Jj, edge_i, edge_j, w, K)
    D = Hii.shape[-1]
    ei, ej = edge_i.long(), edge_j.long()
    eye = torch.eye(D, dtype=b.dtype, device=b.device)
    cg_iters = int(max(64, min(512, K // 4)))
    b_s = -b * free_f[:, None]
    Dblk = torch.zeros((K, D, D), dtype=b.dtype, device=b.device).index_add_(0, ei, Hii).index_add_(0, ej, Hjj)
    Dblk = torch.where(fixed[:, None, None], eye, Dblk + damping * eye)
    Dinv = torch.linalg.inv(Dblk + 1e-8 * eye)

    def H_mv(v):
        v = v * free_f[:, None]
        vi, vj = v[ei], v[ej]
        out = (damping * v).index_add_(0, ei, torch.einsum("eab,eb->ea", Hii, vi) + torch.einsum("eab,eb->ea", Hij, vj))
        out.index_add_(0, ej, torch.einsum("eab,eb->ea", Hjj, vj) + torch.einsum("eba,eb->ea", Hij, vi))
        return out * free_f[:, None]

    def precond(rr):
        return torch.einsum("kab,kb->ka", Dinv, rr) * free_f[:, None]

    x = torch.zeros_like(b_s)
    rr = b_s
    z = precond(rr)
    p = z
    rz = torch.sum(rr * z)
    zero = torch.zeros_like(rz)
    for _ in range(cg_iters):
        Ap = H_mv(p)
        pAp = torch.sum(p * Ap)
        ok = rz > 1e-12
        alpha = torch.where(ok, rz / torch.clamp(pAp, min=1e-20), zero)
        x = x + alpha * p
        rr = rr - alpha * Ap
        z = precond(rr)
        rz_new = torch.sum(rr * z)
        beta = torch.where(ok, rz_new / torch.clamp(rz, min=1e-20), zero)
        p = z + beta * p
        rz = rz_new
    return x * free_f[:, None]


def optimize_sim3_graph_plain(g: Sim3Graph, iters: int = 12, damping: float = 1e-6):
    """Plain version of kernel S (and the PCG branch above DENSE_MAX_K).
    Returns the updated (R, t, s)."""
    R, t, s = g.R, g.t, g.s
    w = g.edge_valid.to(t.dtype) * g.edge_w
    for _ in range(iters):
        r, Ji, Jj = edge_jacobians(R, t, s, g)
        dx = _solve_normal_eqs(r, Ji, Jj, g.edge_i, g.edge_j, w, g.fixed, damping).to(t.dtype)
        Sn = lie.sim3_exp(dx).compose(lie.Sim3(R, t, s))
        R, t, s = lie.normalize_rotation(Sn.R), Sn.t, Sn.s
    return R, t, s


def optimize_sim3_graph(g: Sim3Graph, iters: int = 12, damping: float = 1e-6):
    """Gauss-Newton on the Sim3 pose graph.  Returns the updated (R, t, s).
    Kernel S on CUDA tensors, the plain version on CPU ones; on the card a
    graph above ``DENSE_MAX_K`` vertices raises (its PCG kernel is queued,
    ROADMAP §B)."""
    if g.R.device.type == "cpu":
        return optimize_sim3_graph_plain(g, iters, damping)
    K, E = g.R.shape[0], g.edge_i.shape[0]
    if K > DENSE_MAX_K or _FORCE_CG:
        raise NotImplementedError(f"the pose graph's PCG branch (K = {K} > {DENSE_MAX_K}) has no kernel yet "
                                  "(ROADMAP §B, K20)")
    f32, i32 = torch.float32, torch.int32
    w = (g.edge_valid.to(f32) * g.edge_w.to(f32)).contiguous()
    ei, ej = g.edge_i.to(i32).contiguous(), g.edge_j.to(i32).contiguous()
    meas = torch.cat([g.meas_R.reshape(E, 9), g.meas_t.reshape(E, 3), g.meas_s.reshape(E, 1)], 1).to(f32).contiguous()
    verts = torch.cat([g.R.reshape(K, 9), g.t.reshape(K, 3), g.s.reshape(K, 1)], 1).to(f32).contiguous()
    _kernels.require_cuda("optimize_sim3_graph", vertices=(verts, f32), edge_i=(ei, i32), edge_j=(ej, i32),
                          meas=(meas, f32), w=(w, f32), fixed=(g.fixed, torch.bool))
    if g.fixed.shape != (K,) or ej.shape != (E,) or w.shape != (E,):
        raise ValueError("optimize_sim3_graph: needs (K,) fixed flags and (E,) edges and weights")
    dev = g.R.device
    n = 7 * K
    out = torch.empty_like(verts)
    jac = torch.empty((E, 15, 7), dtype=torch.float64, device=dev)  # r | J_i^T | J_j^T per edge
    H = torch.empty((n, n), dtype=torch.float64, device=dev)
    vec = torch.empty(2 * n, dtype=torch.float64, device=dev)  # b | dx
    fail = torch.zeros((), dtype=i32, device=dev)
    _kernels.launch(
        "sim3_graph_launch", dev, verts.data_ptr(), ei.data_ptr(), ej.data_ptr(), meas.data_ptr(), w.data_ptr(),
        g.fixed.data_ptr(), K, E, iters, float(damping), out.data_ptr(), jac.data_ptr(), H.data_ptr(),
        vec.data_ptr(), fail.data_ptr(),
    )
    optimize_sim3_graph.launches += 1
    optimize_sim3_graph.last_fail = fail
    return out[:, :9].view(K, 3, 3), out[:, 9:12], out[:, 12]


optimize_sim3_graph.launches = 0
optimize_sim3_graph.last_fail = None


def correct_landmarks(lm_pos, ref_kf, R_old, t_old, s_old, R_new, t_new, s_new):
    """Move landmarks rigidly with their reference keyframe's Sim3
    correction, x' = S_new^-1(S_old(x)) (CorrectLoop, LoopClosing.cc:
    1164-1218; Optimizer.cc:1780-1820), batched over the landmarks."""
    ref = ref_kf.long()
    Ro, to, so = R_old[ref], t_old[ref], s_old[ref]
    Rn, tn, sn = R_new[ref], t_new[ref], s_new[ref]
    xc = so[:, None] * torch.einsum("kij,kj->ki", Ro, lm_pos) + to
    return torch.einsum("kji,kj->ki", Rn, xc - tn) / sn[:, None]
