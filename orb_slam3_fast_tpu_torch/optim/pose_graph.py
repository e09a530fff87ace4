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
``optimize_4dof_graph``; OptimizeEssentialGraph4DoF, Optimizer.cc:
5358-5686) takes the same solve with 4x4 blocks and 6-row residuals.

The JAX package takes both Jacobians with ``jax.jacfwd``; the plain
version here takes them in forward mode too: one ``torch.func.jvp`` over
14 copies of the edge list, one copy per tangent direction (7 for each
end).  Both of its solves are float64 (the JAX package's are float32).

``optimize_sim3_graph`` runs on CUDA tensors kernel S
(``csrc/sim3_graph.cu``) for graphs of at most ``DENSE_MAX_K`` vertices
and kernel U (``csrc/sim3_pcg.cu``) above, or at any size under
``_FORCE_CG``; the plain version on CPU ones.  It returns the vertices and
``ok``, False where a solve failed.

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

Kernel Z -- source note.
  Replaces: ``optimize_4dof_graph`` with both branches of
  ``_solve_normal_eqs`` at D = 4 (``orb_slam3_fast_tpu/optim/
  pose_graph.py:224`` and ``:41-123``, K20's 4-DoF form): 12 Gauss-Newton
  iterations of a vmapped ``jax.jacfwd`` through ``_yaw_update``, compose
  and ``se3_log`` per edge (a 6-D residual, two 6x4 Jacobians), then a
  float32 LU of the (4K)^2 system for K <= 128, block-Jacobi PCG with
  ``max(64, min(512, K // 4))`` CG iterations above.
  Bound on the card: latency.  Per iteration a few hundred edges of ~5000
  flops each with their derivatives, a (4K)^2 Cholesky (4K = 280 at K =
  70: 7e6 flops in 280 dependent column steps) or the dependent CG
  iterations of 4x4 block mat-vecs.
  Design: one C entry point for the 12 iterations.  (1) One warp per edge:
  lane d < 8 evaluates ``log_SE3(T_ij T_jw' T_iw'^-1)`` at 0 in float64
  dual numbers along direction d (dx_i's for d < 4, dx_j's after), so its
  branches follow ``jacfwd``'s, as kernel S's lanes do (``csrc/
  sim3.cuh``'s so3_exp / so3_log, the Jacobian inverse of ``lie.
  so3_right_jacobian_inv`` with its Taylor branch).  (2) Dense (K <= 128,
  not ``_FORCE_CG``): kernel S's solve at 4x4 blocks, one CTA: the normal
  matrix in global memory, the edges added in order, the gauge, a float64
  Cholesky and two substitutions.  PCG: kernel U's at 4x4 blocks: per-edge
  blocks, per-vertex sums over ``vertex_csr`` and Gauss-Jordan inverses,
  the CG loop in one CTA with the vectors in L2.  (3) One thread per
  vertex: ``_yaw_update`` in float64 and R re-orthonormalised by the 3x3
  SVD.  Kernels S and U are untouched (Z keeps its own solve, so their
  readings stay bit-equal).  Every sum has a fixed order: a run repeats
  bit for bit.

Kernel U -- source note.
  Replaces: the PCG branch of ``_solve_normal_eqs``
  (``orb_slam3_fast_tpu/optim/pose_graph.py:80-123``, K20, with
  ``optimize_sim3_graph`` ``:152`` around it): per Gauss-Newton iteration
  the per-edge blocks, a block-Jacobi preconditioner and ``max(64,
  min(512, K // 4))`` CG iterations (a ``lax.scan``) on the implicit
  operator H v, the per-edge mat-vecs scatter-added to both ends.
  Bound on the card: latency of the dependent CG iterations.  Per CG
  iteration the work is 4 7x7 mat-vecs per edge and one per vertex and
  three dot products (~0.5 Mflop at K = 2048), which one CTA does in
  microseconds; what sets the pace is that the CTA runs on one SM: the
  operator pass reads the per-edge blocks (1.2 KB an edge, ~2.5 MB at
  K = 2048) from L2 at one SM's share of its bandwidth, and each
  iteration has five barriers.  A multi-CTA form would spread the
  operator pass over the card's 132 SMs and pay a grid-wide barrier (or
  a launch) for each dot product instead; that is a later PR's work.
  Design: one C entry point, five launches per Gauss-Newton iteration:
  (1) kernel S's edge evaluation in float64 dual numbers; (2) one thread
  per (edge, block entry): H_ii, H_jj, H_ij and b_i, b_j; (3) one thread
  per vertex: b and the diagonal block summed over the vertex's edge list
  (``vertex_csr``: the edges that start at it, then those that end at it,
  each in edge order -- the order in which ``index_add_`` visits them),
  damped, inverted by Gauss-Jordan in float64; (4) one CTA of 1024
  threads runs the CG loop with the vectors in global memory (L2), H p per
  row over the same lists, the dot products as warp butterflies and then
  the warps in order; the ``rz > 1e-12`` freeze ends the loop, since from
  there x no longer moves; (5) kernel S's vertex update.  No
  floating-point atomics: a run repeats bit for bit.  It follows the
  plain version in float64 (the JAX package's branch is float32).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from orb_slam3_fast_tpu_torch import _kernels
from orb_slam3_fast_tpu_torch.utils import forward_ad, lie

DENSE_MAX_K = 128  # above this vertex count the step takes the edge-operator PCG branch
_FORCE_CG = False  # test hook: the PCG branch at any size


def cg_iterations(K: int) -> int:
    """The PCG branch's iteration count for K vertices."""
    return int(max(64, min(512, K // 4)))


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
    with forward_ad.LOCK:
        r, dr = torch.func.jvp(lambda dxi, dxj: _edge_residual_sim3(dxi, dxj, Si, Sj, Sij), (zero, zero),
                               (tan_i, tan_j))
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
    cg_iters = cg_iterations(K)
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


class Sim3GraphResult(NamedTuple):
    R: torch.Tensor  # (K,3,3)
    t: torch.Tensor  # (K,3)
    s: torch.Tensor  # (K,)
    ok: torch.Tensor  # () bool on the device: False where a solve failed (S: a Cholesky pivot <= 0; U: a singular
    # diagonal block) and its step, as every later one on U, was zero; on the CPU: the result is finite
    cg_run: torch.Tensor | None  # (iters,) int32: the CG iterations each step of kernel U ran; None elsewhere


def vertex_csr(edge_i: torch.Tensor, edge_j: torch.Tensor, K: int):
    """Each vertex's edge ends in the order the plain version's ``index_add_``
    visits them: the edges that start at it, then those that end at it,
    each in edge order.  Returns (ptr (K+1,), ends (2E,) holding 2 e + 1
    where the vertex is edge e's j end, 2 e where it is its i end), int32
    on the edges' device."""
    E = edge_i.shape[0]
    ends = torch.cat([edge_i, edge_j]).long()
    order = torch.sort(ends, stable=True).indices
    entries = torch.where(order < E, 2 * order, 2 * (order - E) + 1)
    ptr = torch.zeros(K + 1, dtype=torch.int64, device=ends.device)
    ptr[1:] = torch.cumsum(torch.bincount(ends, minlength=K), 0)
    return ptr.to(torch.int32), entries.to(torch.int32)


def optimize_sim3_graph(g: Sim3Graph, iters: int = 12, damping: float = 1e-6) -> Sim3GraphResult:
    """Gauss-Newton on the Sim3 pose graph.  Returns the updated (R, t, s),
    ``ok`` and, for kernel U, the CG iterations each step ran.  On CUDA
    tensors kernel S for at most ``DENSE_MAX_K`` vertices, kernel U above
    (or under ``_FORCE_CG``); the plain version on CPU ones."""
    if g.R.device.type == "cpu":
        R, t, s = optimize_sim3_graph_plain(g, iters, damping)
        ok = torch.isfinite(R).all() & torch.isfinite(t).all() & torch.isfinite(s).all()
        return Sim3GraphResult(R, t, s, ok, None)
    K, E = g.R.shape[0], g.edge_i.shape[0]
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
    out = torch.empty_like(verts)
    jac = torch.empty((E, 15, 7), dtype=torch.float64, device=dev)  # r | J_i^T | J_j^T per edge
    fail = torch.zeros((), dtype=i32, device=dev)
    cg_run = None
    if K > DENSE_MAX_K or _FORCE_CG:
        vptr, vlist = vertex_csr(ei, ej, K)
        blk = torch.empty((E, 3 * 49 + 14), dtype=torch.float64, device=dev)  # H_ii | H_jj | H_ij | b_i | b_j
        dinv = torch.empty((K, 49), dtype=torch.float64, device=dev)
        vec = torch.empty(6 * 7 * K, dtype=torch.float64, device=dev)  # b | x | r | z | p | Ap
        cg_run = torch.zeros(iters, dtype=i32, device=dev)
        _kernels.launch(
            "sim3_pcg_launch", dev, verts.data_ptr(), ei.data_ptr(), ej.data_ptr(), meas.data_ptr(), w.data_ptr(),
            g.fixed.data_ptr(), vptr.data_ptr(), vlist.data_ptr(), K, E, iters, cg_iterations(K), float(damping),
            out.data_ptr(), jac.data_ptr(), blk.data_ptr(), dinv.data_ptr(), vec.data_ptr(), cg_run.data_ptr(),
            fail.data_ptr(),
        )
        optimize_sim3_graph.launches.add("pcg")
    else:
        n = 7 * K
        H = torch.empty((n, n), dtype=torch.float64, device=dev)
        vec = torch.empty(2 * n, dtype=torch.float64, device=dev)  # b | dx
        _kernels.launch(
            "sim3_graph_launch", dev, verts.data_ptr(), ei.data_ptr(), ej.data_ptr(), meas.data_ptr(), w.data_ptr(),
            g.fixed.data_ptr(), K, E, iters, float(damping), out.data_ptr(), jac.data_ptr(), H.data_ptr(),
            vec.data_ptr(), fail.data_ptr(),
        )
        optimize_sim3_graph.launches.add("dense")
    return Sim3GraphResult(out[:, :9].view(K, 3, 3), out[:, 9:12], out[:, 12], fail == 0, cg_run)


optimize_sim3_graph.launches = _kernels.LaunchCounter()  # by mode: "dense" (kernel S), "pcg" (kernel U)


# ---------------------------------------------------------------------------
# 4-DoF variant (yaw + translation; inertial maps, gravity-aligned gauge)
# ---------------------------------------------------------------------------


class SE3Graph(NamedTuple):
    """4-DoF pose-graph problem: K vertices T_iw, E edges T_ij."""

    R: torch.Tensor  # (K,3,3) T_iw
    t: torch.Tensor  # (K,3)
    edge_i: torch.Tensor  # (E,) int
    edge_j: torch.Tensor  # (E,) int
    meas_R: torch.Tensor  # (E,3,3) T_ij, mapping the j frame into the i frame
    meas_t: torch.Tensor  # (E,3)
    edge_valid: torch.Tensor  # (E,) bool
    fixed: torch.Tensor  # (K,) bool
    edge_w: torch.Tensor  # (E,) float32


def _yaw_update(dx, R, t):
    """VertexPose4DoF::oplusImpl (G2oTypes.h:155-183), batched: the world
    frame turned by the yaw dx[3] about gravity (z) and shifted by dx[:3]:
    R' = R Rz^T, t' = t - R' dx[:3]."""
    cy, sy = torch.cos(dx[..., 3]), torch.sin(dx[..., 3])
    zero, one = torch.zeros_like(cy), torch.ones_like(cy)
    RzT = torch.stack([torch.stack([cy, sy, zero], -1), torch.stack([-sy, cy, zero], -1),
                       torch.stack([zero, zero, one], -1)], -2)
    Rn = R @ RzT
    return Rn, t - torch.einsum("...ij,...j->...i", Rn, dx[..., :3])


def _edge_residual_4dof(dxi, dxj, Ri, ti, Rj, tj, mR, mt) -> torch.Tensor:
    """Edge4DoF (G2oTypes.h:783-818): e = log_SE3(T_ij T_jw T_iw^-1)."""
    Ti = lie.SE3(*_yaw_update(dxi, Ri, ti))
    Tj = lie.SE3(*_yaw_update(dxj, Rj, tj))
    return lie.se3_log(lie.SE3(mR, mt).compose(Tj).compose(Ti.inverse()))


def edge_jacobians_4dof(R, t, g: SE3Graph):
    """Residuals (E,6) and Jacobians J_i, J_j (E,6,4) of every 4-DoF edge at
    the vertices (R, t), in forward mode over 8 copies of the edge list
    (copy d carries direction d: dx_i's for d < 4, dx_j's after)."""
    E = g.edge_i.shape[0]
    ei, ej = g.edge_i.long().repeat(8), g.edge_j.long().repeat(8)
    mR, mt = g.meas_R.repeat(8, 1, 1), g.meas_t.repeat(8, 1)
    zero = torch.zeros((8 * E, 4), dtype=t.dtype, device=t.device)
    eye = torch.eye(4, dtype=t.dtype, device=t.device).repeat_interleave(E, dim=0)  # (4E,4): row d*E+e is e_d
    tan_i = torch.cat([eye, torch.zeros_like(eye)])
    tan_j = torch.cat([torch.zeros_like(eye), eye])
    with forward_ad.LOCK:
        r, dr = torch.func.jvp(lambda dxi, dxj: _edge_residual_4dof(dxi, dxj, R[ei], t[ei], R[ej], t[ej], mR, mt),
                               (zero, zero), (tan_i, tan_j))
    dr = dr.view(2, 4, E, 6).permute(0, 2, 3, 1)  # (end, edge, residual row, direction)
    return r[:E], dr[0], dr[1]


def optimize_4dof_graph_plain(g: SE3Graph, iters: int = 12, damping: float = 1e-6):
    """Plain version of kernel Z: Gauss-Newton on the 4-DoF pose graph, the
    solve dense or PCG as ``_solve_normal_eqs`` picks.  Returns (R, t)."""
    R, t = g.R, g.t
    w = g.edge_valid.to(t.dtype) * g.edge_w
    for _ in range(iters):
        r, Ji, Jj = edge_jacobians_4dof(R, t, g)
        dx = _solve_normal_eqs(r, Ji, Jj, g.edge_i, g.edge_j, w, g.fixed, damping).to(t.dtype)
        Rn, t = _yaw_update(dx, R, t)
        R = lie.normalize_rotation(Rn)
    return R, t


class SE3GraphResult(NamedTuple):
    R: torch.Tensor  # (K,3,3)
    t: torch.Tensor  # (K,3)
    ok: torch.Tensor  # () bool: False where a solve failed (as Sim3GraphResult.ok)
    cg_run: torch.Tensor | None  # (iters,) int32: the CG iterations each step of the PCG branch ran; None elsewhere


def optimize_4dof_graph(g: SE3Graph, iters: int = 12, damping: float = 1e-6) -> SE3GraphResult:
    """Gauss-Newton on the 4-DoF pose graph.  Returns the updated (R, t),
    ``ok`` and, on the PCG branch of the card, the CG iterations each step
    ran.  Kernel Z on CUDA tensors (its dense solve for at most
    ``DENSE_MAX_K`` vertices unless ``_FORCE_CG``, its PCG above); the
    plain version on CPU ones."""
    if g.R.device.type == "cpu":
        R, t = optimize_4dof_graph_plain(g, iters, damping)
        return SE3GraphResult(R, t, torch.isfinite(R).all() & torch.isfinite(t).all(), None)
    return _kernel_4dof(g, iters, damping)


def _kernel_4dof(g: SE3Graph, iters: int, damping: float) -> SE3GraphResult:
    K, E = g.R.shape[0], g.edge_i.shape[0]
    f32, i32 = torch.float32, torch.int32
    w = (g.edge_valid.to(f32) * g.edge_w.to(f32)).contiguous()
    ei, ej = g.edge_i.to(i32).contiguous(), g.edge_j.to(i32).contiguous()
    meas = torch.cat([g.meas_R.reshape(E, 9), g.meas_t.reshape(E, 3)], 1).to(f32).contiguous()
    verts = torch.cat([g.R.reshape(K, 9), g.t.reshape(K, 3)], 1).to(f32).contiguous()
    _kernels.require_cuda("optimize_4dof_graph", vertices=(verts, f32), edge_i=(ei, i32), edge_j=(ej, i32),
                          meas=(meas, f32), w=(w, f32), fixed=(g.fixed, torch.bool))
    if g.fixed.shape != (K,) or ej.shape != (E,) or w.shape != (E,):
        raise ValueError("optimize_4dof_graph: needs (K,) fixed flags and (E,) edges and weights")
    dev = g.R.device
    pcg = K > DENSE_MAX_K or _FORCE_CG
    out = torch.empty_like(verts)
    jac = torch.empty((E, 54), dtype=torch.float64, device=dev)  # r (6) | J_i^T (4x6) | J_j^T (4x6) per edge
    fail = torch.zeros((), dtype=i32, device=dev)
    n = 4 * K
    vptr, vlist = vertex_csr(ei, ej, K) if pcg else (ei, ei)  # the dense solve reads no vertex lists
    if pcg:
        H = torch.empty((E, 3 * 16 + 8), dtype=torch.float64, device=dev)  # per edge H_ii | H_jj | H_ij | b_i | b_j
        vec = torch.empty(6 * n + 16 * K, dtype=torch.float64, device=dev)  # b | x | r | z | p | Ap | D^-1
    else:
        H = torch.empty((n, n), dtype=torch.float64, device=dev)
        vec = torch.empty(2 * n, dtype=torch.float64, device=dev)  # b | dx
    cg_run = torch.zeros(iters, dtype=i32, device=dev)
    _kernels.launch(
        "pose_graph4_launch", dev, verts.data_ptr(), ei.data_ptr(), ej.data_ptr(), meas.data_ptr(), w.data_ptr(),
        g.fixed.data_ptr(), vptr.data_ptr(), vlist.data_ptr(), K, E, iters, int(pcg), cg_iterations(K),
        float(damping), out.data_ptr(), jac.data_ptr(), H.data_ptr(), vec.data_ptr(), cg_run.data_ptr(),
        fail.data_ptr(),
    )
    optimize_4dof_graph.launches.add("pcg" if pcg else "dense")
    return SE3GraphResult(out[:, :9].view(K, 3, 3), out[:, 9:12], fail == 0, cg_run if pcg else None)


optimize_4dof_graph.launches = _kernels.LaunchCounter()  # kernel Z, by mode: "dense", "pcg"


def correct_landmarks(lm_pos, ref_kf, R_old, t_old, s_old, R_new, t_new, s_new):
    """Move landmarks rigidly with their reference keyframe's Sim3
    correction, x' = S_new^-1(S_old(x)) (CorrectLoop, LoopClosing.cc:
    1164-1218; Optimizer.cc:1780-1820), batched over the landmarks."""
    ref = ref_kf.long()
    Ro, to, so = R_old[ref], t_old[ref], s_old[ref]
    Rn, tn, sn = R_new[ref], t_new[ref], s_new[ref]
    xc = so[:, None] * torch.einsum("kij,kj->ki", Ro, lm_pos) + to
    return torch.einsum("kji,kj->ki", Rn, xc - tn) / sn[:, None]
