"""Visual-inertial bundle adjustment over a window of keyframe body states
(pose, velocity, bias) and their landmarks: reprojection, preintegration
and bias random-walk factors.

Counterpart of ``orb_slam3_fast_tpu/optim/vi_ba.py`` (LocalInertialBA,
Optimizer.cc:2426-3024): the same ``VIBAProblem`` table, the same robust
two-phase schedule (``iters1`` LM iterations, chi2 reclassification,
``iters2`` more, a final classification), the landmarks eliminated by the
Schur complement into the dense (15K)^2 system of the states, fixed states
handled by masking, and the accept test on the robust cost.

``vi_bundle_adjust`` is the wrapper of kernel Y (``csrc/vi_ba.cu``);
``vi_bundle_adjust_plain`` is the JAX code in PyTorch (the dense ``Z``
(M,K,6,3), ``torch.func`` forward-mode Jacobians of the inertial edges,
a float32 LU solve).

Kernel Y -- source note.
  Replaces: ``vi_bundle_adjust`` (``orb_slam3_fast_tpu/optim/vi_ba.py:184``,
  K25), a jitted pair of LM scans (4 + 8 iterations) over K = 16 states
  (window 10 and its anchor, padded), M <= 2048 landmarks, O <= 8192
  observations and K-1 inertial edges, with a dense (15K)^2 = 240^2 solve.
  Bound on the card: latency.  An iteration is ~400 flops per observation,
  ~100 per pair of observations of one landmark for the Schur complement,
  ~30 dual-number evaluations per inertial edge and a 240^2 solve (~9
  Mflop of elimination in 240 dependent column steps); the observation
  table is ~0.3 MB.
  Design: one CTA of 512 threads runs both phases and the classifications
  in one launch.  Per iteration: (1) threads stride over the observations:
  residual, closed-form Jacobians of the body pose (through T_cb) and the
  landmark, Huber weight; each writes its own terms (no atomics); (2) per
  landmark, the observations through CSR offsets (``lm_ptr`` / ``lm_obs``,
  built by the wrapper with a stable sort): Hll, bl, the damped inverse
  V^-1; per state, its observations in landmark order (``kf_ptr`` /
  ``kf_obs``): the pose blocks, and for each pair of states a merge of
  their two lists over the shared landmarks: the coupling - sum W_i V^-1
  W_j^T and the correction W V^-1 bl, every sum in a fixed order, so a run
  repeats bit for bit; (3) the inertial edges from ``csrc/inertial.cuh``'s
  dual numbers, thread (edge, direction) per Jacobian column, summed into
  the dense system entry by entry over the state's own edges in edge
  order (``ke_ptr`` / ``ke_edge``); (4) the damped system solved by
  Gaussian elimination with partial pivoting (the JAX package's LU solve)
  in float64 in global memory (it does not fit in shared memory at K =
  32), one warp searching each column's pivot, the block sharing its row
  updates, thread 0 substituting.  The system holds the free states alone
  (``free_ids`` / ``free_pos``): a fixed state's rows and columns in the
  JAX package's (15K)^2 system are the identity's and coupled to nothing,
  so its elimination leaves the free entries bit for bit as they are, and
  dropping them changes no result (at K = 16 on the mono path, 10 free
  states of 16: 150^2 in place of 240^2).  K has no limit; the one CTA's
  elimination grows as the cube of 15 times the free states (PERF.md
  gives its time at K = 128);
  (5) back-substitution of the landmarks, the candidate's robust cost, the
  accept and the damping on the device.  Kernels E and F are not called:
  their Jacobians are with respect to a camera-frame SE3.  A distorted
  pin-hole camera and a KB8 camera each take their own instance
  (``csrc/camera.cuh``).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from orb_slam3_fast_tpu_torch import _kernels
from orb_slam3_fast_tpu_torch.cameras import models as cam_models
from orb_slam3_fast_tpu_torch.imu import preintegration as pre
from orb_slam3_fast_tpu_torch.optim import inertial as inr
from orb_slam3_fast_tpu_torch.optim.pose_opt import CAMERA_NAMES, _huber_weight, kernel_camera
from orb_slam3_fast_tpu_torch.utils import lie

S = 15  # per-keyframe state [theta, p, v, bg, ba]


class VIBAProblem(NamedTuple):
    R_wb: torch.Tensor  # (K,3,3)
    p_wb: torch.Tensor  # (K,3)
    v_w: torch.Tensor  # (K,3)
    bias: torch.Tensor  # (K,6)
    state_fixed: torch.Tensor  # (K,) bool
    xw: torch.Tensor  # (M,3)
    lm_valid: torch.Tensor  # (M,) bool
    obs_kf: torch.Tensor  # (O,) int
    obs_lm: torch.Tensor  # (O,) int
    obs_uv: torch.Tensor  # (O,3)
    obs_inv_sigma2: torch.Tensor
    obs_is_stereo: torch.Tensor
    obs_valid: torch.Tensor
    edge_i: torch.Tensor  # (E,) int
    edge_j: torch.Tensor  # (E,) int
    edge_valid: torch.Tensor  # (E,) bool
    preint: pre.Preintegrated  # stacked (E, ...)


def _project_obs(cam, bf, Rk, tk, xo, prob: VIBAProblem):
    xc = torch.einsum("oij,oj->oi", Rk, xo) + tk
    r = prob.obs_uv - cam_models.stereo_project(cam, xc, bf)
    r = torch.cat([r[:, :2], torch.where(prob.obs_is_stereo, r[:, 2], torch.zeros_like(r[:, 2]))[:, None]], 1)
    return r, xc, xc[:, 2] > 0.05


def _chi2_delta2(r, prob: VIBAProblem):
    chi2 = torch.sum(r * r, -1) * prob.obs_inv_sigma2
    delta2 = torch.where(prob.obs_is_stereo, torch.full_like(chi2, 7.815), torch.full_like(chi2, 5.991))
    return chi2, delta2


def _visual_blocks(cam, bf, T_cb, R_wb, p_wb, xw, prob: VIBAProblem, inlier, with_blocks=True, per_obs=False):
    """The reprojection factors' normal-equation pieces (Hpp, Hll, bp, bl,
    the coupling, w_lm, cost): the coupling as the dense Z (M,K,6,3), or
    with ``per_obs`` as each observation's W (O,6,3) (the CG form's); with
    ``with_blocks`` False the robust cost alone."""
    K, M = R_wb.shape[0], xw.shape[0]
    R_cw, t_cw = inr.camera_pose(T_cb, R_wb, p_wb)
    xo = xw[prob.obs_lm]
    r, xc, posd = _project_obs(cam, bf, R_cw[prob.obs_kf], t_cw[prob.obs_kf], xo, prob)
    active = prob.obs_valid & inlier & posd & prob.lm_valid[prob.obs_lm]
    chi2, delta2 = _chi2_delta2(r, prob)
    rho = torch.where(chi2 <= delta2, chi2, 2.0 * torch.sqrt(delta2 * torch.clamp(chi2, min=1e-12)) - delta2)
    cost = torch.sum(torch.where(active, rho, torch.zeros_like(rho)))
    if not with_blocks:
        return cost
    w = torch.where(active, _huber_weight(chi2, delta2) * prob.obs_inv_sigma2, torch.zeros_like(chi2))
    Jp = inr.visual_pose_jacobian(cam, bf, T_cb, R_wb[prob.obs_kf], p_wb[prob.obs_kf], xo, xc, prob.obs_is_stereo)
    Jproj = cam_models.stereo_project_jac(cam, xc, bf)
    Jproj = torch.cat([Jproj[:, :2], Jproj[:, 2:] * prob.obs_is_stereo[:, None, None]], 1)
    Jl = -(Jproj @ R_cw[prob.obs_kf])
    free = (~prob.state_fixed)[prob.obs_kf]
    Jp = Jp * free[:, None, None]
    f32 = torch.float32
    dev = xw.device
    Hpp = torch.zeros((K, 6, 6), dtype=f32, device=dev).index_add_(0, prob.obs_kf,
                                                                   torch.einsum("oij,o,oik->ojk", Jp, w, Jp))
    Hll = torch.zeros((M, 3, 3), dtype=f32, device=dev).index_add_(0, prob.obs_lm,
                                                                   torch.einsum("oij,o,oik->ojk", Jl, w, Jl))
    bp = torch.zeros((K, 6), dtype=f32, device=dev).index_add_(0, prob.obs_kf, -torch.einsum("oij,o,oi->oj", Jp, w, r))
    bl = torch.zeros((M, 3), dtype=f32, device=dev).index_add_(0, prob.obs_lm, -torch.einsum("oij,o,oi->oj", Jl, w, r))
    Wob = torch.einsum("oij,o,oik->ojk", Jp, w, Jl)
    w_lm = torch.zeros(M, dtype=f32, device=dev).index_add_(0, prob.obs_lm, w)
    if per_obs:
        return Hpp, Hll, bp, bl, Wob, w_lm, cost
    Z = torch.zeros((M, K, 6, 3), dtype=f32, device=dev).index_put_((prob.obs_lm.long(), prob.obs_kf.long()), Wob,
                                                                   accumulate=True)
    return Hpp, Hll, bp, bl, Z, w_lm, cost


def _edge_factors(prob: VIBAProblem, R_wb, p_wb, v_w, bias, D=None):
    """(E, 15) [r9, rb] of every edge, the endpoints retracted by D (E, 30)."""
    i, j = prob.edge_i.long(), prob.edge_j.long()
    si = inr.BodyState(R_wb[i], p_wb[i], v_w[i], bias[i])
    sj = inr.BodyState(R_wb[j], p_wb[j], v_w[j], bias[j])
    if D is not None:
        si, sj = inr.retract(si, D[:, :S]), inr.retract(sj, D[:, S:])
    return torch.cat([inr.inertial_residual(si, sj, prob.preint), sj.bias - si.bias], -1)


def _inertial_edge_terms(prob: VIBAProblem, R_wb, p_wb, v_w, bias, with_blocks=True):
    """Per edge of the inertial and bias random-walk chain the 15x15 blocks
    H_ii, H_jj, H_ij and the gradient pieces g_i, g_j (forward-mode
    Jacobians, a fixed state's columns zeroed), and the chain's cost; with
    ``with_blocks`` False the cost alone."""
    E = prob.edge_i.shape[0]
    dev = R_wb.device
    f32 = torch.float32
    info9 = inr.inertial_information(prob.preint)
    walk = inr.walk_information(prob.preint)
    ev = prob.edge_valid.to(f32)
    f = _edge_factors(prob, R_wb, p_wb, v_w, bias)
    r9, rb = f[:, :9], f[:, 9:]
    cost = torch.sum(ev * torch.einsum("ea,eab,eb->e", r9, info9, r9))
    cost = cost + torch.sum(ev * torch.einsum("ea,eab,eb->e", rb, walk, rb))
    if not with_blocks:
        return cost
    zero = torch.zeros((E, 2 * S), dtype=f32, device=dev)
    basis = torch.eye(2 * S, dtype=f32, device=dev)[:, None, :].expand(2 * S, E, 2 * S)
    cols = torch.func.vmap(lambda t: torch.func.jvp(lambda D: _edge_factors(prob, R_wb, p_wb, v_w, bias, D),
                                                    (zero,), (t,))[1])(basis)  # (30, E, 15)
    J = cols.permute(1, 2, 0)  # (E, 15, 30)
    free = (~prob.state_fixed).to(f32)
    i, j = prob.edge_i.long(), prob.edge_j.long()
    mi = (ev * free[i])[:, None, None]
    mj = (ev * free[j])[:, None, None]
    J_i, J_j = J[:, :9, :S] * mi, J[:, :9, S:] * mj
    Jb_i, Jb_j = J[:, 9:, :S] * mi, J[:, 9:, S:] * mj
    Hii = torch.einsum("eap,eab,ebq->epq", J_i, info9, J_i) + torch.einsum("eap,eab,ebq->epq", Jb_i, walk, Jb_i)
    Hjj = torch.einsum("eap,eab,ebq->epq", J_j, info9, J_j) + torch.einsum("eap,eab,ebq->epq", Jb_j, walk, Jb_j)
    Hij = torch.einsum("eap,eab,ebq->epq", J_i, info9, J_j) + torch.einsum("eap,eab,ebq->epq", Jb_i, walk, Jb_j)
    gi = -torch.einsum("eap,eab,eb->ep", J_i, info9, r9 * ev[:, None]) - torch.einsum(
        "eap,eab,eb->ep", Jb_i, walk, rb * ev[:, None])
    gj = -torch.einsum("eap,eab,eb->ep", J_j, info9, r9 * ev[:, None]) - torch.einsum(
        "eap,eab,eb->ep", Jb_j, walk, rb * ev[:, None])
    return Hii, Hjj, Hij, gi, gj, cost


def _inertial_blocks(prob: VIBAProblem, R_wb, p_wb, v_w, bias, with_blocks=True):
    """The dense (K,S,K,S) terms, gradient and cost of the inertial and bias
    random-walk chain."""
    if not with_blocks:
        return _inertial_edge_terms(prob, R_wb, p_wb, v_w, bias, with_blocks=False)
    K, dev = R_wb.shape[0], R_wb.device
    Hii, Hjj, Hij, gi, gj, cost = _inertial_edge_terms(prob, R_wb, p_wb, v_w, bias)
    i, j = prob.edge_i.long(), prob.edge_j.long()
    H = torch.zeros((K, S, K, S), dtype=torch.float32, device=dev)
    g = torch.zeros((K, S), dtype=torch.float32, device=dev)
    for e in range(prob.edge_i.shape[0]):
        a, b = int(i[e]), int(j[e])
        H[a, :, a, :] += Hii[e]
        H[b, :, b, :] += Hjj[e]
        H[a, :, b, :] += Hij[e]
        H[b, :, a, :] += Hij[e].T
        g[a] += gi[e]
        g[b] += gj[e]
    return H, g, cost


def _classify(cam, bf, T_cb, R_wb, p_wb, xw, prob: VIBAProblem):
    R_cw, t_cw = inr.camera_pose(T_cb, R_wb, p_wb)
    r, _, posd = _project_obs(cam, bf, R_cw[prob.obs_kf], t_cw[prob.obs_kf], xw[prob.obs_lm], prob)
    chi2, delta2 = _chi2_delta2(r, prob)
    return prob.obs_valid & (chi2 <= delta2) & posd


def vi_bundle_adjust_plain(cam, bf, T_cb: lie.SE3, prob: VIBAProblem, iters1: int = 4, iters2: int = 8):
    """Plain version of kernel Y.  Returns (R_wb, p_wb, v_w, bias, xw,
    obs_inlier)."""
    K, M = prob.R_wb.shape[0], prob.xw.shape[0]
    dev = prob.xw.device
    f32 = torch.float32
    free = (~prob.state_fixed).to(f32)
    mask = free.repeat_interleave(S)
    eye3 = torch.eye(3, dtype=f32, device=dev)
    eyeN = torch.eye(K * S, dtype=f32, device=dev)
    ar = torch.arange(K, device=dev)

    def lm_step(R_wb, p_wb, v_w, bias, xw, inlier, lam):
        Hpp6, Hll, bp6, bl, Z, w_lm, vcost = _visual_blocks(cam, bf, T_cb, R_wb, p_wb, xw, prob, inlier)
        Hi, gi, icost = _inertial_blocks(prob, R_wb, p_wb, v_w, bias)
        H = Hi.clone()
        H[ar, 0:6, ar, 0:6] += Hpp6
        g = gi.clone()
        g[:, 0:6] += bp6
        Hflat = H.reshape(K * S, K * S)
        Hflat = Hflat + torch.diag(lam * torch.clamp(torch.diag(Hflat), min=1e-3))
        Hflat = Hflat * mask[:, None] * mask[None, :] + torch.diag(1.0 - mask)
        gflat = g.reshape(-1) * mask
        Hll_d = Hll + (lam * torch.clamp(torch.diagonal(Hll, dim1=1, dim2=2), min=1e-3))[:, :, None] * eye3
        lm_seen = w_lm > 0
        Hll_d = torch.where(lm_seen[:, None, None], Hll_d, eye3)
        Vinv = torch.linalg.inv(Hll_d)
        ZV = torch.einsum("mkab,mbc->mkac", Z, Vinv)
        S_coup6 = torch.einsum("mkac,mjbc->kajb", ZV, Z)
        Scoup = torch.zeros((K, S, K, S), dtype=f32, device=dev)
        Scoup[:, 0:6, :, 0:6] = S_coup6
        Hflat = Hflat - Scoup.reshape(K * S, K * S) * mask[:, None] * mask[None, :]
        b_corr = torch.zeros((K, S), dtype=f32, device=dev)
        b_corr[:, 0:6] = torch.einsum("mkac,mc->ka", ZV, bl)
        gflat = gflat - b_corr.reshape(-1) * mask
        dx = torch.linalg.solve(Hflat + 1e-6 * eyeN, gflat).reshape(K, S) * free[:, None]
        Wt_dp = torch.einsum("mkab,ka->mb", Z, dx[:, 0:6])
        dl = torch.einsum("mab,mb->ma", Vinv, bl - Wt_dp) * (lm_seen & prob.lm_valid)[:, None]
        R_new = R_wb @ lie.so3_exp(dx[:, 0:3])
        p_new = p_wb + torch.einsum("kij,kj->ki", R_wb, dx[:, 3:6])
        v_new, b_new, xw_new = v_w + dx[:, 6:9], bias + dx[:, 9:15], xw + dl
        new_cost = _visual_blocks(cam, bf, T_cb, R_new, p_new, xw_new, prob, inlier, with_blocks=False) + \
            _inertial_blocks(prob, R_new, p_new, v_new, b_new, with_blocks=False)
        accept = new_cost < vcost + icost
        pick = [torch.where(accept, a, b) for a, b in ((R_new, R_wb), (p_new, p_wb), (v_new, v_w), (b_new, bias),
                                                        (xw_new, xw))]
        return pick, torch.where(accept, torch.clamp(lam * 0.5, min=1e-8), torch.clamp(lam * 5.0, max=1e6))

    state = [prob.R_wb, prob.p_wb, prob.v_w, prob.bias, prob.xw]
    inlier = torch.ones_like(prob.obs_valid)
    for n in (iters1, iters2):
        lam = torch.tensor(1e-4, dtype=f32, device=dev)
        for _ in range(n):
            state, lam = lm_step(*state, inlier, lam)
        inlier = _classify(cam, bf, T_cb, state[0], state[1], state[4], prob)
    return (*state, inlier)


def _csr(key: torch.Tensor, sub: torch.Tensor | None, n: int, valid: torch.Tensor):
    """Offsets (n+1,) int32 and the valid observations sorted by ``key``
    (then ``sub``, then index), as int32."""
    idx = torch.nonzero(valid).flatten()
    if sub is not None:
        idx = idx[torch.sort(sub[idx].long(), stable=True).indices]
    idx = idx[torch.sort(key[idx].long(), stable=True).indices]
    counts = torch.bincount(key[idx].long(), minlength=n)
    ptr = torch.zeros(n + 1, dtype=torch.int32, device=key.device)
    ptr[1:] = torch.cumsum(counts, 0)
    return ptr, idx.to(torch.int32).contiguous()


def _state_edges(edge_i: torch.Tensor, edge_j: torch.Tensor, edge_valid: torch.Tensor, K: int):
    """Each state's valid inertial edges in edge order, as CSR: offsets
    (K+1,) int32 and edge ids int32 (an edge with i == j listed once)."""
    e = torch.arange(edge_i.shape[0], dtype=torch.int32, device=edge_i.device)
    second = edge_valid & (edge_j != edge_i)
    key = torch.cat([edge_i[edge_valid], edge_j[second]])
    ids = torch.cat([e[edge_valid], e[second]])
    ptr, order = _csr(key, ids, K, torch.ones_like(key, dtype=torch.bool))
    return ptr, ids[order.long()].contiguous()


def vi_bundle_adjust(cam, bf, T_cb: lie.SE3, prob: VIBAProblem, iters1: int = 4, iters2: int = 8):
    """Kernel Y on CUDA tensors, its plain version on CPU ones.  Returns
    (R_wb, p_wb, v_w, bias, xw, obs_inlier)."""
    if prob.xw.device.type == "cpu":
        return vi_bundle_adjust_plain(cam, bf, T_cb, prob, iters1, iters2)
    return _kernel(cam, bf, T_cb, prob, iters1, iters2)


def _kernel(cam, bf, T_cb, prob: VIBAProblem, iters1: int, iters2: int):
    f32, i32, b8 = torch.float32, torch.int32, torch.bool
    dev = prob.xw.device
    cam10, kind = kernel_camera(cam, bf, "kernel Y")
    K, M, O, E = prob.R_wb.shape[0], prob.xw.shape[0], prob.obs_kf.shape[0], prob.edge_i.shape[0]
    c = {name: getattr(prob, name).contiguous() for name in VIBAProblem._fields if name != "preint"}
    for name in ("obs_kf", "obs_lm", "edge_i", "edge_j"):
        c[name] = c[name].to(i32)
    types = dict(R_wb=f32, p_wb=f32, v_w=f32, bias=f32, state_fixed=b8, xw=f32, lm_valid=b8, obs_kf=i32, obs_lm=i32,
                 obs_uv=f32, obs_inv_sigma2=f32, obs_is_stereo=b8, obs_valid=b8, edge_i=i32, edge_j=i32,
                 edge_valid=b8)
    _kernels.require_cuda("vi_bundle_adjust", **{k: (c[k], t) for k, t in types.items()})
    if E < 1:
        raise ValueError("vi_bundle_adjust: kernel Y takes at least one edge")
    lm_ptr, lm_obs = _csr(c["obs_lm"], None, M, c["obs_valid"])
    kf_ptr, kf_obs = _csr(c["obs_kf"], c["obs_lm"], K, c["obs_valid"])
    ke_ptr, ke_edge = _state_edges(c["edge_i"], c["edge_j"], c["edge_valid"], K)
    free = ~c["state_fixed"]
    free_ids = torch.nonzero(free).flatten().to(i32).contiguous()
    free_pos = torch.where(free, torch.cumsum(free.to(i32), 0) - 1, -1).to(i32).contiguous()
    nf = int(free_ids.shape[0])
    tcb = torch.cat([T_cb.R.reshape(9), T_cb.t]).to(device=dev, dtype=f32).contiguous()
    pk = pre.pack(prob.preint.to(dev))
    scratch = torch.empty(vi_ba_scratch_doubles(K, M, O, E, nf), dtype=torch.float64, device=dev)
    state = torch.empty((K, 21), dtype=f32, device=dev)
    xw = torch.empty((M, 3), dtype=f32, device=dev)
    inlier = torch.empty(O, dtype=b8, device=dev)
    _kernels.launch(
        "vi_ba_launch", dev, cam10.to(dev).data_ptr(), kind, tcb.data_ptr(), K, M, O, E,
        c["R_wb"].data_ptr(), c["p_wb"].data_ptr(), c["v_w"].data_ptr(), c["bias"].data_ptr(),
        c["state_fixed"].data_ptr(), c["xw"].data_ptr(), c["lm_valid"].data_ptr(), c["obs_kf"].data_ptr(),
        c["obs_lm"].data_ptr(), c["obs_uv"].data_ptr(), c["obs_inv_sigma2"].data_ptr(), c["obs_is_stereo"].data_ptr(),
        c["obs_valid"].data_ptr(), c["edge_i"].data_ptr(), c["edge_j"].data_ptr(), c["edge_valid"].data_ptr(),
        pk.data_ptr(), lm_ptr.data_ptr(), lm_obs.data_ptr(), kf_ptr.data_ptr(), kf_obs.data_ptr(), ke_ptr.data_ptr(),
        ke_edge.data_ptr(), free_ids.data_ptr(), free_pos.data_ptr(), nf, iters1, iters2, scratch.data_ptr(),
        state.data_ptr(), xw.data_ptr(), inlier.data_ptr(),
    )
    vi_bundle_adjust.launches.add(camera=CAMERA_NAMES[kind])
    s = inr.unpack_state(state)
    return s.R, s.p, s.v, s.bias, xw, inlier


def vi_ba_scratch_doubles(K: int, M: int, O: int, E: int, nf: int | None = None) -> int:
    """Doubles of kernel Y's scratch (csrc/vi_ba.cu): 68 per observation
    (residual, Jacobians, weight, W and W V^-1), 31 per landmark (Hll, bl,
    V^-1, the weight sum, the position and the candidate's), 1032 per edge
    (Jacobian, its weighted copy, residual, informations), the system over
    the ``nf`` free states (15 nf) x (15 nf + 1) (all K when not given),
    its solution, the step of every state, the current and candidate
    states and 8 more."""
    n = 15 * (K if nf is None else nf)
    return O * 68 + M * 31 + E * 1032 + n * (n + 1) + n + 15 * K + K * 42 + 8


vi_bundle_adjust.launches = _kernels.LaunchCounter()  # by camera instance: "", "radtan", "kb8"
