"""FullInertialBA: Levenberg-Marquardt over every keyframe's 15-D body state
(pose, velocity, bias), every landmark and the whole preintegration chain,
the landmarks eliminated implicitly and the reduced state system solved by
block-Jacobi preconditioned conjugate gradients.

Counterpart of ``orb_slam3_fast_tpu/optim/vi_ba_cg.py``
(Optimizer::FullInertialBA, Optimizer.cc:374-780, run from the loop
closer's global-BA thread, LoopClosing.cc:2397-2650): the chain stays per
edge, (E,15,15) blocks applied as an operator (block-tridiagonal); the
visual factors keep their per-observation coupling W (O,6,3) on the first
6 slots of the state tangent (``optim/vi_ba.py``'s factors,
``R <- R Exp(dtheta)``, ``p <- p + R dp``); S = H_state - Z V^-1 Z^T is
applied, never formed.  The LM schedule is host-segmented
(``lm_segment_vi``, 2 iterations a segment) so that the GBA thread polls
its abort flag between segments (mbStopGBA, LoopClosing.cc:1072-1086).

``lm_segment_vi`` and ``classify_vi`` run kernel AA (``csrc/vi_pcg.cu``)
on CUDA tensors, a template instance per camera kind (pin-hole,
radial-tangential, KB8: ``csrc/camera.cuh``, as kernel Y's), and their
plain versions on CPU ones.  The plain versions
take the chain's Jacobians in forward mode (``optim/vi_ba.py``) and solve
in float64, as the kernel does (the JAX package's solve is float32).

Kernel AA -- source note.
  Replaces: ``lm_segment_vi`` (``orb_slam3_fast_tpu/optim/vi_ba_cg.py:348``,
  with ``_lm_step_vi`` ``:312``, ``_implicit_vi_solve`` ``:201``,
  ``_visual_blocks_cg`` ``:52``, ``_inertial_edge_blocks`` ``:103``) and
  ``classify_vi`` (``:382``), K25's CG form: ``n_iters`` LM steps in a
  ``lax.scan``, each forming the visual blocks (K,6,6), (M,3,3), (O,6,3),
  the chain's (E,15,15) blocks from ``jax.jacfwd`` per edge, the damped
  landmark and 15x15 block-Jacobi inverses, ``cg_iters`` = 40 PCG
  iterations of the implicit operator (two gathers, two (O,6,3) einsums
  and scatter-adds, the chain's mat-vecs), the retraction, the candidate's
  robust cost and the accept.
  Bound on the card: latency.  Per LM step ~600 flops per observation,
  ~30 dual-number evaluations of ~3000 flops per edge, and 40 dependent CG
  iterations of ~40 flops per observation and ~1000 per edge each; at the
  200-keyframe world (O ~ 19k) that is ~0.1 Gflop an LM step against 67
  Tflop/s, while the CG iterations' barriers set the pace.
  Design: one CTA of 512 threads runs the whole segment in one launch
  (kernel Y's layout: the working set in a float64 scratch in global
  memory, no host read inside the segment).  Per LM step: (1) the
  observations (kernel Y's pass: residual, body-pose and landmark
  Jacobians through T_cb, Huber weight, W = Jp^T w Jl), each thread
  writing its own; (2) the chain's Jacobian columns in float64 dual
  numbers (``csrc/inertial.cuh``), thread (edge, direction), the
  information-weighted rows, and each edge's 30x30 block entry by entry;
  (3) per landmark over its observations in CSR order: Hll, bl, w_lm and
  the damped inverse V^-1; per state over its observations (state CSR)
  and its edges (``ke_ptr`` / ``ke_edge``, edge order): Hpp, the gradient,
  the damping diagonal, W V^-1 W^T and the block-Jacobi inverse of the
  15x15 diagonal block (Gauss-Jordan, +1e-5 I); (4) the CG iterations: per
  landmark y = V^-1 sum W^T p (CSR), per state row the operator (damping,
  Hpp, the state's edges' blocks, - sum W y), dot products as fixed-order
  block sums; the freeze of the JAX scan (alpha = beta = 0 once r.z <=
  1e-12) ends the loop; (5) the landmarks' back-substitution, the
  candidate states (float64 retraction), the candidate's visual and
  chain cost, the accept and the damping.  ``classify_vi`` is its second
  entry (one thread per observation).  Every sum has a fixed order and
  there are no floating-point atomics: a run repeats bit for bit.
"""
from __future__ import annotations

import torch

from orb_slam3_fast_tpu_torch import _kernels
from orb_slam3_fast_tpu_torch.imu import preintegration as pre
from orb_slam3_fast_tpu_torch.optim import inertial as inr
from orb_slam3_fast_tpu_torch.optim import vi_ba as vb
from orb_slam3_fast_tpu_torch.optim.pose_opt import CAMERA_NAMES, kernel_camera
from orb_slam3_fast_tpu_torch.optim.vi_ba import S, VIBAProblem
from orb_slam3_fast_tpu_torch.utils import lie


def _visual_blocks_cg(cam, bf, T_cb, R_wb, p_wb, xw, prob: VIBAProblem, inlier):
    """(Hpp (K,6,6), Hll (M,3,3), bp (K,6), bl (M,3), Wob (O,6,3), w_lm
    (M,), cost) of the reprojection factors, the coupling per observation."""
    return vb._visual_blocks(cam, bf, T_cb, R_wb, p_wb, xw, prob, inlier, per_obs=True)


def _inertial_edge_blocks(prob: VIBAProblem, R_wb, p_wb, v_w, bias):
    """The chain's per-edge blocks (Hii, Hjj, Hij (E,15,15)), its gradient
    summed per state (K,15) and its cost."""
    Hii, Hjj, Hij, gi, gj, cost = vb._inertial_edge_terms(prob, R_wb, p_wb, v_w, bias)
    g = torch.zeros((R_wb.shape[0], S), dtype=gi.dtype, device=gi.device)
    g.index_add_(0, prob.edge_i.long(), gi).index_add_(0, prob.edge_j.long(), gj)
    return Hii, Hjj, Hij, g, cost


def _inertial_cost(prob: VIBAProblem, R_wb, p_wb, v_w, bias):
    return vb._inertial_edge_terms(prob, R_wb, p_wb, v_w, bias, with_blocks=False)


def _visual_cost(cam, bf, T_cb, R_wb, p_wb, xw, prob: VIBAProblem, inlier):
    return vb._visual_blocks(cam, bf, T_cb, R_wb, p_wb, xw, prob, inlier, with_blocks=False)


def _identity(x):
    return x


def _implicit_vi_solve(Hpp, Hll, bp, bl, Wob, Hii, Hjj, Hij, g_chain, obs_kf, obs_lm, edge_i, edge_j, w_lm,
                       state_fixed, lm_valid, lam, cg_iters: int, reduce_k=_identity, reduce_m=_identity):
    """PCG on the landmark-Schur-reduced 15-D state system applied as an
    operator, in float64 (kernel AA's arithmetic).  Returns (dx (K,15), dl
    (M,3)) in float32.

    ``reduce_k`` / ``reduce_m`` sum a (K,...) / (M,...) tensor of partial
    sums over the observation shards (the JAX package's hooks, the identity
    on one device; ``parallel/dist_ba.py`` passes ``Mesh.all_reduce``): the
    visual blocks must already be reduced and the chain's blocks replicated."""
    f64 = torch.float64
    K, M = Hpp.shape[0], Hll.shape[0]
    dev = Hpp.device
    kf, lm, ei, ej = obs_kf.long(), obs_lm.long(), edge_i.long(), edge_j.long()
    Hpp, Hll, bp, bl, Wob, Hii, Hjj, Hij, g_chain, lam = (
        x.to(f64) for x in (Hpp, Hll, bp, bl, Wob, Hii, Hjj, Hij, g_chain, torch.as_tensor(lam)))
    free = ~state_fixed
    free_f = free.to(f64)[:, None]
    eye3, eyeS = torch.eye(3, dtype=f64, device=dev), torch.eye(S, dtype=f64, device=dev)
    b = g_chain.clone()
    b[:, 0:6] += bp
    lm_seen = w_lm > 0
    Hll_d = Hll + torch.diag_embed(lam * torch.clamp(torch.diagonal(Hll, dim1=1, dim2=2), min=1e-3))
    Vinv = torch.linalg.inv(torch.where(lm_seen[:, None, None], Hll_d, eye3))
    diag15 = torch.zeros((K, S), dtype=f64, device=dev)
    diag15[:, 0:6] += torch.diagonal(Hpp, dim1=1, dim2=2)
    diag15.index_add_(0, ei, torch.diagonal(Hii, dim1=1, dim2=2)).index_add_(0, ej, torch.diagonal(Hjj, dim1=1, dim2=2))
    damp = lam * torch.clamp(diag15, min=1e-3)

    def Zt_v(v6):  # (K,6) -> (M,3)
        t = torch.einsum("oab,oa->ob", Wob, v6[kf])
        return reduce_m(torch.zeros((M, 3), dtype=f64, device=dev).index_add_(0, lm, t))

    def Z_y(y):  # (M,3) -> (K,6)
        t = torch.einsum("oab,ob->oa", Wob, y[lm])
        return reduce_k(torch.zeros((K, 6), dtype=f64, device=dev).index_add_(0, kf, t))

    def S_mv(v):
        v = v * free_f
        out = damp * v
        out[:, 0:6] += torch.einsum("kab,kb->ka", Hpp, v[:, 0:6])
        vi, vj = v[ei], v[ej]
        out.index_add_(0, ei, torch.einsum("eab,eb->ea", Hii, vi) + torch.einsum("eab,eb->ea", Hij, vj))
        out.index_add_(0, ej, torch.einsum("eab,eb->ea", Hjj, vj) + torch.einsum("eba,eb->ea", Hij, vi))
        out[:, 0:6] -= Z_y(torch.einsum("mab,mb->ma", Vinv, Zt_v(v[:, 0:6])))
        return out * free_f

    b_s = b.clone()
    b_s[:, 0:6] -= Z_y(torch.einsum("mab,mb->ma", Vinv, bl))
    b_s = b_s * free_f
    D = torch.zeros((K, S, S), dtype=f64, device=dev)
    D[:, 0:6, 0:6] += Hpp
    D.index_add_(0, ei, Hii).index_add_(0, ej, Hjj)
    D = D + torch.diag_embed(damp)
    coup = torch.einsum("oab,obc,odc->oad", Wob, Vinv[lm], Wob)
    D[:, 0:6, 0:6] -= reduce_k(torch.zeros((K, 6, 6), dtype=f64, device=dev).index_add_(0, kf, coup))
    Dinv = torch.linalg.inv(torch.where(free[:, None, None], D, eyeS) + 1e-5 * eyeS)

    def precond(r):
        return torch.einsum("kab,kb->ka", Dinv, r) * free_f

    x = torch.zeros_like(b_s)
    r = b_s
    z = precond(r)
    p = z
    rz = torch.sum(r * z)
    zero = torch.zeros_like(rz)
    for _ in range(cg_iters):
        Ap = S_mv(p)
        pAp = torch.sum(p * Ap)
        ok = rz > 1e-12
        alpha = torch.where(ok, rz / torch.clamp(pAp, min=1e-20), zero)
        x = x + alpha * p
        r = r - alpha * Ap
        z = precond(r)
        rz_new = torch.sum(r * z)
        beta = torch.where(ok, rz_new / torch.clamp(rz, min=1e-20), zero)
        p = z + beta * p
        rz = rz_new
    dx = x * free_f
    dl = torch.einsum("mab,mb->ma", Vinv, bl - Zt_v(dx[:, 0:6])) * (lm_seen & lm_valid)[:, None]
    return dx.to(torch.float32), dl.to(torch.float32)


def _lm_step_vi(cam, bf, T_cb, prob: VIBAProblem, R_wb, p_wb, v_w, bias, xw, inlier, lam, cg_iters: int,
                reduce_k=_identity, reduce_m=_identity, reduce_s=_identity):
    """One LM step: (R, p, v, bias, xw, lam) after it and the cost before it.
    On observation shards (``reduce_*`` the JAX package's hooks) the visual
    blocks and costs are the shard's partial sums, reduced by ``reduce_s``;
    the chain is replicated and not reduced."""
    Hpp, Hll, bp, bl, Wob, w_lm, vcost = _visual_blocks_cg(cam, bf, T_cb, R_wb, p_wb, xw, prob, inlier)
    Hpp, Hll, bp, bl, w_lm, vcost = (reduce_s(x) for x in (Hpp, Hll, bp, bl, w_lm, vcost))
    Hii, Hjj, Hij, g_chain, icost = _inertial_edge_blocks(prob, R_wb, p_wb, v_w, bias)
    dx, dl = _implicit_vi_solve(Hpp, Hll, bp, bl, Wob, Hii, Hjj, Hij, g_chain, prob.obs_kf, prob.obs_lm, prob.edge_i,
                                prob.edge_j, w_lm, prob.state_fixed, prob.lm_valid, lam, cg_iters, reduce_k=reduce_k,
                                reduce_m=reduce_m)
    R_new = R_wb @ lie.so3_exp(dx[:, 0:3])
    p_new = p_wb + torch.einsum("kij,kj->ki", R_wb, dx[:, 3:6])
    v_new, b_new, xw_new = v_w + dx[:, 6:9], bias + dx[:, 9:15], xw + dl
    cost_new = reduce_s(_visual_cost(cam, bf, T_cb, R_new, p_new, xw_new, prob, inlier)) + \
        _inertial_cost(prob, R_new, p_new, v_new, b_new)
    accept = cost_new < vcost + icost
    pick = [torch.where(accept, a, c) for a, c in ((R_new, R_wb), (p_new, p_wb), (v_new, v_w), (b_new, bias),
                                                    (xw_new, xw))]
    lam = torch.where(accept, torch.clamp(lam * 0.5, min=1e-8), torch.clamp(lam * 5.0, max=1e6))
    return (*pick, lam, vcost + icost)


def lm_segment_vi_plain(cam, bf, T_cb, prob: VIBAProblem, R_wb, p_wb, v_w, bias, xw, inlier, lam, n_iters: int = 2,
                        cg_iters: int = 32):
    """Plain version of kernel AA: ``n_iters`` LM steps.  Returns (R_wb,
    p_wb, v_w, bias, xw, lam, the last step's cost before it)."""
    lam = torch.as_tensor(lam, dtype=torch.float32, device=xw.device)
    cost = torch.zeros((), dtype=torch.float32, device=xw.device)
    for _ in range(n_iters):
        R_wb, p_wb, v_w, bias, xw, lam, cost = _lm_step_vi(cam, bf, T_cb, prob, R_wb, p_wb, v_w, bias, xw, inlier, lam,
                                                           cg_iters)
    return R_wb, p_wb, v_w, bias, xw, lam, cost


def classify_vi_plain(cam, bf, T_cb, prob: VIBAProblem, R_wb, p_wb, xw):
    """The chi2 inlier gate of the reprojection factors at the state."""
    return vb._classify(cam, bf, T_cb, R_wb, p_wb, xw, prob)


def lm_segment_vi(cam, bf, T_cb, prob: VIBAProblem, R_wb, p_wb, v_w, bias, xw, inlier, lam, n_iters: int = 2,
                  cg_iters: int = 32):
    """``n_iters`` LM steps of FullInertialBA: kernel AA on CUDA tensors, one
    launch with no host read inside; the plain version on CPU ones.
    Returns (R_wb, p_wb, v_w, bias, xw, lam, cost) with ``lam`` and
    ``cost`` () tensors on the device."""
    if xw.device.type == "cpu":
        return lm_segment_vi_plain(cam, bf, T_cb, prob, R_wb, p_wb, v_w, bias, xw, inlier, lam, n_iters, cg_iters)
    return _kernel(cam, bf, T_cb, prob, (R_wb, p_wb, v_w, bias), xw, inlier, lam, n_iters, cg_iters)


def classify_vi(cam, bf, T_cb, prob: VIBAProblem, R_wb, p_wb, xw):
    """classify_vi: kernel AA's classification entry on CUDA tensors, the
    plain version on CPU ones.  Returns the (O,) inlier mask."""
    if xw.device.type == "cpu":
        return classify_vi_plain(cam, bf, T_cb, prob, R_wb, p_wb, xw)
    return _kernel(cam, bf, T_cb, prob, (R_wb, p_wb, None, None), xw, None, None, 0, 0)


def full_inertial_ba_cg(cam, bf, T_cb: lie.SE3, prob: VIBAProblem, iters1: int = 5, iters2: int = 8,
                        cg_iters: int = 40, seg: int = 2, abort_flag=None):
    """The two-phase robust FullInertialBA, host-segmented (``seg`` LM
    iterations a segment) so that ``abort_flag`` lands between segments,
    through kernel AA on CUDA tensors.  Returns (R_wb, p_wb, v_w, bias, xw,
    obs_inlier, aborted); an aborted solve returns its current state,
    which the caller discards (LoopClosing.cc:2412-2422)."""
    return _two_phase(lm_segment_vi, classify_vi, cam, bf, T_cb, prob, iters1, iters2, cg_iters, seg, abort_flag)


def full_inertial_ba_cg_plain(cam, bf, T_cb: lie.SE3, prob: VIBAProblem, iters1: int = 5, iters2: int = 8,
                              cg_iters: int = 40, seg: int = 2, abort_flag=None):
    """``full_inertial_ba_cg`` through the plain versions on any device."""
    return _two_phase(lm_segment_vi_plain, classify_vi_plain, cam, bf, T_cb, prob, iters1, iters2, cg_iters, seg,
                      abort_flag)


def _two_phase(segment, classify, cam, bf, T_cb, prob: VIBAProblem, iters1, iters2, cg_iters, seg, abort_flag):
    xw = prob.xw
    inlier = torch.ones(prob.obs_uv.shape[0], dtype=torch.bool, device=xw.device)

    def run_phase(state, inlier, total):
        lam = torch.tensor(1e-4, dtype=torch.float32, device=xw.device)
        done = 0
        while done < total:
            n = min(seg, total - done)
            *state, lam, _ = segment(cam, bf, T_cb, prob, *state, inlier, lam, n_iters=n, cg_iters=cg_iters)
            done += n
            if abort_flag is not None and abort_flag.is_set():
                return state, True
        return state, False

    state, aborted = run_phase([prob.R_wb, prob.p_wb, prob.v_w, prob.bias, xw], inlier, iters1)
    if aborted:
        return (*state, inlier, True)
    inlier = classify(cam, bf, T_cb, prob, state[0], state[1], state[4])
    state, aborted = run_phase(state, inlier, iters2)
    inlier = classify(cam, bf, T_cb, prob, state[0], state[1], state[4])
    return (*state, inlier, aborted)


def vi_pcg_scratch_doubles(K: int, M: int, O: int, E: int) -> int:
    """Doubles of kernel AA's scratch (csrc/vi_pcg.cu): 68 per observation
    (kernel Y's), 31 per landmark (Hll, bl, V^-1, w_lm, y, the position
    and the candidate's), 1932 per edge (Jacobian, its weighted copy,
    residual, informations, the 30x30 block), 423 per state (gradient,
    damping, the CG vectors x, r, z, p, Ap, the step, Hpp, the
    block-Jacobi inverse, the current and candidate states) and 16 more."""
    return O * 68 + M * 31 + E * 1932 + K * 423 + 16


def _kernel(cam, bf, T_cb, prob: VIBAProblem, state, xw, inlier, lam, n_iters: int, cg_iters: int, info=None):
    """Kernel AA: ``n_iters`` > 0 LM steps from ``state`` (R, p, v, bias) and
    ``xw``, or with ``n_iters`` = 0 the classification at (R, p, xw).  A
    dict ``info`` receives the CG iterations the segment ran (a host read)."""
    f32, i32, b8 = torch.float32, torch.int32, torch.bool
    dev = xw.device
    cam10, kind = kernel_camera(cam, bf, "kernel AA")
    K, M, O, E = prob.R_wb.shape[0], xw.shape[0], prob.obs_kf.shape[0], prob.edge_i.shape[0]
    classify = n_iters == 0
    R, p, v, b = state
    if classify:
        v, b = prob.v_w, prob.bias
    c = {name: getattr(prob, name).contiguous() for name in VIBAProblem._fields if name != "preint"}
    for name in ("obs_kf", "obs_lm", "edge_i", "edge_j"):
        c[name] = c[name].to(i32)
    R, p, v, b, xw = (x.to(f32).contiguous() for x in (R, p, v, b, xw))
    inl = (torch.ones(O, dtype=b8, device=dev) if inlier is None else inlier).contiguous()
    types = dict(state_fixed=b8, lm_valid=b8, obs_kf=i32, obs_lm=i32, obs_uv=f32, obs_inv_sigma2=f32,
                 obs_is_stereo=b8, obs_valid=b8, edge_i=i32, edge_j=i32, edge_valid=b8)
    _kernels.require_cuda("lm_segment_vi", R_wb=(R, f32), p_wb=(p, f32), v_w=(v, f32), bias=(b, f32), xw=(xw, f32),
                          inlier=(inl, b8), **{k: (c[k], t) for k, t in types.items()})
    lam_io = torch.zeros(3, dtype=f32, device=dev)  # lam in, then lam | cost | CG iterations run out
    lam_io[0] = 1e-4 if lam is None else lam
    tcb = torch.cat([T_cb.R.reshape(9), T_cb.t]).to(device=dev, dtype=f32).contiguous()
    if classify:
        lm_ptr = lm_obs = kf_ptr = kf_obs = ke_ptr = ke_edge = pk = inl
        scratch = torch.empty(1, dtype=torch.float64, device=dev)
    else:
        lm_ptr, lm_obs = vb._csr(c["obs_lm"], None, M, c["obs_valid"])
        kf_ptr, kf_obs = vb._csr(c["obs_kf"], c["obs_lm"], K, c["obs_valid"])
        ke_ptr, ke_edge = vb._state_edges(c["edge_i"], c["edge_j"], c["edge_valid"], K)
        pk = pre.pack(prob.preint.to(dev))
        scratch = torch.empty(vi_pcg_scratch_doubles(K, M, O, E), dtype=torch.float64, device=dev)
    state_out = torch.empty((K, 21), dtype=f32, device=dev)
    xw_out = torch.empty((M, 3), dtype=f32, device=dev)
    inlier_out = torch.empty(O, dtype=b8, device=dev)
    _kernels.launch(
        "vi_pcg_launch", dev, cam10.to(dev).data_ptr(), kind, tcb.data_ptr(), K, M, O, E, R.data_ptr(),
        p.data_ptr(), v.data_ptr(), b.data_ptr(), c["state_fixed"].data_ptr(), xw.data_ptr(),
        c["lm_valid"].data_ptr(), c["obs_kf"].data_ptr(), c["obs_lm"].data_ptr(), c["obs_uv"].data_ptr(),
        c["obs_inv_sigma2"].data_ptr(), c["obs_is_stereo"].data_ptr(), c["obs_valid"].data_ptr(),
        c["edge_i"].data_ptr(), c["edge_j"].data_ptr(), c["edge_valid"].data_ptr(), pk.data_ptr(), lm_ptr.data_ptr(),
        lm_obs.data_ptr(), kf_ptr.data_ptr(), kf_obs.data_ptr(), ke_ptr.data_ptr(), ke_edge.data_ptr(),
        inl.data_ptr(), n_iters, cg_iters, scratch.data_ptr(), lam_io.data_ptr(), state_out.data_ptr(),
        xw_out.data_ptr(), inlier_out.data_ptr(),
    )
    lm_segment_vi.launches.add("classify" if classify else "segment", camera=CAMERA_NAMES[kind])
    if classify:
        return inlier_out
    if info is not None:
        info["cg_run"] = int(lam_io[2])
    s = inr.unpack_state(state_out)
    return s.R, s.p, s.v, s.bias, xw_out, lam_io[0], lam_io[1]


lm_segment_vi.launches = _kernels.LaunchCounter()  # kernel AA, by mode ("segment", "classify") and camera instance
classify_vi.launches = lm_segment_vi.launches
