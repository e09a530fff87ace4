"""Global bundle adjustment: Levenberg-Marquardt with the reduced camera
system solved by block-Jacobi preconditioned conjugate gradients, applied
implicitly (never formed).

Counterpart of ``orb_slam3_fast_tpu/optim/ba_cg.py``
(Optimizer::GlobalBundleAdjustemnt, Optimizer.cc:47-373, over every
keyframe, landmark and observation): S = Hpp - W V^-1 W^T is applied as an
operator over the per-observation coupling W_o (O,6,3), so memory stays
O(K + M + O).  The LM schedule is the reference's (a robust phase, chi2
reclassification, a second phase), host-segmented so that an abort flag
can land between segments (LoopClosing.cc:1072-1086, mbStopGBA).

``build_blocks`` is kernel E (``optim/ba.build_normal_blocks``: its
per-observation W is exactly what this solver needs) and its plain
version; ``implicit_schur_solve`` runs kernel T (``csrc/ba_pcg.cu``) on
CUDA tensors and its plain version on CPU ones.  The LM loop around them is
plain PyTorch, as it is for local BA (ROADMAP §B queue 3).

Kernel T -- source note.
  Replaces: ``implicit_schur_solve`` (``orb_slam3_fast_tpu/optim/
  ba_cg.py:81``, K21): per CG iteration two gathers, two (O,6,3) einsums
  and two scatter-adds, and the vector updates, 32 iterations in a
  ``lax.scan``.
  Bound on the card: latency.  Per CG iteration it reads the O x 18 W
  (2.2 MB at O = 30k in float32) twice and does ~80 flops per
  observation; 32 dependent iterations of three launches.
  Design: 3 + 3 x cg_iters + 1 launches from one C entry point.  Setup:
  one thread per landmark damps Hll (lam * max(diag, 1e-3)), inverts it in
  float64 (the identity where no weight reached it) and forms V^-1 bl; one
  CTA per pose sums, over that pose's observations in the pose CSR's order,
  W_o V^-1 W_o^T (the block-Jacobi preconditioner D = Hpp_d - ...) and
  W_o V^-1 bl, reduces the threads in a fixed order, inverts D + 1e-5 I in
  float64 and starts x = 0, r = b_s, z = p = D^-1 r; one CTA forms r.z.
  Each CG iteration: (1) one thread per landmark: y = V^-1 sum W_o^T p over
  the landmark CSR; (2) one CTA per pose: (S p)_k = Hpp_d p_k - sum W_o y
  over the pose CSR, and p_k.(S p)_k; (3) one CTA: p.Sp, alpha, x, r, z =
  D^-1 r, r.z, beta, p, with the freeze of the reference (alpha = beta = 0
  once r.z <= 1e-12).  Last, one thread per landmark back-substitutes
  dl = V^-1 (bl - sum W_o^T dp).  The vectors are float64 and every sum
  has a fixed order, so a run repeats bit for bit.
"""
from __future__ import annotations

import torch

from orb_slam3_fast_tpu_torch import _kernels
from orb_slam3_fast_tpu_torch.optim import ba as ba_mod
from orb_slam3_fast_tpu_torch.optim.ba import BAProblem


def build_blocks(cam, bf, R, t, xw, prob: BAProblem, inlier):
    """Normal-equation pieces without the dense Z: (Hpp (K,6,6), Hll
    (M,3,3), bp (K,6), bl (M,3), W (O,6,3), w_lm (M,), cost ()).  Kernel E
    on CUDA tensors, its plain version on CPU ones."""
    if R.device.type == "cpu":
        return ba_mod.build_normal_blocks_plain(cam, bf, R, t, xw, prob, inlier, per_obs=True)
    return ba_mod.build_normal_blocks(cam, bf, R, t, xw, prob, inlier)


def _damp(H: torch.Tensor, lam: torch.Tensor) -> torch.Tensor:
    d = torch.diagonal(H, dim1=-2, dim2=-1)
    return H + torch.diag_embed(lam * torch.clamp(d, min=1e-3))


def implicit_schur_solve_plain(Hpp, Hll, bp, bl, W, obs_kf, obs_lm, w_lm, pose_fixed, lm_valid, lam,
                               cg_iters: int = 32):
    """Plain version of kernel T, in float64 as the kernel solves: PCG on the
    reduced camera system applied implicitly.  Returns (dp (K,6), dl (M,3))
    in float32."""
    f64 = torch.float64
    K, M = Hpp.shape[0], Hll.shape[0]
    dev = Hpp.device
    kf, lm = obs_kf.long(), obs_lm.long()
    Hpp, Hll, bp, bl, W, lam = Hpp.to(f64), Hll.to(f64), bp.to(f64), bl.to(f64), W.to(f64), lam.to(f64)
    eye3, eye6 = torch.eye(3, dtype=f64, device=dev), torch.eye(6, dtype=f64, device=dev)
    Hpp_d = _damp(Hpp, lam)
    lm_seen = w_lm > 0
    Vinv = torch.linalg.inv(torch.where(lm_seen[:, None, None], _damp(Hll, lam), eye3))
    free_f = (~pose_fixed).to(f64)

    def Zt_v(v):  # (K,6) -> (M,3)
        return torch.zeros((M, 3), dtype=f64, device=dev).index_add_(0, lm, torch.einsum("oab,oa->ob", W, v[kf]))

    def Z_y(y):  # (M,3) -> (K,6)
        return torch.zeros((K, 6), dtype=f64, device=dev).index_add_(0, kf, torch.einsum("oab,ob->oa", W, y[lm]))

    def S_mv(v):
        v = v * free_f[:, None]
        y = torch.einsum("mab,mb->ma", Vinv, Zt_v(v))
        return (torch.einsum("kab,kb->ka", Hpp_d, v) - Z_y(y)) * free_f[:, None]

    b_s = (bp - Z_y(torch.einsum("mab,mb->ma", Vinv, bl))) * free_f[:, None]
    coup = torch.einsum("oab,obc,odc->oad", W, Vinv[lm], W)
    D = Hpp_d - torch.zeros((K, 6, 6), dtype=f64, device=dev).index_add_(0, kf, coup)
    D = torch.where(pose_fixed[:, None, None], eye6, D)
    Dinv = torch.linalg.inv(D + 1e-5 * eye6)

    def precond(r):
        return torch.einsum("kab,kb->ka", Dinv, r) * free_f[:, None]

    x = torch.zeros_like(b_s)
    r = b_s
    z = precond(r)
    p = z
    rz = torch.sum(r * z)
    zero = torch.zeros((), dtype=f64, device=dev)
    for _ in range(cg_iters):
        Ap = S_mv(p)
        pAp = torch.sum(p * Ap)
        ok = rz > 1e-12  # freeze once converged, so that further iterations change nothing
        alpha = torch.where(ok, rz / torch.clamp(pAp, min=1e-20), zero)
        x = x + alpha * p
        r = r - alpha * Ap
        z = precond(r)
        rz_new = torch.sum(r * z)
        beta = torch.where(ok, rz_new / torch.clamp(rz, min=1e-20), zero)
        p = z + beta * p
        rz = rz_new
    dp = x * free_f[:, None]
    dl = torch.einsum("mab,mb->ma", Vinv, bl - Zt_v(dp)) * (lm_seen & lm_valid)[:, None]
    return dp.to(torch.float32), dl.to(torch.float32)


def implicit_schur_solve(Hpp, Hll, bp, bl, W, prob: BAProblem, w_lm, lam, cg_iters: int = 32):
    """PCG on the reduced camera system, applied implicitly; ``W`` the
    per-observation coupling (O,6,3), ``lam`` a () float32 tensor.  Returns
    (dp (K,6), dl (M,3)).  Kernel T on CUDA tensors, its plain version on
    CPU ones."""
    if Hpp.device.type == "cpu":
        return implicit_schur_solve_plain(Hpp, Hll, bp, bl, W, prob.obs_kf, prob.obs_lm, w_lm, prob.pose_fixed,
                                          prob.lm_valid, lam, cg_iters)
    f32, i32, b = torch.float32, torch.int32, torch.bool
    lam = lam.to(f32).reshape(()).contiguous()
    _kernels.require_cuda(
        "implicit_schur_solve", Hpp=(Hpp, f32), Hll=(Hll, f32), bp=(bp, f32), bl=(bl, f32), W=(W, f32),
        w_lm=(w_lm, f32), pose_fixed=(prob.pose_fixed, b), lm_valid=(prob.lm_valid, b), obs_kf=(prob.obs_kf, i32),
        obs_lm=(prob.obs_lm, i32), lm_ptr=(prob.lm_ptr, i32), lm_obs=(prob.lm_obs, i32), kf_ptr=(prob.kf_ptr, i32),
        kf_obs=(prob.kf_obs, i32), lam=(lam, f32),
    )
    K, M, O = Hpp.shape[0], Hll.shape[0], W.shape[0]
    if W.shape != (O, 6, 3) or prob.lm_ptr.shape != (M + 1,) or prob.kf_ptr.shape != (K + 1,):
        raise ValueError("implicit_schur_solve: needs the per-observation W (O,6,3) and both CSR offsets")
    dev = Hpp.device
    scratch = torch.empty(12 * M + 102 * K + 8, dtype=torch.float64, device=dev)
    dp = torch.empty((K, 6), dtype=f32, device=dev)
    dl = torch.empty((M, 3), dtype=f32, device=dev)
    _kernels.launch(
        "ba_pcg_launch", dev, Hpp.data_ptr(), Hll.data_ptr(), bp.data_ptr(), bl.data_ptr(), W.data_ptr(),
        w_lm.data_ptr(), prob.pose_fixed.data_ptr(), prob.lm_valid.data_ptr(), prob.obs_kf.data_ptr(),
        prob.obs_lm.data_ptr(), prob.lm_ptr.data_ptr(), prob.lm_obs.data_ptr(), prob.kf_ptr.data_ptr(),
        prob.kf_obs.data_ptr(), lam.data_ptr(), K, M, O, cg_iters, scratch.data_ptr(), dp.data_ptr(), dl.data_ptr(),
    )
    implicit_schur_solve.launches.add()
    return dp, dl


implicit_schur_solve.launches = _kernels.LaunchCounter()


def _lm_step(cam, bf, prob: BAProblem, R, t, xw, inlier, lam, cg_iters: int, blocks, solve):
    """One damped LM iteration, accepted when the robust cost drops; the
    decision stays on the device."""
    Hpp, Hll, bp, bl, W, w_lm, cost = blocks(cam, bf, R, t, xw, prob, inlier)
    dp, dl = solve(Hpp, Hll, bp, bl, W, prob, w_lm, lam, cg_iters)
    R_new, t_new, xw_new = ba_mod.apply_update(R, t, xw, dp, dl)
    r_new, _, posd_new = ba_mod._obs_residuals(cam, bf, R_new, t_new, xw_new, prob)
    cost_new, _ = ba_mod._robust_cost(r_new, prob, ba_mod._active(prob, inlier, posd_new))
    accept = cost_new < cost
    R, t, xw = torch.where(accept, R_new, R), torch.where(accept, t_new, t), torch.where(accept, xw_new, xw)
    lam = torch.where(accept, torch.clamp(lam * 0.5, min=1e-8), torch.clamp(lam * 5.0, max=1e6))
    return R, t, xw, lam, cost


def _solve_plain(Hpp, Hll, bp, bl, W, prob: BAProblem, w_lm, lam, cg_iters):
    return implicit_schur_solve_plain(Hpp, Hll, bp, bl, W, prob.obs_kf, prob.obs_lm, w_lm, prob.pose_fixed,
                                      prob.lm_valid, lam, cg_iters)


def _blocks_plain(cam, bf, R, t, xw, prob, inlier):
    return ba_mod.build_normal_blocks_plain(cam, bf, R, t, xw, prob, inlier, per_obs=True)


def lm_segment(cam, bf, prob: BAProblem, R, t, xw, inlier, lam, n_iters: int = 2, cg_iters: int = 32,
               blocks=build_blocks, solve=implicit_schur_solve):
    """``n_iters`` LM iterations; the host checks the abort flag between
    segments.  Returns (R, t, xw, lam, last cost)."""
    cost = None
    for _ in range(n_iters):
        R, t, xw, lam, cost = _lm_step(cam, bf, prob, R, t, xw, inlier, lam, cg_iters, blocks, solve)
    return R, t, xw, lam, cost


def classify(cam, bf, prob: BAProblem, R, t, xw):
    """The chi2 inlier gate (Optimizer.cc:1347-1365)."""
    r, _, posd = ba_mod._obs_residuals(cam, bf, R, t, xw, prob)
    chi2 = torch.sum(r * r, dim=-1) * prob.obs_inv_sigma2
    return (chi2 <= ba_mod._delta2(prob)) & posd & prob.obs_valid


def _bundle_adjust_cg(cam, bf, prob: BAProblem, iters1: int, iters2: int, cg_iters: int, seg: int, abort_flag,
                      blocks, solve):
    R, t, xw = prob.R, prob.t, prob.xw
    inlier = torch.ones_like(prob.obs_valid)

    def run_phase(R, t, xw, inlier, total):
        lam = torch.tensor(1e-4, dtype=torch.float32, device=R.device)
        done = 0
        while done < total:
            n = min(seg, total - done)
            R, t, xw, lam, _ = lm_segment(cam, bf, prob, R, t, xw, inlier, lam, n, cg_iters, blocks, solve)
            done += n
            if abort_flag is not None and abort_flag.is_set():
                return R, t, xw, True
        return R, t, xw, False

    R, t, xw, aborted = run_phase(R, t, xw, inlier, iters1)
    if aborted:
        return R, t, xw, inlier, True
    inlier = classify(cam, bf, prob, R, t, xw)
    R, t, xw, aborted = run_phase(R, t, xw, inlier, iters2)
    return R, t, xw, classify(cam, bf, prob, R, t, xw), aborted


def bundle_adjust_cg(cam, bf, prob: BAProblem, iters1: int = 5, iters2: int = 10, cg_iters: int = 32, seg: int = 5,
                     abort_flag=None):
    """Two-phase robust BA through kernels E and T (their plain versions on
    the CPU), in segments of ``seg`` LM iterations; ``abort_flag``
    (anything with ``is_set()``) is polled between segments.  Returns (R,
    t, xw, inlier, aborted); an aborted solve returns its state as it
    stands (the reference discards it, LoopClosing.cc:2412-2422)."""
    return _bundle_adjust_cg(cam, bf, prob, iters1, iters2, cg_iters, seg, abort_flag, build_blocks,
                             implicit_schur_solve)


def bundle_adjust_cg_plain(cam, bf, prob: BAProblem, iters1: int = 5, iters2: int = 10, cg_iters: int = 32,
                           seg: int = 5, abort_flag=None):
    """The same schedule through the plain versions on any device."""
    return _bundle_adjust_cg(cam, bf, prob, iters1, iters2, cg_iters, seg, abort_flag, _blocks_plain, _solve_plain)
