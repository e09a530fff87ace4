"""Bundle adjustment: batched Levenberg-Marquardt with the pose-landmark
Schur complement.

Counterpart of ``orb_slam3_fast_tpu/optim/ba.py`` (LocalBundleAdjustment,
Optimizer.cc:1109-1516): a fixed-shape observation table, Huber-weighted
mono / stereo reprojection edges, the reduced camera system solved dense and
the landmarks back-substituted.  The schedule is the reference's: ``iters1``
LM iterations, chi2 reclassification of the observations (5.991 / 7.815),
``iters2`` more, and a final classification.  An LM step is accepted when
the robust cost drops (``cost_new < cost_old``); the decision and the
damping update stay on the device, with no host read per iteration.  On
the card an iteration is kernels E -> F -> AC on the caller's stream and
launches no other operation.

``build_normal_blocks`` and ``schur_solve`` are the wrappers of kernels E
(``csrc/ba_blocks.cu``) and F (``csrc/ba_schur.cu``).  Their plain versions
are the JAX code as it stands, and the coupling between poses and landmarks
differs between the two forms:
  * plain: the dense ``Z`` (M,K,6,3), ``Z[m,k] = sum of W_o`` over the
    observations of landmark m from keyframe k;
  * kernel: the per-observation ``W_o = Jp^T w Jl`` (O,6,3), never
    scattered into ``Z`` (9.4 MB at M=4096, K=32, almost all zeros).
So ``build_normal_blocks`` returns ``Z`` for CPU tensors and ``W`` for CUDA
ones, ``schur_solve`` takes what the matching call returned, and
``coupling_to_dense`` turns either into ``Z``.  ``schur_solve`` also returns
whether the solve succeeded; an LM step whose solve failed is rejected like
one that raised the cost.

Kernel E -- source note.
  Replaces: ``build_normal_blocks`` (``orb_slam3_fast_tpu/optim/ba.py:72``,
  K12): residuals, ``jax.jacfwd`` projection Jacobians, and segment sums
  into Hpp, Hll, bp, bl and the dense Z.
  Bound on the card: atomics.  One thread per observation does ~400 flops
  and ~70 float64 ``atomicAdd``s into K * 42 + M * 13 sums; the observation
  table (O = 16384) is 1 MB.
  Design: closed-form stereo pin-hole Jacobian (as kernel D), ``Jp`` zeroed
  for fixed poses, ``W_o`` written per observation, the cost reduced per
  warp before one atomic.  The sums are float64, rounded to float32 by a
  second launch, so that their order does not reach the result and a run
  on the card repeats exactly; float32 atomics would round each run
  differently, and a System's runs would drift apart (3.3e-3 m over 30
  frames of the stereo corridor, PERF.md).  A pin-hole camera with
  radial-tangential distortion takes a second instance of the kernel, with
  the distortion's closed-form Jacobian (``csrc/camera.cuh``), and a
  Kannala-Brandt (KB8) camera a third, with the KB8 projection and its
  closed-form Jacobian; kernels F and T take their blocks from either. One
  without distortion runs the instructions it always ran.

Kernel F -- source note.
  Replaces: ``schur_solve`` (``orb_slam3_fast_tpu/optim/ba.py:108``, K12):
  landmark inverses, ``S_coup`` as a dense einsum over every (m, k, j)
  (about 4.5e8 multiply-adds at M=4096, K=32, nearly all on zeros) and an
  LU solve of the (6K)^2 system.
  Bound on the card: latency.  The reduction does ~100 flops per pair of
  observations of one landmark (~16 pairs per landmark here); the solve is
  a 192 x 192 Cholesky, ~1.2 Mflop with 192 dependent steps.
  Design: three launches.  (1) One CTA per pair of free poses (ki >= kj)
  strides its threads over the landmarks (observations grouped by landmark
  through the CSR offsets ``lm_ptr`` / ``lm_obs``, built on the host at
  gather time); where a landmark is seen from both poses it inverts the
  damped 3x3 block in float64 and subtracts ``W_i V^-1 W_j^T`` for each
  such pair of its observations, and on the diagonal ``W_i V^-1 bl``; a
  shuffle tree and the warps in turn sum the threads into block (ki, kj)
  of S and b_s.  The order of every sum is fixed, so a run repeats bit for
  bit (float64 atomics, in whatever order they land, move S by ~1e-16,
  which an ill-conditioned S can carry into the last bit of dp).  (2) One CTA of 1024 threads adds the damped pose blocks,
  the gauge handling and ``1e-6 I`` as the reference does, factors the
  packed lower triangle in float64 shared memory (148 KB at 6K = 192) and
  solves by two warp-parallel substitutions.  (3) One thread per landmark
  back-substitutes ``dl = V^-1 (bl - sum W_o^T dp)``.  The damping ``lam``
  is read from device memory.  6K <= 192 (K <= 32 padded poses).  A
  Cholesky pivot <= 0 clears a byte in device memory and zeroes dp and
  dl; the wrapper returns the byte as ``ok``, which kernel AC folds into
  its accept with no host read.  The entry zeroes its own sums.  Where the
  reduced system is indefinite but not singular, the reference's LU solve
  still gives a step; F rejects it.

Kernel AC -- source note.
  Replaces: the rest of the LM iteration of ``bundle_adjust``
  (``orb_slam3_fast_tpu/optim/ba.py:151-203``, K12: ``apply_update``, the
  residuals and robust cost at the candidate, the accept and the damping
  under ``jnp.where``, and the chi2 reclassification) and of the global
  BA's ``lm_segment`` and ``classify`` (``orb_slam3_fast_tpu/optim/
  ba_cg.py:190, 205``, K21), which the JAX package compiles into the same
  XLA programs as E's and F's (T's) work.  ``lm_update`` and ``classify``
  are its two entries; ``lm_update_plain`` and ``classify_plain`` the JAX
  code in PyTorch.
  Bound on the card: launch latency.  An update reads the observation
  table and the state (~0.6 MB at the mapper's caps, ~0.2 us at the HBM
  rate) and does ~100 flops per observation.
  Design: three launches on the caller's stream: (1) one thread per pose
  forms exp(dp) T in float32 (``lie.se3_exp``'s branches), one per
  landmark xw + dl, into the outputs; (2) one thread per observation, the
  residual and Huber cost of ``csrc/ba_obs.cuh`` at the candidate, kernel
  E's code (the products E's Jacobian reuses, which the compiler leaves
  unfused there, pinned unfused here), reduced as E reduces its cost (a
  warp shuffle, float64 atomics, rounded to float32), so that at one state
  the two costs are the same bits and a zero step is rejected; (3) accept =
  ok & (cost_new < cost_old), the damping halved or multiplied by 5, and
  the old state copied back where the step is rejected.  ``ok`` is kernel
  F's byte; T has none.  The classification is one launch, one thread per
  observation.  The camera's kind is a template parameter, as for E.
"""
from __future__ import annotations

import threading
from typing import NamedTuple

import numpy as np
import torch

from orb_slam3_fast_tpu_torch import _kernels
from orb_slam3_fast_tpu_torch.cameras import models as cam_models
from orb_slam3_fast_tpu_torch.optim.pose_opt import CAMERA_NAMES, CHI2_MONO, CHI2_STEREO, _huber_weight, kernel_camera
from orb_slam3_fast_tpu_torch.utils import lie

MAX_POSES = 32  # kernel F's shared-memory bound: 6K <= 192


class BAProblem(NamedTuple):
    R: torch.Tensor  # (K,3,3) T_cw rotations
    t: torch.Tensor  # (K,3)
    pose_fixed: torch.Tensor  # (K,) bool gauge / boundary poses
    xw: torch.Tensor  # (M,3) landmarks
    lm_valid: torch.Tensor  # (M,) bool
    obs_kf: torch.Tensor  # (O,) int32
    obs_lm: torch.Tensor  # (O,) int32
    obs_uv: torch.Tensor  # (O,3) [u, v, u_r], u_r = -1 for mono
    obs_inv_sigma2: torch.Tensor  # (O,)
    obs_is_stereo: torch.Tensor  # (O,) bool
    obs_valid: torch.Tensor  # (O,) bool
    lm_ptr: torch.Tensor  # (M+1,) int32 CSR offsets of the valid observations by landmark
    lm_obs: torch.Tensor  # (O,) int32 observation ids in landmark order
    kf_ptr: torch.Tensor  # (K+1,) int32 CSR offsets of the valid observations by pose
    kf_obs: torch.Tensor  # (O,) int32 observation ids in pose order


def landmark_csr(obs_lm: np.ndarray, obs_valid: np.ndarray, n_lm: int):
    """CSR grouping of the valid observations by landmark (or by pose, given
    ``obs_kf`` and K): (ptr (n+1,), ids (O,)), both int32, each group in
    observation order; the invalid observations trail unreferenced."""
    obs_lm = np.asarray(obs_lm)
    key = np.where(np.asarray(obs_valid), obs_lm, n_lm)
    order = np.argsort(key, kind="stable").astype(np.int32)
    ptr = np.searchsorted(key[order], np.arange(n_lm + 1), side="left").astype(np.int32)
    return ptr, order


def make_problem(R, t, pose_fixed, xw, lm_valid, obs_kf, obs_lm, obs_uv, obs_inv_sigma2, obs_is_stereo, obs_valid,
                 device) -> BAProblem:
    """A BAProblem on ``device`` from numpy arrays in the JAX package's
    layout, with the landmark and pose CSR built here."""
    lm_ptr, lm_obs = landmark_csr(obs_lm, obs_valid, len(xw))
    kf_ptr, kf_obs = landmark_csr(obs_kf, obs_valid, len(R))

    def dev(a, dtype):
        return torch.as_tensor(np.asarray(a), dtype=dtype).to(device)

    f32, i32, b = torch.float32, torch.int32, torch.bool
    return BAProblem(
        R=dev(R, f32), t=dev(t, f32), pose_fixed=dev(pose_fixed, b), xw=dev(xw, f32), lm_valid=dev(lm_valid, b),
        obs_kf=dev(obs_kf, i32), obs_lm=dev(obs_lm, i32), obs_uv=dev(obs_uv, f32),
        obs_inv_sigma2=dev(obs_inv_sigma2, f32), obs_is_stereo=dev(obs_is_stereo, b), obs_valid=dev(obs_valid, b),
        lm_ptr=dev(lm_ptr, i32), lm_obs=dev(lm_obs, i32), kf_ptr=dev(kf_ptr, i32), kf_obs=dev(kf_obs, i32),
    )


def _obs_residuals(cam, bf, R, t, xw, prob: BAProblem):
    """(O,3) residuals (zero u_r residual on mono edges), camera-frame
    points, and the positive-depth mask."""
    kf, lm = prob.obs_kf.long(), prob.obs_lm.long()
    xc = torch.einsum("oij,oj->oi", R[kf], xw[lm]) + t[kf]
    r = prob.obs_uv - cam_models.stereo_project(cam, xc, bf)
    r = torch.cat([r[:, :2], torch.where(prob.obs_is_stereo, r[:, 2], torch.zeros_like(r[:, 2]))[:, None]], 1)
    return r, xc, xc[:, 2] > 0.05


def _delta2(prob: BAProblem) -> torch.Tensor:
    return torch.where(
        prob.obs_is_stereo,
        torch.full_like(prob.obs_inv_sigma2, CHI2_STEREO),
        torch.full_like(prob.obs_inv_sigma2, CHI2_MONO),
    )


def _robust_rho(r, prob: BAProblem, active):
    """Huber rho(chi2) per observation, zero where not active, and chi2."""
    chi2 = torch.sum(r * r, dim=-1) * prob.obs_inv_sigma2
    delta2 = _delta2(prob)
    rho = torch.where(chi2 <= delta2, chi2, 2.0 * torch.sqrt(delta2 * torch.clamp(chi2, min=1e-12)) - delta2)
    return torch.where(active, rho, torch.zeros_like(rho)), chi2


def _robust_cost(r, prob: BAProblem, active):
    """Huber rho(chi2) summed over the active observations, and chi2."""
    rho, chi2 = _robust_rho(r, prob, active)
    return torch.sum(rho), chi2


def _active(prob: BAProblem, inlier, posd):
    return prob.obs_valid & inlier & posd & prob.lm_valid[prob.obs_lm.long()]


def obs_terms_plain(cam, bf, R, t, xw, prob: BAProblem, inlier):
    """Each observation's share of the normal equations: (Hpp_o (O,6,6),
    Hll_o (O,3,3), bp_o (O,6), bl_o (O,3), W_o (O,6,3), w (O,), rho (O,)),
    zero where the observation is not active."""
    kf = prob.obs_kf.long()
    r, xc, posd = _obs_residuals(cam, bf, R, t, xw, prob)
    active = _active(prob, inlier, posd)
    chi2 = torch.sum(r * r, dim=-1) * prob.obs_inv_sigma2
    w = torch.where(active, _huber_weight(chi2, _delta2(prob)) * prob.obs_inv_sigma2, torch.zeros_like(chi2))
    Jproj = cam_models.stereo_project_jac(cam, xc, bf)
    Jproj = torch.cat([Jproj[:, :2], Jproj[:, 2:] * prob.obs_is_stereo[:, None, None]], 1)
    eye = torch.eye(3, dtype=xc.dtype, device=xc.device).expand(xc.shape[0], 3, 3)
    dxc_dxi = torch.cat([eye, -lie.hat(xc)], dim=-1)  # (O,3,6)
    Jp = -(Jproj @ dxc_dxi)
    Jl = -(Jproj @ R[kf])
    Jp = Jp * (~prob.pose_fixed)[kf][:, None, None]
    rho, _ = _robust_rho(r, prob, active)
    return (torch.einsum("oij,o,oik->ojk", Jp, w, Jp), torch.einsum("oij,o,oik->ojk", Jl, w, Jl),
            -torch.einsum("oij,o,oi->oj", Jp, w, r), -torch.einsum("oij,o,oi->oj", Jl, w, r),
            torch.einsum("oij,o,oik->ojk", Jp, w, Jl), w, rho)


def build_normal_blocks_plain(cam, bf, R, t, xw, prob: BAProblem, inlier, per_obs: bool = False):
    """Plain version of kernel E: (Hpp (K,6,6), Hll (M,3,3), bp (K,6),
    bl (M,3), Z (M,K,6,3), w_lm (M,), cost ()); with ``per_obs`` the
    per-observation W (O,6,3) in Z's place, as the kernel returns it
    (``optim/ba_cg.build_blocks``)."""
    K, M = R.shape[0], xw.shape[0]
    kf, lm = prob.obs_kf.long(), prob.obs_lm.long()
    hpp, hll, gp, gl, Wob, w, rho = obs_terms_plain(cam, bf, R, t, xw, prob, inlier)
    z = R.new_zeros
    Hpp = z((K, 6, 6)).index_add_(0, kf, hpp)
    Hll = z((M, 3, 3)).index_add_(0, lm, hll)
    bp = z((K, 6)).index_add_(0, kf, gp)
    bl = z((M, 3)).index_add_(0, lm, gl)
    w_lm = z((M,)).index_add_(0, lm, w)
    cost = torch.sum(rho)
    if per_obs:
        return Hpp, Hll, bp, bl, Wob, w_lm, cost
    Z = z((M * K, 6, 3)).index_add_(0, lm * K + kf, Wob).reshape(M, K, 6, 3)
    return Hpp, Hll, bp, bl, Z, w_lm, cost


def _damped(H: torch.Tensor, lam) -> torch.Tensor:
    d = torch.diagonal(H, dim1=-2, dim2=-1)
    return H + torch.diag_embed(lam * torch.clamp(d, min=1e-3))


def reduced_system_plain(Hpp, Hll, bp, bl, Z, w_lm, pose_fixed, lam):
    """The damped reduced camera system of ``schur_solve_plain``: (S (6K,6K)
    with fixed poses' rows and columns set to the identity, its right-hand
    side (6K,), V^-1 (M,3,3), free-pose flags (K,), seen-landmark flags)."""
    K = Hpp.shape[0]
    eye3 = torch.eye(3, dtype=Hll.dtype, device=Hll.device)
    Hpp_d = _damped(Hpp, lam)
    lm_seen = w_lm > 0
    Hll_d = torch.where(lm_seen[:, None, None], _damped(Hll, lam), eye3)
    Vinv = torch.linalg.inv(Hll_d)
    ZV = torch.einsum("mkab,mbc->mkac", Z, Vinv)
    S_coup = torch.einsum("mkac,mjbc->kajb", ZV, Z)
    S = torch.zeros((K, 6, K, 6), dtype=Hpp.dtype, device=Hpp.device)
    diag = torch.arange(K, device=Hpp.device)
    S[diag, :, diag, :] += Hpp_d
    S = S - S_coup
    b_s = bp - torch.einsum("mkac,mc->ka", ZV, bl)
    free_f = (~pose_fixed).to(S.dtype)
    S = S * free_f[:, None, None, None] * free_f[None, None, :, None]
    S[diag, :, diag, :] += (1.0 - free_f)[:, None, None] * torch.eye(6, dtype=S.dtype, device=S.device)
    b_s = b_s * free_f[:, None]
    Sd = S.reshape(K * 6, K * 6) + 1e-6 * torch.eye(K * 6, dtype=S.dtype, device=S.device)
    return Sd, b_s.reshape(-1), Vinv, free_f, lm_seen


def schur_solve_plain(Hpp, Hll, bp, bl, Z, w_lm, pose_fixed, lm_valid, lam):
    """Plain version of kernel F (the JAX einsums and a dense solve).
    Returns (dp (K,6), dl (M,3))."""
    K = Hpp.shape[0]
    Sd, b_s, Vinv, free_f, lm_seen = reduced_system_plain(Hpp, Hll, bp, bl, Z, w_lm, pose_fixed, lam)
    dp = torch.linalg.solve(Sd, b_s).reshape(K, 6) * free_f[:, None]
    Wt_dp = torch.einsum("mkab,ka->mb", Z, dp)
    dl = torch.einsum("mab,mb->ma", Vinv, bl - Wt_dp) * (lm_seen & lm_valid)[:, None]
    return dp, dl


def coupling_to_dense(coupling, prob: BAProblem) -> torch.Tensor:
    """The dense Z (M,K,6,3) from the coupling ``build_normal_blocks``
    returned: Z itself, or the per-observation W scattered into it."""
    if coupling.dim() == 4:
        return coupling
    K, M = prob.R.shape[0], prob.xw.shape[0]
    key = prob.obs_lm.long() * K + prob.obs_kf.long()
    Z = coupling.new_zeros((M * K, 6, 3)).index_add_(0, key, coupling)
    return Z.reshape(M, K, 6, 3)


_DEVICE_CAMERAS = threading.local()


def _device_camera(cam, bf, dev, name: str):
    """``kernel_camera``'s slots on ``dev`` and the camera's kind, uploaded
    once per thread and camera: an upload from pageable host memory waits
    for the stream, which would stall every LM iteration."""
    cam10, kind = kernel_camera(cam, bf, name)
    key = (tuple(cam10.tolist()), str(dev))
    cache = _DEVICE_CAMERAS.__dict__.setdefault("slots", {})
    if key not in cache:
        cache[key] = cam10.to(dev)
    return cache[key], kind


def build_normal_blocks(cam, bf, R, t, xw, prob: BAProblem, inlier):
    """Kernel E on CUDA tensors, its plain version on CPU ones.  Returns
    (Hpp, Hll, bp, bl, coupling, w_lm, cost): the coupling is the dense Z
    (M,K,6,3) on the CPU and the per-observation W (O,6,3) on the card."""
    if R.device.type == "cpu":
        return build_normal_blocks_plain(cam, bf, R, t, xw, prob, inlier)
    return _blocks_kernel(cam, bf, R, t, xw, prob, inlier)


def _blocks_kernel(cam, bf, R, t, xw, prob, inlier):
    """Kernel E's launch."""
    f32, i32, b = torch.float32, torch.int32, torch.bool
    _kernels.require_cuda(
        "build_normal_blocks", R=(R, f32), t=(t, f32), xw=(xw, f32), pose_fixed=(prob.pose_fixed, b),
        lm_valid=(prob.lm_valid, b), obs_kf=(prob.obs_kf, i32), obs_lm=(prob.obs_lm, i32),
        obs_uv=(prob.obs_uv, f32), obs_inv_sigma2=(prob.obs_inv_sigma2, f32),
        obs_is_stereo=(prob.obs_is_stereo, b), obs_valid=(prob.obs_valid, b), inlier=(inlier, b),
    )
    dev = R.device
    K, M, O = R.shape[0], xw.shape[0], prob.obs_kf.shape[0]
    cam10, kind = _device_camera(cam, bf, dev, "kernel E")
    sizes = (K * 36, M * 9, K * 6, M * 3, M, 1)  # Hpp, Hll, bp, bl, w_lm, cost in one buffer
    acc = torch.empty(sum(sizes), dtype=torch.float64, device=dev)  # zeroed by the entry
    out = torch.empty(sum(sizes), dtype=f32, device=dev)
    W = torch.empty((O, 6, 3), dtype=f32, device=dev)
    _kernels.launch(
        "ba_blocks_launch", dev, cam10.data_ptr(), kind, R.data_ptr(), t.data_ptr(), xw.data_ptr(),
        prob.pose_fixed.data_ptr(), prob.lm_valid.data_ptr(), prob.obs_kf.data_ptr(), prob.obs_lm.data_ptr(),
        prob.obs_uv.data_ptr(), prob.obs_inv_sigma2.data_ptr(), prob.obs_is_stereo.data_ptr(),
        prob.obs_valid.data_ptr(), inlier.data_ptr(), O, K, M, W.data_ptr(), acc.data_ptr(), out.data_ptr(),
    )
    build_normal_blocks.launches.add(camera=CAMERA_NAMES[kind])
    Hpp, Hll, bp, bl, w_lm, cost = torch.split(out, sizes)
    return Hpp.view(K, 6, 6), Hll.view(M, 3, 3), bp.view(K, 6), bl.view(M, 3), W, w_lm, cost.view(())


build_normal_blocks.launches = _kernels.LaunchCounter()  # by camera instance: "", "radtan", "kb8"


def _solve_plain(Hpp, Hll, bp, bl, Z, w_lm, prob, lam):
    """The plain solve, with ``ok`` False where it gave a non-finite step
    (a singular system), which the reference's cost test rejects too."""
    dp, dl = schur_solve_plain(Hpp, Hll, bp, bl, Z, w_lm, prob.pose_fixed, prob.lm_valid, lam)
    return dp, dl, torch.isfinite(dp).all() & torch.isfinite(dl).all()


def schur_solve(Hpp, Hll, bp, bl, coupling, w_lm, prob: BAProblem, lam):
    """Kernel F on CUDA tensors, its plain version on CPU ones; ``coupling``
    is what ``build_normal_blocks`` returned, ``lam`` a () float32 tensor.
    Returns (dp (K,6), dl (M,3), ok ()): ``ok`` is a bool tensor on the
    device, False where the solve failed (kernel F: the reduced system was
    not positive definite, and dp and dl are zero; its byte, which kernel AC
    reads)."""
    if Hpp.device.type == "cpu":
        return _solve_plain(Hpp, Hll, bp, bl, coupling, w_lm, prob, lam)
    f32, i32, b = torch.float32, torch.int32, torch.bool
    lam = lam.to(f32).reshape(()).contiguous()
    _kernels.require_cuda(
        "schur_solve", Hpp=(Hpp, f32), Hll=(Hll, f32), bp=(bp, f32), bl=(bl, f32), W=(coupling, f32),
        w_lm=(w_lm, f32), pose_fixed=(prob.pose_fixed, b), lm_valid=(prob.lm_valid, b),
        obs_kf=(prob.obs_kf, i32), lm_ptr=(prob.lm_ptr, i32), lm_obs=(prob.lm_obs, i32), lam=(lam, f32),
    )
    K, M, O = Hpp.shape[0], Hll.shape[0], coupling.shape[0]
    if K > MAX_POSES or coupling.shape[1:] != (6, 3) or prob.lm_ptr.shape[0] != M + 1:
        raise ValueError(f"schur_solve: needs K <= {MAX_POSES}, the per-observation W and an (M+1,) lm_ptr")
    dev = Hpp.device
    S = torch.empty((6 * K, 6 * K), dtype=torch.float64, device=dev)  # lower triangle of -S_coup; the entry zeroes
    bs = torch.empty(6 * K, dtype=torch.float64, device=dev)  # -Z V^-1 bl; the entry zeroes
    dp = torch.empty((K, 6), dtype=f32, device=dev)
    dl = torch.empty((M, 3), dtype=f32, device=dev)
    ok = torch.empty((), dtype=b, device=dev)
    _kernels.launch(
        "ba_schur_launch", dev, Hpp.data_ptr(), Hll.data_ptr(), bp.data_ptr(), bl.data_ptr(), coupling.data_ptr(),
        w_lm.data_ptr(), prob.pose_fixed.data_ptr(), prob.lm_valid.data_ptr(), prob.obs_kf.data_ptr(),
        prob.lm_ptr.data_ptr(), prob.lm_obs.data_ptr(), lam.data_ptr(), K, M, O, S.data_ptr(), bs.data_ptr(),
        dp.data_ptr(), dl.data_ptr(), ok.data_ptr(),
    )
    schur_solve.launches.add()
    return dp, dl, ok


schur_solve.launches = _kernels.LaunchCounter()


def apply_update(R, t, xw, dp, dl):
    dT = lie.se3_exp(dp)
    return dT.R @ R, torch.einsum("kij,kj->ki", dT.R, t) + dT.t, xw + dl


def lm_update_plain(cam, bf, prob: BAProblem, R, t, xw, dp, dl, inlier, cost_old, ok, lam):
    """Plain version of kernel AC's first entry: the candidate state, its
    robust cost, accept = ok & (cost_new < cost_old) (``ok`` None: the
    cost test alone, as the global BA has it) and the damping halved or
    multiplied by 5.  Returns (R, t, xw, lam, accept, cost_new)."""
    R_new, t_new, xw_new = apply_update(R, t, xw, dp, dl)
    r_new, _, posd_new = _obs_residuals(cam, bf, R_new, t_new, xw_new, prob)
    cost_new, _ = _robust_cost(r_new, prob, _active(prob, inlier, posd_new))
    accept = cost_new < cost_old
    if ok is not None:
        accept = ok & accept
    lam = torch.where(accept, torch.clamp(lam * 0.5, min=1e-8), torch.clamp(lam * 5.0, max=1e6))
    return (torch.where(accept, R_new, R), torch.where(accept, t_new, t), torch.where(accept, xw_new, xw), lam, accept,
            cost_new)


def lm_update(cam, bf, prob: BAProblem, R, t, xw, dp, dl, inlier, cost_old, ok, lam):
    """Kernel AC's first entry on CUDA tensors, its plain version on CPU
    ones: the LM iteration's update, cost, accept and damping after the
    step (dp (K,6), dl (M,3)).  ``cost_old`` is the cost the blocks
    returned, ``ok`` kernel F's flag (None after kernel T), ``lam`` a ()
    float32 tensor.  Returns (R, t, xw, lam, accept, cost_new), all on the
    device."""
    if R.device.type == "cpu":
        return lm_update_plain(cam, bf, prob, R, t, xw, dp, dl, inlier, cost_old, ok, lam)
    return _lm_update_kernel(cam, bf, prob, R, t, xw, dp, dl, inlier, cost_old, ok, lam)


def _lm_update_kernel(cam, bf, prob: BAProblem, R, t, xw, dp, dl, inlier, cost_old, ok, lam):
    """Kernel AC's first entry: three launches."""
    f32, i32, b = torch.float32, torch.int32, torch.bool
    checked = dict(R=(R, f32), t=(t, f32), xw=(xw, f32), dp=(dp, f32), dl=(dl, f32), lm_valid=(prob.lm_valid, b),
                   obs_kf=(prob.obs_kf, i32), obs_lm=(prob.obs_lm, i32), obs_uv=(prob.obs_uv, f32),
                   obs_inv_sigma2=(prob.obs_inv_sigma2, f32), obs_is_stereo=(prob.obs_is_stereo, b),
                   obs_valid=(prob.obs_valid, b), inlier=(inlier, b), cost_old=(cost_old, f32), lam=(lam, f32))
    if ok is not None:
        checked["ok"] = (ok, b)
    _kernels.require_cuda("lm_update", **checked)
    dev = R.device
    K, M, O = R.shape[0], xw.shape[0], prob.obs_kf.shape[0]
    cam10, kind = _device_camera(cam, bf, dev, "kernel AC")
    R_out, t_out, xw_out = torch.empty_like(R), torch.empty_like(t), torch.empty_like(xw)
    lam_out, cost = torch.empty((), dtype=f32, device=dev), torch.empty((), dtype=f32, device=dev)
    accept = torch.empty((), dtype=b, device=dev)
    acc = torch.empty(1, dtype=torch.float64, device=dev)
    _kernels.launch(
        "ba_lm_update_launch", dev, cam10.data_ptr(), kind, R.data_ptr(), t.data_ptr(), xw.data_ptr(), dp.data_ptr(),
        dl.data_ptr(), prob.lm_valid.data_ptr(), prob.obs_kf.data_ptr(), prob.obs_lm.data_ptr(),
        prob.obs_uv.data_ptr(), prob.obs_inv_sigma2.data_ptr(), prob.obs_is_stereo.data_ptr(),
        prob.obs_valid.data_ptr(), inlier.data_ptr(), cost_old.data_ptr(), None if ok is None else ok.data_ptr(),
        lam.data_ptr(), O, K, M, R_out.data_ptr(), t_out.data_ptr(), xw_out.data_ptr(), lam_out.data_ptr(),
        accept.data_ptr(), cost.data_ptr(), acc.data_ptr(),
    )
    lm_update.launches.add(camera=CAMERA_NAMES[kind])
    return R_out, t_out, xw_out, lam_out, accept, cost


lm_update.launches = _kernels.LaunchCounter()  # by camera instance: "", "radtan", "kb8"


def classify_plain(cam, bf, prob: BAProblem, R, t, xw):
    """Plain version of kernel AC's second entry: the chi2 inlier gate
    (Optimizer.cc:1347-1365, 1398-1420)."""
    r, _, posd = _obs_residuals(cam, bf, R, t, xw, prob)
    chi2 = torch.sum(r * r, dim=-1) * prob.obs_inv_sigma2
    return (chi2 <= _delta2(prob)) & posd & prob.obs_valid


def classify(cam, bf, prob: BAProblem, R, t, xw):
    """Kernel AC's second entry on CUDA tensors, its plain version on CPU
    ones: (O,) bool, the observations within their chi2 bound, in front of
    the camera and valid."""
    if R.device.type == "cpu":
        return classify_plain(cam, bf, prob, R, t, xw)
    return _classify_kernel(cam, bf, prob, R, t, xw)


def _classify_kernel(cam, bf, prob: BAProblem, R, t, xw):
    """Kernel AC's second entry: one launch."""
    f32, i32, b = torch.float32, torch.int32, torch.bool
    _kernels.require_cuda(
        "classify", R=(R, f32), t=(t, f32), xw=(xw, f32), obs_kf=(prob.obs_kf, i32), obs_lm=(prob.obs_lm, i32),
        obs_uv=(prob.obs_uv, f32), obs_inv_sigma2=(prob.obs_inv_sigma2, f32), obs_is_stereo=(prob.obs_is_stereo, b),
        obs_valid=(prob.obs_valid, b),
    )
    dev = R.device
    O = prob.obs_kf.shape[0]
    cam10, kind = _device_camera(cam, bf, dev, "kernel AC")
    inlier = torch.empty(O, dtype=b, device=dev)
    _kernels.launch(
        "ba_classify_launch", dev, cam10.data_ptr(), kind, R.data_ptr(), t.data_ptr(), xw.data_ptr(),
        prob.obs_kf.data_ptr(), prob.obs_lm.data_ptr(), prob.obs_uv.data_ptr(), prob.obs_inv_sigma2.data_ptr(),
        prob.obs_is_stereo.data_ptr(), prob.obs_valid.data_ptr(), O, inlier.data_ptr(),
    )
    classify.launches.add(camera=CAMERA_NAMES[kind])
    return inlier


classify.launches = _kernels.LaunchCounter()  # by camera instance: "", "radtan", "kb8"


def _bundle_adjust(cam, bf, prob: BAProblem, iters1: int, iters2: int, blocks, solve, update=lm_update,
                   gate=classify):
    def run_phase(R, t, xw, inlier, n_iters):
        lam = torch.full((), 1e-4, dtype=torch.float32, device=R.device)
        for _ in range(n_iters):
            Hpp, Hll, bp, bl, C, w_lm, cost_old = blocks(cam, bf, R, t, xw, prob, inlier)
            dp, dl, ok = solve(Hpp, Hll, bp, bl, C, w_lm, prob, lam)
            R, t, xw, lam, _, _ = update(cam, bf, prob, R, t, xw, dp, dl, inlier, cost_old, ok, lam)
        return R, t, xw

    inlier = torch.ones_like(prob.obs_valid)
    R, t, xw = run_phase(prob.R, prob.t, prob.xw, inlier, iters1)
    R, t, xw = run_phase(R, t, xw, gate(cam, bf, prob, R, t, xw), iters2)  # Optimizer.cc:1347-1365
    return R, t, xw, gate(cam, bf, prob, R, t, xw)  # Optimizer.cc:1398-1420


def bundle_adjust(cam, bf, prob: BAProblem, iters1: int = 5, iters2: int = 10):
    """Two-phase robust BA through kernels E, F and AC (their plain
    versions on the CPU).  Returns (R, t, xw, observation inlier mask)."""
    return _bundle_adjust(cam, bf, prob, iters1, iters2, build_normal_blocks, schur_solve)


def bundle_adjust_plain(cam, bf, prob: BAProblem, iters1: int = 5, iters2: int = 10):
    """The same schedule through the plain versions on any device."""
    return _bundle_adjust(cam, bf, prob, iters1, iters2, build_normal_blocks_plain, _solve_plain, lm_update_plain,
                          classify_plain)
