"""Bundle adjustment over observation shards: the local (dense) and the
global (CG) BA with the observation table split over the ranks.

Counterpart of ``orb_slam3_fast_tpu/parallel/dist_ba.py`` (``shard_problem``
:37, ``make_distributed_ba`` :61, ``make_distributed_ba_cg`` :159, the
``get_*`` factories :336-365).  Each rank holds its contiguous O/n chunk of
the observation table with its own pose and landmark CSRs
(``optim/ba.landmark_csr``) and the whole state (poses, landmarks), which
every rank updates alike.  The reductions the JAX package writes as
``psum`` are ``all_reduce``s of float64 partial sums between two launches
on one stream, so every rank solves the same reduced system and holds the
same state bit for bit.

* Dense run (``make_distributed_ba``, JAX ``dist_ba.py:61-153``): per LM
  iteration kernel E over the shard, the float64 sums (Hpp, Hll, bp, bl,
  w_lm, cost) all-reduced before they are rounded; the shards' per-
  observation W all-gathered (contiguous chunks rebuild the whole (O,6,3)
  table in its order) and kernel F run unchanged on the whole table's
  landmark CSR, each rank solving the same reduced system (JAX psums a
  dense (M,K,6,3) Z instead, ``dist_ba.py:104-107``); kernel AC's candidate
  and the shard's cost, the float64 cost all-reduced, AC's commit
  (``:110-113``).
* CG run (``make_distributed_ba_cg``, ``:159-238``): the same blocks and
  update around kernel T's solve, its sums split over the shards: at setup
  the block-Jacobi coupling and W V^-1 bl per pose, (K,42) (``reduce_k``,
  JAX ``optim/ba_cg.py:126``); per CG iteration sum W^T p (M,3)
  (``reduce_m``, ``:108``), V^-1 applied after the reduction, and sum W y
  (K,6) (``reduce_k``, ``:112``); the back-substitution's sum W^T dp (M,3).

Both return (R, t, xw, inlier (O,) over the whole table, cost): the chi2
gate of the whole table, gathered, and the cost at the start of the last
iteration, as the JAX package's ``costs[-1]``.  The gate is kernel AC's, as
in the single-device BA (the JAX runs also drop an invalid landmark's
observations there, ``dist_ba.py:132``; their solves do not see them).  A
world of one computes what E -> F -> AC and E -> T -> AC compute.

* FullInertialBA (``shard_vi_problem`` :221, ``make_distributed_vi_ba_cg``
  :245-321): the visual observations sharded, the 15-D states, the
  landmarks and the preintegration chain whole on every rank; per LM step
  the shard's visual sums (``reduce_s``, JAX ``optim/vi_ba_cg.py:320-321,
  335``), the coupling at setup and per CG iteration (``reduce_k`` /
  ``reduce_m``, ``:239, 243, 277``) all-reduced, the chain computed alike
  by every rank.  Kernel AG on CUDA tensors, the plain LM step of
  ``optim/vi_ba_cg.py`` with ``Mesh.all_reduce`` as its hooks on CPU ones.
  Returns (R_wb, p_wb, v_w, bias, xw, inlier) with the inlier mask of the
  whole table, gathered, unpadded.

The factories cache nothing: a run closes over its mesh, camera, ``bf``
(and ``T_cb``) and iteration counts and is rebuilt per call at no cost, so
no camera can go stale in it (the JAX package's caches key on the mesh
size, the camera's kind and the counts, ``dist_ba.py:326, 340, 354``, and
return one camera's compiled program for another).

Kernel AF -- source note.
  Replaces: the jitted ``run`` of ``make_distributed_ba``
  (``orb_slam3_fast_tpu/parallel/dist_ba.py:140``) and of
  ``make_distributed_ba_cg`` (``:210``), K27's first two runs: the shard's
  blocks, the psums, the replicated solve and the update.
  Bound on the card: as kernels E, T and AC (their notes): the shard's
  observation table and W once an iteration (bytes), plus the collectives:
  an iteration reduces 42 K + 13 M + 1 float64 sums and one cost; the dense
  run gathers O x 72 bytes of W; the CG run reduces (K,42) once, then (M,3)
  and (K,6) float64 per CG iteration.
  Design: ``csrc/ba_shard.cu``, E's, T's and AC's device code (their
  headers ``ba_blocks.cuh``, ``ba_pcg.cuh``, ``ba_lm.cuh``) behind entries
  cut where the reductions sit: blocks (E's sums left in float64), round,
  cost (AC's candidate and the shard's cost), commit; CG setup (every
  landmark's V^-1, each pose's sums over the shard), start (each pose's
  D^-1 and the CG vectors from the reduced sums, and r.z, one CTA), per CG
  iteration the landmark sums, the pose sums (V^-1 applied to the reduced
  landmark sums) and the update (S p from the reduced pose sums, then T's
  update, one CTA), and the back-substitution.  The host calls
  ``all_reduce`` / ``all_gather`` between launches on the same stream and
  reads nothing back mid-solve.  Every sum keeps T's and E's fixed order
  within a shard.

Kernel AG -- source note.
  Replaces: the jitted ``run`` of ``make_distributed_vi_ba_cg``
  (``orb_slam3_fast_tpu/parallel/dist_ba.py:309``, its ``shard_map`` body
  ``:272-306``), K27's third run: FullInertialBA's LM steps over the
  observation shards with the psums of ``_lm_step_vi`` and
  ``_implicit_vi_solve``, the replicated chain, the chi2 gate per phase.
  Bound on the card: as kernel AA's (its note in ``optim/vi_ba_cg.py``):
  the shard's observation table and its W once a step, and the
  collectives: a step reduces 42 K + 13 M + 1, then 42 K, then per CG
  iteration 3 M and 6 K, then 3 M and 1 float64 sums; 40 CG iterations
  are 84 dependent collectives a step, which set the pace where the ranks
  share a card over gloo.
  Design: ``csrc/vi_shard.cu``, AA's device code (its header
  ``vi_pcg.cuh``) behind one entry with a stage argument, each stage one
  CTA of AA's 512 threads running AA's passes (the per-landmark sums of
  the CG one thread a landmark), cut where the sums over the
  observations end: obs (the shard's rows and sums; the chain, replicated)
  -> all_reduce; landmarks (V^-1, each state's chain terms, the shard's
  coupling) -> all_reduce; start (the block-Jacobi inverses, r.z); per CG
  iteration cg_lm -> all_reduce, cg_zy -> all_reduce, cg_update (one CTA,
  a device-side freeze once r.z <= 1e-12 where AA leaves its loop);
  backsub -> all_reduce; candidate -> all_reduce; commit.  Where AA
  subtracts a sum over the observations term by term from a starting
  value (D's pose block, the back-substitution's bl), rank 0's partial
  starts from that value and the others' from zero, so a world of one
  runs AA's arithmetic in AA's order and its result bit for bit; the
  damping crosses segments in float32, as it crosses AA's launches.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from orb_slam3_fast_tpu_torch import _kernels
from orb_slam3_fast_tpu_torch.imu import preintegration as pre
from orb_slam3_fast_tpu_torch.optim import ba, ba_cg
from orb_slam3_fast_tpu_torch.optim import inertial as inr
from orb_slam3_fast_tpu_torch.optim import vi_ba as vb
from orb_slam3_fast_tpu_torch.optim import vi_ba_cg as vbc
from orb_slam3_fast_tpu_torch.optim.ba import BAProblem
from orb_slam3_fast_tpu_torch.optim.pose_opt import CAMERA_NAMES, kernel_camera
from orb_slam3_fast_tpu_torch.optim.vi_ba import VIBAProblem
from orb_slam3_fast_tpu_torch.parallel.multihost import Mesh

STATE = ("R", "t", "pose_fixed", "xw", "lm_valid")
OBS = ("obs_kf", "obs_lm", "obs_uv", "obs_inv_sigma2", "obs_is_stereo", "obs_valid")
OBS_PAD = {"obs_kf": 0, "obs_lm": 0, "obs_uv": -1.0, "obs_inv_sigma2": 1.0, "obs_is_stereo": False,
           "obs_valid": False}


class Shard(NamedTuple):
    local: BAProblem  # this rank's observations with their own CSRs, and the whole state
    whole: BAProblem | None  # the whole padded table (the dense run's kernel F), or None


def shard_problem(prob: BAProblem, mesh: Mesh, whole: bool = False) -> Shard:
    """This rank's contiguous chunk of ``prob``'s observations, padded with
    ``obs_valid=False`` rows to a multiple of the world size, on the mesh's
    device; with ``whole`` also the padded table (for the dense run)."""
    host = {f: getattr(prob, f).cpu().numpy() for f in STATE + OBS}
    pad = -len(host["obs_kf"]) % mesh.world
    if pad:
        for f in OBS:
            a = host[f]
            host[f] = np.concatenate([a, np.full((pad,) + a.shape[1:], OBS_PAD[f], a.dtype)])
    n = len(host["obs_kf"])
    lo, hi = mesh.rank * n // mesh.world, (mesh.rank + 1) * n // mesh.world
    state = [host[f] for f in STATE]
    local = ba.make_problem(*state, *(host[f][lo:hi] for f in OBS), device=mesh.device)
    return Shard(local, ba.make_problem(*state, *(host[f] for f in OBS), device=mesh.device) if whole else None)


# --- kernel AF's stages, each a wrapper that launches on CUDA tensors and takes its plain version on CPU ones ---

LAUNCHES = _kernels.LaunchCounter()  # kernel AF's entries, by mode (blocks, round, cost, commit, cg) and camera


def _launch(name: str, dev, mode: str, *args, camera: str = "") -> None:
    _kernels.launch(name, dev, *args)
    LAUNCHES.add(mode=mode, camera=camera)


def _sizes(K: int, M: int) -> tuple:
    return K * 36, M * 9, K * 6, M * 3, M, 1  # Hpp | Hll | bp | bl | w_lm | cost, kernel E's layout


def blocks_partial_plain(cam, bf, R, t, xw, prob: BAProblem, inlier):
    """Plain version of AF's blocks entry: (the shard's float64 sums of
    kernel E's layout, flat; W (O,6,3))."""
    K, M = R.shape[0], xw.shape[0]
    kf, lm = prob.obs_kf.long(), prob.obs_lm.long()
    hpp, hll, gp, gl, W, w, rho = ba.obs_terms_plain(cam, bf, R, t, xw, prob, inlier)

    def total(index, n, terms):
        return torch.zeros((n,) + terms.shape[1:], dtype=torch.float64, device=R.device).index_add_(
            0, index, terms.double()).flatten()

    cost = rho.double().sum().reshape(1)
    return torch.cat([total(kf, K, hpp), total(lm, M, hll), total(kf, K, gp), total(lm, M, gl), total(lm, M, w),
                      cost]), W


def blocks_partial(cam, bf, R, t, xw, prob: BAProblem, inlier):
    """AF's blocks entry (kernel E over the shard, its float64 sums not
    rounded) on CUDA tensors, its plain version on CPU ones."""
    if R.device.type == "cpu":
        return blocks_partial_plain(cam, bf, R, t, xw, prob, inlier)
    return _blocks_partial_kernel(cam, bf, R, t, xw, prob, inlier)


def _blocks_partial_kernel(cam, bf, R, t, xw, prob: BAProblem, inlier):
    f32, i32, b = torch.float32, torch.int32, torch.bool
    _kernels.require_cuda(
        "blocks_partial", R=(R, f32), t=(t, f32), xw=(xw, f32), pose_fixed=(prob.pose_fixed, b),
        lm_valid=(prob.lm_valid, b), obs_kf=(prob.obs_kf, i32), obs_lm=(prob.obs_lm, i32), obs_uv=(prob.obs_uv, f32),
        obs_inv_sigma2=(prob.obs_inv_sigma2, f32), obs_is_stereo=(prob.obs_is_stereo, b),
        obs_valid=(prob.obs_valid, b), inlier=(inlier, b),
    )
    dev = R.device
    K, M, O = R.shape[0], xw.shape[0], prob.obs_kf.shape[0]
    cam10, kind = ba._device_camera(cam, bf, dev, "kernel AF")
    acc = torch.empty(sum(_sizes(K, M)), dtype=torch.float64, device=dev)  # zeroed by the entry
    W = torch.empty((O, 6, 3), dtype=f32, device=dev)
    _launch("ba_shard_blocks_launch", dev, "blocks", cam10.data_ptr(), kind, R.data_ptr(), t.data_ptr(), xw.data_ptr(),
            prob.pose_fixed.data_ptr(), prob.lm_valid.data_ptr(), prob.obs_kf.data_ptr(), prob.obs_lm.data_ptr(),
            prob.obs_uv.data_ptr(), prob.obs_inv_sigma2.data_ptr(), prob.obs_is_stereo.data_ptr(),
            prob.obs_valid.data_ptr(), inlier.data_ptr(), O, K, M, W.data_ptr(), acc.data_ptr(),
            camera=CAMERA_NAMES[kind])
    return acc, W


def _split(out: torch.Tensor, K: int, M: int):
    Hpp, Hll, bp, bl, w_lm, cost = torch.split(out, _sizes(K, M))
    return Hpp.view(K, 6, 6), Hll.view(M, 3, 3), bp.view(K, 6), bl.view(M, 3), w_lm, cost.view(())


def round_blocks_plain(acc, K: int, M: int):
    """Plain version of AF's round entry: (Hpp, Hll, bp, bl, w_lm, cost) in
    float32 from the reduced sums."""
    return _split(acc.to(torch.float32), K, M)


def round_blocks(acc, K: int, M: int):
    """AF's round entry (kernel E's second launch) on a CUDA tensor, its
    plain version on a CPU one."""
    if acc.device.type == "cpu":
        return round_blocks_plain(acc, K, M)
    return _round_blocks_kernel(acc, K, M)


def _round_blocks_kernel(acc, K: int, M: int):
    _kernels.require_cuda("round_blocks", acc=(acc, torch.float64))
    out = torch.empty(acc.shape[0], dtype=torch.float32, device=acc.device)
    _launch("ba_shard_round_launch", acc.device, "round", acc.data_ptr(), out.data_ptr(), acc.shape[0])
    return _split(out, K, M)


def update_partial_plain(cam, bf, prob: BAProblem, R, t, xw, dp, dl, inlier):
    """Plain version of AF's cost entry: the candidate state and the
    shard's robust cost at it, (1,) float64."""
    R_c, t_c, xw_c = ba.apply_update(R, t, xw, dp, dl)
    r, _, posd = ba._obs_residuals(cam, bf, R_c, t_c, xw_c, prob)
    rho, _ = ba._robust_rho(r, prob, ba._active(prob, inlier, posd))
    return R_c, t_c, xw_c, rho.double().sum().reshape(1)


def update_partial(cam, bf, prob: BAProblem, R, t, xw, dp, dl, inlier):
    """AF's cost entry (kernel AC's candidate and cost launches over the
    shard) on CUDA tensors, its plain version on CPU ones."""
    if R.device.type == "cpu":
        return update_partial_plain(cam, bf, prob, R, t, xw, dp, dl, inlier)
    return _update_partial_kernel(cam, bf, prob, R, t, xw, dp, dl, inlier)


def _update_partial_kernel(cam, bf, prob: BAProblem, R, t, xw, dp, dl, inlier):
    f32, i32, b = torch.float32, torch.int32, torch.bool
    _kernels.require_cuda(
        "update_partial", R=(R, f32), t=(t, f32), xw=(xw, f32), dp=(dp, f32), dl=(dl, f32),
        lm_valid=(prob.lm_valid, b), obs_kf=(prob.obs_kf, i32), obs_lm=(prob.obs_lm, i32), obs_uv=(prob.obs_uv, f32),
        obs_inv_sigma2=(prob.obs_inv_sigma2, f32), obs_is_stereo=(prob.obs_is_stereo, b),
        obs_valid=(prob.obs_valid, b), inlier=(inlier, b),
    )
    dev = R.device
    K, M, O = R.shape[0], xw.shape[0], prob.obs_kf.shape[0]
    cam10, kind = ba._device_camera(cam, bf, dev, "kernel AF")
    R_c, t_c, xw_c = torch.empty_like(R), torch.empty_like(t), torch.empty_like(xw)
    acc = torch.empty(1, dtype=torch.float64, device=dev)
    _launch("ba_shard_cost_launch", dev, "cost", cam10.data_ptr(), kind, R.data_ptr(), t.data_ptr(), xw.data_ptr(),
            dp.data_ptr(), dl.data_ptr(), prob.lm_valid.data_ptr(), prob.obs_kf.data_ptr(), prob.obs_lm.data_ptr(),
            prob.obs_uv.data_ptr(), prob.obs_inv_sigma2.data_ptr(), prob.obs_is_stereo.data_ptr(),
            prob.obs_valid.data_ptr(), inlier.data_ptr(), O, K, M, R_c.data_ptr(), t_c.data_ptr(), xw_c.data_ptr(),
            acc.data_ptr(), camera=CAMERA_NAMES[kind])
    return R_c, t_c, xw_c, acc


def commit_plain(R, t, xw, R_c, t_c, xw_c, acc, cost_old, ok, lam):
    """Plain version of AF's commit entry: accept = ok & (cost_new <
    cost_old) (``ok`` None: the cost test alone), the damping halved or
    multiplied by 5, the old state kept where the step is rejected.
    Returns (R, t, xw, lam, accept, cost_new)."""
    cost_new = acc.to(torch.float32).reshape(())
    accept = cost_new < cost_old
    if ok is not None:
        accept = ok & accept
    lam = torch.where(accept, torch.clamp(lam * 0.5, min=1e-8), torch.clamp(lam * 5.0, max=1e6))
    return (torch.where(accept, R_c, R), torch.where(accept, t_c, t), torch.where(accept, xw_c, xw), lam, accept,
            cost_new)


def commit(R, t, xw, R_c, t_c, xw_c, acc, cost_old, ok, lam):
    """AF's commit entry (kernel AC's third launch, from the reduced cost
    ``acc``) on CUDA tensors, its plain version on CPU ones; the kernel
    writes the state into the candidate's buffers."""
    if R.device.type == "cpu":
        return commit_plain(R, t, xw, R_c, t_c, xw_c, acc, cost_old, ok, lam)
    return _commit_kernel(R, t, xw, R_c, t_c, xw_c, acc, cost_old, ok, lam)


def _commit_kernel(R, t, xw, R_c, t_c, xw_c, acc, cost_old, ok, lam):
    f32 = torch.float32
    checked = dict(R=(R, f32), t=(t, f32), xw=(xw, f32), R_c=(R_c, f32), t_c=(t_c, f32), xw_c=(xw_c, f32),
                   acc=(acc, torch.float64), cost_old=(cost_old, f32), lam=(lam, f32))
    if ok is not None:
        checked["ok"] = (ok, torch.bool)
    _kernels.require_cuda("commit", **checked)
    dev = R.device
    lam_out, cost = torch.empty((), dtype=f32, device=dev), torch.empty((), dtype=f32, device=dev)
    accept = torch.empty((), dtype=torch.bool, device=dev)
    _launch("ba_shard_commit_launch", dev, "commit", R.data_ptr(), t.data_ptr(), xw.data_ptr(), R.shape[0],
            xw.shape[0], acc.data_ptr(), cost_old.data_ptr(), None if ok is None else ok.data_ptr(), lam.data_ptr(),
            R_c.data_ptr(), t_c.data_ptr(), xw_c.data_ptr(), lam_out.data_ptr(), accept.data_ptr(), cost.data_ptr())
    return R_c, t_c, xw_c, lam_out, accept, cost


def cg_solve_plain(mesh: Mesh, Hpp, Hll, bp, bl, W, prob: BAProblem, w_lm, lam, cg_iters: int):
    """Plain version of AF's CG entries: kernel T's plain version over the
    shard, its partial sums reduced over the mesh.  Returns (dp, dl)."""
    return ba_cg.implicit_schur_solve_plain(Hpp, Hll, bp, bl, W, prob.obs_kf, prob.obs_lm, w_lm, prob.pose_fixed,
                                            prob.lm_valid, lam, cg_iters, reduce_k=mesh.all_reduce,
                                            reduce_m=mesh.all_reduce)


def cg_solve(mesh: Mesh, Hpp, Hll, bp, bl, W, prob: BAProblem, w_lm, lam, cg_iters: int):
    """AF's CG entries on CUDA tensors (2 + 3 cg_iters + 2 launches and 2 +
    2 cg_iters all_reduces), its plain version on CPU ones: the implicit-
    Schur PCG of kernel T with the shard's partial sums reduced over the
    mesh.  Returns (dp (K,6), dl (M,3)), the same on every rank."""
    if Hpp.device.type == "cpu":
        return cg_solve_plain(mesh, Hpp, Hll, bp, bl, W, prob, w_lm, lam, cg_iters)
    return _cg_solve_kernel(mesh, Hpp, Hll, bp, bl, W, prob, w_lm, lam, cg_iters)


def _cg_solve_kernel(mesh: Mesh, Hpp, Hll, bp, bl, W, prob: BAProblem, w_lm, lam, cg_iters: int):
    f32, f64, i32, b = torch.float32, torch.float64, torch.int32, torch.bool
    lam = lam.to(f32).reshape(()).contiguous()
    _kernels.require_cuda(
        "cg_solve", Hpp=(Hpp, f32), Hll=(Hll, f32), bp=(bp, f32), bl=(bl, f32), W=(W, f32), w_lm=(w_lm, f32),
        pose_fixed=(prob.pose_fixed, b), lm_valid=(prob.lm_valid, b), obs_kf=(prob.obs_kf, i32),
        obs_lm=(prob.obs_lm, i32), lm_ptr=(prob.lm_ptr, i32), lm_obs=(prob.lm_obs, i32), kf_ptr=(prob.kf_ptr, i32),
        kf_obs=(prob.kf_obs, i32), lam=(lam, f32),
    )
    K, M, O = Hpp.shape[0], Hll.shape[0], W.shape[0]
    if W.shape != (O, 6, 3) or prob.lm_ptr.shape != (M + 1,) or prob.kf_ptr.shape != (K + 1,):
        raise ValueError("cg_solve: needs the shard's W (O,6,3) and both of its CSR offsets")
    dev = Hpp.device
    scratch = torch.empty(12 * M + 102 * K + 8, dtype=f64, device=dev)  # kernel T's layout
    part_k42, part_m, part_k = (torch.empty(n, dtype=f64, device=dev) for n in (42 * K, 3 * M, 6 * K))
    dp, dl = torch.empty((K, 6), dtype=f32, device=dev), torch.empty((M, 3), dtype=f32, device=dev)
    sp = scratch.data_ptr()
    _launch("ba_shard_cg_setup_launch", dev, "cg", Hll.data_ptr(), bl.data_ptr(), w_lm.data_ptr(), lam.data_ptr(),
            W.data_ptr(), prob.obs_lm.data_ptr(), prob.kf_ptr.data_ptr(), prob.kf_obs.data_ptr(), K, M, sp,
            part_k42.data_ptr())
    mesh.all_reduce(part_k42)
    _launch("ba_shard_cg_start_launch", dev, "cg", Hpp.data_ptr(), bp.data_ptr(), prob.pose_fixed.data_ptr(),
            lam.data_ptr(), part_k42.data_ptr(), K, M, sp)

    def landmark_sums(which: int):  # 0: p, 1: x
        _launch("ba_shard_cg_lm_launch", dev, "cg", W.data_ptr(), prob.obs_kf.data_ptr(), prob.lm_ptr.data_ptr(),
                prob.lm_obs.data_ptr(), prob.pose_fixed.data_ptr(), which, K, M, sp, part_m.data_ptr())
        mesh.all_reduce(part_m)

    for _ in range(cg_iters):
        landmark_sums(0)
        _launch("ba_shard_cg_pose_launch", dev, "cg", W.data_ptr(), prob.obs_lm.data_ptr(), prob.kf_ptr.data_ptr(),
                prob.kf_obs.data_ptr(), part_m.data_ptr(), K, M, sp, part_k.data_ptr())
        mesh.all_reduce(part_k)
        _launch("ba_shard_cg_update_launch", dev, "cg", prob.pose_fixed.data_ptr(), part_k.data_ptr(), K, M, sp)
    landmark_sums(1)
    _launch("ba_shard_cg_backsub_launch", dev, "cg", bl.data_ptr(), w_lm.data_ptr(), prob.lm_valid.data_ptr(),
            prob.pose_fixed.data_ptr(), part_m.data_ptr(), K, M, sp, dp.data_ptr(), dl.data_ptr())
    return dp, dl


def dense_solve_plain(Hpp, Hll, bp, bl, W_all, whole: BAProblem, w_lm, lam):
    """The dense run's solve, plain: the gathered W scattered into Z and
    kernel F's plain version.  Returns (dp, dl, ok)."""
    return ba._solve_plain(Hpp, Hll, bp, bl, ba.coupling_to_dense(W_all, whole), w_lm, whole, lam)


def dense_solve(Hpp, Hll, bp, bl, W_all, whole: BAProblem, w_lm, lam):
    """The dense run's solve: kernel F on the gathered W (CUDA tensors), its
    plain version on CPU ones."""
    if Hpp.device.type == "cpu":
        return dense_solve_plain(Hpp, Hll, bp, bl, W_all, whole, w_lm, lam)
    return ba.schur_solve(Hpp, Hll, bp, bl, W_all, w_lm, whole, lam)


class Stages(NamedTuple):
    blocks: object
    round: object
    update: object
    commit: object
    gate: object
    cg: object
    dense: object


DISPATCH = Stages(blocks_partial, round_blocks, update_partial, commit, ba.classify, cg_solve, dense_solve)
PLAIN = Stages(blocks_partial_plain, round_blocks_plain, update_partial_plain, commit_plain, ba.classify_plain,
               cg_solve_plain, dense_solve_plain)


def _run(mesh: Mesh, st: Stages, cam, bf, shard: Shard, iters1: int, iters2: int, solve):
    """The two robust phases with the chi2 gate between them and after
    (Optimizer.cc:984-1094), ``solve(Hpp, Hll, bp, bl, W, w_lm, lam)``
    giving (dp, dl, ok)."""
    loc = shard.local
    K, M = loc.R.shape[0], loc.xw.shape[0]

    def phase(R, t, xw, inlier, n):
        lam = torch.full((), 1e-4, dtype=torch.float32, device=R.device)
        cost = None
        for _ in range(n):
            acc, W = st.blocks(cam, bf, R, t, xw, loc, inlier)
            Hpp, Hll, bp, bl, w_lm, cost = st.round(mesh.all_reduce(acc), K, M)
            dp, dl, ok = solve(Hpp, Hll, bp, bl, W, w_lm, lam)
            R_c, t_c, xw_c, acc_c = st.update(cam, bf, loc, R, t, xw, dp, dl, inlier)
            R, t, xw, lam, _, _ = st.commit(R, t, xw, R_c, t_c, xw_c, mesh.all_reduce(acc_c), cost, ok, lam)
        return R, t, xw, cost

    R, t, xw, cost = phase(loc.R, loc.t, loc.xw, torch.ones_like(loc.obs_valid), iters1)
    inlier = st.gate(cam, bf, loc, R, t, xw)
    if iters2 > 0:
        R, t, xw, cost = phase(R, t, xw, inlier, iters2)
        inlier = st.gate(cam, bf, loc, R, t, xw)
    return R, t, xw, mesh.all_gather(inlier), cost


def make_distributed_ba(mesh: Mesh, cam, bf, n_iters: int = 10, iters1: int | None = None,
                        iters2: int | None = None, plain: bool = False):
    """The dense distributed BA for ``mesh``: ``iters1`` (default
    ``n_iters``) LM iterations, the chi2 gate, ``iters2`` (default 0) more.
    Returns ``run(shard) -> (R, t, xw, inlier, cost)`` for a ``Shard`` with
    its ``whole`` table (``shard_problem(..., whole=True)``); ``plain`` runs
    every stage's plain version on any device."""
    i1 = n_iters if iters1 is None else iters1
    i2 = iters2 or 0
    st = PLAIN if plain else DISPATCH

    def run(shard: Shard):
        if shard.whole is None:
            raise ValueError("make_distributed_ba: the shard needs its whole table (shard_problem(..., whole=True))")

        def solve(Hpp, Hll, bp, bl, W, w_lm, lam):
            return st.dense(Hpp, Hll, bp, bl, mesh.all_gather(W), shard.whole, w_lm, lam)

        return _run(mesh, st, cam, bf, shard, i1, i2, solve)

    return run


def make_distributed_ba_cg(mesh: Mesh, cam, bf, iters1: int = 5, iters2: int = 10, cg_iters: int = 24,
                           plain: bool = False):
    """The implicit-Schur CG distributed BA for ``mesh`` (the global BA):
    ``iters1`` LM iterations, the chi2 gate, ``iters2`` more, ``cg_iters``
    CG iterations a solve.  Returns ``run(shard) -> (R, t, xw, inlier,
    cost)``; ``plain`` runs every stage's plain version on any device."""
    st = PLAIN if plain else DISPATCH

    def run(shard: Shard):
        def solve(Hpp, Hll, bp, bl, W, w_lm, lam):
            dp, dl = st.cg(mesh, Hpp, Hll, bp, bl, W, shard.local, w_lm, lam, cg_iters)
            return dp, dl, None

        return _run(mesh, st, cam, bf, shard, iters1, iters2, solve)

    return run


def get_distributed_ba(mesh: Mesh, cam, bf, iters1: int, iters2: int):
    """The mapper's dense run (the JAX package's cached factory): built anew
    per call, nothing to cache (see the module's note)."""
    return make_distributed_ba(mesh, cam, bf, iters1=iters1, iters2=iters2)


def get_distributed_ba_cg(mesh: Mesh, cam, bf, iters1: int, iters2: int, cg_iters: int = 24):
    """The mapper's CG run (the JAX package's cached factory): built anew
    per call."""
    return make_distributed_ba_cg(mesh, cam, bf, iters1=iters1, iters2=iters2, cg_iters=cg_iters)


for _wrapper in (blocks_partial, round_blocks, update_partial, commit, cg_solve):
    _wrapper.launches = LAUNCHES


# --- FullInertialBA over observation shards: kernel AG's stages ---------------------------------------------------

class VIShard(NamedTuple):
    local: VIBAProblem  # this rank's observation rows (padded), the whole states, landmarks and chain
    csr: tuple  # (lm_ptr, lm_obs, kf_ptr, kf_obs) over the shard's valid rows, (ke_ptr, ke_edge) each state's edges
    n_obs: int  # the whole table's observations, before the padding


def shard_vi_problem(prob: VIBAProblem, mesh: Mesh) -> VIShard:
    """This rank's contiguous chunk of ``prob``'s observations, padded with
    ``obs_valid=False`` rows to a multiple of the world size (a padded row
    is in no CSR and adds nothing), the states, landmarks, edges and
    windows whole, on the mesh's device, with the shard's CSRs."""
    dev = mesh.device
    O = prob.obs_kf.shape[0]
    pad = -O % mesh.world
    n = O + pad
    lo, hi = mesh.rank * n // mesh.world, (mesh.rank + 1) * n // mesh.world

    def rows(f):
        a = getattr(prob, f).to(dev)
        if pad:
            a = torch.cat([a, torch.full((pad,) + a.shape[1:], OBS_PAD[f], dtype=a.dtype, device=dev)])
        return a[lo:hi].contiguous()

    whole = {f: getattr(prob, f).to(dev) for f in VIBAProblem._fields if f not in OBS and f != "preint"}
    local = prob._replace(**whole, **{f: rows(f) for f in OBS}, preint=prob.preint.to(dev))
    K, M = local.R_wb.shape[0], local.xw.shape[0]
    i32 = torch.int32
    kf, lm, ei, ej = (getattr(local, f).to(i32) for f in ("obs_kf", "obs_lm", "edge_i", "edge_j"))
    csr = (*vb._csr(lm, None, M, local.obs_valid), *vb._csr(kf, lm, K, local.obs_valid),
           *vb._state_edges(ei, ej, local.edge_valid, K))
    return VIShard(local, csr, O)


VI_LAUNCHES = _kernels.LaunchCounter()  # kernel AG's stages, by mode (the stage's name) and camera instance
# LM steps a launch segment of AG, full_inertial_ba_cg's: the damping crosses segments in float32 as it crosses AA's
# launches, so that a world of one runs AA's arithmetic
VI_SEGMENT = 2
# kernel AG's stages in the order of csrc/vi_shard.cu's stage numbers
VI_STAGES = ("begin", "obs", "landmarks", "start", "cg_lm", "cg_zy", "cg_update", "backsub", "candidate", "commit",
             "end", "classify")


def vi_part_doubles(K: int, M: int) -> int:
    """Doubles of AG's buffer of partial sums: all_reduce #1's 42 K + 13 M + 1,
    the largest; each later stage's sums use its start."""
    return 42 * K + 13 * M + 1


def lm_segment_vi_shard_plain(cam, bf, T_cb, prob: VIBAProblem, R_wb, p_wb, v_w, bias, xw, inlier, lam,
                              n_iters: int = 2, cg_iters: int = 40, *, mesh: Mesh):
    """Plain version of AG's segment: ``n_iters`` plain LM steps
    (``optim/vi_ba_cg._lm_step_vi``) on the shard ``prob`` with every hook
    ``mesh.all_reduce``.  Returns (R_wb, p_wb, v_w, bias, xw, lam, the last
    step's cost before it)."""
    lam = torch.as_tensor(lam, dtype=torch.float32, device=xw.device)
    cost = torch.zeros((), dtype=torch.float32, device=xw.device)
    red = mesh.all_reduce
    for _ in range(n_iters):
        R_wb, p_wb, v_w, bias, xw, lam, cost = vbc._lm_step_vi(cam, bf, T_cb, prob, R_wb, p_wb, v_w, bias, xw, inlier,
                                                               lam, cg_iters, reduce_k=red, reduce_m=red,
                                                               reduce_s=red)
    return R_wb, p_wb, v_w, bias, xw, lam, cost


def lm_segment_vi_shard(cam, bf, T_cb, prob: VIBAProblem, R_wb, p_wb, v_w, bias, xw, inlier, lam,
                        n_iters: int = 2, cg_iters: int = 40, *, mesh: Mesh, csr):
    """``n_iters`` LM steps of FullInertialBA on this rank's shard ``prob``
    (its CSRs ``csr``, ``VIShard.csr``): kernel AG's stages on CUDA tensors
    (6 + 3 ``cg_iters`` launches and 4 + 2 ``cg_iters`` all_reduces a step,
    2 more launches a segment, no host read), the plain version on CPU ones.
    Returns (R_wb, p_wb, v_w, bias, xw, lam, cost), the same on every rank."""
    if xw.device.type == "cpu":
        return lm_segment_vi_shard_plain(cam, bf, T_cb, prob, R_wb, p_wb, v_w, bias, xw, inlier, lam, n_iters,
                                         cg_iters, mesh=mesh)
    return _segment_kernel(cam, bf, T_cb, prob, R_wb, p_wb, v_w, bias, xw, inlier, lam, n_iters, cg_iters, mesh=mesh,
                           csr=csr)


def classify_vi_shard(cam, bf, T_cb, prob: VIBAProblem, R_wb, p_wb, xw):
    """AG's classify stage (AA's chi2 gate) over the shard's observations on
    CUDA tensors, ``classify_vi``'s plain version on CPU ones: the shard's
    (O,) inlier mask."""
    if xw.device.type == "cpu":
        return vbc.classify_vi_plain(cam, bf, T_cb, prob, R_wb, p_wb, xw)
    return _classify_kernel(cam, bf, T_cb, prob, R_wb, p_wb, xw)


def _classify_kernel(cam, bf, T_cb, prob: VIBAProblem, R_wb, p_wb, xw):
    out = torch.empty(prob.obs_kf.shape[0], dtype=torch.bool, device=xw.device)
    args, kind, _keep = _vi_args(cam, bf, T_cb, prob, None, (R_wb, p_wb, prob.v_w, prob.bias), xw, None)
    _vi_launch(xw.device, "classify", kind, args, 0, None, None, None, None, None, out)
    return out


def _vi_args(cam, bf, T_cb, prob: VIBAProblem, csr, state, xw, inlier):
    """AG's problem arguments (cam10 ... inlier_in of ``vi_shard_launch``),
    the camera's kind and the tensors they point into; ``csr`` None: the
    classification's (the CSR, edge and window pointers unread)."""
    f32, i32, b8 = torch.float32, torch.int32, torch.bool
    dev = xw.device
    cam10, kind = kernel_camera(cam, bf, "kernel AG")
    c = {name: getattr(prob, name).contiguous() for name in VIBAProblem._fields if name != "preint"}
    for name in ("obs_kf", "obs_lm", "edge_i", "edge_j"):
        c[name] = c[name].to(i32)
    R, p, v, b, xw = (x.to(f32).contiguous() for x in (*state, xw))
    inl = (torch.ones(prob.obs_kf.shape[0], dtype=b8, device=dev) if inlier is None else inlier).contiguous()
    types = dict(state_fixed=b8, lm_valid=b8, obs_kf=i32, obs_lm=i32, obs_uv=f32, obs_inv_sigma2=f32,
                 obs_is_stereo=b8, obs_valid=b8, edge_i=i32, edge_j=i32, edge_valid=b8)
    _kernels.require_cuda("kernel AG", R_wb=(R, f32), p_wb=(p, f32), v_w=(v, f32), bias=(b, f32), xw=(xw, f32),
                          inlier=(inl, b8), **{k: (c[k], t) for k, t in types.items()})
    cam10 = cam10.to(dev)
    tcb = torch.cat([T_cb.R.reshape(9), T_cb.t]).to(device=dev, dtype=f32).contiguous()
    if csr is None:
        pk, csr = inl, (inl,) * 6
    else:
        pk = pre.pack(prob.preint.to(dev))
        _kernels.require_cuda("kernel AG", **{f"csr{i}": (t, i32) for i, t in enumerate(csr)})
    K, M, O, E = R.shape[0], xw.shape[0], c["obs_kf"].shape[0], c["edge_i"].shape[0]
    keep = (cam10, tcb, R, p, v, b, xw, inl, pk, *c.values(), *csr)
    ptr = [t.data_ptr() for t in (R, p, v, b, c["state_fixed"], xw, c["lm_valid"], c["obs_kf"], c["obs_lm"],
                                  c["obs_uv"], c["obs_inv_sigma2"], c["obs_is_stereo"], c["obs_valid"], c["edge_i"],
                                  c["edge_j"], c["edge_valid"], pk, *csr, inl)]
    return (cam10.data_ptr(), kind, tcb.data_ptr(), K, M, O, E, *ptr), kind, keep


def _vi_launch(dev, stage: str, kind: int, args: tuple, lead: int, scratch, part, lam_io, state_out, xw_out,
               inlier_out=None) -> None:
    def ptr(t):
        return None if t is None else t.data_ptr()

    _kernels.launch("vi_shard_launch", dev, VI_STAGES.index(stage), *args, lead, ptr(scratch), ptr(part), ptr(lam_io),
                    ptr(state_out), ptr(xw_out), ptr(inlier_out))
    VI_LAUNCHES.add(mode=stage, camera=CAMERA_NAMES[kind])


def _segment_kernel(cam, bf, T_cb, prob: VIBAProblem, R_wb, p_wb, v_w, bias, xw, inlier, lam, n_iters: int,
                    cg_iters: int, *, mesh: Mesh, csr):
    f32, f64 = torch.float32, torch.float64
    dev = xw.device
    args, kind, _keep = _vi_args(cam, bf, T_cb, prob, csr, (R_wb, p_wb, v_w, bias), xw, inlier)
    K, M, O, E = args[3:7]
    scratch = torch.empty(vbc.vi_pcg_scratch_doubles(K, M, O, E), dtype=f64, device=dev)
    part = torch.empty(vi_part_doubles(K, M), dtype=f64, device=dev)
    lam_io = torch.zeros(3, dtype=f32, device=dev)  # lam in, then lam | cost | CG iterations run out
    lam_io[0] = lam
    state_out = torch.empty((K, 21), dtype=f32, device=dev)
    xw_out = torch.empty((M, 3), dtype=f32, device=dev)
    lead = int(mesh.rank == 0)

    def stage(name: str, reduce: int = 0) -> None:
        _vi_launch(dev, name, kind, args, lead, scratch, part, lam_io, state_out, xw_out)
        if reduce:
            mesh.all_reduce(part[:reduce])

    stage("begin")
    for _ in range(n_iters):
        stage("obs", vi_part_doubles(K, M))
        stage("landmarks", 42 * K)
        stage("start")
        for _ in range(cg_iters):
            stage("cg_lm", 3 * M)
            stage("cg_zy", 6 * K)
            stage("cg_update")
        stage("backsub", 3 * M)
        stage("candidate", 1)
        stage("commit")
    stage("end")
    s = inr.unpack_state(state_out)
    return s.R, s.p, s.v, s.bias, xw_out, lam_io[0], lam_io[1]


class VIStages(NamedTuple):
    segment: object
    classify: object


VI_DISPATCH = VIStages(lm_segment_vi_shard, classify_vi_shard)
VI_PLAIN = VIStages(lm_segment_vi_shard_plain, vbc.classify_vi_plain)


def _run_vi(mesh: Mesh, st: VIStages, cam, bf, T_cb, shard: VIShard, iters1: int, iters2: int, cg_iters: int):
    """``vi_ba_cg.full_inertial_ba_cg``'s two robust phases (the damping
    1e-4 at each, the chi2 gate after each, no abort flag) on the shard,
    the inlier mask gathered and unpadded."""
    step = functools.partial(st.segment, mesh=mesh, **({} if st is VI_PLAIN else dict(csr=shard.csr)))
    R, p, v, b, xw, inlier, _ = vbc._two_phase(step, st.classify, cam, bf, T_cb, shard.local, iters1, iters2,
                                               cg_iters, VI_SEGMENT, None)
    return R, p, v, b, xw, mesh.all_gather(inlier)[: shard.n_obs]


def make_distributed_vi_ba_cg(mesh: Mesh, cam, bf, T_cb, iters1: int = 5, iters2: int = 8, cg_iters: int = 40,
                              plain: bool = False):
    """FullInertialBA over observation shards for ``mesh``: ``iters1`` LM
    steps, the chi2 gate, ``iters2`` more from the damping 1e-4, the gate
    again, ``cg_iters`` CG iterations a step (``VI_SEGMENT`` steps a
    launch segment).  No abort flag: the caller reads its own once after
    the run, as the JAX package's tracker does.  Returns ``run(shard) ->
    (R_wb, p_wb, v_w, bias, xw, inlier)`` for a ``VIShard``, ``inlier`` the
    whole table's (gathered, unpadded); ``plain`` runs the plain stages on
    any device."""
    st = VI_PLAIN if plain else VI_DISPATCH

    def run(shard: VIShard):
        return _run_vi(mesh, st, cam, bf, T_cb, shard, iters1, iters2, cg_iters)

    return run


def get_distributed_vi_ba_cg(mesh: Mesh, cam, bf, T_cb, iters1: int, iters2: int, cg_iters: int = 40):
    """The inertial tracker's FullInertialBA over the ranks (the JAX
    package's cached factory, whose key omits ``bf``, the intrinsics and
    ``T_cb``): built anew per call."""
    return make_distributed_vi_ba_cg(mesh, cam, bf, T_cb, iters1=iters1, iters2=iters2, cg_iters=cg_iters)


lm_segment_vi_shard.launches = VI_LAUNCHES
classify_vi_shard.launches = VI_LAUNCHES
