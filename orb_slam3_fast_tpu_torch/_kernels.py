"""Build, load and launch the port's hand-written CUDA kernels.

Each ``csrc/*.cu`` source compiles with its own ``nvcc`` process, all
started together, and one more ``nvcc`` links the objects into
``_build/libkernels.so`` (a plain C interface, no PyTorch headers, so the
build takes seconds), at first use and again whenever a source is newer than
the library.  The library is loaded with ``ctypes``; every pointer and the
stream are passed as ``c_void_p``.  Each C entry point launches on the
caller's stream and returns ``cudaGetLastError()``; :func:`launch` raises if
that is not ``cudaSuccess``.  There is no fallback: a kernel that does not
build or launch raises.

Each wrapper counts its launches in a :class:`LaunchCounter`, which is safe
under threads and keeps the counts per thread name, so that a run of the
asynchronous System can show which thread (``slam-backend``, ``slam-gba``
or the tracker's) launched which kernel.
"""
from __future__ import annotations

import collections
import concurrent.futures
import ctypes
import functools
import os
import subprocess
import threading
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
LIB_PATH = BUILD_DIR / "libkernels.so"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers, shared memory and spills per kernel, in build()'s output
)

_P, _I, _F, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_double

# C signature of every entry point (all return a cudaError_t as int).
SIGNATURES = {
    # img, raw, raw_inb, nms, h, w, border, ini_th, min_th, stream
    "fast_nms_launch": [_P, _P, _P, _P, _I, _I, _I, _F, _F, _P],
    # img_flat, blur_flat, kp_off (int64), kp_w, kp_xy, pattern, umax, n,
    # angle_out, desc_out, stream
    "orb_describe_launch": [_P, _P, _P, _P, _P, _P, _P, _I, _P, _P, _P],
    # desc_a, desc_b, n, m, mode, row_f, col_f, max_disp, idx, dist, dist2,
    # idx2, col_key, stream
    "hamming_best2_launch": [_P, _P, _I, _I, _I, _P, _P, _F, _P, _P, _P, _P, _P, _P],
    # xw, uv, inv_sigma2, is_stereo, valid, n, cam10 (optim/pose_opt.kernel_camera),
    # kind (0 pin-hole, 1 radtan, 2 KB8), R0, t0, n_rounds, iters, R_out, t_out, inlier_out, n_inl_out, stream
    "pose_lm_launch": [_P, _P, _P, _P, _P, _I, _P, _I, _P, _P, _I, _I, _P, _P, _P, _P, _P],
    # cam10, kind, R, t, xw, pose_fixed, lm_valid, obs_kf, obs_lm, obs_uv,
    # inv_sigma2, is_stereo, obs_valid, inlier, n_obs, n_kf, n_lm, W, acc
    # (float64 sums), out (Hpp | Hll | bp | bl | w_lm | cost), stream
    "ba_blocks_launch": [_P, _I] + [_P] * 12 + [_I] * 3 + [_P] * 4,
    # Hpp, Hll, bp, bl, W, w_lm, pose_fixed, lm_valid, obs_kf, lm_ptr,
    # lm_obs, lam, n_poses, n_lm, n_obs, S, bs, dp, dl, ok, stream
    "ba_schur_launch": [_P] * 12 + [_I] * 3 + [_P] * 6,
    # cam10, kind, R, t, xw, dp, dl, lm_valid, obs_kf, obs_lm, obs_uv, inv_sigma2, is_stereo, obs_valid, inlier,
    # cost_old, ok (kernel F's byte, or null), lam, n_obs, n_kf, n_lm, R_out, t_out, xw_out, lam_out, accept_out,
    # cost_out, acc (one float64), stream
    "ba_lm_update_launch": [_P, _I] + [_P] * 16 + [_I] * 3 + [_P] * 8,
    # cam10, kind, R, t, xw, obs_kf, obs_lm, obs_uv, inv_sigma2, is_stereo, obs_valid, n_obs, inlier_out, stream
    "ba_classify_launch": [_P, _I] + [_P] * 9 + [_I] + [_P] * 2,
    # P0, P1, x0, x1, n, X, stream
    "triangulate_dlt_launch": [_P, _P, _P, _P, _I, _P, _P],
    # img, shapes (host), offs (host), n_levels, taps (host), img_flat,
    # blur_flat, stream
    "pyramid_blur_launch": [_P, _P, _P, _I, _P, _P, _P, _P],
    # nms, raw, shapes, offs, n_sel, scales (host), n_levels, cell, K,
    # border, cand_v, cand_i, xy_lvl, xy, resp, valid, stream
    "select_subpixel_launch": [_P] * 6 + [_I] * 4 + [_P] * 7,
    # img_l, img_r, h, w, xy_l, right_u, valid, n, u_out, ok_out, stream
    "sad_refine_launch": [_P, _P, _I, _I, _P, _P, _P, _I, _P, _P, _P],
    # R, t, pos, mask, normal, dmin, dmax, m, cam_params (host), kind, width,
    # height, log_sf, n_lvl, uv, level, visible, stream
    "visible_landmarks_launch": [_P] * 7 + [_I, _P, _I, _F, _F, _F, _I, _P, _P, _P, _P],
    # uv0, uv1, valid, samples, n, n_hyp, cam10 (host; optim/pose_opt.kernel_camera), kind, min_triangulated,
    # min_parallax_deg, x0, x1, sigma2, hyp, hyp_score, model, model_score, inl, Rall, tall, X, tri, n_good,
    # parallax, qual, success, used_h, R, t, X_out, good, stream
    "twoview_ransac_launch": [_P] * 4 + [_I, _I, _P, _I, _I, _F] + [_P] * 22,
    # uv0, uv1, n, cam10 (host), kind, x0, x1, sigma2, stream
    "twoview_unproject_launch": [_P, _P, _I, _P, _I] + [_P] * 4,
    # Rall, tall, X, tri, n_good, parallax, qual, model_score, valid, inl, n, min_triangulated, min_parallax_deg,
    # success, used_h, R, t, X_out, good, stream
    "twoview_verdict_launch": [_P] * 10 + [_I, _I, _F] + [_P] * 7,
    # centroids, alive, weights, B, depth, node_lvl, desc, valid, n, n_words,
    # words, nodes, bow, total, stream
    "vocab_transform_launch": [_P] * 3 + [_I] * 3 + [_P, _P, _I, _I] + [_P] * 5,
    # xw, uv, xn, inv_sigma2, valid, subsets, n, n_hyp, cam9 (host), kind,
    # min_inliers, hyp_R, hyp_t, counts, R, t, inliers, n_inl, ok, stream
    "pnp_ransac_launch": [_P] * 6 + [_I, _I, _P, _I, _I] + [_P] * 9,
    # xc1, xc2, uv1, uv2, is1, is2, valid, subsets, n, n_hyp, cams18 (host,
    # optim/sim3._cams18), kind, fix_scale, min_inliers, hyp, counts, S,
    # inliers, n_inl, ok, stream
    "sim3_ransac_launch": [_P] * 8 + [_I, _I, _P, _I, _I, _I] + [_P] * 7,
    # xc1, xc2, uv1, uv2, is1, is2, valid, S0, n, cams18 (host), kind,
    # fix_scale, iters, chi2, S, inliers, n_inl, stream
    "sim3_refine_launch": [_P] * 8 + [_I, _P, _I, _I, _I, _F] + [_P] * 4,
    # vertices, edge_i, edge_j, meas, w, fixed, K, E, iters, damping,
    # vertices_out, jac, H, vec, fail, stream
    "sim3_graph_launch": [_P] * 6 + [_I] * 3 + [_D] + [_P] * 6,
    # vertices, edge_i, edge_j, meas, w, fixed, vptr, vlist, K, E, iters,
    # cg_iters, damping, vertices_out, jac, blk, dinv, vec, cg_run, fail, stream
    "sim3_pcg_launch": [_P] * 8 + [_I] * 4 + [_D] + [_P] * 8,
    # vertices, edge_i, edge_j, meas, w, fixed, vptr, vlist, K, E, iters, pcg, cg_iters, damping,
    # vertices_out, jac, H, vec, cg_run, fail, stream
    "pose_graph4_launch": [_P] * 8 + [_I] * 5 + [_D] + [_P] * 7,
    # Hpp, Hll, bp, bl, W, w_lm, pose_fixed, lm_valid, obs_kf, obs_lm,
    # lm_ptr, lm_obs, kf_ptr, kf_obs, lam, K, M, O, cg_iters, scratch, dp,
    # dl, stream
    "ba_pcg_launch": [_P] * 15 + [_I] * 4 + [_P] * 4,
    # kernel AF (csrc/ba_shard.cu): cam10, kind, R, t, xw, pose_fixed, lm_valid, obs_kf, obs_lm, obs_uv, inv_sigma2,
    # is_stereo, obs_valid, inlier, n_obs, n_kf, n_lm, W, acc (float64, unrounded), stream
    "ba_shard_blocks_launch": [_P, _I] + [_P] * 12 + [_I] * 3 + [_P] * 3,
    # acc, out, n, stream
    "ba_shard_round_launch": [_P, _P, _I, _P],
    # cam10, kind, R, t, xw, dp, dl, lm_valid, obs_kf, obs_lm, obs_uv, inv_sigma2, is_stereo, obs_valid, inlier,
    # n_obs, n_kf, n_lm, R_out, t_out, xw_out, acc (one float64), stream
    "ba_shard_cost_launch": [_P, _I] + [_P] * 13 + [_I] * 3 + [_P] * 5,
    # R, t, xw, n_kf, n_lm, acc, cost_old, ok (or null), lam, R_out, t_out, xw_out, lam_out, accept_out, cost_out,
    # stream
    "ba_shard_commit_launch": [_P] * 3 + [_I] * 2 + [_P] * 11,
    # Hll, bl, w_lm, lam, W, obs_lm, kf_ptr, kf_obs, K, M, scratch, part (K,42), stream
    "ba_shard_cg_setup_launch": [_P] * 8 + [_I] * 2 + [_P] * 3,
    # Hpp, bp, pose_fixed, lam, part (K,42), K, M, scratch, stream
    "ba_shard_cg_start_launch": [_P] * 5 + [_I] * 2 + [_P] * 2,
    # W, obs_kf, lm_ptr, lm_obs, pose_fixed, which (0 p, 1 x), K, M, scratch, part (M,3), stream
    "ba_shard_cg_lm_launch": [_P] * 5 + [_I] * 3 + [_P] * 3,
    # W, obs_lm, kf_ptr, kf_obs, part_m (M,3), K, M, scratch, part_k (K,6), stream
    "ba_shard_cg_pose_launch": [_P] * 5 + [_I] * 2 + [_P] * 3,
    # pose_fixed, part_k (K,6), K, M, scratch, stream
    "ba_shard_cg_update_launch": [_P] * 2 + [_I] * 2 + [_P] * 2,
    # bl, w_lm, lm_valid, pose_fixed, part_m (M,3), K, M, scratch, dp, dl, stream
    "ba_shard_cg_backsub_launch": [_P] * 5 + [_I] * 2 + [_P] * 4,
    # kernel AE (csrc/kfdb_score.cu): ids, w, lut, n_rows, T, n_words, common, score, stream
    "kfdb_score_launch": [_P] * 3 + [_I] * 3 + [_P] * 3,
    # start (packed window or null), bias, acc, gyro, dts, valid, n, noise (host), out, stream
    "imu_preint_launch": [_P] * 6 + [_I, _P, _P, _P],
    # a, b (packed windows), out, stream
    "imu_compose_launch": [_P] * 4,
    # cam10, kind, tcb, s_prev, pk, s0, prior, last, xw, uv, inv_sigma2, is_stereo, valid, n, n_rounds, iters,
    # state_out, inlier, n_inl, H_out, stream
    "pose_inertial_launch": [_P, _I] + [_P] * 5 + [_I] + [_P] * 5 + [_I] * 3 + [_P] * 5,
    # R, p, pk, edge_valid, vel, bias, K, prior (host), iters, fix_scale, refine, work, out, stream
    "imu_init_launch": [_P] * 6 + [_I, _P, _I, _I, _I, _P, _P, _P],
    # cam10, kind, tcb, K, M, O, E, R, p, v, bias, fixed, xw, lm_valid, obs_kf, obs_lm, uv, inv_sigma2,
    # is_stereo, obs_valid, edge_i, edge_j, edge_valid, pk, lm_ptr, lm_obs, kf_ptr, kf_obs, ke_ptr, ke_edge,
    # free_ids, free_pos, nf, iters1, iters2, scratch, state_out, xw_out, inlier, stream
    "vi_ba_launch": [_P, _I, _P] + [_I] * 4 + [_P] * 25 + [_I] * 3 + [_P] * 5,
    # cam10, kind, tcb, K, M, O, E, R, p, v, bias, fixed, xw, lm_valid, obs_kf, obs_lm, uv, inv_sigma2,
    # is_stereo, obs_valid, edge_i, edge_j, edge_valid, pk, lm_ptr, lm_obs, kf_ptr, kf_obs, ke_ptr, ke_edge,
    # inlier, n_iters, cg_iters, scratch, lam_io, state_out, xw_out, inlier_out, stream
    "vi_pcg_launch": [_P, _I, _P] + [_I] * 4 + [_P] * 24 + [_I] * 2 + [_P] * 6,
    # xy_l, level_l, xy_r, level_r, idx, dist, dist2, col, sigma2, n, cams16 (host), Rt (host), ratio, th,
    # min_cos, depth, x3d, valid, stream
    "fisheye_stereo_launch": [_P] * 9 + [_I, _P, _P, _F, _I, _F] + [_P] * 4,
    # n, m, flags, idx (int64), dist, dist2, dist_f32, col (int64), angle_a, angle_b, xy_l, xy_r, th, ratio, bf,
    # accept, right_u, depth, stream
    "match_epilogue_launch": [_I] * 3 + [_P] * 3 + [_I] + [_P] * 5 + [_F] * 3 + [_P] * 4,
}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME  # CUDA_HOME / CUDA_PATH, PATH, or the default install

    if CUDA_HOME is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def _stale() -> bool:
    if not LIB_PATH.exists():
        return True
    newest = max(p.stat().st_mtime for p in SRC_DIR.glob("*.cu*"))
    return LIB_PATH.stat().st_mtime < newest


def build() -> tuple[float, str]:
    """Compile the kernels if the library is missing or stale.  Returns
    (seconds, compiler output); (0.0, "") when the library is current."""
    if not _stale():
        return 0.0, ""
    BUILD_DIR.mkdir(exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    tmp = BUILD_DIR / f"libkernels.{tag}.so"
    srcs = sorted(SRC_DIR.glob("*.cu"))
    objs = [BUILD_DIR / f"{p.stem}.{tag}.o" for p in srcs]
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = [
        subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(p)], stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True)
        for p, o in zip(srcs, objs)
    ]
    def finish(proc):  # each compiler's output and the seconds until it finished (a thread each: no pipe fills)
        return proc.communicate()[0], time.perf_counter() - t0

    with concurrent.futures.ThreadPoolExecutor(len(procs)) as pool:
        results = list(pool.map(finish, procs))
    out, failed = [], []
    for p, proc, (text, secs) in zip(srcs, procs, results):
        out.append(f"== {p.name} ({secs:.1f} s)\n{text}")
        if proc.returncode != 0:
            failed.append(p.name)
    try:
        if failed:
            raise RuntimeError(f"nvcc failed on {', '.join(failed)}:\n" + "".join(out))
        link = subprocess.run([nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(tmp), *map(str, objs)],
                              capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed with code {link.returncode}:\n{link.stdout}{link.stderr}")
        os.replace(tmp, LIB_PATH)
    finally:
        for o in objs:
            o.unlink(missing_ok=True)
    return time.perf_counter() - t0, "".join(out)


_BUILD_LOCK = threading.Lock()  # one build at a time: the tracker and the backend threads may ask at once


@functools.cache
def lib() -> ctypes.CDLL:
    """The loaded kernel library (built first if needed)."""
    with _BUILD_LOCK:
        build()
    so = ctypes.CDLL(str(LIB_PATH))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(so, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    so.kernels_error_string.argtypes = [ctypes.c_int]
    so.kernels_error_string.restype = ctypes.c_char_p
    so.kernels_set_device.argtypes = [ctypes.c_int]
    so.kernels_set_device.restype = ctypes.c_int
    return so


def _check(so: ctypes.CDLL, name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err}: {so.kernels_error_string(err).decode()}")


def launch(name: str, device: torch.device, *args) -> None:
    """Call C entry point ``name`` on ``device`` and PyTorch's current stream
    there; raise on a launch error."""
    so = lib()
    index = device.index if device.index is not None else torch.cuda.current_device()
    _check(so, "kernels_set_device", so.kernels_set_device(index))
    _check(so, name, getattr(so, name)(*args, torch.cuda.current_stream(index).cuda_stream))


class LaunchCounter:
    """The launches of one kernel's wrapper, counted per (thread name, mode,
    camera instance) under a lock so that concurrent threads lose no count.
    The wrapper calls :meth:`add` where it launches its kernel and nowhere
    else; a kernel with camera instances (``csrc/camera.cuh``) names the
    one it launched: "" (pin-hole), "radtan" or "kb8"."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counts: collections.Counter = collections.Counter()

    def add(self, mode: str = "", camera: str = "") -> None:
        key = (threading.current_thread().name, mode, camera)
        with self._lock:
            self._counts[key] += 1

    def reset(self) -> None:
        with self._lock:
            self._counts.clear()

    def total(self, thread: str | None = None, mode: str | None = None, camera: str | None = None) -> int:
        """Launches in all, or those of one thread name, mode and / or
        camera instance."""
        with self._lock:
            return sum(n for (t, m, c), n in self._counts.items()
                       if (thread is None or t == thread) and (mode is None or m == mode)
                       and (camera is None or c == camera))

    def by_thread(self) -> dict[str, int]:
        with self._lock:
            out: dict[str, int] = {}
            for (t, _, _), n in self._counts.items():
                out[t] = out.get(t, 0) + n
            return out


def resolve_device(device: torch.device | str) -> torch.device:
    """The device an entry point runs on.  ``"cuda"`` (the default of
    ``System``, ``Tracker``, ``Mapper`` and ``StereoTrackingStep``) raises
    when PyTorch sees no CUDA card: the CPU is taken only when asked for."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {str(dev)!r}: PyTorch sees no CUDA card; pass device='cpu' to run on the CPU "
                           "with the kernels' plain versions")
    return dev


def require_cuda(name: str, **tensors: tuple[torch.Tensor, torch.dtype]) -> None:
    """Raise unless every tensor is a contiguous CUDA tensor of its dtype."""
    for arg, (t, dtype) in tensors.items():
        if t.device.type != "cuda":
            raise ValueError(f"{name}: {arg} must be a CUDA tensor, got {t.device}")
        if t.dtype != dtype:
            raise ValueError(f"{name}: {arg} must be {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")
