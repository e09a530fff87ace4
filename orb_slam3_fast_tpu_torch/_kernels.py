"""Build, load and launch the port's hand-written CUDA kernels.

All ``csrc/*.cu`` sources compile with one ``nvcc`` call into
``_build/libkernels.so`` (a plain C interface, no PyTorch headers, so the
build takes seconds), at first use and again whenever a source is newer than
the library.  The library is loaded with ``ctypes``; every pointer and the
stream are passed as ``c_void_p``.  Each C entry point launches on the
caller's stream and returns ``cudaGetLastError()``; :func:`launch` raises if
that is not ``cudaSuccess``.  There is no fallback: a kernel that does not
build or launch raises.
"""
from __future__ import annotations

import ctypes
import functools
import os
import subprocess
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
LIB_PATH = BUILD_DIR / "libkernels.so"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers, shared memory and spills per kernel, in build()'s output
)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

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
    # xw, uv, inv_sigma2, is_stereo, valid, n, cam (fx,fy,cx,cy,bf), R0, t0,
    # n_rounds, iters, R_out, t_out, inlier_out, n_inl_out, stream
    "pose_lm_launch": [_P, _P, _P, _P, _P, _I, _P, _P, _P, _I, _I, _P, _P, _P, _P, _P],
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
    tmp = BUILD_DIR / f"libkernels.{os.getpid()}.tmp.so"
    srcs = sorted(str(p) for p in SRC_DIR.glob("*.cu"))
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *srcs]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed with code {res.returncode}:\n{res.stdout}{res.stderr}")
    os.replace(tmp, LIB_PATH)
    return time.perf_counter() - t0, res.stdout + res.stderr


@functools.cache
def lib() -> ctypes.CDLL:
    """The loaded kernel library (built first if needed)."""
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


def require_cuda(name: str, **tensors: tuple[torch.Tensor, torch.dtype]) -> None:
    """Raise unless every tensor is a contiguous CUDA tensor of its dtype."""
    for arg, (t, dtype) in tensors.items():
        if t.device.type != "cuda":
            raise ValueError(f"{name}: {arg} must be a CUDA tensor, got {t.device}")
        if t.dtype != dtype:
            raise ValueError(f"{name}: {arg} must be {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")
