"""Host C++ kernels of the map (covisibility counts and matrix, observation
gather, redundancy counts, landmark stats), loaded with ctypes.

Counterpart of ``orb_slam3_fast_tpu/native/__init__.py``.  The source,
``map_ops.cpp`` beside this file, is the port's own copy of the JAX
package's ``native/map_ops.cpp`` (byte for byte; a test holds the two
equal), compiled with ``g++`` into
``orb_slam3_fast_tpu_torch/_build/libmap_ops.so`` at first use.  This is host code, not a
device kernel: where no toolchain is found every function returns None or a
numpy result, and ``WorldMap`` takes the same numpy fallback as the JAX
package.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().parent / "map_ops.cpp"
_SO = Path(__file__).resolve().parents[1] / "_build" / "libmap_ops.so"

_lib = None


def _build() -> bool:
    """Compile into a per-process temporary and move it into place, so that
    processes building at once never load a half-written library."""
    if not _SRC.exists():
        return False
    _SO.parent.mkdir(exist_ok=True)
    tmp = _SO.with_name(f"libmap_ops.{os.getpid()}.tmp.so")
    try:
        subprocess.run(
            ["g++", "-O3", "-march=native", "-shared", "-fPIC", str(_SRC), "-o", str(tmp)],
            check=True, capture_output=True, timeout=120,
        )
    except (OSError, subprocess.SubprocessError):
        return False
    os.replace(tmp, _SO)
    return True


def get_lib():
    """The loaded native library, or None if unavailable."""
    global _lib
    if _lib is not None:
        return _lib if _lib is not False else None
    if not _SO.exists() or (_SRC.exists() and _SO.stat().st_mtime < _SRC.stat().st_mtime):
        if not _build():
            _lib = False
            return None
    try:
        lib = ctypes.CDLL(str(_SO))
    except OSError:
        _lib = False
        return None
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    fp = ctypes.POINTER(ctypes.c_float)
    i64 = ctypes.c_int64
    lib.covis_counts.argtypes = [i32p, i64, i64, i32p, i64, u8p, i64, i32p]
    lib.covis_counts.restype = None
    lib.observations_of.argtypes = [i32p, i64, i64p, i64, i32p, i64, i32p, i32p, i32p, i64]
    lib.observations_of.restype = i64
    lib.redundancy_counts.argtypes = [i32p, i32p, i64, i64p, i64, i32p, i64, i32p, i64, i32p]
    lib.redundancy_counts.restype = None
    lib.covis_matrix.argtypes = [i32p, i64, i64, i64, i32p, i32p, i32p]
    lib.covis_matrix.restype = None
    lib.landmark_stats.argtypes = [i32p, i64, i64, i32p, i64, fp, fp, fp, i32p, i32p, i32p]
    lib.landmark_stats.restype = None
    _lib = lib
    return lib


def _ptr(a: np.ndarray, ct):
    return a.ctypes.data_as(ctypes.POINTER(ct))


def covis_counts(kf_obs: np.ndarray, lm_ids: np.ndarray, scratch: np.ndarray) -> np.ndarray:
    """counts[j] = shared-landmark count of keyframe j with lm_ids."""
    lib = get_lib()
    K, N = kf_obs.shape
    if lib is None:
        return np.isin(kf_obs, lm_ids).sum(axis=1).astype(np.int32)
    out = np.empty(K, dtype=np.int32)
    kf_obs = np.ascontiguousarray(kf_obs, dtype=np.int32)
    lm = np.ascontiguousarray(lm_ids, dtype=np.int32)
    lib.covis_counts(_ptr(kf_obs, ctypes.c_int32), K, N, _ptr(lm, ctypes.c_int32), len(lm),
                     _ptr(scratch, ctypes.c_uint8), len(scratch), _ptr(out, ctypes.c_int32))
    return out


def observations_of(kf_obs: np.ndarray, kf_ids: np.ndarray, lm_local: np.ndarray):
    """COO (kf_local, lm_local, slot) triplets (see WorldMap.observations_of),
    or None without the library."""
    lib = get_lib()
    if lib is None:
        return None
    K_sel = len(kf_ids)
    N = kf_obs.shape[1]
    cap = K_sel * N
    out_kf = np.empty(cap, np.int32)
    out_lm = np.empty(cap, np.int32)
    out_slot = np.empty(cap, np.int32)
    kf_obs = np.ascontiguousarray(kf_obs, dtype=np.int32)
    kf_ids = np.ascontiguousarray(kf_ids, dtype=np.int64)
    lm_local = np.ascontiguousarray(lm_local, dtype=np.int32)
    n = lib.observations_of(_ptr(kf_obs, ctypes.c_int32), N, _ptr(kf_ids, ctypes.c_int64), K_sel,
                            _ptr(lm_local, ctypes.c_int32), len(lm_local), _ptr(out_kf, ctypes.c_int32),
                            _ptr(out_lm, ctypes.c_int32), _ptr(out_slot, ctypes.c_int32), cap)
    return out_kf[:n], out_lm[:n], out_slot[:n]


def covis_matrix(kf_obs: np.ndarray, max_lm: int) -> np.ndarray | None:
    """The (K,K) covisibility matrix (shared landmarks per keyframe pair, 0
    on the diagonal) in one pass; None without the library."""
    lib = get_lib()
    if lib is None:
        return None
    K, N = kf_obs.shape
    kf_obs = np.ascontiguousarray(kf_obs, dtype=np.int32)
    lm_count = np.zeros(max_lm + 1, np.int32)
    lm_list = np.empty(K * N, np.int32)
    out = np.empty((K, K), np.int32)
    lib.covis_matrix(_ptr(kf_obs, ctypes.c_int32), K, N, max_lm, _ptr(lm_count, ctypes.c_int32),
                     _ptr(lm_list, ctypes.c_int32), _ptr(out, ctypes.c_int32))
    return out


def landmark_stats(kf_obs: np.ndarray, lm_local: np.ndarray, centers: np.ndarray, lm_pos: np.ndarray, n_out: int):
    """(normal_sum (n,3), n_obs (n,), first_kf (n,), first_slot (n,)) over
    all keyframes for the landmarks selected by lm_local; None without the
    library."""
    lib = get_lib()
    if lib is None:
        return None
    K, N = kf_obs.shape
    kf_obs = np.ascontiguousarray(kf_obs, dtype=np.int32)
    lm_local = np.ascontiguousarray(lm_local, dtype=np.int32)
    centers = np.ascontiguousarray(centers, dtype=np.float32)
    lm_pos = np.ascontiguousarray(lm_pos, dtype=np.float32)
    normal = np.zeros((n_out, 3), np.float32)
    nobs = np.zeros(n_out, np.int32)
    first_kf = np.full(n_out, -1, np.int32)
    first_slot = np.zeros(n_out, np.int32)
    lib.landmark_stats(_ptr(kf_obs, ctypes.c_int32), K, N, _ptr(lm_local, ctypes.c_int32), len(lm_local),
                       _ptr(centers, ctypes.c_float), _ptr(lm_pos, ctypes.c_float), _ptr(normal, ctypes.c_float),
                       _ptr(nobs, ctypes.c_int32), _ptr(first_kf, ctypes.c_int32), _ptr(first_slot, ctypes.c_int32))
    return normal, nobs, first_kf, first_slot


def redundancy_counts(kf_obs: np.ndarray, kf_level: np.ndarray, kf_sel: np.ndarray,
                      lm_local: np.ndarray, lvl_c: np.ndarray) -> np.ndarray | None:
    """Per landmark of a candidate keyframe: how many of the ``kf_sel``
    keyframes observe it at the same or a finer scale; None without the
    library."""
    lib = get_lib()
    if lib is None:
        return None
    N = kf_obs.shape[1]
    out = np.empty(len(lvl_c), np.int32)
    kf_obs = np.ascontiguousarray(kf_obs, dtype=np.int32)
    kf_level = np.ascontiguousarray(kf_level, dtype=np.int32)
    kf_sel = np.ascontiguousarray(kf_sel, dtype=np.int64)
    lm_local = np.ascontiguousarray(lm_local, dtype=np.int32)
    lvl_c = np.ascontiguousarray(lvl_c, dtype=np.int32)
    lib.redundancy_counts(_ptr(kf_obs, ctypes.c_int32), _ptr(kf_level, ctypes.c_int32), N,
                          _ptr(kf_sel, ctypes.c_int64), len(kf_sel), _ptr(lm_local, ctypes.c_int32), len(lm_local),
                          _ptr(lvl_c, ctypes.c_int32), len(lvl_c), _ptr(out, ctypes.c_int32))
    return out
