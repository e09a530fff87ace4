"""Kernel AD (csrc/match_epilogue.cu) compiled for the host through the
emulated-CTA harness of tests/test_torch_fisheye_kernels_host.py (one
std::thread per CUDA thread; its one CTA at 64 threads, every loop striding
by the block's width), and held through its wrapper's marshalling against
``match_epilogue_plain`` at every search's stage set, on the seeded and the
tie-heavy inputs of ``chip_smoke.epilogue_case``: the masks, right u and
depth equal bit for bit.  Also the buffers past 48 KB, in the opted-in
shared memory: the dedup over 7000 columns and the median's sort of 16384
stereo rows, every one accepted; and a search past the opt-in limit
refused.  The card runs the same source
(tests/test_torch_kernels.py's cuda cases, chip_smoke.py phase 3)."""
import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

import chip_smoke
from orb_slam3_fast_tpu_torch import _kernels
from orb_slam3_fast_tpu_torch.ops import hamming as tham
from tests.test_torch_fisheye_kernels_host import _FISHEYE_STUB
from tests.test_torch_loop_kernels_host import _host_source

torch.set_num_threads(1)

_EPILOGUE_STUB = _FISHEYE_STUB + r"""
inline unsigned __float_as_uint(float x) {
  unsigned u;
  std::memcpy(&u, &x, sizeof u);
  return u;
}
inline unsigned long long atomicMin(unsigned long long* p, unsigned long long v) {
  std::lock_guard<std::mutex> lock(g_atomic);
  const unsigned long long old = *p;
  if (v < old) *p = v;
  return old;
}
inline int atomicAdd(int* p, int v) {
  std::lock_guard<std::mutex> lock(g_atomic);
  const int old = *p;
  *p += v;
  return old;
}
inline unsigned long long g_dyn_u64[227 * 128];  // the 227 KB of opted-in dynamic shared memory
"""


@pytest.fixture(scope="module")
def host_kernels(tmp_path_factory):
    """match_epilogue.cu built into a host library, and _kernels.launch /
    require_cuda pointed at it for the module."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to compile the kernel's device code for the host")
    d = tmp_path_factory.mktemp("epilogue_kernel")
    (d / "cuda_runtime.h").write_text(_EPILOGUE_STUB)
    src = (_kernels.SRC_DIR / "match_epilogue.cu").read_text()
    src = src.replace("extern __shared__ unsigned long long keys[];", "unsigned long long* keys = g_dyn_u64;")
    cpp = d / "match_epilogue.cpp"
    cpp.write_text(_host_source(src))
    so = d / "libmatch_epilogue_host.so"
    out = subprocess.run(["g++", "-std=c++20", "-O1", "-fPIC", "-shared", "-pthread", f"-I{d}", str(cpp), "-o",
                          str(so)], capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stdout + out.stderr
    lib = ctypes.CDLL(str(so))
    fn = lib.match_epilogue_launch
    fn.argtypes, fn.restype = _kernels.SIGNATURES["match_epilogue_launch"], ctypes.c_int

    def launch(name, device, *args):
        err = getattr(lib, name)(*args, None)
        assert err == 0, f"{name}: {err}"

    saved = _kernels.launch, _kernels.require_cuda
    _kernels.launch, _kernels.require_cuda = launch, lambda *a, **k: None
    yield lib
    _kernels.launch, _kernels.require_cuda = saved


def check(kind, case):
    """The emulated kernel against the plain version on one case; returns
    the accept mask."""
    b, th, kw = chip_smoke.epilogue_inputs(case, kind, "cpu")
    n0 = tham.match_epilogue.launches.total()
    k = tham._epilogue_kernel(b, th, kw["inclusive"], kw["ratio"], kw.get("col"), kw.get("dedup_m"), kw.get("angles"),
                              kw.get("stereo"))
    p = tham.match_epilogue_plain(b, th, **kw)
    assert tham.match_epilogue.launches.total() == n0 + 1
    assert chip_smoke.epilogues_equal(k, p), kind
    return k[2] if isinstance(k, tuple) else k


@pytest.mark.parametrize("ties", [False, True], ids=["seeded", "tie-heavy"])
@pytest.mark.parametrize("kind", list(chip_smoke.EPILOGUES))
def test_kernel_matches_plain(host_kernels, kind, ties):
    """Every search's stage set, seeded and tie-heavy, 96 rows over 80
    columns: the emulated kernel's outputs equal the plain version's."""
    acc = check(kind, chip_smoke.epilogue_case(np.random.default_rng(5), kind, 96, 96 if kind == "stereo" else 80,
                                               ties))
    assert 0 < int(acc.sum()) < 96


@pytest.mark.parametrize("kind, n, m", [("projection", 1024, 7000), ("stereo", 16384, 16384)])
def test_kernel_opt_in_shared_memory(host_kernels, kind, n, m):
    """The dedup keys of 7000 columns (56 KB) and the sort of 16384 stereo
    rows (64 KB), past 48 KB of shared memory: the same outputs as the plain
    version; the stereo case is tie-heavy, every slot accepted before the
    median."""
    case = chip_smoke.epilogue_case(np.random.default_rng(9), kind, n, m, ties=kind == "stereo")
    acc = check(kind, case)
    assert 0 < int(acc.sum()) < n


@pytest.mark.parametrize("flags, n, m", [(tham._AD_DEDUP, 64, 28929), (tham._AD_STEREO, 32769, 0)],
                         ids=["dedup", "sort"])
def test_kernel_refuses_past_opt_in_limit(host_kernels, flags, n, m):
    """One column past the 28,928 dedup keys, one row past the sort of
    32,768 stereo rows: the entry returns cudaErrorInvalidValue before it
    launches, so the wrapper raises."""
    args = [None] * 3 + [0] + [None] * 5 + [10.0, 0.0, 1.0] + [None] * 4
    assert host_kernels.match_epilogue_launch(n, m, flags, *args) == 1
