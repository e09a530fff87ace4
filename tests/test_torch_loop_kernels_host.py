"""Kernels Z and AA (csrc/pose_graph4.cu, csrc/vi_pcg.cu) compiled for the
host, each CTA emulated with one std::thread per CUDA thread (the harness
of tests/test_torch_vi_kernels_host.py; a launch of several CTAs runs them
one after another, each at its full width; a one-CTA launch runs at most
64 threads, its loops striding by the block's width), through their
wrappers' marshalling, and held against the plain versions on the same
inputs.  The card runs the same sources (chip_smoke.py phase 3)."""
import ctypes
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from orb_slam3_fast_tpu_torch import _kernels
from orb_slam3_fast_tpu_torch.optim import pose_graph as tpg
from orb_slam3_fast_tpu_torch.optim import vi_ba_cg as tcg
from orb_slam3_fast_tpu_torch.utils import convert
from orb_slam3_fast_tpu_torch.utils import lie as tlie
from tests.test_torch_pose_graph4 import graph4
from tests.test_torch_vi_kernels_host import EMULATED_THREADS, _STUB

torch.set_num_threads(1)

SOURCES = ("pose_graph4.cu", "vi_pcg.cu")

_GRID_STUB = _STUB + r"""
#include <cstring>
enum { cudaMemcpyDeviceToDevice = 3 };
inline int cudaMemcpyAsync(void* d, const void* s, std::size_t n, int, cudaStream_t) {
  std::memcpy(d, s, n);
  return 0;
}
inline int cudaMemsetAsync(void* d, int v, std::size_t n, cudaStream_t) {
  std::memset(d, v, n);
  return 0;
}
// A launch of ``grid`` CTAs: one after another, each at its full width; a single CTA at most EMULATED threads.
inline void host_launch_grid(unsigned grid, unsigned threads, unsigned cap, const std::function<void()>& body) {
  for (unsigned b = 0; b < grid; ++b) {
    blockIdx.x = b;
    gridDim.x = grid;
    host_launch(grid == 1 ? std::min(threads, cap) : threads, body);
  }
  blockIdx.x = 0;
}
"""


def _host_source(src: str) -> str:
    """The .cu source with its launches as host_launch_grid calls."""

    def launch(m):
        cfg = [c.strip() for c in re.split(r",(?![^<(]*[>)])", m.group(2))]
        return (f"host_launch_grid((unsigned)({cfg[0]}), (unsigned)({cfg[1]}), {EMULATED_THREADS}u, "
                f"[&] {{ {m.group(1)}({m.group(3)}); }});")

    return re.sub(r"(\w+(?:<[^<>;]*>)?)<<<(.*?)>>>\((.*?)\);", launch, src, flags=re.S)


@pytest.fixture(scope="module")
def host_kernels(tmp_path_factory):
    """The sources built into one host library, and _kernels.launch /
    require_cuda pointed at it for the duration of the module."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to compile the kernels' device code for the host")
    d = tmp_path_factory.mktemp("loop_kernels")
    (d / "cuda_runtime.h").write_text(_GRID_STUB)
    objs, procs = [], []
    for name in SOURCES:
        cpp = d / (name[:-3] + ".cpp")
        cpp.write_text(_host_source((_kernels.SRC_DIR / name).read_text()))
        obj = d / (name[:-3] + ".o")
        procs.append(subprocess.Popen(["g++", "-std=c++20", "-O1", "-fPIC", "-pthread", f"-I{d}",
                                       f"-I{_kernels.SRC_DIR}", "-c", str(cpp), "-o", str(obj)],
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        objs.append(str(obj))
    for p in procs:
        out = p.communicate(timeout=600)[0]
        assert p.returncode == 0, out
    so = d / "libloop_host.so"
    subprocess.run(["g++", "-shared", "-pthread", "-o", str(so), *objs], check=True, capture_output=True, timeout=120)
    lib = ctypes.CDLL(str(so))
    for name, argtypes in _kernels.SIGNATURES.items():
        fn = getattr(lib, name, None)
        if fn is not None:
            fn.argtypes, fn.restype = argtypes, ctypes.c_int

    def launch(name, device, *args):
        err = getattr(lib, name)(*args, None)
        assert err == 0, f"{name}: {err}"

    saved = _kernels.launch, _kernels.require_cuda
    _kernels.launch, _kernels.require_cuda = launch, lambda *a, **k: None
    yield lib
    _kernels.launch, _kernels.require_cuda = saved


@pytest.mark.parametrize("K,force_cg", [(30, False), (30, True), (200, False)])
def test_kernel_z_matches_plain(host_kernels, monkeypatch, K, force_cg):
    """Kernel Z against its plain version on the yaw-drifted circle (K = 30
    dense and, under ``_FORCE_CG``, PCG; K = 200 PCG), 6 iterations: the
    float64 Cholesky and CG against the plain float64 LU and CG, vertices
    stored in float32 between steps: rotation entries and translations
    within 1e-4; the fixed vertex unmoved; ``ok`` set; the launch counted
    in its mode."""
    monkeypatch.setattr(tpg, "_FORCE_CG", force_cg)
    arrays, _ = graph4(K, seed=1 if K == 30 else 3)
    g = tpg.SE3Graph(**{k: torch.as_tensor(v) for k, v in arrays.items()})
    tpg.optimize_4dof_graph.launches.reset()
    out = tpg._kernel_4dof(g, 6, 1e-6)
    R_p, t_p = tpg.optimize_4dof_graph_plain(g, 6)
    mode = "pcg" if force_cg or K > tpg.DENSE_MAX_K else "dense"
    assert tpg.optimize_4dof_graph.launches.total(mode=mode) == 1
    assert bool(out.ok) and (out.cg_run is None) == (mode == "dense")
    np.testing.assert_allclose(out.R.numpy(), R_p.numpy(), atol=1e-4)
    np.testing.assert_allclose(out.t.numpy(), t_p.numpy(), atol=1e-4)
    np.testing.assert_array_equal(out.t[0].numpy(), arrays["t"][0])


def _aa_problem():
    """tests/test_torch_vi_ba.py's tracker-shaped problem (a camera offset
    from the body, stereo edges, outliers, padded fixed states, invalid
    landmarks and padded observations) and its T_cb."""
    from tests.test_torch_vi_ba import tracker_shaped

    prob, _ = tracker_shaped(np.random.default_rng(7))
    R = tlie.so3_exp(torch.tensor([0.01, -0.02, 0.015]))
    return convert.inertial_to_torch(prob), tlie.SE3(R, torch.tensor([0.03, 0.0, -0.02]))


def test_kernel_aa_segment_matches_plain(host_kernels):
    """Kernel AA's segment (3 LM steps, 24 CG iterations) against its plain
    version on the same inputs: both float64 solves, the observations'
    terms in float32: rotation entries within 2e-4, positions within 2e-3
    m, velocities within 1e-2 m/s, biases within 1e-3, landmarks within
    1e-2 m, the damping equal, the starting cost within 1e-4 relative; the
    launch counted as a segment."""
    from tests.test_torch_vi_ba import T_CAM

    pt, T_cb = _aa_problem()
    inl = torch.ones(pt.obs_uv.shape[0], dtype=torch.bool)
    inl[::17] = False
    args = (T_CAM, 40.0, T_cb, pt)
    tcg.lm_segment_vi.launches.reset()
    out_k = tcg._kernel(*args, (pt.R_wb, pt.p_wb, pt.v_w, pt.bias), pt.xw, inl, torch.tensor(1e-4), 3, 24)
    out_p = tcg.lm_segment_vi_plain(*args, pt.R_wb, pt.p_wb, pt.v_w, pt.bias, pt.xw, inl, torch.tensor(1e-4), 3, 24)
    assert tcg.lm_segment_vi.launches.total(mode="segment") == 1
    for name, tol, a, b in zip(("R", "p", "v", "bias", "xw"), (2e-4, 2e-3, 1e-2, 1e-3, 1e-2), out_k[:5], out_p[:5]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=tol, err_msg=name)
    assert float(out_k[5]) == float(out_p[5])
    assert float(out_k[6]) == pytest.approx(float(out_p[6]), rel=1e-4)


def test_kernel_aa_classify_matches_plain(host_kernels):
    """Kernel AA's classification entry against classify_vi's plain version:
    the same mask but for observations within 1e-3 of the chi2 gate."""
    from tests.test_torch_vi_ba import T_CAM

    pt, T_cb = _aa_problem()
    xw = pt.xw + 0.02 * torch.sin(torch.arange(pt.xw.numel(), dtype=torch.float32)).view(-1, 3)
    k = tcg._kernel(T_CAM, 40.0, T_cb, pt, (pt.R_wb, pt.p_wb, None, None), xw, None, None, 0, 0)
    q = tcg.classify_vi_plain(T_CAM, 40.0, T_cb, pt, pt.R_wb, pt.p_wb, xw)
    assert 0 < int(q.sum()) < len(q)
    assert int((k != q).sum()) <= 2
