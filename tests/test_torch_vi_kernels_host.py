"""Kernels V, W, X and Y (csrc/imu_preint.cu, pose_inertial.cu, imu_init.cu,
vi_ba.cu) compiled for the host and run as one emulated CTA of at most 64
threads -- one std::thread per CUDA thread, __syncthreads and __syncwarp
as barriers, warp shuffles through an exchange buffer -- through their
wrappers' marshalling, and held against the plain versions on the same
inputs.  The
card runs the same sources (tests/test_torch_kernels.py's cuda cases and
chip_smoke.py); this shows here what their device code computes."""
import ctypes
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from orb_slam3_fast_tpu_torch import _kernels
from orb_slam3_fast_tpu_torch.imu import preintegration as tpre
from orb_slam3_fast_tpu_torch.optim import imu_init as tinit
from orb_slam3_fast_tpu_torch.optim import inertial as tinr
from orb_slam3_fast_tpu_torch.optim import vi_ba as tvb
from orb_slam3_fast_tpu_torch.utils import convert
from orb_slam3_fast_tpu_torch.utils import lie as tlie

torch.set_num_threads(1)

SOURCES = ("imu_preint.cu", "pose_inertial.cu", "pose_inertial_radtan.cu", "pose_inertial_kb8.cu", "imu_init.cu",
           "vi_ba.cu")
# The emulated CTA's width: the kernels stride every loop over the block, so 64 threads compute what the card's
# 256 or 512 do (with more items a thread); V runs as its one warp.
EMULATED_THREADS = 64

_STUB = r"""
#pragma once
#include <algorithm>
#include <barrier>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <functional>
#include <memory>
#include <thread>
#include <vector>
using std::sqrt; using std::fabs; using std::exp; using std::expm1; using std::log; using std::atan2;
using std::sin; using std::cos; using std::fmax; using std::fmin; using std::isfinite; using std::isnan;
using std::max; using std::min;
inline float sqrtf(float x) { return std::sqrt(x); }
inline float sinf(float x) { return std::sin(x); }
inline float cosf(float x) { return std::cos(x); }
inline float fabsf(float x) { return std::fabs(x); }
inline float fmaxf(float a, float b) { return std::fmax(a, b); }
inline float nanf(const char*) { return NAN; }
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__ static
typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1, cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
inline int cudaGetLastError() { return 0; }
template <class F> int cudaFuncSetAttribute(F, int, int) { return 0; }
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fsub_rn(float a, float b) { return a - b; }
struct HostDim { unsigned x = 0, y = 0, z = 0; };
inline thread_local HostDim threadIdx;
inline HostDim blockDim, blockIdx, gridDim;
inline std::barrier<>* g_block;
inline std::vector<std::unique_ptr<std::barrier<>>> g_warps;
inline double g_xchg[2][1024];
inline thread_local unsigned g_shfl_calls;
inline double g_dyn[1 << 17];
inline void __syncthreads() { g_block->arrive_and_wait(); }
inline void __syncwarp(unsigned = 0xFFFFFFFFu) { g_warps[threadIdx.x / 32]->arrive_and_wait(); }
// One barrier a shuffle: consecutive shuffles of a warp alternate between two exchange buffers, and a lane
// rewrites one only after the next shuffle's barrier, which every lane reaches after reading it.
template <class T> T shfl_at(T v, int src_lane) {
  const unsigned t = threadIdx.x, base = t & ~31u;
  double* x = g_xchg[g_shfl_calls++ & 1];
  x[t] = (double)v;
  g_warps[t / 32]->arrive_and_wait();
  const T out = src_lane >= 0 && src_lane < 32 ? (T)x[base + src_lane] : v;
  return out;
}
template <class T> T __shfl_down_sync(unsigned, T v, int o) { return shfl_at(v, (int)(threadIdx.x & 31) + o); }
template <class T> T __shfl_xor_sync(unsigned, T v, int o) { return shfl_at(v, (int)((threadIdx.x & 31) ^ o)); }
inline void host_launch(unsigned threads, const std::function<void()>& body) {
  std::barrier<> block(threads);
  g_block = &block;
  g_warps.clear();
  for (unsigned w = 0; w < (threads + 31) / 32; ++w)
    g_warps.emplace_back(new std::barrier<>(std::min(32u, threads - 32 * w)));
  blockDim.x = threads;
  std::vector<std::thread> pool;
  for (unsigned i = 0; i < threads; ++i)
    pool.emplace_back([i, &body] { threadIdx.x = i; body(); });
  for (auto& t : pool) t.join();
}
"""


def _host_source(src: str) -> str:
    """The .cu source with its launches as host_launch calls and dynamic
    shared memory from a host buffer."""
    src = src.replace("extern __shared__ double smem[];", "double* smem = g_dyn;")

    def launch(m):
        cfg = [c.strip() for c in re.split(r",(?![^<(]*[>)])", m.group(2))]
        threads = f"std::min<unsigned>({cfg[1]}, {EMULATED_THREADS})"
        return f"host_launch({threads}, [&] {{ {m.group(1)}({m.group(3)}); }});"

    return re.sub(r"(\w+(?:<[^<>;]*>)?)<<<(.*?)>>>\((.*?)\);", launch, src, flags=re.S)


@pytest.fixture(scope="module")
def host_kernels(tmp_path_factory):
    """The four sources built into one host library, and _kernels.launch /
    require_cuda pointed at it for the duration of the module."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to compile the kernels' device code for the host")
    d = tmp_path_factory.mktemp("vi_kernels")
    (d / "cuda_runtime.h").write_text(_STUB)
    objs = []
    procs = []
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
    so = d / "libvi_host.so"
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


def _window(rng, n=64, n_valid=None):
    acc = (rng.normal(size=(n, 3)) * 2.0 + np.array([0, 0, 9.81])).astype(np.float32)
    gyro = (rng.normal(size=(n, 3)) * 0.3).astype(np.float32)
    dts = np.full(n, 1.0 / 200.0, np.float32)
    valid = np.arange(n) < (n if n_valid is None else n_valid)
    return tuple(torch.as_tensor(a) for a in (acc, gyro, dts, valid))


NOISE = tpre.ImuNoise.from_continuous(1.7e-4, 2e-3, 1.9e-5, 3e-3, 200.0)


def _close_preint(a, b, atol=1e-5, rtol_c=1e-4):
    for f in ("dT", "dR", "dV", "dP", "JRg", "JVg", "JVa", "JPg", "JPa", "bias"):
        np.testing.assert_allclose(getattr(a, f).numpy(), getattr(b, f).numpy(), atol=atol, err_msg=f)
    Cb = b.C.numpy()
    np.testing.assert_allclose(a.C.numpy(), Cb, atol=rtol_c * np.abs(Cb).max())


def test_kernel_v_matches_plain(host_kernels):
    """Kernel V (float32 scan, float64 SVD) against the plain scan: deltas
    and Jacobians within 1e-5, the covariance within 1e-4 of its largest
    entry; merge and compose likewise; NaN in, NaN out."""
    rng = np.random.default_rng(0)
    acc, gyro, dts, valid = _window(rng, 64, 50)
    bias = torch.as_tensor((rng.normal(size=6) * 0.01).astype(np.float32))
    k = tpre._launch(None, bias, acc, gyro, dts, valid, NOISE, "")
    p = tpre.preintegrate_plain(acc, gyro, dts, bias, NOISE, valid)
    _close_preint(k, p)
    acc2, gyro2, dts2, valid2 = _window(rng, 32)
    km = tpre._launch(tpre.pack(p), p.bias, acc2, gyro2, dts2, valid2, NOISE, "merge")
    _close_preint(km, tpre.merge_plain(p, acc2, gyro2, dts2, NOISE, valid2))
    p2 = tpre.preintegrate_plain(acc2, gyro2, dts2, bias, NOISE)
    _close_preint(tpre._compose_kernel(p, p2), tpre.compose_plain(p, p2))
    acc[3, 0] = float("nan")
    gyro[9, 2] = float("inf")
    bad = tpre._launch(None, bias, acc, gyro, dts, valid, NOISE, "")
    assert not torch.isfinite(bad.dR).all() and not torch.isfinite(bad.dV).all()


def _w_problem(seed, n=160):
    from tests.test_torch_inertial import T_CAM, scenario, t_cb_pair

    preint, s_prev, s_true, s0, obs = scenario(seed, n=n)
    to = convert.inertial_to_torch
    return T_CAM, t_cb_pair()[1], to(preint), to(s_prev), to(s0), to(obs)


@pytest.mark.parametrize("form", ["anchored", "prior", "last_frame"])
def test_kernel_w_matches_plain(host_kernels, form):
    """Kernel W against its plain version (2 rounds of 4 iterations, the
    emulated CTA's barriers being slow): float64 sums and solve against
    float32 ones: rotation entries within 2e-4,
    positions within 2e-3 m, velocities within 5e-3 m/s, biases within
    1e-3, at most 2 edges classified otherwise, H within 1e-3 of its
    largest entry."""
    cam, T_cb, preint, s_prev, s0, obs = _w_problem({"anchored": 0, "prior": 1, "last_frame": 2}[form])
    prior = None
    if form != "anchored":
        prior = tinr.PriorState(state=s_prev._replace(p=s_prev.p + 0.01),
                                H=torch.diag(torch.linspace(10.0, 1e3, 15)))
    last = form == "last_frame"
    sk, ik, nk, Hk = tinr._launch(cam, 40.0, T_cb, s_prev, prior, preint, s0, obs, last, 2, 4)
    if last:
        sp, ip, np_, Hp = tinr.pose_inertial_optimization_last_frame_plain(cam, 40.0, T_cb, s_prev, prior, preint,
                                                                            s0, obs, 2, 4)
    else:
        sp, ip, np_, Hp = tinr.pose_inertial_optimization_plain(cam, 40.0, T_cb, s_prev, preint, s0, obs, prior,
                                                                2, 4)
    for a, b, tol in zip(sk, sp, (2e-4, 2e-3, 5e-3, 1e-3)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=tol)
    assert int((ik != ip).sum()) <= 2 and abs(int(nk) - int(np_)) <= 2
    np.testing.assert_allclose(Hk.numpy(), Hp.numpy(), atol=1e-3 * float(Hp.abs().max()))


def test_kernel_x_matches_plain(host_kernels):
    """Kernel X's two entries against the plain versions (8 and 10
    iterations; float64 against float32 LM): scale within 2e-3 relative, gravity rotation entries within
    1e-4, biases within 2e-4, velocities within 2e-3 of their largest; with
    padding edges too."""
    from tests.test_torch_imu_init import chain

    for pad, priors, fix in ((0, (1e-2, 1e-2), False), (3, (1e2, 1e6), False), (0, (1e2, 1e6), True)):
        R, p, vel, preints, ev = chain(0, pad=pad)
        args = (torch.as_tensor(R), torch.as_tensor(p), convert.inertial_to_torch(preints))
        evt = None if ev is None else torch.as_tensor(ev)
        k = tinit._init_kernel(*args, priors[0], priors[1], 8, fix, evt)
        q = tinit.inertial_only_optimization_plain(*args, priors[0], priors[1], 8, fix, evt)
        assert abs(float(k.scale) / float(q.scale) - 1) < 2e-3
        np.testing.assert_allclose(k.Rwg.numpy(), q.Rwg.numpy(), atol=1e-4)
        np.testing.assert_allclose(k.bias.numpy(), q.bias.numpy(), atol=2e-4)
        np.testing.assert_allclose(k.vel.numpy(), q.vel.numpy(), atol=2e-3 * float(q.vel.abs().max()))
    R, p, vel, preints, _ = chain(1)
    args = (torch.as_tensor(R), torch.as_tensor(p * 3.0 / 1.08), torch.as_tensor(vel * 3.0 / 1.08),
            torch.zeros(6), convert.inertial_to_torch(preints))
    Rk, sk = tinit._refine_kernel(*args, None, 10)
    Rp, sp = tinit.scale_gravity_refinement_plain(*args, None, 10)
    assert abs(float(sk) - float(sp)) < 1e-4
    np.testing.assert_allclose(Rk.numpy(), Rp.numpy(), atol=1e-5)


def test_kernel_x_long_chain_matches_plain(host_kernels):
    """Kernel X on chip_smoke.py's chain of 52 keyframes, whose system
    (P = 165) lies beyond shared memory and is solved in the global
    scratch, against the plain version (3 iterations, the emulated
    barriers being slow; the refinement 10), at
    test_kernel_x_matches_plain's tolerances."""
    import chip_smoke

    R, p, vel, preints = chip_smoke.x_problem(np.random.default_rng(2), "cpu", 52)
    k = tinit._init_kernel(R, p, preints, 1e2, 1e6, 3, False, None)
    q = tinit.inertial_only_optimization_plain(R, p, preints, 1e2, 1e6, 3, False, None)
    assert abs(float(k.scale) / float(q.scale) - 1) < 2e-3
    np.testing.assert_allclose(k.Rwg.numpy(), q.Rwg.numpy(), atol=1e-4)
    np.testing.assert_allclose(k.bias.numpy(), q.bias.numpy(), atol=2e-4)
    np.testing.assert_allclose(k.vel.numpy(), q.vel.numpy(), atol=2e-3 * float(q.vel.abs().max()))
    args = (R, p * 0.95, vel * 0.95, torch.zeros(6), preints)
    Rk, sk = tinit._refine_kernel(*args, None, 10)
    Rp, sp = tinit.scale_gravity_refinement_plain(*args, None, 10)
    assert abs(float(sk) - float(sp)) < 1e-4
    np.testing.assert_allclose(Rk.numpy(), Rp.numpy(), atol=1e-5)


def test_kernel_y_matches_plain(host_kernels):
    """Kernel Y against the plain VI-BA (2 + 3 iterations) on the
    tracker-shaped problem (camera offset, stereo, outliers, padded fixed
    states, invalid landmarks): positions within 2e-3 m, rotation entries within 2e-4,
    velocities within 1e-2 m/s, biases within 1e-3, landmarks within 1e-2
    m, at most 1% of the observations classified otherwise."""
    import jax.numpy as jnp

    from orb_slam3_fast_tpu.utils import lie as jlie
    from tests.test_torch_vi_ba import T_CAM, tracker_shaped

    prob, _ = tracker_shaped(np.random.default_rng(7))
    Tj = jlie.SE3(jlie.so3_exp(jnp.asarray([0.01, -0.02, 0.015])), jnp.asarray([0.03, 0.0, -0.02]))
    T_cb = tlie.SE3(torch.tensor(np.asarray(Tj.R)), torch.tensor(np.asarray(Tj.t)))
    pt = convert.inertial_to_torch(prob)
    out_k = tvb._kernel(T_CAM, 40.0, T_cb, pt, 2, 3)
    out_p = tvb.vi_bundle_adjust_plain(T_CAM, 40.0, T_cb, pt, 2, 3)
    for name, tol, a, b in zip(("R", "p", "v", "bias", "xw"), (2e-4, 2e-3, 1e-2, 1e-3, 1e-2), out_k[:5], out_p[:5]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=tol, err_msg=name)
    assert float((out_k[5] != out_p[5]).float().mean()) <= 0.01
