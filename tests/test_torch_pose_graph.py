"""The port's Sim3 essential graph (kernel S's plain version) against the
JAX package on the drifted circle of tests/test_pose_graph.py: the dense
branch, the PCG branch (``_FORCE_CG``, and at 200 vertices), padded against unpadded vertices,
the edge Jacobians against ``jax.jacfwd``, and ``correct_landmarks``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam3_fast_tpu.optim import pose_graph as jpg
from orb_slam3_fast_tpu.utils import lie as jlie
from orb_slam3_fast_tpu_torch.optim import pose_graph as tpg
from orb_slam3_fast_tpu_torch.utils import lie as tlie
import chip_smoke
from tests.test_pose_graph import _ate, _build_drifted, _rel_sim3, _sim3_graph_from_drift

torch.set_num_threads(1)

K = 24


def _graph(K=K, pad_k=0, pad_e=0):
    """The odometry chain of a drifted K-keyframe circle plus the exact loop
    edge (0, K-1) and an exact covisibility-like edge (K-1, K-3), vertex 0 fixed;
    ``pad_k`` fixed vertices touched by no edge and ``pad_e`` invalid edges
    appended, as the JAX loop closer pads."""
    R0, t0, s0, R_gt, t_gt, _, meas = _build_drifted(K)
    edges = [(k + 1, k, *meas[k]) for k in range(K - 1)]
    edges.append((0, K - 1, *_rel_sim3(R_gt[0], t_gt[0], 1.0, R_gt[K - 1], t_gt[K - 1], 1.0)))
    edges.append((K - 1, K - 3, *_rel_sim3(R_gt[K - 1], t_gt[K - 1], 1.0, R_gt[K - 3], t_gt[K - 3], 1.0)))
    E = len(edges) + pad_e
    ei, ej = np.zeros(E, np.int32), np.zeros(E, np.int32)
    mR = np.tile(np.eye(3, dtype=np.float32), (E, 1, 1))
    mt, ms, ev = np.zeros((E, 3), np.float32), np.ones(E, np.float32), np.zeros(E, bool)
    for e, (i, j, R, t, s) in enumerate(edges):
        ei[e], ej[e], mR[e], mt[e], ms[e], ev[e] = i, j, R, t, s, True
    Kp = K + pad_k
    R = np.tile(np.eye(3, dtype=np.float32), (Kp, 1, 1))
    t, s = np.zeros((Kp, 3), np.float32), np.ones(Kp, np.float32)
    R[:K], t[:K], s[:K] = R0, t0, s0
    fixed = np.zeros(Kp, bool)
    fixed[0] = True
    fixed[K:] = True
    arrays = dict(R=R, t=t, s=s, edge_i=ei, edge_j=ej, meas_R=mR, meas_t=mt, meas_s=ms, edge_valid=ev, fixed=fixed,
                  edge_w=np.ones(E, np.float32))
    return arrays, (R_gt, t_gt)


def _run_both(arrays, iters=12):
    gt = tpg.Sim3Graph(**{k: torch.as_tensor(v) for k, v in arrays.items()})
    gj = jpg.Sim3Graph(**{k: jnp.asarray(v) for k, v in arrays.items()})
    return [x.numpy() for x in tpg.optimize_sim3_graph(gt, iters=iters)[:3]], \
        [np.asarray(x) for x in jpg.optimize_sim3_graph(gj, iters=iters)]


def test_dense_graph_matches_jax():
    """The drifted circle snaps back as in the JAX test, and the port lands
    within 2e-3 of the JAX package (its float32 LU of the 168 x 168 system
    against the port's float64 solve; 12 iterations compound the gap)."""
    arrays, (R_gt, t_gt) = _graph()
    (R_t, t_t, s_t), (R_j, t_j, s_j) = _run_both(arrays)
    before = _ate(arrays["R"], arrays["t"], arrays["s"], R_gt, t_gt)
    after = _ate(R_t, t_t, s_t, R_gt, t_gt)
    assert before > 0.2 and after < 0.25 * before, (before, after)
    np.testing.assert_allclose(R_t, R_j, atol=2e-3)
    np.testing.assert_allclose(t_t, t_j, atol=2e-3)
    np.testing.assert_allclose(s_t, s_j, atol=2e-3)
    assert np.array_equal(R_t[0], arrays["R"][0]) and np.array_equal(t_t[0], arrays["t"][0])


def test_pcg_branch_matches_jax(monkeypatch):
    """``_FORCE_CG`` in both packages, 6 iterations: the PCG branch within
    2e-3 of the JAX package's and within 2e-3 of the port's dense solve."""
    arrays, _ = _graph()
    dense = [x.numpy() for x in tpg.optimize_sim3_graph(
        tpg.Sim3Graph(**{k: torch.as_tensor(v) for k, v in arrays.items()}), iters=6)[:3]]
    monkeypatch.setattr(tpg, "_FORCE_CG", True)
    monkeypatch.setattr(jpg, "_FORCE_CG", True)
    jax.clear_caches()  # the JAX program reads _FORCE_CG while it traces
    try:
        (R_t, t_t, s_t), (R_j, t_j, s_j) = _run_both(arrays, iters=6)
    finally:
        jax.clear_caches()
    for a, b, c in ((R_t, R_j, dense[0]), (t_t, t_j, dense[1]), (s_t, s_j, dense[2])):
        np.testing.assert_allclose(a, b, atol=2e-3)
        np.testing.assert_allclose(a, c, atol=2e-3)


def test_pcg_branch_at_200_vertices_matches_jax():
    """tests/test_pose_graph.py's drift graph of 200 vertices (seed 3),
    which both packages solve by the PCG branch without ``_FORCE_CG`` (K >
    DENSE_MAX_K), 12 iterations: the port (float64 CG, kernel U's plain
    version) within 2e-3 of the JAX package (float32 CG), both moving the
    camera centres towards the truth (3.85 -> 2.71 m: 64 CG iterations a
    step do not carry the loop edge around the whole chain in 12 steps);
    chip_smoke.drift_graph, which builds kernel U's check on the card,
    gives the same graph to 1e-6."""
    g, R0, t0, s0, R_gt, t_gt = _sim3_graph_from_drift(200, seed=3)
    assert g.R.shape[0] > tpg.DENSE_MAX_K and not tpg._FORCE_CG and not jpg._FORCE_CG
    arrays = {k: np.asarray(v) for k, v in g._asdict().items()}
    mine, (Rg, tg) = chip_smoke.drift_graph(200, seed=3)
    for k, v in arrays.items():
        np.testing.assert_allclose(mine[k], v, atol=1e-6, err_msg=k)
    np.testing.assert_allclose(Rg, R_gt, atol=1e-7)
    (R_t, t_t, s_t), (R_j, t_j, s_j) = _run_both(arrays)
    for a, b in ((R_t, R_j), (t_t, t_j), (s_t, s_j)):
        np.testing.assert_allclose(a, b, atol=2e-3)
    before, after = _ate(R0, t0, s0, R_gt, t_gt), _ate(R_t, t_t, s_t, R_gt, t_gt)
    assert after < 0.8 * before and abs(after - _ate(R_j, t_j, s_j, R_gt, t_gt)) < 1e-3, (before, after)
    assert chip_smoke.graph_ate(R_t, t_t, s_t, R_gt, t_gt) == pytest.approx(after, rel=1e-6)


def test_padding_changes_nothing():
    """Fixed vertices touched by no edge and invalid edges (the JAX loop
    closer's power-of-two padding) leave the solution as it is, to 1e-5."""
    arrays, _ = _graph()
    padded, _ = _graph(pad_k=8, pad_e=6)
    g0 = tpg.Sim3Graph(**{k: torch.as_tensor(v) for k, v in arrays.items()})
    g1 = tpg.Sim3Graph(**{k: torch.as_tensor(v) for k, v in padded.items()})
    out0 = tpg.optimize_sim3_graph(g0, iters=6)[:3]
    out1 = tpg.optimize_sim3_graph(g1, iters=6)[:3]
    for a, b in zip(out0, out1):
        np.testing.assert_allclose(b[:K].numpy(), a.numpy(), atol=1e-5)
    np.testing.assert_array_equal(out1[1][K:].numpy(), 0.0)


def test_edge_jacobians_match_jacfwd():
    """Both 7x7 Jacobians of every edge (the forward-mode derivative kernel
    S takes in dual numbers) against the JAX package's jax.jacfwd, within
    1e-3 of the largest entry; residuals within 1e-5."""
    arrays, _ = _graph()
    g = tpg.Sim3Graph(**{k: torch.as_tensor(v) for k, v in arrays.items()})
    r, Ji, Jj = tpg.edge_jacobians(g.R, g.t, g.s, g)
    a = {k: jnp.asarray(v) for k, v in arrays.items()}
    zero = jnp.zeros(7)

    @jax.jit
    @jax.vmap
    def one_edge(i, j, mR, mt, ms):
        Si, Sj = jlie.Sim3(a["R"][i], a["t"][i], a["s"][i]), jlie.Sim3(a["R"][j], a["t"][j], a["s"][j])

        def f(di, dj):
            return jpg._edge_residual_sim3(di, dj, Si, Sj, jlie.Sim3(mR, mt, ms))

        return f(zero, zero), jax.jacfwd(f, argnums=0)(zero, zero), jax.jacfwd(f, argnums=1)(zero, zero)

    rj, Jij, Jjj = (np.asarray(x) for x in one_edge(a["edge_i"], a["edge_j"], a["meas_R"], a["meas_t"],
                                                     a["meas_s"]))
    np.testing.assert_allclose(r.numpy(), rj, atol=1e-5)
    scale = np.maximum(np.abs(Jij).max((1, 2)), np.abs(Jjj).max((1, 2)))[:, None, None]
    assert np.all(np.abs(Ji.numpy() - Jij) <= 1e-3 * scale)
    assert np.all(np.abs(Jj.numpy() - Jjj) <= 1e-3 * scale)


def test_correct_landmarks_matches_jax(rng):
    """x' = S_new^-1(S_old(x)) per landmark's reference keyframe, within
    1e-5 of the JAX package."""
    Kv, M = 6, 50
    xi_o = rng.normal(0, 0.3, (Kv, 7)).astype(np.float32)
    xi_n = xi_o + rng.normal(0, 0.05, (Kv, 7)).astype(np.float32)
    So, Sn = jlie.sim3_exp(jnp.asarray(xi_o)), jlie.sim3_exp(jnp.asarray(xi_n))
    pos = rng.normal(0, 3, (M, 3)).astype(np.float32)
    ref = rng.integers(0, Kv, M)
    out_j = np.asarray(jpg.correct_landmarks(jnp.asarray(pos), jnp.asarray(ref), So.R, So.t, So.s, Sn.R, Sn.t, Sn.s))
    T = lambda a: torch.as_tensor(np.asarray(a))  # noqa: E731
    out_t = tpg.correct_landmarks(T(pos), T(ref), T(So.R), T(So.t), T(So.s), T(Sn.R), T(Sn.t), T(Sn.s)).numpy()
    np.testing.assert_allclose(out_t, out_j, atol=1e-5, rtol=1e-5)
    # the identity correction leaves the landmarks where they are
    same = tpg.correct_landmarks(T(pos), T(ref), T(So.R), T(So.t), T(So.s), T(So.R), T(So.t), T(So.s)).numpy()
    np.testing.assert_allclose(same, pos, atol=1e-4)


def test_gpu_branch_refuses_the_pcg_size():
    """A graph above DENSE_MAX_K vertices on a device other than the CPU (a
    meta tensor) goes to kernel U's wrapper, whose argument check refuses a
    tensor that is not on CUDA; it is neither run plain nor refused as a
    branch without a kernel."""
    arrays, _ = _graph()
    g = tpg.Sim3Graph(**{k: torch.as_tensor(v).to("meta") for k, v in arrays.items()})
    K = tpg.DENSE_MAX_K + 1
    big = g._replace(R=torch.empty((K, 3, 3), device="meta"), t=torch.empty((K, 3), device="meta"),
                     s=torch.empty(K, device="meta"), fixed=torch.zeros(K, dtype=torch.bool, device="meta"))
    with pytest.raises(ValueError, match="CUDA"):
        tpg.optimize_sim3_graph(big)
    assert tlie.Sim3.identity().s.shape == ()


# Kernel S's edge evaluation (csrc/sim3.cuh: sim3::edge_lane), compiled for the
# host with the CUDA qualifiers and intrinsics it uses stubbed out.
_HOST_STUBS = r"""
#pragma once
#include <cmath>
#include <cstdint>
using std::sqrt; using std::fabs; using std::exp; using std::expm1; using std::log; using std::atan2;
using std::sin; using std::cos;
#define __device__
#define __forceinline__ inline
template <class T> T __shfl_xor_sync(unsigned, T v, int) { return v; }
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fsub_rn(float a, float b) { return a - b; }
inline void __syncthreads() {}
struct HostDim { unsigned x, y, z; };
static HostDim threadIdx, blockDim;
"""
_HOST_MAIN = r"""
#include <cstdio>
#include "sim3.cuh"
int main() {
  int n;
  if (scanf("%d", &n) != 1) return 1;
  for (int e = 0; e < n; ++e) {
    float v[39];
    for (float& x : v) if (scanf("%f", &x) != 1) return 1;
    double r[7], col[7];
    for (int lane = 0; lane < 14; ++lane) {
      sim3::edge_lane(v, v + 13, v + 26, lane, col, lane == 0 ? r : nullptr);
      if (lane == 0) for (double x : r) printf("%.17g ", x);
      for (double x : col) printf("%.17g ", x);
    }
    printf("\n");
  }
  return 0;
}
"""


def test_kernel_s_dual_numbers_match_jacfwd(tmp_path):
    """Kernel S's float64 dual-number edge code, compiled for the host
    from csrc/sim3.cuh: every edge's residual within 1e-5 and both 7x7
    Jacobians within 1e-4 of the largest entry of the JAX package's
    jax.jacfwd (float32) at the drifted circle, and at vertices moved off
    it by 0.2 rad and 0.3 in sigma, where the quaternion log and the closed
    forms of _sim3_W_coeffs take other branches."""
    import shutil
    import subprocess

    from orb_slam3_fast_tpu_torch import _kernels

    if shutil.which("g++") is None:
        pytest.skip("needs g++ to compile the kernel's device code for the host")
    (tmp_path / "cuda_runtime.h").write_text(_HOST_STUBS)
    (tmp_path / "main.cpp").write_text(_HOST_MAIN)
    exe = tmp_path / "edge_lane"
    subprocess.run(["g++", "-std=c++17", "-O1", f"-I{tmp_path}", f"-I{_kernels.SRC_DIR}", str(tmp_path / "main.cpp"),
                    "-o", str(exe)], check=True, capture_output=True, timeout=120)
    arrays, _ = _graph()
    rng = np.random.default_rng(3)
    moved = dict(arrays)
    xi = rng.normal(0, [0.3, 0.3, 0.3, 0.2, 0.2, 0.2, 0.3], (K, 7)).astype(np.float32)
    S = jlie.sim3_exp(jnp.asarray(xi)).compose(jlie.Sim3(*(jnp.asarray(arrays[k]) for k in ("R", "t", "s"))))
    moved["R"], moved["t"], moved["s"] = (np.asarray(x, np.float32) for x in S)
    for a in (arrays, moved):
        V = np.concatenate([a["R"].reshape(-1, 9), a["t"], a["s"][:, None]], 1)
        M = np.concatenate([a["meas_R"].reshape(-1, 9), a["meas_t"], a["meas_s"][:, None]], 1)
        E = len(a["edge_i"])
        lines = [str(E)] + [" ".join(f"{x:.9g}" for x in np.concatenate([V[a["edge_i"][e]], V[a["edge_j"][e]], M[e]]))
                            for e in range(E)]
        out = subprocess.run([str(exe)], input="\n".join(lines), capture_output=True, text=True, check=True,
                             timeout=60).stdout.split("\n")
        vals = np.array([np.array(line.split(), float) for line in out[:E]])  # (E, 7 + 14 x 7)
        r_k, cols = vals[:, :7], vals[:, 7:].reshape(E, 14, 7)
        aj = {k: jnp.asarray(v) for k, v in a.items()}
        zero = jnp.zeros(7)

        @jax.jit
        @jax.vmap
        def one_edge(i, j, mR, mt, ms):
            Si, Sj = jlie.Sim3(aj["R"][i], aj["t"][i], aj["s"][i]), jlie.Sim3(aj["R"][j], aj["t"][j], aj["s"][j])

            def f(di, dj):
                return jpg._edge_residual_sim3(di, dj, Si, Sj, jlie.Sim3(mR, mt, ms))

            return f(zero, zero), jax.jacfwd(f, argnums=0)(zero, zero), jax.jacfwd(f, argnums=1)(zero, zero)

        rj, Jij, Jjj = (np.asarray(x, np.float64) for x in one_edge(aj["edge_i"], aj["edge_j"], aj["meas_R"],
                                                                     aj["meas_t"], aj["meas_s"]))
        assert np.abs(r_k - rj).max() <= 1e-5 * max(1.0, np.abs(rj).max())
        J_k = np.concatenate([cols[:, :7], cols[:, 7:]], 1).transpose(0, 2, 1)  # (E, 7 rows, 14 directions)
        J_j = np.concatenate([Jij, Jjj], 2)
        scale = np.abs(J_j).max((1, 2))[:, None, None]
        assert np.all(np.abs(J_k - J_j) <= 1e-4 * scale), np.abs(J_k - J_j).max()
