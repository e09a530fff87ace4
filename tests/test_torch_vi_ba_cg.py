"""Parity of the port's FullInertialBA (kernel AA's plain version,
``optim/vi_ba_cg.py``) with the JAX package on tests/test_vi_ba.py's
simulated flight (``build_vi_problem``): the blocks, the implicit solve,
one LM segment, the classification, the whole two-phase solve with its
convergence gates, and an abort that lands mid-solve."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam3_fast_tpu.optim import vi_ba_cg as jcg
from orb_slam3_fast_tpu.utils import lie as jlie
from orb_slam3_fast_tpu_torch.optim import vi_ba_cg as tcg
from orb_slam3_fast_tpu_torch.utils import convert
from orb_slam3_fast_tpu_torch.utils import lie as tlie
from tests.test_inertial import CAM as J_CAM
from tests.test_torch_vi_ba import T_CAM
from tests.test_vi_ba import build_vi_problem

torch.set_num_threads(1)

T_ID = tlie.SE3(torch.eye(3), torch.zeros(3))


@pytest.fixture(scope="module")
def problem():
    prob, R_gt, p_gt, v_gt, xw_gt = build_vi_problem(np.random.default_rng(0))
    return prob, convert.inertial_to_torch(prob), (R_gt, p_gt, v_gt, xw_gt)


def _np(x):
    return np.asarray(x, np.float64)


def _blocks(jp, tp):
    """Both packages' visual and chain blocks at the problem's state."""
    inl = jnp.ones(jp.obs_uv.shape[0], bool)
    jv = jcg._visual_blocks_cg(J_CAM, jnp.float32(0.0), jlie.SE3.identity(), jp.R_wb, jp.p_wb, jp.xw, jp, inl)
    ji = jcg._inertial_edge_blocks(jp, jp.R_wb, jp.p_wb, jp.v_w, jp.bias)
    tinl = torch.ones(tp.obs_uv.shape[0], dtype=torch.bool)
    tv = tcg._visual_blocks_cg(T_CAM, 0.0, T_ID, tp.R_wb, tp.p_wb, tp.xw, tp, tinl)
    ti = tcg._inertial_edge_blocks(tp, tp.R_wb, tp.p_wb, tp.v_w, tp.bias)
    return jv, ji, tv, ti


def test_blocks_match_jax(problem):
    """The visual blocks (Hpp, Hll, bp, bl, W, w_lm, cost) and the chain's
    (Hii, Hjj, Hij, gradient, cost) within 1e-4 of each one's largest
    entry (float32 sums in another order; forward-mode against jax.jacfwd
    Jacobians)."""
    jp, tp, _ = problem
    jv, ji, tv, ti = _blocks(jp, tp)
    for name, a, b in zip(("Hpp", "Hll", "bp", "bl", "W", "w_lm", "vcost", "Hii", "Hjj", "Hij", "g", "icost"),
                          (*tv, *ti), (*jv, *ji)):
        b = _np(b)
        np.testing.assert_allclose(_np(a), b, atol=1e-4 * max(1.0, np.abs(b).max()), err_msg=name)


def test_implicit_vi_solve_matches_jax(problem):
    """``_implicit_vi_solve`` on the JAX package's own blocks, lam = 1e-4,
    32 CG iterations: the port (float64 CG) within 2e-3 of the largest
    state step and 2e-3 of the largest landmark step of the JAX package's
    (float32 CG); fixed states do not move."""
    jp, tp, _ = problem
    jv, ji, _, _ = _blocks(jp, tp)
    (Hpp, Hll, bp, bl, W, w_lm, _), (Hii, Hjj, Hij, g, _) = jv, ji
    dx_j, dl_j = jcg._implicit_vi_solve(Hpp, Hll, bp, bl, W, Hii, Hjj, Hij, g, jp.obs_kf, jp.obs_lm, jp.edge_i,
                                        jp.edge_j, w_lm, jp.state_fixed, jp.lm_valid, jnp.float32(1e-4), 32)
    T = lambda a: torch.as_tensor(np.asarray(a))  # noqa: E731
    dx_t, dl_t = tcg._implicit_vi_solve(T(Hpp), T(Hll), T(bp), T(bl), T(W), T(Hii), T(Hjj), T(Hij), T(g), tp.obs_kf,
                                        tp.obs_lm, tp.edge_i, tp.edge_j, T(w_lm), tp.state_fixed, tp.lm_valid,
                                        torch.tensor(1e-4), 32)
    dx_j, dl_j = _np(dx_j), _np(dl_j)
    np.testing.assert_allclose(_np(dx_t), dx_j, atol=2e-3 * np.abs(dx_j).max())
    np.testing.assert_allclose(_np(dl_t), dl_j, atol=2e-3 * np.abs(dl_j).max())
    assert not dx_t[0].any()


def test_lm_segment_and_classify_match_jax(problem):
    """One segment of 2 LM steps (32 CG iterations) from the perturbed
    start: states within 1e-3 (rotation entries, m, m/s, biases),
    landmarks within 2e-3 m, the damping and the cost within 1e-4
    relative; the classification of the result agrees on every
    observation."""
    jp, tp, _ = problem
    inl = jnp.ones(jp.obs_uv.shape[0], bool)
    out_j = jcg.lm_segment_vi(J_CAM, jnp.float32(0.0), jlie.SE3.identity(), jp, jp.R_wb, jp.p_wb, jp.v_w, jp.bias,
                              jp.xw, inl, jnp.float32(1e-4), n_iters=2, cg_iters=32)
    out_t = tcg.lm_segment_vi(T_CAM, 0.0, T_ID, tp, tp.R_wb, tp.p_wb, tp.v_w, tp.bias, tp.xw,
                              torch.ones(tp.obs_uv.shape[0], dtype=torch.bool), torch.tensor(1e-4), 2, 32)
    for name, a, b, tol in zip(("R", "p", "v", "bias", "xw"), out_t[:5], out_j[:5], (1e-3, 1e-3, 1e-3, 1e-3, 2e-3)):
        np.testing.assert_allclose(_np(a), _np(b), atol=tol, err_msg=name)
    assert float(out_t[5]) == pytest.approx(float(out_j[5]), rel=1e-4)
    assert float(out_t[6]) == pytest.approx(float(out_j[6]), rel=1e-4)
    cj = jcg.classify_vi(J_CAM, jnp.float32(0.0), jlie.SE3.identity(), jp, out_j[0], out_j[1], out_j[4])
    ct = tcg.classify_vi(T_CAM, 0.0, T_ID, tp, out_t[0], out_t[1], out_t[4])
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
    assert tcg.lm_segment_vi.launches.total() == 0  # the CPU runs the plain versions


def test_full_inertial_ba_cg_matches_jax(problem):
    """The whole two-phase solve (5 + 8 LM steps, 32 CG iterations) meets
    tests/test_vi_ba_cg.py's gates (positions within 0.01 m, velocities
    within 0.05 m/s, rotations within 0.3 degrees of the truth, > 90%
    inliers) and lands within 2e-3 of the JAX package's result; the inlier
    masks differ on at most 0.5% of the observations."""
    jp, tp, (R_gt, p_gt, v_gt, _) = problem
    out_j = jcg.full_inertial_ba_cg(J_CAM, jnp.float32(0.0), jlie.SE3.identity(), jp, cg_iters=32)
    out_t = tcg.full_inertial_ba_cg(T_CAM, 0.0, T_ID, tp, cg_iters=32)
    assert not out_t[6] and not out_j[6]
    R, p, v = (x.numpy() for x in out_t[:3])
    assert np.linalg.norm(p - p_gt, axis=1).max() < 0.01
    assert np.linalg.norm(v - v_gt, axis=1).max() < 0.05
    assert float(out_t[5].float().mean()) > 0.9
    for k in range(len(R_gt)):
        ang = np.degrees(np.arccos(np.clip((np.trace(R[k] @ R_gt[k].T) - 1) / 2, -1, 1)))
        assert ang < 0.3, (k, ang)
    for name, a, b in zip(("R", "p", "v", "bias", "xw"), out_t[:5], out_j[:5]):
        np.testing.assert_allclose(_np(a), _np(b), atol=2e-3, err_msg=name)
    assert np.mean(out_t[5].numpy() != np.asarray(out_j[5])) <= 0.005


def test_abort_lands_mid_solve(problem):
    """tests/test_vi_ba_cg.py:49: an abort flag that lets one segment
    through stops the solve at the second poll and reports aborted, after
    exactly two segments (the state then is what two segments give)."""
    _, tp, _ = problem
    polls = {"n": 0}

    class Flag:
        def is_set(self):
            polls["n"] += 1
            return polls["n"] >= 2

    out = tcg.full_inertial_ba_cg(T_CAM, 0.0, T_ID, tp, iters1=6, iters2=6, seg=2, abort_flag=Flag())
    assert out[6] and polls["n"] == 2
    ref = tcg.lm_segment_vi(T_CAM, 0.0, T_ID, tp, tp.R_wb, tp.p_wb, tp.v_w, tp.bias, tp.xw,
                            torch.ones(tp.obs_uv.shape[0], dtype=torch.bool), torch.tensor(1e-4), 2, 40)
    ref = tcg.lm_segment_vi(T_CAM, 0.0, T_ID, tp, *ref[:5], torch.ones(tp.obs_uv.shape[0], dtype=torch.bool),
                            ref[5], 2, 40)
    for a, b in zip(out[:5], ref[:5]):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
