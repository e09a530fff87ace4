"""Global BA of the port (optim/ba_cg.py: kernel E's per-observation
blocks and kernel T's plain version) against the JAX package's
optim/ba_cg.py on the seeded problem of tests/test_torch_ba.py, and an
abort that lands between segments."""
import jax.numpy as jnp
import numpy as np
import torch

from orb_slam3_fast_tpu.optim import ba_cg as jcg
from orb_slam3_fast_tpu_torch.optim import ba as tba
from orb_slam3_fast_tpu_torch.optim import ba_cg as tcg
from tests.test_torch_ba import BF, JCAM, TCAM, both, problem

torch.set_num_threads(1)


def test_pose_csr():
    """The pose CSR lists every valid observation of each pose once, in
    observation order."""
    p = problem(1)
    prob = tba.make_problem(**p, device="cpu")
    ptr, ids = prob.kf_ptr.numpy(), prob.kf_obs.numpy()
    for k in range(len(p["R"])):
        got = ids[ptr[k]:ptr[k + 1]]
        want = np.nonzero(p["obs_valid"] & (p["obs_kf"] == k))[0]
        np.testing.assert_array_equal(got, want)
    assert ptr[-1] == p["obs_valid"].sum()


def test_blocks_and_implicit_schur_solve_match_jax():
    """build_blocks within 1e-4 of the largest entry of each block (the
    per-observation W too); the PCG step (32 iterations) within 1e-3 of the
    JAX package's float32 one, relative to the step's size."""
    p = problem(2)
    jp, tp = both(p)
    inl = np.ones(len(p["obs_kf"]), bool)
    got = tcg.build_blocks(TCAM, BF, tp.R, tp.t, tp.xw, tp, torch.as_tensor(inl))
    want = jcg.build_blocks(JCAM, jnp.float32(BF), jp.R, jp.t, jp.xw, jp, jnp.asarray(inl))
    for g, w in zip(got, want):
        g, w = g.numpy(), np.asarray(w)
        assert np.abs(g - w).max() <= 1e-4 * max(float(np.abs(w).max()), 1e-12)
    Hpp, Hll, bp, bl, W, w_lm, _ = got
    lam = torch.tensor(1e-4)
    dp, dl = tcg.implicit_schur_solve(Hpp, Hll, bp, bl, W, tp, w_lm, lam, cg_iters=32)
    Jb = want
    dp_j, dl_j = jcg.implicit_schur_solve(Jb[0], Jb[1], Jb[2], Jb[3], Jb[4], jp.obs_kf, jp.obs_lm, Jb[5],
                                          jp.pose_fixed, jp.lm_valid, jnp.float32(1e-4), 32)
    dp_j, dl_j = np.asarray(dp_j), np.asarray(dl_j)
    assert np.abs(dp.numpy() - dp_j).max() <= 1e-3 * np.abs(dp_j).max()
    assert np.abs(dl.numpy() - dl_j).max() <= 1e-3 * np.abs(dl_j).max()
    np.testing.assert_array_equal(dp.numpy()[p["pose_fixed"]], 0.0)
    # the implicit operator solves the dense reduced system of kernel F's plain version
    dp_d, dl_d = tba.schur_solve_plain(Hpp, Hll, bp, bl, tba.coupling_to_dense(W, tp), w_lm, tp.pose_fixed,
                                       tp.lm_valid, lam)
    assert np.abs(dp.numpy() - dp_d.numpy()).max() <= 1e-3 * np.abs(dp_d.numpy()).max()


def test_bundle_adjust_cg_matches_jax():
    """The two-phase schedule (5 + 10 LM iterations, 32 CG iterations):
    poses within 1e-3, the landmarks that keep two inlier observations
    within 1e-3 (those with fewer are unconstrained along their ray and
    drift off to hundreds of metres in both packages, 1% apart), inlier
    masks within 0.2%; the port's run is what ``bundle_adjust_cg_plain``
    gives."""
    p = problem(3)
    jp, tp = both(p)
    R_t, t_t, x_t, inl_t, ab_t = tcg.bundle_adjust_cg(TCAM, BF, tp)
    R_j, t_j, x_j, inl_j, ab_j = jcg.bundle_adjust_cg(JCAM, jnp.float32(BF), jp)
    assert not ab_t and not ab_j
    np.testing.assert_allclose(R_t.numpy(), np.asarray(R_j), atol=1e-3)
    np.testing.assert_allclose(t_t.numpy(), np.asarray(t_j), atol=1e-3)
    n_inl = np.bincount(p["obs_lm"][p["obs_valid"] & np.asarray(inl_j)], minlength=len(p["xw"]))
    held = p["lm_valid"] & (n_inl >= 2)
    assert held.sum() > 200
    np.testing.assert_allclose(x_t.numpy()[held], np.asarray(x_j)[held], atol=1e-3)
    assert np.mean(inl_t.numpy() != np.asarray(inl_j)) <= 0.002
    R_p, t_p, x_p, inl_p, _ = tcg.bundle_adjust_cg_plain(TCAM, BF, tp)
    assert torch.equal(R_p, R_t) and torch.equal(x_p, x_t) and torch.equal(inl_p, inl_t)


class _Flag:
    """Set after ``after`` polls."""

    def __init__(self, after):
        self.after, self.n = after, 0

    def is_set(self):
        self.n += 1
        return self.n > self.after


def test_abort_lands_between_segments():
    """An abort after the first segment of 2 LM iterations: the solve stops
    there, reports it, and its state is that of 2 iterations of an
    unaborted run."""
    p = problem(4)
    _, tp = both(p)
    flag = _Flag(after=0)
    R_a, t_a, x_a, _, aborted = tcg.bundle_adjust_cg(TCAM, BF, tp, iters1=10, iters2=10, seg=2, abort_flag=flag)
    assert aborted and flag.n == 1
    R_2, t_2, x_2, _, aborted_2 = tcg.bundle_adjust_cg(TCAM, BF, tp, iters1=2, iters2=0, seg=2)
    assert not aborted_2
    assert torch.equal(R_a, R_2) and torch.equal(t_a, t_2) and torch.equal(x_a, x_2)
