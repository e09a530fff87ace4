"""The plain versions of kernel AC (optim/ba.py: ``lm_update_plain``, the
LM iteration's update, cost, accept and damping; ``classify_plain``, the
chi2 gate) against the JAX package on the seeded problem of
tests/test_torch_ba.py: ``lm_update_plain`` against the composition of
``orb_slam3_fast_tpu/optim/ba.py``'s ``apply_update``, ``_obs_residuals``
and ``_robust_cost`` with the accept and damping rule of its
``bundle_adjust`` (``ba.py:175-179``), ``classify_plain`` against the
jitted ``orb_slam3_fast_tpu/optim/ba_cg.py`` ``classify``; and the
dispatching wrappers on the CPU."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam3_fast_tpu.optim import ba as jba
from orb_slam3_fast_tpu.optim import ba_cg as jcg
from orb_slam3_fast_tpu_torch.optim import ba as tba
from orb_slam3_fast_tpu_torch.optim import ba_cg as tcg
from tests.test_torch_ba import BF, JCAM, TCAM, both, problem

torch.set_num_threads(1)


def jax_lm_update(jp, R, t, xw, dp, dl, inlier, cost_old, lam):
    """The JAX package's LM update (ba.py:168-179) on its own functions."""
    R_new, t_new, xw_new = jba.apply_update(R, t, xw, dp, dl)
    r_new, _, posd_new = jba._obs_residuals(JCAM, jnp.float32(BF), R_new, t_new, xw_new, jp)
    active = jp.obs_valid & inlier & posd_new & jp.lm_valid[jp.obs_lm]
    cost_new, _ = jba._robust_cost(r_new, jp, active)
    accept = cost_new < cost_old
    lam = jnp.where(accept, jnp.maximum(lam * 0.5, 1e-8), jnp.minimum(lam * 5.0, 1e6))
    return (jnp.where(accept, R_new, R), jnp.where(accept, t_new, t), jnp.where(accept, xw_new, xw), lam, accept,
            cost_new)


@pytest.mark.parametrize("step", ["accepted", "rejected"])
def test_lm_update_plain_matches_jax(step):
    """One LM update from the same state, blocks and step in both packages:
    the plain solve's step (the cost drops: accepted) or three times it
    (the cost rises: rejected).  States within 1e-5, the accept equal, the
    damping equal, the candidate's cost within 1e-5 relative; a rejected
    step leaves the state as it was, bit for bit.  The CPU wrapper is the
    plain version."""
    p = problem(seed=3)
    jp, tp = both(p)
    inlier = np.random.default_rng(1).uniform(size=len(p["obs_kf"])) > 0.05
    ti = torch.as_tensor(inlier)
    blocks = tba.build_normal_blocks_plain(TCAM, BF, tp.R, tp.t, tp.xw, tp, ti)
    lam = torch.tensor(1e-4)
    dp, dl = tba.schur_solve_plain(*blocks[:6], tp.pose_fixed, tp.lm_valid, lam)
    ok = None  # the global BA's form: the cost test alone
    if step == "rejected":
        dp, dl = 3.0 * dp, 3.0 * dl
    cost_old = blocks[6]
    got = tba.lm_update_plain(TCAM, BF, tp, tp.R, tp.t, tp.xw, dp, dl, ti, cost_old, ok, lam)
    want = jax_lm_update(jp, jp.R, jp.t, jp.xw, jnp.asarray(dp.numpy()), jnp.asarray(dl.numpy()), jnp.asarray(inlier),
                         jnp.float32(cost_old.item()), jnp.float32(1e-4))
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)
    assert bool(got[4]) == bool(want[4]) == (step == "accepted")
    assert float(got[3]) == float(want[3]) == np.float32(1e-4) * np.float32(0.5 if step == "accepted" else 5.0)
    assert float(got[5]) == pytest.approx(float(want[5]), rel=1e-5)
    if step == "rejected":
        assert torch.equal(got[0], tp.R) and torch.equal(got[1], tp.t) and torch.equal(got[2], tp.xw)
    for g, w in zip(tba.lm_update(TCAM, BF, tp, tp.R, tp.t, tp.xw, dp, dl, ti, cost_old, ok, lam), got):
        assert torch.equal(g, w)
    # a solve that failed rejects the step whatever its cost
    failed = tba.lm_update_plain(TCAM, BF, tp, tp.R, tp.t, tp.xw, dp, dl, ti, cost_old, torch.tensor(False), lam)
    assert not bool(failed[4]) and torch.equal(failed[2], tp.xw)
    assert float(failed[3]) == np.float32(1e-4) * np.float32(5)


def test_zero_step_is_rejected():
    """At dp = dl = 0 the candidate's cost is the blocks' cost, bit for bit,
    and the step is rejected (the damping multiplied by 5)."""
    _, tp = both(problem(seed=3))
    inl = torch.ones_like(tp.obs_valid)
    cost_old = tba.build_normal_blocks_plain(TCAM, BF, tp.R, tp.t, tp.xw, tp, inl)[6]
    out = tba.lm_update_plain(TCAM, BF, tp, tp.R, tp.t, tp.xw, torch.zeros(4, 6), torch.zeros_like(tp.xw),
                              inl, cost_old, None, torch.tensor(1e-4))
    assert float(out[5]) == float(cost_old) and not bool(out[4])


def test_classify_plain_matches_jax():
    """The chi2 gate at a perturbed state against the JAX package's jitted
    ``ba_cg.classify``: the masks equal (no observation's chi2 lies within
    1e-4 of its bound here); the CPU wrappers of both BA forms are the
    plain version."""
    p = problem(seed=4)
    jp, tp = both(p)
    xw = tp.xw + 0.03 * torch.sin(torch.arange(tp.xw.numel(), dtype=torch.float32)).view(-1, 3)
    got = tba.classify_plain(TCAM, BF, tp, tp.R, tp.t, xw)
    want = np.asarray(jcg.classify(JCAM, jnp.float32(BF), jp, jp.R, jp.t, jnp.asarray(xw.numpy())))
    r, _, _ = tba._obs_residuals(TCAM, BF, tp.R, tp.t, xw, tp)
    ratio = (r * r).sum(-1) * tp.obs_inv_sigma2 / tba._delta2(tp)
    assert not bool(((ratio - 1).abs() < 1e-4).any())
    assert 0 < int(got.sum()) < int(tp.obs_valid.sum())
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(tba.classify(TCAM, BF, tp, tp.R, tp.t, xw), got)
    assert torch.equal(tcg.classify(TCAM, BF, tp, tp.R, tp.t, xw), got)
