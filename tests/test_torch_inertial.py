"""Parity of the port's inertial factors and visual-inertial frame
optimisation (kernel W's plain version) with the JAX package, on the
scenario of tests/test_inertial.py: the KF-anchored form with and without a
prior, and the last-frame form, with a camera offset from the body, stereo
edges and outliers."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam3_fast_tpu.cameras import models as jcam
from orb_slam3_fast_tpu.optim import inertial as jinr
from orb_slam3_fast_tpu.utils import lie as jlie
from orb_slam3_fast_tpu_torch.cameras import models as tcam
from orb_slam3_fast_tpu_torch.optim import inertial as tinr
from orb_slam3_fast_tpu_torch.utils import convert
from orb_slam3_fast_tpu_torch.utils import lie as tlie
from tests.test_inertial import preintegrate_segments, simulate_trajectory

torch.set_num_threads(1)

FX, BF = 400.0, 40.0
J_CAM = jcam.Camera.pinhole(FX, FX, 320.0, 240.0)
T_CAM = tcam.Camera.pinhole(FX, FX, 320.0, 240.0)
# camera -> body (IMU.T_b_c1 style), a few cm and a few degrees off
T_BC = np.eye(4, dtype=np.float32)
T_BC[:3, :3] = np.asarray(jlie.so3_exp(jnp.asarray([0.02, -0.03, 0.01])))
T_BC[:3, 3] = [0.05, -0.02, 0.01]


def t_cb_pair():
    Tj = jlie.SE3(jnp.asarray(T_BC[:3, :3]), jnp.asarray(T_BC[:3, 3])).inverse()
    return Tj, tlie.SE3(torch.tensor(np.asarray(Tj.R)), torch.tensor(np.asarray(Tj.t)))


def scenario(seed, n=200, stereo=True, outliers=0.1):
    rng = np.random.default_rng(seed)
    states, segments, dt = simulate_trajectory(rng, n_kf=2)
    preint = jax.tree.map(lambda a: a[0], preintegrate_segments(segments, dt))
    bias0 = np.asarray([0.001, -0.002, 0.0015, 0.02, -0.01, 0.03], np.float32)
    s_prev = jinr.BodyState(*(jnp.asarray(x, jnp.float32) for x in states[0]), jnp.asarray(bias0))
    s_true = jinr.BodyState(*(jnp.asarray(x, jnp.float32) for x in states[1]), jnp.asarray(bias0))
    Tj, _ = t_cb_pair()
    xw = np.stack([rng.uniform(-4, 4, n), rng.uniform(-3, 3, n), rng.uniform(4, 12, n)], -1).astype(np.float32)
    R_cw = np.asarray(Tj.R) @ np.asarray(s_true.R).T
    t_cw = np.asarray(Tj.R) @ (-np.asarray(s_true.R).T @ np.asarray(s_true.p)) + np.asarray(Tj.t)
    xc = xw @ R_cw.T + t_cw
    uvr = np.array(jcam.stereo_project(J_CAM, jnp.asarray(xc), jnp.float32(BF)))
    uvr += rng.normal(0, 0.3, uvr.shape)
    is_st = (rng.uniform(size=n) < 0.5) if stereo else np.zeros(n, bool)
    uvr[~is_st, 2] = -1.0
    n_out = int(outliers * n)
    uvr[:n_out, :2] += rng.uniform(20, 40, (n_out, 2))
    valid = rng.uniform(size=n) > 0.05
    level = rng.integers(0, 4, n)
    obs = jinr.VIObs(jnp.asarray(xw), jnp.asarray(uvr.astype(np.float32)),
                     jnp.asarray((1.0 / 1.44**level).astype(np.float32)), jnp.asarray(is_st & valid),
                     jnp.asarray(valid))
    s0 = jinr.BodyState(s_true.R @ jlie.so3_exp(jnp.asarray([0.02, -0.01, 0.015])),
                        s_true.p + jnp.asarray([0.05, -0.03, 0.02]), s_true.v + jnp.asarray([0.1, 0.05, -0.05]),
                        s_true.bias)
    return preint, s_prev, s_true, s0, obs


def assert_state_close(st, sj, tol_R=2e-4, tol_p=2e-3, tol_v=5e-3, tol_b=1e-3):
    np.testing.assert_allclose(st.R.numpy(), np.asarray(sj.R), atol=tol_R)
    np.testing.assert_allclose(st.p.numpy(), np.asarray(sj.p), atol=tol_p)
    np.testing.assert_allclose(st.v.numpy(), np.asarray(sj.v), atol=tol_v)
    np.testing.assert_allclose(st.bias.numpy(), np.asarray(sj.bias), atol=tol_b)


def test_factors_and_jacobian_match_reference():
    """The residuals, the informations and the closed-form reprojection
    Jacobian against jax.jacfwd, at a state off the truth."""
    preint, s_prev, s_true, s0, obs = scenario(0)
    Tj, Tt = t_cb_pair()
    pt, sp_t, s0_t = (convert.inertial_to_torch(x) for x in (preint, s_prev, s0))
    np.testing.assert_allclose(tinr.inertial_residual(sp_t, s0_t, pt).numpy(),
                               np.asarray(jinr.inertial_residual(s_prev, s0, preint)), atol=2e-5)
    info_j = np.asarray(jinr.inertial_information(preint))
    np.testing.assert_allclose(tinr.inertial_information(pt).numpy(), info_j, rtol=1e-3, atol=1e-3 * np.abs(info_j).max())
    obs_t = convert.inertial_to_torch(obs)
    zero = jnp.zeros(15)
    Jv_j = jax.jacfwd(lambda d: jinr._visual_residuals(J_CAM, jnp.float32(BF), Tj, jinr.retract(s0, d), obs)[0])(zero)
    r_t, xc_t, _ = tinr.visual_residuals(T_CAM, BF, Tt, s0_t, obs_t.xw, obs_t.uv, obs_t.is_stereo)
    J_t = tinr.visual_pose_jacobian(T_CAM, BF, Tt, s0_t.R, s0_t.p, obs_t.xw, xc_t, obs_t.is_stereo)
    Jv = np.asarray(Jv_j)
    np.testing.assert_allclose(J_t.numpy(), Jv[..., :6], atol=2e-3 * np.abs(Jv).max())
    assert np.abs(Jv[..., 6:]).max() == 0.0


@pytest.mark.parametrize("seed,with_prior", [(0, False), (1, True)])
def test_pose_inertial_optimization_matches_reference(seed, with_prior):
    """KF-anchored form.  Float32 LM in two frameworks with the chi2 rounds
    between: the states agree within 2e-4 (rotation entries), 2e-3 m, 5e-3
    m/s and 1e-3 in the biases; at most 2 edges classified otherwise; the
    information within 1e-3 of its largest entry."""
    preint, s_prev, s_true, s0, obs = scenario(seed)
    Tj, Tt = t_cb_pair()
    prior_j = None
    if with_prior:
        prior_j = jinr.PriorState(state=s_prev._replace(p=s_prev.p + 0.01),
                                  H=jnp.asarray(np.diag(np.linspace(10, 1e3, 15)).astype(np.float32)))
    sj, inl_j, n_j, H_j = jinr.pose_inertial_optimization(J_CAM, jnp.float32(BF), Tj, s_prev, preint, s0, obs,
                                                          prior=prior_j)
    to = convert.inertial_to_torch
    st, inl_t, n_t, H_t = tinr.pose_inertial_optimization(
        T_CAM, BF, Tt, to(s_prev), to(preint), to(s0), to(obs), prior=None if prior_j is None else to(prior_j))
    assert_state_close(st, sj)
    assert np.sum(inl_t.numpy() != np.asarray(inl_j)) <= 2
    assert abs(int(n_t) - int(n_j)) <= 2
    Hj = np.asarray(H_j)
    np.testing.assert_allclose(H_t.numpy(), Hj, atol=1e-3 * np.abs(Hj).max())
    assert np.abs(st.p.numpy() - np.asarray(s_true.p)).max() < 0.02


def test_pose_inertial_last_frame_matches_reference():
    """Last-frame form: the previous state free under its prior, then
    marginalised.  Tolerances as above; the marginal within 2e-3 of its
    largest entry (a float32 15x15 solve in each framework)."""
    preint, s_prev, s_true, s0, obs = scenario(2)
    Tj, Tt = t_cb_pair()
    prior_j = jinr.PriorState(state=s_prev, H=jnp.asarray(1e4 * np.eye(15, dtype=np.float32)))
    sj, inl_j, n_j, H_j = jinr.pose_inertial_optimization_last_frame(J_CAM, jnp.float32(BF), Tj, s_prev, prior_j,
                                                                     preint, s0, obs)
    to = convert.inertial_to_torch
    st, inl_t, n_t, H_t = tinr.pose_inertial_optimization_last_frame(T_CAM, BF, Tt, to(s_prev), to(prior_j),
                                                                     to(preint), to(s0), to(obs))
    assert_state_close(st, sj)
    assert np.sum(inl_t.numpy() != np.asarray(inl_j)) <= 2
    Hj = np.asarray(H_j)
    np.testing.assert_allclose(H_t.numpy(), Hj, atol=2e-3 * np.abs(Hj).max())


def test_state_round_trip_and_packing():
    preint, s_prev, s_true, s0, obs = scenario(3, n=16)
    prior = jinr.PriorState(state=s_prev, H=jnp.eye(15))
    back = convert.inertial_to_numpy(convert.inertial_to_torch(prior))
    rebuilt = jinr.PriorState(state=jinr.BodyState(**back["state"]), H=back["H"])
    for a, b in zip(jax.tree.leaves(rebuilt), jax.tree.leaves(prior)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    st = convert.inertial_to_torch(s0)
    for a, b in zip(tinr.unpack_state(tinr.pack_state(st)), st):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    o = convert.inertial_to_torch(obs)
    assert o.valid.dtype == torch.bool and o.xw.dtype == torch.float32
