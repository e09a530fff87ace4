"""Parity of the port's IMU initialisation (kernel X's plain version) with
the JAX package, on the scenarios of tests/test_inertial.py: the inertial-
only optimisation with and without fixed scale and with padding edges, and
the scale refinement."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam3_fast_tpu.optim import imu_init as jinit
from orb_slam3_fast_tpu.utils import lie as jlie
from orb_slam3_fast_tpu_torch.optim import imu_init as tinit
from orb_slam3_fast_tpu_torch.utils import convert
from tests.test_inertial import preintegrate_segments, simulate_trajectory

torch.set_num_threads(1)

BG = np.array([0.02, -0.01, 0.015])
BA = np.array([0.05, 0.08, -0.06])


def chain(seed, n_kf=10, pad=0):
    rng = np.random.default_rng(seed)
    states, segments, dt = simulate_trajectory(rng, n_kf=n_kf, gyro_bias=BG, acc_bias=BA)
    preints = preintegrate_segments(segments, dt)
    rot = np.asarray(jlie.so3_exp(jnp.asarray([0.15, -0.1, 0.0])))
    R_wb = np.stack([rot @ s[0] for s in states]).astype(np.float32)
    p_wb = np.stack([rot @ s[1] / 3.0 for s in states]).astype(np.float32)
    vel = np.stack([rot @ s[2] / 3.0 for s in states]).astype(np.float32)
    edge_valid = None
    if pad:
        R_wb = np.concatenate([R_wb, np.repeat(R_wb[-1:], pad, 0)])
        p_wb = np.concatenate([p_wb, np.repeat(p_wb[-1:], pad, 0)])
        vel = np.concatenate([vel, np.repeat(vel[-1:], pad, 0)])
        preints = jax.tree.map(lambda a: jnp.concatenate([a, jnp.repeat(a[-1:], pad, 0)]), preints)
        edge_valid = np.arange(1, n_kf + pad) < n_kf
    return R_wb, p_wb, vel, preints, edge_valid


@pytest.mark.parametrize("fix_scale,pad,priors", [(False, 0, (1e-2, 1e-2)), (False, 6, (1e2, 1e6)),
                                                   (True, 0, (1e2, 1e6))])
def test_inertial_only_optimization_matches_reference(fix_scale, pad, priors):
    """40 float32 LM iterations over P = 9 + 3K parameters in two
    frameworks: scale within 2e-3 (relative), gravity rotation entries
    within 1e-4, biases within 2e-4, velocities within 2e-3 (relative to
    their largest)."""
    R_wb, p_wb, vel, preints, ev = chain(0, pad=pad)
    ev_j = None if ev is None else jnp.asarray(ev)
    ij = jinit.inertial_only_optimization(jnp.asarray(R_wb), jnp.asarray(p_wb), preints, prior_gyro=priors[0],
                                          prior_acc=priors[1], fix_scale=fix_scale, edge_valid=ev_j)
    it = tinit.inertial_only_optimization(torch.as_tensor(R_wb), torch.as_tensor(p_wb),
                                          convert.inertial_to_torch(preints), prior_gyro=priors[0],
                                          prior_acc=priors[1], fix_scale=fix_scale,
                                          edge_valid=None if ev is None else torch.as_tensor(ev))
    assert abs(float(it.scale) / float(ij.scale) - 1.0) < 2e-3
    np.testing.assert_allclose(it.Rwg.numpy(), np.asarray(ij.Rwg), atol=1e-4)
    np.testing.assert_allclose(it.bias.numpy(), np.asarray(ij.bias), atol=2e-4)
    vj = np.asarray(ij.vel)
    np.testing.assert_allclose(it.vel.numpy(), vj, atol=2e-3 * np.abs(vj).max())
    if not fix_scale and priors[0] < 1:
        assert abs(float(it.scale) - 3.0) < 0.06
    if fix_scale:
        assert float(it.scale) == 1.0


def test_scale_gravity_refinement_matches_reference():
    """20 LM iterations over 3 parameters: scale within 1e-4, gravity
    rotation entries within 1e-5."""
    R_wb, p_wb, vel, preints, _ = chain(1)
    p_wb, vel = p_wb * 3.0 / 1.08, vel * 3.0 / 1.08
    Rj, sj = jinit.scale_gravity_refinement(jnp.asarray(R_wb), jnp.asarray(p_wb), jnp.asarray(vel),
                                            jnp.asarray(np.r_[BG, BA].astype(np.float32)), preints)
    Rt, st = tinit.scale_gravity_refinement(torch.as_tensor(R_wb), torch.as_tensor(p_wb), torch.as_tensor(vel),
                                            torch.as_tensor(np.r_[BG, BA].astype(np.float32)),
                                            convert.inertial_to_torch(preints))
    assert abs(float(st) - float(sj)) < 1e-4
    np.testing.assert_allclose(Rt.numpy(), np.asarray(Rj), atol=1e-5)
    init = tinit.InertialInit(Rwg=Rt, scale=st, vel=torch.as_tensor(vel), bias=torch.zeros(6))
    R_gw, s = tinit.gravity_alignment_transform(init)
    np.testing.assert_allclose(R_gw.numpy(), Rt.numpy().T)
    back = jinit.InertialInit(**convert.inertial_to_numpy(init))
    np.testing.assert_array_equal(np.asarray(back.Rwg), Rt.numpy())
