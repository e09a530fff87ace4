"""Parity of the port's IMU preintegration (kernel V's plain version) with
the JAX package, on the scenarios of tests/test_imu.py, and the state
carried across by utils/convert.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam3_fast_tpu.imu import preintegration as jpre
from orb_slam3_fast_tpu_torch.imu import preintegration as tpre
from orb_slam3_fast_tpu_torch.utils import convert

torch.set_num_threads(1)

J_NOISE = jpre.ImuNoise.from_continuous(1.7e-4, 2e-3, 1.9e-5, 3e-3, 200.0)
T_NOISE = tpre.ImuNoise.from_continuous(1.7e-4, 2e-3, 1.9e-5, 3e-3, 200.0)
DT = 1.0 / 200.0


def window(rng, n=64, n_valid=None):
    acc = (rng.normal(size=(n, 3)) * 2.0 + np.array([0, 0, 9.81])).astype(np.float32)
    gyro = (rng.normal(size=(n, 3)) * 0.3).astype(np.float32)
    dts = np.full(n, DT, np.float32)
    valid = np.arange(n) < (n if n_valid is None else n_valid)
    bias = (rng.normal(size=6) * 0.01).astype(np.float32)
    return acc, gyro, dts, valid, bias


def assert_preint_close(pt: tpre.Preintegrated, pj, atol_state=2e-5, rtol_c=2e-4):
    """Float32 scans of 64 steps in two frameworks: the deltas and
    Jacobians within 2e-5 (each step re-orthonormalises dR by an SVD, whose
    last bits differ), the covariance within 2e-4 of its largest entry."""
    for f in ("dT", "dR", "dV", "dP", "JRg", "JVg", "JVa", "JPg", "JPa", "bias"):
        np.testing.assert_allclose(getattr(pt, f).numpy(), np.asarray(getattr(pj, f)), atol=atol_state, err_msg=f)
    Cj = np.asarray(pj.C)
    np.testing.assert_allclose(pt.C.numpy(), Cj, atol=rtol_c * np.abs(Cj).max())


def test_noise_from_continuous():
    assert convert.inertial_to_torch(J_NOISE) == T_NOISE
    for a, b in zip(T_NOISE, J_NOISE):
        assert np.float32(a) == np.float32(b)


@pytest.mark.parametrize("n_valid", [64, 40])
def test_preintegrate_matches_reference(rng, n_valid):
    acc, gyro, dts, valid, bias = window(rng, 64, n_valid)
    pj = jpre.preintegrate(jnp.asarray(acc), jnp.asarray(gyro), jnp.asarray(dts), jnp.asarray(bias), J_NOISE,
                           valid=jnp.asarray(valid))
    pt = tpre.preintegrate(torch.as_tensor(acc), torch.as_tensor(gyro), torch.as_tensor(dts), torch.as_tensor(bias),
                           T_NOISE, valid=torch.as_tensor(valid))
    assert_preint_close(pt, pj)


def test_merge_and_compose_match_reference(rng):
    acc, gyro, dts, valid, bias = window(rng, 64)
    acc2, gyro2, dts2, valid2, _ = window(rng, 64, 50)
    pj1 = jpre.preintegrate(jnp.asarray(acc), jnp.asarray(gyro), jnp.asarray(dts), jnp.asarray(bias), J_NOISE)
    pj2 = jpre.preintegrate(jnp.asarray(acc2), jnp.asarray(gyro2), jnp.asarray(dts2), jnp.asarray(bias), J_NOISE,
                            valid=jnp.asarray(valid2))
    pt1 = convert.inertial_to_torch(pj1)
    mj = jpre.merge(pj1, jnp.asarray(acc2), jnp.asarray(gyro2), jnp.asarray(dts2), J_NOISE, valid=jnp.asarray(valid2))
    mt = tpre.merge(pt1, torch.as_tensor(acc2), torch.as_tensor(gyro2), torch.as_tensor(dts2), T_NOISE,
                    valid=torch.as_tensor(valid2))
    assert_preint_close(mt, mj)
    cj = jpre.compose(pj1, pj2)
    ct = tpre.compose(pt1, convert.inertial_to_torch(pj2))
    assert_preint_close(ct, cj, atol_state=1e-5, rtol_c=1e-5)
    # composing two windows approximates integrating them in one go
    np.testing.assert_allclose(ct.dR.numpy(), mt.dR.numpy(), atol=1e-4)
    np.testing.assert_allclose(ct.dV.numpy(), mt.dV.numpy(), atol=1e-3)


def test_pack_round_trip(rng):
    acc, gyro, dts, valid, bias = window(rng, 16)
    pt = tpre.preintegrate(torch.as_tensor(acc), torch.as_tensor(gyro), torch.as_tensor(dts), torch.as_tensor(bias),
                           T_NOISE)
    back = tpre.unpack(tpre.pack(pt))
    for a, b in zip(pt, back):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    stacked = tpre.stack([pt, pt])
    assert tpre.unpack(tpre.pack(stacked)).C.shape == (2, 15, 15)


def test_predict_state_and_bias_correction(rng):
    acc, gyro, dts, valid, bias = window(rng, 64)
    pj = jpre.preintegrate(jnp.asarray(acc), jnp.asarray(gyro), jnp.asarray(dts), jnp.zeros(6), J_NOISE)
    pt = convert.inertial_to_torch(pj)
    R0 = np.asarray([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]], np.float32)
    p0, v0 = np.asarray([1.0, 2.0, 3.0], np.float32), np.asarray([0.5, -0.2, 0.1], np.float32)
    Rj, pj2, vj = jpre.predict_state(jnp.asarray(R0), jnp.asarray(p0), jnp.asarray(v0), pj, jnp.asarray(bias))
    Rt, pt2, vt = tpre.predict_state(torch.as_tensor(R0), torch.as_tensor(p0), torch.as_tensor(v0), pt,
                                     torch.as_tensor(bias))
    np.testing.assert_allclose(Rt.numpy(), np.asarray(Rj), atol=1e-6)
    np.testing.assert_allclose(pt2.numpy(), np.asarray(pj2), atol=1e-5)
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), atol=1e-5)
    for fn in ("delta_rotation", "delta_velocity", "delta_position"):
        np.testing.assert_allclose(getattr(tpre, fn)(pt, torch.as_tensor(bias)).numpy(),
                                   np.asarray(getattr(jpre, fn)(pj, jnp.asarray(bias))), atol=1e-6)


def test_nan_sample_gives_nan_not_a_raise(rng):
    """A corrupt sample reaches the tracker's bad-IMU test as NaN in dR,
    dV and dP, in both packages; the plain version must not raise in its
    SVD (ROADMAP §C, non-finite input to an SVD)."""
    acc, gyro, dts, valid, bias = window(rng, 32)
    acc[5, 1] = np.nan
    gyro[9, 0] = np.inf
    pj = jpre.preintegrate(jnp.asarray(acc), jnp.asarray(gyro), jnp.asarray(dts), jnp.asarray(bias), J_NOISE)
    pt = tpre.preintegrate(torch.as_tensor(acc), torch.as_tensor(gyro), torch.as_tensor(dts), torch.as_tensor(bias),
                           T_NOISE)
    for f in ("dR", "dV", "dP"):
        assert not np.isfinite(np.asarray(getattr(pj, f))).all()
        assert not torch.isfinite(getattr(pt, f)).all()


def test_convert_round_trip(rng):
    acc, gyro, dts, valid, bias = window(rng, 8)
    pj = jpre.preintegrate(jnp.asarray(acc), jnp.asarray(gyro), jnp.asarray(dts), jnp.asarray(bias), J_NOISE)
    back = jpre.Preintegrated(**convert.inertial_to_numpy(convert.inertial_to_torch(pj)))
    for a, b in zip(back, pj):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    noise = jpre.ImuNoise(**convert.inertial_to_numpy(T_NOISE))
    assert all(np.float32(a) == np.float32(b) for a, b in zip(noise, J_NOISE))
