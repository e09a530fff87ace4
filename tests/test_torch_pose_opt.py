"""Parity of the port's pose optimisation (kernel D's plain version) with
the JAX package, with outliers, mono and stereo edges and invalid slots."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam3_fast_tpu.cameras import models as jcam
from orb_slam3_fast_tpu.optim import pose_opt as jpo
from orb_slam3_fast_tpu.utils import lie as jlie
from orb_slam3_fast_tpu_torch.cameras import models as tcam
from orb_slam3_fast_tpu_torch.optim import pose_opt as tpo
from orb_slam3_fast_tpu_torch.utils import lie as tlie

torch.set_num_threads(1)

FX, FY, CX, CY, BF = 458.654, 457.296, 367.215, 248.375, 47.9


def problem(rng, n=256, outlier_frac=0.15, stereo_frac=0.5, invalid_frac=0.1):
    xw = np.stack([rng.uniform(-3, 3, n), rng.uniform(-2, 2, n), rng.uniform(3, 15, n)], -1).astype(np.float32)
    T_gt = jlie.se3_exp(jnp.asarray([0.15, -0.1, 0.2, 0.03, -0.02, 0.04], jnp.float32))
    cam = jcam.Camera.pinhole(FX, FY, CX, CY)
    uvr = np.array(jcam.stereo_project(cam, T_gt.apply(jnp.asarray(xw)), jnp.float32(BF)))
    level = rng.integers(0, 8, n)
    inv_s2 = (1.0 / 1.44**level).astype(np.float32)
    uvr += rng.normal(0, 0.4, uvr.shape).astype(np.float32) * np.sqrt(1.44**level)[:, None]
    stereo = rng.uniform(size=n) < stereo_frac
    uvr[~stereo, 2] = -1.0
    n_out = int(n * outlier_frac)
    uvr[:n_out, :2] += rng.uniform(15, 50, (n_out, 2)) * rng.choice([-1, 1], (n_out, 2))
    valid = rng.uniform(size=n) > invalid_frac
    xw[~valid] = 0.0
    uvr[~valid] = -1.0
    return xw, uvr.astype(np.float32), inv_s2, stereo & valid, valid


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pose_optimization_matches_reference(seed):
    """Start 0.1 rad / 0.3 m off, 15% outliers.  Both run every round with
    the round-0 mask (the reference's scan reuses its first trace).  The
    accept test (cost_new < cost) compares float32 sums taken in another
    order, so a borderline step may go the other way and the two stop at
    slightly different points of the same minimum: rotation entries within
    1e-4, translation within 1e-3 m, at most 2 edges classified otherwise."""
    rng = np.random.default_rng(seed)
    xw, uvr, inv_s2, stereo, valid = problem(rng)
    T0_j = jlie.se3_exp(jnp.asarray([0.3, 0.0, -0.1, 0.1, 0.0, 0.0], jnp.float32))
    cam_j = jcam.Camera.pinhole(FX, FY, CX, CY)
    obs_j = jpo.PoseObs(jnp.asarray(xw), jnp.asarray(uvr), jnp.asarray(inv_s2), jnp.asarray(stereo), jnp.asarray(valid))
    Tj, inl_j, n_j = jpo.pose_optimization(cam_j, jnp.float32(BF), T0_j, obs_j)

    cam_t = tcam.Camera.pinhole(FX, FY, CX, CY)
    T0_t = tlie.SE3(torch.tensor(np.asarray(T0_j.R)), torch.tensor(np.asarray(T0_j.t)))
    obs_t = tpo.PoseObs(
        torch.as_tensor(xw), torch.as_tensor(uvr), torch.as_tensor(inv_s2), torch.as_tensor(stereo), torch.as_tensor(valid)
    )
    Tt, inl_t, n_t = tpo.pose_optimization(cam_t, BF, T0_t, obs_t)
    np.testing.assert_allclose(Tt.R.numpy(), np.asarray(Tj.R), atol=1e-4)
    np.testing.assert_allclose(Tt.t.numpy(), np.asarray(Tj.t), atol=1e-3)
    assert np.sum(inl_t.numpy() != np.asarray(inl_j)) <= 2
    assert abs(int(n_t) - int(n_j)) <= 2
    # and both found the truth, outliers rejected
    T_gt = jlie.se3_exp(jnp.asarray([0.15, -0.1, 0.2, 0.03, -0.02, 0.04], jnp.float32))
    assert np.abs(Tt.t.numpy() - np.asarray(T_gt.t)).max() < 0.05
    assert not inl_t.numpy()[: int(256 * 0.15)].any()


def test_normal_equations_match_reference(rng):
    """One linearisation: H, g and cost against the reference's AD-built
    ones (closed-form Jacobian here); float32 sums of ~250 terms."""
    xw, uvr, inv_s2, stereo, valid = problem(rng)
    T_j = jlie.se3_exp(jnp.asarray([0.2, -0.1, 0.1, 0.05, 0.0, 0.03], jnp.float32))
    obs_j = jpo.PoseObs(jnp.asarray(xw), jnp.asarray(uvr), jnp.asarray(inv_s2), jnp.asarray(stereo), jnp.asarray(valid))
    inl = rng.uniform(size=len(valid)) > 0.2
    H_j, g_j, c_j, _, _ = jpo._build_normal_eqs(
        jcam.Camera.pinhole(FX, FY, CX, CY), jnp.float32(BF), T_j, obs_j, jnp.asarray(inl)
    )
    T_t = tlie.SE3(torch.tensor(np.asarray(T_j.R)), torch.tensor(np.asarray(T_j.t)))
    obs_t = tpo.PoseObs(
        torch.as_tensor(xw), torch.as_tensor(uvr), torch.as_tensor(inv_s2), torch.as_tensor(stereo), torch.as_tensor(valid)
    )
    H_t, g_t, c_t = tpo._build_normal_eqs(tcam.Camera.pinhole(FX, FY, CX, CY), BF, T_t, obs_t, torch.as_tensor(inl))
    np.testing.assert_allclose(H_t.numpy(), np.asarray(H_j), rtol=1e-4, atol=1e-6 * float(np.abs(H_j).max()))
    np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), rtol=1e-4, atol=1e-4 * float(np.abs(g_j).max()))
    np.testing.assert_allclose(float(c_t), float(c_j), rtol=1e-5)
