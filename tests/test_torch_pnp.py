"""PnP RANSAC of the port (optim/pnp.py, kernel P's plain version) against
the JAX package's optim/pnp.pnp_ransac on the same numpy inputs, with the
JAX package's own subsets (its ``_sample_subsets`` with the same key); the
closed-form Gauss-Newton Jacobian against ``torch.func.jacfwd``; and
``normalize_rotation`` against the JAX package's."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from orb_slam3_fast_tpu.cameras import models as jcam
from orb_slam3_fast_tpu.optim import pnp as jpnp
from orb_slam3_fast_tpu.utils import lie as jlie
from orb_slam3_fast_tpu_torch.cameras import models as tcam
from orb_slam3_fast_tpu_torch.optim import pnp as tpnp
from orb_slam3_fast_tpu_torch.utils import lie as tlie

torch.set_num_threads(1)

JCAM = jcam.Camera.pinhole(400.0, 400.0, 320.0, 240.0)
TCAM = tcam.Camera.pinhole(400.0, 400.0, 320.0, 240.0)


rot_angle = chip_smoke.rot_angle


@pytest.mark.parametrize("seed, n, n_valid, outliers", [(0, 256, 200, 0.2), (1, 128, 40, 0.4)])
def test_pnp_ransac_matches_jax(seed, n, n_valid, outliers):
    """The winning count and ``ok`` equal; the pose within 1e-3 rad and 1e-3
    of the scene scale; the inlier masks equal but for 1% of the slots."""
    xw, uv, inv_s2, valid, R_true, _ = chip_smoke.pnp_problem(np.random.default_rng(seed), n, n_valid, outliers)
    key = jax.random.PRNGKey(seed + 7)
    rj = jpnp.pnp_ransac(JCAM, *(jnp.asarray(a) for a in (xw, uv, inv_s2, valid)), key, n_hyp=64)
    subsets = torch.as_tensor(np.asarray(jpnp._sample_subsets(key, jnp.asarray(valid), 64)))
    rt = tpnp.pnp_ransac(TCAM, *(torch.as_tensor(a) for a in (xw, uv, inv_s2, valid)), 0, subsets=subsets)
    assert int(rt.n_inliers) == int(rj.n_inliers) and bool(rt.ok) == bool(rj.ok) and bool(rt.ok)
    assert rot_angle(rt.R.numpy(), np.asarray(rj.R)) <= 1e-3
    scale = float(np.median(np.linalg.norm(xw[valid], axis=1)))
    assert np.linalg.norm(rt.t.numpy() - np.asarray(rj.t)) <= 1e-3 * scale
    assert (rt.inliers.numpy() != np.asarray(rj.inliers)).mean() <= 0.01
    assert rot_angle(rt.R.numpy(), R_true) < 0.02  # and the pose is the true one


def test_sample_subsets_distribution():
    """Six distinct valid indices per row, the same draws for the same seed,
    and every valid point drawn about equally often."""
    valid = torch.zeros(100, dtype=torch.bool)
    valid[::3] = True
    a, b = tpnp._sample_subsets(5, valid, 2000), tpnp._sample_subsets(5, valid, 2000)
    assert torch.equal(a, b) and a.shape == (2000, 6)
    assert bool(valid[a].all())
    assert all(len(set(r.tolist())) == 6 for r in a[:50])
    counts = torch.bincount(a.flatten(), minlength=100)[valid].double()
    assert float(counts.std() / counts.mean()) < 0.15


def test_solve_dlt_and_procrustes_match_jax():
    """Both sign candidates of the 6-point DLT (after Procrustes) equal the
    JAX package's up to float rounding, in either order."""
    rng = np.random.default_rng(4)
    xw = rng.uniform(-1, 1, (6, 3)).astype(np.float32)
    R = np.asarray(jlie.so3_exp(jnp.asarray([0.1, -0.2, 0.05], jnp.float32)))
    xc = xw @ R.T + [0.1, 0.2, 3.0]
    xn = (xc[:, :2] / xc[:, 2:] + rng.normal(0, 1e-3, (6, 2))).astype(np.float32)
    Rj, tj = (np.asarray(x) for x in jpnp._solve_dlt(jnp.asarray(xw), jnp.asarray(xn)))
    Rt, tt = (x.numpy() for x in tpnp._solve_dlt(torch.as_tensor(xw), torch.as_tensor(xn)))
    order = [0, 1] if np.abs(Rt[0] - Rj[0]).max() < np.abs(Rt[0] - Rj[1]).max() else [1, 0]
    np.testing.assert_allclose(Rt[order], Rj, atol=1e-4)
    np.testing.assert_allclose(tt[order], tj, atol=1e-4 * np.abs(tj).max())


def test_gn_jacobian_matches_autodiff():
    """The closed-form 12x6 Jacobian of the GN residual against
    ``torch.func.jacfwd`` of the residual of a left increment [w, v] at 0,
    including a point held at |z| < 1e-6."""
    rng = np.random.default_rng(5)
    R = tlie.so3_exp(torch.tensor([0.2, -0.1, 0.3], dtype=torch.float64))
    t = torch.tensor([0.1, -0.3, 2.0], dtype=torch.float64)
    xw = torch.as_tensor(rng.uniform(-1, 1, (6, 3)))
    xw[5] = R.T @ (torch.tensor([0.3, 0.2, 1e-7], dtype=torch.float64) - t)  # this point sits at z ~ 1e-7
    xn = torch.as_tensor(rng.uniform(-0.3, 0.3, (6, 2)))

    def residual(xi):
        dR = tlie.so3_exp(xi[:3])
        return tpnp._residual(dR @ R, dR @ t + xi[3:], xw, xn)

    J_ad = torch.func.jacfwd(residual)(torch.zeros(6, dtype=torch.float64))
    torch.testing.assert_close(tpnp.gn_jacobian(R, t, xw), J_ad, rtol=1e-9, atol=1e-9)


def test_refine_gn_matches_jax():
    """4 GN steps from a perturbed pose land on the JAX package's result."""
    rng = np.random.default_rng(6)
    xw = (rng.uniform(-1, 1, (6, 3)) + [0, 0, 4]).astype(np.float32)
    R0 = np.asarray(jlie.so3_exp(jnp.asarray([0.03, 0.02, -0.01], jnp.float32)))
    t0 = np.array([0.05, -0.02, 0.1], np.float32)
    xn = (xw[:, :2] / xw[:, 2:] + rng.normal(0, 1e-3, (6, 2))).astype(np.float32)
    Rj, tj = jpnp._refine_gn(jnp.asarray(R0), jnp.asarray(t0), jnp.asarray(xw), jnp.asarray(xn))
    Rt, tt = tpnp._refine_gn(*(torch.as_tensor(a) for a in (R0, t0, xw, xn)))
    np.testing.assert_allclose(Rt.numpy(), np.asarray(Rj), atol=1e-5)
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), atol=1e-5)


def test_normalize_rotation_matches_jax():
    rng = np.random.default_rng(7)
    R = np.asarray(jlie.so3_exp(jnp.asarray(rng.normal(0, 0.5, (5, 3)), jnp.float32)))
    R = (R + rng.normal(0, 1e-3, R.shape)).astype(np.float32)
    R[4] = -R[4] * [1.0, 0.9, 0.8]  # a reflection with distinct singular values: the determinant fix
    np.testing.assert_allclose(tlie.normalize_rotation(torch.as_tensor(R)).numpy(),
                               np.asarray(jlie.normalize_rotation(jnp.asarray(R))), atol=1e-6)


def test_cpu_wrapper_is_the_plain_version():
    xw, uv, inv_s2, valid, _, _ = chip_smoke.pnp_problem(np.random.default_rng(2), 96, 60, 0.2)
    args = [torch.as_tensor(a) for a in (xw, uv, inv_s2, valid)]
    before = tpnp.pnp_ransac.launches.total()
    subsets = tpnp._sample_subsets(3, args[3], 32)
    for x, y in zip(tpnp.pnp_ransac(TCAM, *args, 3, n_hyp=32), tpnp.pnp_ransac_plain(TCAM, *args, subsets)):
        assert torch.equal(x, y)
    assert tpnp.pnp_ransac.launches.total() == before
