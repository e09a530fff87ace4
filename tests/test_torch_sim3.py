"""The port's Sim3 Lie maps, Horn solve, Sim3 RANSAC (kernel Q's plain
version) and Sim3 refinement (kernel R's plain version) against the JAX
package, on seeded numpy inputs; and R's closed-form Jacobian against
``torch.func.jacfwd`` of the plain residual."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam3_fast_tpu.cameras import models as jcam
from orb_slam3_fast_tpu.optim import sim3 as jsim3
from orb_slam3_fast_tpu.utils import lie as jlie
from orb_slam3_fast_tpu_torch.cameras import models as tcam
from orb_slam3_fast_tpu_torch.optim import sim3 as tsim3
from orb_slam3_fast_tpu_torch.utils import lie as tlie

torch.set_num_threads(1)

CAM_T = tcam.Camera.pinhole(400.0, 400.0, 320.0, 240.0)
CAM_J = jcam.Camera.pinhole(400.0, 400.0, 320.0, 240.0)


def _t(a):
    return torch.as_tensor(np.asarray(a, np.float32))


def _tangents(rng):
    """sim(3) tangents in each of _sim3_W_coeffs' four branches (|phi| and
    |sigma| either side of 0.05), and on the switch itself."""
    out = []
    for th, sg in ((0.01, 0.02), (0.01, 0.4), (0.6, 0.01), (0.7, -0.5), (0.05, 0.05), (1e-7, 1e-13)):
        axis = rng.normal(size=3)
        axis /= np.linalg.norm(axis)
        out.append(np.concatenate([rng.normal(size=3), th * axis, [sg]]).astype(np.float32))
    return np.stack(out)


def test_sim3_exp_log_match_jax_in_every_branch(rng):
    """exp within 2e-6 of the JAX package's (float32), log(exp(xi)) within
    1e-4 of xi and of the JAX log."""
    xi = _tangents(rng)
    S_t = tlie.sim3_exp(_t(xi))
    S_j = jlie.sim3_exp(jnp.asarray(xi))
    np.testing.assert_allclose(S_t.R.numpy(), np.asarray(S_j.R), atol=2e-6)
    np.testing.assert_allclose(S_t.t.numpy(), np.asarray(S_j.t), atol=2e-6, rtol=1e-5)
    np.testing.assert_allclose(S_t.s.numpy(), np.asarray(S_j.s), rtol=1e-6)
    for a, b in zip(tlie._sim3_W_coeffs(_t((xi[:, 3:6] ** 2).sum(1)), _t(xi[:, 6])),
                    jlie._sim3_W_coeffs(jnp.asarray((xi[:, 3:6] ** 2).sum(1)), jnp.asarray(xi[:, 6]))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-7)
    log_t = tlie.sim3_log(S_t).numpy()
    np.testing.assert_allclose(log_t, xi, atol=1e-4)
    np.testing.assert_allclose(log_t, np.asarray(jlie.sim3_log(S_j)), atol=1e-4)
    # se3_log and the group operations
    T = tlie.se3_exp(_t(xi[:, :6]))
    np.testing.assert_allclose(tlie.se3_log(T).numpy(), xi[:, :6], atol=1e-4)
    A, B = tlie.sim3_exp(_t(xi[:3])), tlie.sim3_exp(_t(xi[3:]))
    x = _t(rng.normal(size=(3, 3)))
    np.testing.assert_allclose(A.compose(B).apply(x).numpy(), A.apply(B.apply(x)).numpy(), atol=1e-5)
    np.testing.assert_allclose(A.inverse().apply(A.apply(x)).numpy(), x.numpy(), atol=1e-5)
    np.testing.assert_allclose(tlie.vee(tlie.hat(x)).numpy(), x.numpy())


def _pair_problem(rng, n=768, n_valid=300, outliers=0.25, s=1.3):
    """Matched points of two keyframes in their camera frames: xc2 in front
    of keyframe 2, xc1 = S12 xc2, pixel noise 0.5 px, a share of the pairs
    replaced by random points; padded to n slots."""
    xi = np.array([0.2, -0.1, 0.3, 0.05, -0.1, 0.08, np.log(s)], np.float32)
    S = jlie.sim3_exp(jnp.asarray(xi))
    R, t, sc = np.asarray(S.R), np.asarray(S.t), float(S.s)
    xc2 = np.zeros((n, 3), np.float32)
    xc2[:n_valid] = np.stack([rng.uniform(-2, 2, n_valid), rng.uniform(-1.5, 1.5, n_valid),
                              rng.uniform(3, 8, n_valid)], -1)
    xc1 = (sc * xc2 @ R.T + t).astype(np.float32)
    bad = rng.uniform(size=n) < outliers
    bad[n_valid:] = False
    xc1[bad] = np.stack([rng.uniform(-2, 2, bad.sum()), rng.uniform(-1.5, 1.5, bad.sum()),
                         rng.uniform(3, 8, bad.sum())], -1)
    fx = 400.0

    def proj(x):
        z = np.where(np.abs(x[:, 2]) < 1e-9, 1e-9, x[:, 2])
        return np.stack([fx * x[:, 0] / z + 320.0, fx * x[:, 1] / z + 240.0], -1)

    uv1 = (proj(xc1) + rng.normal(0, 0.5, (n, 2))).astype(np.float32)
    uv2 = (proj(xc2) + rng.normal(0, 0.5, (n, 2))).astype(np.float32)
    lvl1, lvl2 = rng.integers(0, 4, n), rng.integers(0, 4, n)
    is1 = (1.0 / 1.44 ** lvl1).astype(np.float32)
    is2 = (1.0 / 1.44 ** lvl2).astype(np.float32)
    valid = np.zeros(n, bool)
    valid[:n_valid] = True
    return dict(xc1=xc1, xc2=xc2, uv1=uv1, uv2=uv2, is1=is1, is2=is2, valid=valid), (R, t, sc)


def jax_subsets(key, valid, n_hyp=tsim3.N_HYP):
    """The JAX package's Sim3 RANSAC draw (sim3.py:87-89) for a key."""
    g = jax.random.gumbel(jax.random.PRNGKey(key), (n_hyp, valid.shape[0]))
    g = jnp.where(jnp.asarray(valid)[None, :], g, -jnp.inf)
    return torch.as_tensor(np.asarray(jax.lax.top_k(g, 3)[1]))


def test_jax_key_keeps_the_low_word():
    """loopcloser.py:427's key k * 2654435761 + c overflows 32 bits; JAX
    keeps its low word, which is the seed the port's generator takes."""
    key = 30 * 2654435761 + 5
    assert tsim3.jax_seed(key) == 2323661507
    np.testing.assert_array_equal(np.asarray(jax.random.PRNGKey(key)), [0, 2323661507])
    np.testing.assert_array_equal(np.asarray(jax.random.PRNGKey(tsim3.jax_seed(key))), [0, 2323661507])


def test_horn_matches_jax(rng):
    """Batched Horn within 5e-4 of the JAX solve on noiseless triples, with
    and without the scale (a 3-point float32 SVD: the two solvers round
    differently), and at the true Sim3."""
    p, (R, t, s) = _pair_problem(rng, outliers=0.0)
    sub = np.stack([rng.choice(300, 3, replace=False) for _ in range(16)])
    for fix in (False, True):
        S_t = tsim3.horn_sim3(_t(p["xc2"][sub]), _t(p["xc1"][sub]), fix_scale=fix)
        for i in range(16):
            S_j = jsim3.horn_sim3(jnp.asarray(p["xc2"][sub[i]]), jnp.asarray(p["xc1"][sub[i]]), fix_scale=fix)
            np.testing.assert_allclose(S_t.R[i].numpy(), np.asarray(S_j.R), atol=5e-4)
            np.testing.assert_allclose(S_t.t[i].numpy(), np.asarray(S_j.t), atol=5e-4)
            np.testing.assert_allclose(float(S_t.s[i]), float(S_j.s), rtol=5e-4)
        if not fix:
            np.testing.assert_allclose(S_t.R[0].numpy(), R, atol=5e-4)
            np.testing.assert_allclose(float(S_t.s[0]), s, rtol=5e-4)


@pytest.mark.parametrize("fix_scale", [False, True])
def test_sim3_ransac_matches_jax(rng, fix_scale):
    """With JAX's own indices: the same winning count and ok, the same
    inlier mask, and the Sim3 within 1e-4."""
    p, _ = _pair_problem(rng)
    key = 30 * 2654435761 + 5
    subsets = jax_subsets(key, p["valid"])
    res_t = tsim3.sim3_ransac(CAM_T, CAM_T, *(_t(p[k]) for k in ("xc1", "xc2", "uv1", "uv2", "is1", "is2")),
                              torch.as_tensor(p["valid"]), tsim3.jax_seed(key), fix_scale=fix_scale, subsets=subsets)
    res_j = jsim3.sim3_ransac(CAM_J, CAM_J, *(jnp.asarray(p[k]) for k in ("xc1", "xc2", "uv1", "uv2", "is1", "is2",
                                                                            "valid")),
                              jax.random.PRNGKey(key), fix_scale=fix_scale)
    assert int(res_t.n_inliers) == int(res_j.n_inliers)
    assert bool(res_t.ok) == bool(res_j.ok)
    np.testing.assert_array_equal(res_t.inliers.numpy(), np.asarray(res_j.inliers))
    np.testing.assert_allclose(res_t.S12.R.numpy(), np.asarray(res_j.S12.R), atol=1e-4)
    np.testing.assert_allclose(res_t.S12.t.numpy(), np.asarray(res_j.S12.t), atol=1e-4)
    np.testing.assert_allclose(float(res_t.S12.s), float(res_j.S12.s), rtol=1e-4)
    # the port's own draw: valid, distinct indices
    own = tsim3._sample_subsets(7, torch.as_tensor(p["valid"]))
    assert own.shape == (tsim3.N_HYP, 3) and bool(torch.as_tensor(p["valid"])[own].all())
    assert bool((own[:, 0] != own[:, 1]).all() & (own[:, 1] != own[:, 2]).all() & (own[:, 0] != own[:, 2]).all())


@pytest.mark.parametrize("fix_scale", [False, True])
def test_optimize_sim3_matches_jax(rng, fix_scale):
    """From a perturbed start: the same inlier mask and count, the Sim3
    within 2e-4 (the JAX package solves the 7x7 system in float32, the
    port in float64)."""
    p, (R, t, s) = _pair_problem(rng, outliers=0.1, s=1.0 if fix_scale else 1.3)
    xi0 = np.array([0.2, -0.1, 0.3, 0.05, -0.1, 0.08, 0.0 if fix_scale else np.log(1.3)], np.float32)
    xi0 = xi0 + np.array([0.05, -0.03, 0.04, 0.01, 0.01, -0.01, 0.0 if fix_scale else 0.02], np.float32)
    S0_j = jlie.sim3_exp(jnp.asarray(xi0))
    S0_t = tlie.Sim3(_t(S0_j.R), _t(S0_j.t), _t(S0_j.s))
    names = ("xc1", "xc2", "uv1", "uv2", "is1", "is2")
    S_t, inl_t, n_t = tsim3.optimize_sim3(CAM_T, CAM_T, S0_t, *(_t(p[k]) for k in names),
                                          torch.as_tensor(p["valid"]), fix_scale=fix_scale)
    S_j, inl_j, n_j = jsim3.optimize_sim3(CAM_J, CAM_J, S0_j, *(jnp.asarray(p[k]) for k in names),
                                          jnp.asarray(p["valid"]), fix_scale=fix_scale)
    assert int(n_t) == int(n_j) and int(n_t) > 200
    np.testing.assert_array_equal(inl_t.numpy(), np.asarray(inl_j))
    np.testing.assert_allclose(S_t.R.numpy(), np.asarray(S_j.R), atol=2e-4)
    np.testing.assert_allclose(S_t.t.numpy(), np.asarray(S_j.t), atol=2e-4)
    np.testing.assert_allclose(float(S_t.s), float(S_j.s), rtol=2e-4)
    if fix_scale:
        assert float(S_t.s) == float(S0_t.s)


def test_pair_jacobians_match_jacfwd(rng):
    """Kernel R's closed-form Jacobians against torch.func.jacfwd of the
    residual through sim3_exp(xi) S at xi = 0, within 1e-3 relative."""
    p, _ = _pair_problem(rng, n=64, n_valid=64, outliers=0.0)
    S = tlie.sim3_exp(_t([0.2, -0.1, 0.3, 0.05, -0.1, 0.08, 0.26]))
    args = [_t(p[k]) for k in ("xc1", "xc2", "uv1", "uv2")]
    r1, r2, J1, J2, _, _ = tsim3.pair_jacobians(CAM_T, CAM_T, S, *args)

    def res(xi):  # xi (1,7): forward AD promotes the tangents of 0-dim tensors to float64
        Sx = tlie.sim3_exp(xi).compose(S)
        a, b, _, _ = tsim3._two_sided(CAM_T, CAM_T, Sx, *args)
        return torch.cat([a, b], -1)

    J = torch.func.jacfwd(res)(torch.zeros(1, 7))[:, :, 0]  # (N,4,7)
    np.testing.assert_allclose(torch.cat([r1, r2], -1).numpy(), res(torch.zeros(1, 7)).detach().numpy(), atol=1e-4)
    ref = J.detach().numpy()
    got = torch.cat([J1, J2], 1).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-3 * np.abs(ref).max())
