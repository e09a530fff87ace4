"""Local BA of the port (optim/ba.py) against the JAX package's optim/ba.py
on one seeded problem: K=4 pose slots (one fixed, one padding), M=256
landmark slots (some invalid), O=1024 observation slots (some padding),
mono and stereo edges, 10% outliers.  Both packages get the same numpy
arrays."""
import jax.numpy as jnp
import numpy as np
import torch

from orb_slam3_fast_tpu.cameras import models as jcam
from orb_slam3_fast_tpu.optim import ba as jba
from orb_slam3_fast_tpu.utils import lie as jlie
from orb_slam3_fast_tpu_torch.cameras import models as tcam
from orb_slam3_fast_tpu_torch.optim import ba as tba

torch.set_num_threads(1)

FX, CX, CY, BF = 400.0, 320.0, 240.0, 48.0
K, M, O = 4, 256, 1024


def problem(seed=0, stereo_frac=0.4, step=0.3):
    """numpy fields of a BAProblem: 3 real poses ``step`` apart along x
    (pose 0 fixed) and a padding slot, 240 live landmarks each seen from 2
    or 3 poses (as triangulated landmarks are), ``stereo_frac`` stereo
    edges, 10% outliers, poses and landmarks perturbed from the truth."""
    rng = np.random.default_rng(seed)
    R = np.tile(np.eye(3, dtype=np.float32), (K, 1, 1))
    t = np.zeros((K, 3), np.float32)
    t[:3, 0] = [0.0, -step, -2 * step]
    X = np.stack([rng.uniform(-3, 3, M), rng.uniform(-2, 2, M), rng.uniform(4, 12, M)], -1).astype(np.float32)
    lm_valid = np.arange(M) < 240
    seen = rng.uniform(size=(240, 3)) < 0.8
    seen[np.arange(240), rng.integers(0, 3, 240)] = True
    seen[np.arange(240), (np.argmax(seen, 1) + 1 + rng.integers(0, 2, 240)) % 3] = True
    lm, kf = (a.astype(np.int32) for a in np.nonzero(seen))
    n = len(kf)
    xc = np.einsum("oij,oj->oi", R[kf], X[lm]) + t[kf]
    u = FX * xc[:, 0] / xc[:, 2] + CX
    v = FX * xc[:, 1] / xc[:, 2] + CY
    ur = u - BF / xc[:, 2]
    uv = np.stack([u, v, ur], -1) + rng.normal(0, 0.5, (n, 3))
    out = rng.uniform(size=n) < 0.1
    uv[out, :2] += rng.uniform(15, 40, (out.sum(), 2)) * rng.choice([-1, 1], (out.sum(), 2))
    stereo = rng.uniform(size=n) < stereo_frac
    uv[~stereo, 2] = -1.0
    level = rng.integers(0, 4, n)
    pad = lambda a, fill: np.concatenate([a, np.full((O - n, *a.shape[1:]), fill, a.dtype)])  # noqa: E731
    R0 = R.copy()
    t0 = t.copy()
    for k in (1, 2):  # perturb the free poses
        dT = jlie.se3_exp(jnp.asarray(rng.normal(0, [0.02, 0.02, 0.02, 0.005, 0.005, 0.005]), jnp.float32))
        R0[k] = np.asarray(dT.R) @ R[k]
        t0[k] = np.asarray(dT.R) @ t[k] + np.asarray(dT.t)
    return dict(
        R=R0, t=t0, pose_fixed=np.array([True, False, False, True]),
        xw=(X + rng.normal(0, 0.05, X.shape)).astype(np.float32), lm_valid=lm_valid,
        obs_kf=pad(kf, 0), obs_lm=pad(lm, 0), obs_uv=pad(uv.astype(np.float32), -1.0),
        obs_inv_sigma2=pad((1.0 / 1.44 ** level).astype(np.float32), 1.0), obs_is_stereo=pad(stereo, False),
        obs_valid=pad(np.ones(n, bool), False),
    )


def both(p):
    jp = jba.BAProblem(**{k: jnp.asarray(v) for k, v in p.items()})
    return jp, tba.make_problem(**p, device="cpu")


JCAM = jcam.Camera.pinhole(FX, FX, CX, CY)
TCAM = tcam.Camera.pinhole(FX, FX, CX, CY)


def _close_blocks(got, want):
    for g, w in zip(got, want):
        g, w = g.numpy(), np.asarray(w)
        scale = max(float(np.abs(w).max()), 1e-12)
        assert np.abs(g - w).max() <= 1e-4 * scale, (np.abs(g - w).max(), scale)


def test_landmark_csr():
    obs_lm = np.array([3, 1, 3, 0, 1, 2, 0], np.int32)
    valid = np.array([True, True, True, True, False, True, True])
    ptr, order = tba.landmark_csr(obs_lm, valid, 5)
    np.testing.assert_array_equal(ptr, [0, 2, 3, 4, 6, 6])
    np.testing.assert_array_equal(order[:6], [3, 6, 1, 5, 0, 2])
    assert sorted(order.tolist()) == list(range(7))


def test_build_normal_blocks_matches_jax():
    p = problem()
    jp, tp = both(p)
    inlier = np.random.default_rng(1).uniform(size=O) > 0.05
    want = jba.build_normal_blocks(JCAM, jnp.float32(BF), jp.R, jp.t, jp.xw, jp, jnp.asarray(inlier))
    got = tba.build_normal_blocks_plain(TCAM, BF, tp.R, tp.t, tp.xw, tp, torch.as_tensor(inlier))
    _close_blocks(got, want)
    assert float(np.asarray(want[5]).sum()) > 0  # landmarks are seen
    # the CPU wrapper is the plain version
    _close_blocks(tba.build_normal_blocks(TCAM, BF, tp.R, tp.t, tp.xw, tp, torch.as_tensor(inlier)), got)


def test_schur_solve_matches_jax():
    """Both solves are float32.  On the 40%-stereo problem the reduced
    system's condition number is ~2e4 (eigenvalues 7e2..1.3e7) and each
    solve sits 1e-4..5e-4 (relative) from the float64 solution, so the
    1e-4 parity check takes a better-conditioned problem: 90% stereo edges,
    0.5 m steps (both solves then within 5e-5 of float64)."""
    p = problem(seed=2, stereo_frac=0.9, step=0.5)
    jp, tp = both(p)
    inlier = jnp.ones(O, bool)
    Hpp, Hll, bp, bl, Z, w_lm, _ = jba.build_normal_blocks(JCAM, jnp.float32(BF), jp.R, jp.t, jp.xw, jp, inlier)
    for lam in (1e-4, 0.5):
        dp_j, dl_j = jba.schur_solve(Hpp, Hll, bp, bl, Z, w_lm, jp.pose_fixed, jp.lm_valid, jnp.float32(lam))
        blocks = [torch.as_tensor(np.array(x)) for x in (Hpp, Hll, bp, bl, Z, w_lm)]
        dp_t, dl_t = tba.schur_solve_plain(*blocks, tp.pose_fixed, tp.lm_valid, torch.tensor(lam))
        for g, w in ((dp_t, dp_j), (dl_t, dl_j)):
            w = np.asarray(w)
            assert np.abs(g.numpy() - w).max() <= 1e-4 * np.abs(w).max()
        assert np.abs(np.asarray(dp_j)[[0, 3]]).max() == 0.0  # fixed and padding poses stay
        dp_w, dl_w, ok_w = tba.schur_solve(*blocks[:5], blocks[5], tp, torch.tensor(lam))
        torch.testing.assert_close((dp_w, dl_w), (dp_t, dl_t), rtol=0, atol=0)
        assert bool(ok_w)
        assert tba.coupling_to_dense(blocks[4], tp) is blocks[4]  # the CPU coupling is already Z


def test_failed_solve_rejects_the_step():
    """A solve that reports failure (kernel F's flag, or a non-finite plain
    step) leaves the poses and landmarks as they were, whatever step it
    returned."""
    tp = tba.make_problem(**problem(seed=3), device="cpu")

    def failing(Hpp, Hll, bp, bl, Z, w_lm, prob, lam):
        return torch.full_like(bp, 0.01), torch.full_like(bl, 0.01), torch.tensor(False)

    R, t, xw, _ = tba._bundle_adjust(TCAM, BF, tp, 2, 1, tba.build_normal_blocks_plain, failing)
    assert torch.equal(R, tp.R) and torch.equal(t, tp.t) and torch.equal(xw, tp.xw)
    blocks = list(tba.build_normal_blocks_plain(TCAM, BF, tp.R, tp.t, tp.xw, tp, torch.ones_like(tp.obs_valid)))
    blocks[3] = blocks[3].clone()
    blocks[3][0, 0] = float("nan")
    assert not bool(tba.schur_solve(*blocks[:6], tp, torch.tensor(1e-4))[2])


def test_bundle_adjust_matches_jax():
    p = problem(seed=3)
    jp, tp = both(p)
    R_j, t_j, x_j, inl_j = jba.bundle_adjust(JCAM, jnp.float32(BF), jp, iters1=5, iters2=10)
    R_t, t_t, x_t, inl_t = tba.bundle_adjust(TCAM, BF, tp, iters1=5, iters2=10)
    np.testing.assert_allclose(t_t.numpy(), np.asarray(t_j), atol=1e-4)
    np.testing.assert_allclose(R_t.numpy(), np.asarray(R_j), atol=1e-4)
    np.testing.assert_array_equal(inl_t.numpy(), np.asarray(inl_j))
    # the outliers went, and the free poses moved toward the truth
    n_out = int((~inl_t.numpy()[: int(p["obs_valid"].sum())]).sum())
    assert 0.07 * O <= n_out <= 0.1 * O, n_out
    truth = np.array([[-0.3, 0, 0], [-0.6, 0, 0]])
    assert np.abs(t_t.numpy()[1:3] - truth).max() < 0.5 * np.abs(p["t"][1:3] - truth).max()
