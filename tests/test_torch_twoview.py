"""Two-view geometry of the port (ops/twoview.py) against the JAX
package's ops/twoview.py on the same numpy inputs: batched DLT
triangulation (kernel G's plain version) on 512 matches between two
keyframes; two-view reconstruction (kernel M's plain version) on the JAX
package's own hypothesis samples, for a 3-D scene (the F branch) and a
planar one (the H branch), with its hypotheses, scores and motions."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from orb_slam3_fast_tpu.cameras import models as jcam
from orb_slam3_fast_tpu.ops import extractor as jext
from orb_slam3_fast_tpu.ops import matching as jmat
from orb_slam3_fast_tpu.ops import twoview as jtv
from orb_slam3_fast_tpu.utils import lie as jlie
from orb_slam3_fast_tpu_torch.cameras import models as tcam
from orb_slam3_fast_tpu_torch.ops import twoview as ttv

torch.set_num_threads(1)


def matches(rng, n=512):
    """P0 = [I | 0], P1 a 0.4 m sideways step with a small turn; points 2-15
    m ahead, some nearly at infinity (tiny parallax); normalised
    coordinates with 1e-3 noise (about 0.4 px at fx = 400)."""
    T1 = jlie.se3_exp(jnp.asarray([-0.4, 0.02, 0.05, 0.01, -0.03, 0.005], jnp.float32))
    R1, t1 = np.asarray(T1.R, np.float64), np.asarray(T1.t, np.float64)
    X = np.stack([rng.uniform(-4, 4, n), rng.uniform(-3, 3, n), rng.uniform(2, 15, n)], -1)
    X[:40, 2] = rng.uniform(500, 5000, 40)  # near-infinite points
    x0 = X[:, :2] / X[:, 2:]
    xc1 = X @ R1.T + t1
    x1 = xc1[:, :2] / xc1[:, 2:]
    x0 = (x0 + rng.normal(0, 1e-3, x0.shape)).astype(np.float32)
    x1 = (x1 + rng.normal(0, 1e-3, x1.shape)).astype(np.float32)
    P0 = np.concatenate([np.eye(3), np.zeros((3, 1))], 1).astype(np.float32)
    P1 = np.concatenate([R1, t1[:, None]], 1).astype(np.float32)
    c1 = -R1.T @ t1  # parallax cosine between the two rays, as the mapper gates it
    d0, d1 = X, X - c1
    cosp = (d0 * d1).sum(1) / (np.linalg.norm(d0, axis=1) * np.linalg.norm(d1, axis=1))
    return P0, P1, x0, x1, X, cosp


def test_triangulate_dlt_matches_jax():
    """X within 1e-4 relative (to |X|) wherever the parallax cosine is below
    0.9998; the low-parallax rows are ill-posed and only need to agree in
    direction."""
    P0, P1, x0, x1, X, cosp = matches(np.random.default_rng(0))
    X_j = np.asarray(jtv.triangulate_dlt(*(jnp.asarray(a) for a in (P0, P1, x0, x1))))
    X_t = ttv.triangulate_dlt_plain(*(torch.as_tensor(a) for a in (P0, P1, x0, x1))).numpy()
    good = cosp < 0.9998
    assert good.sum() > 400 and (~good).sum() >= 40
    err = np.linalg.norm(X_t - X_j, axis=1) / np.linalg.norm(X_j, axis=1)
    assert err[good].max() < 1e-4, err[good].max()
    # the triangulation itself is right: median error under 2% of the depth where the parallax is good
    assert np.median(np.linalg.norm(X_t[good] - X[good], axis=1) / X[good, 2]) < 0.02
    # the ill-posed rows point the same way
    dir_t = X_t[~good] / np.linalg.norm(X_t[~good], axis=1, keepdims=True)
    dir_j = X_j[~good] / np.linalg.norm(X_j[~good], axis=1, keepdims=True)
    assert np.abs(np.abs((dir_t * dir_j).sum(1)) - 1).max() < 1e-3


def test_cpu_wrapper_is_the_plain_version():
    P0, P1, x0, x1, _, _ = matches(np.random.default_rng(1), n=64)
    args = [torch.as_tensor(a) for a in (P0, P1, x0, x1)]
    before = ttv.triangulate_dlt.launches.total()
    torch.testing.assert_close(ttv.triangulate_dlt(*args), ttv.triangulate_dlt_plain(*args), rtol=0, atol=0)
    assert ttv.triangulate_dlt.launches.total() == before


# --- two-view reconstruction (kernel M's plain version) --------------------------

JCAM = jcam.Camera.pinhole(400.0, 400.0, 320.0, 240.0)
TCAM = tcam.Camera.pinhole(400.0, 400.0, 320.0, 240.0)


def two_view_case(name):
    """(uv0, uv1, valid) numpy: the mono corridor's frames 0 and 5 matched by
    the JAX package's search_for_initialization (a 3-D scene: the F branch),
    or chip_smoke's planar pair (the H branch)."""
    if name == "plane":
        return chip_smoke.planar_matches(np.random.default_rng(7), n=512, n_valid=300)
    imgs, _ = chip_smoke.mono_frames(6)
    cfg = jext.ExtractorConfig(n_features=768)
    kp0, kp5 = (jext.extract(jnp.asarray(imgs[i]), cfg) for i in (0, 5))
    idx, acc = jmat.search_for_initialization(kp0, kp5, 100.0)
    return np.asarray(kp0.xy), np.asarray(kp5.xy)[np.asarray(idx)], np.asarray(acc)


def jax_samples(key, valid, n_iters=200):
    """The JAX package's own hypothesis draw (twoview.py:329-331)."""
    p = jnp.asarray(valid, jnp.float32)
    p = p / jnp.maximum(jnp.sum(p), 1.0)
    return torch.as_tensor(np.asarray(jax.random.choice(key, valid.shape[0], shape=(n_iters, 8), p=p)))


rot_angle = chip_smoke.rot_angle


@pytest.mark.parametrize("name, used_h", [("corridor", False), ("plane", True)])
def test_reconstruct_matches_jax(name, used_h):
    """reconstruct_plain on the JAX package's samples against reconstruct:
    success and used_h equal, R within 1e-3 rad, t's direction within 1e-3,
    good equal on >= 99% of the rows, X within 1e-3 relative where both
    call a row good."""
    uv0, uv1, valid = two_view_case(name)
    key = jax.random.PRNGKey(250)
    rj = jtv.reconstruct(JCAM, jnp.asarray(uv0), jnp.asarray(uv1), jnp.asarray(valid), key)
    rt = ttv.reconstruct_plain(TCAM, torch.as_tensor(uv0), torch.as_tensor(uv1), torch.as_tensor(valid),
                               jax_samples(key, valid))
    assert bool(rt.success) == bool(rj.success) and bool(rt.success)
    assert bool(rt.used_h) == bool(rj.used_h) == used_h
    assert rot_angle(rt.R.numpy(), rj.R) <= 1e-3
    assert 1.0 - abs(float(np.dot(rt.t.numpy(), np.asarray(rj.t)))) <= 1e-3
    good_t, good_j = rt.good.numpy(), np.asarray(rj.good)
    assert (good_t == good_j).mean() >= 0.99 and good_j.sum() >= 50
    both = good_t & good_j
    X_j = np.asarray(rj.X)
    assert (np.linalg.norm(rt.X.numpy() - X_j, axis=1) / np.linalg.norm(X_j, axis=1))[both].max() <= 1e-3


@pytest.mark.parametrize("name", ["corridor", "plane"])
def test_hypotheses_and_scores_match_jax(name):
    """The 200 sampled F and H of both packages equal up to sign (F and H are
    defined up to scale; both are unit-norm null vectors before
    denormalisation) within the rounding their systems' conditioning
    allows, and their transfer scores within 1e-4 relative where both
    models are well conditioned."""
    uv0, uv1, valid = two_view_case(name)
    samples = jax_samples(jax.random.PRNGKey(3), valid)
    x0 = np.asarray(jcam.unproject(JCAM, jnp.asarray(uv0)))[:, :2]
    x1 = np.asarray(jcam.unproject(JCAM, jnp.asarray(uv1)))[:, :2]
    sigma2 = (1.0 / 400.0) ** 2
    vj, sj = jnp.asarray(valid), jnp.asarray(samples.numpy())

    def fit_one(idx):  # reconstruct's fit_one (twoview.py:333-342)
        s0n, T0 = jtv._normalize(jnp.asarray(x0), vj)
        s1n, T1 = jtv._normalize(jnp.asarray(x1), vj)
        F = T1.T @ jtv._fit_f8(s0n[idx], s1n[idx]) @ T0
        H = jnp.linalg.inv(T1) @ jtv._fit_h8(s0n[idx], s1n[idx]) @ T0
        return F, H

    Fj, Hj = (np.asarray(a) for a in jax.vmap(fit_one)(sj))
    sfj = np.asarray(jax.vmap(lambda F: jtv._score_f(F, jnp.asarray(x0), jnp.asarray(x1), vj, sigma2)[0])(Fj))
    shj = np.asarray(jax.vmap(lambda H: jtv._score_h(H, jnp.asarray(x0), jnp.asarray(x1), vj, sigma2)[0])(Hj))
    tx0, tx1, tv = torch.as_tensor(x0), torch.as_tensor(x1), torch.as_tensor(valid)
    s0n, T0 = ttv._normalize(tx0, tv)
    s1n, T1 = ttv._normalize(tx1, tv)
    Ft = (T1.T @ ttv._fit_f8(s0n[samples], s1n[samples]) @ T0).numpy()
    Ht = (torch.linalg.inv(T1) @ ttv._fit_h8(s0n[samples], s1n[samples]) @ T0).numpy()
    # float32 rounding moves a null vector by ~eps s1 / gap (held to 1e-6 s1 / gap, eps ~ 6e-8), gap being the
    # distance to the next singular value: the 8-row F system's 8th, the H system's 8th minus its 9th (a draw
    # with repeated matches has none); the scores are compared where both models are held to 1e-3
    sv_f = torch.linalg.svdvals(ttv._f_rows(s0n[samples], s1n[samples])).double()
    sv_h = torch.linalg.svdvals(ttv._h_rows(s0n[samples], s1n[samples])).double()
    unique = np.ones(len(samples), bool)
    for Mt, Mj, gap, s1 in ((Ft, Fj, sv_f[:, 7], sv_f[:, 0]), (Ht, Hj, sv_h[:, 7] - sv_h[:, 8], sv_h[:, 0])):
        bound = np.clip((1e-6 * s1 / gap.clamp(min=1e-30)).numpy(), 1e-5, None)
        unique &= bound <= 1e-3
        a = Mt.reshape(-1, 9) / np.linalg.norm(Mt.reshape(-1, 9), axis=1, keepdims=True)
        b = Mj.reshape(-1, 9) / np.linalg.norm(Mj.reshape(-1, 9), axis=1, keepdims=True)
        sign = np.sign((a * b).sum(1, keepdims=True))
        assert (np.abs(a - sign * b).max(1) <= bound).all()
    assert unique.sum() >= 40
    sft = ttv._score_f(torch.as_tensor(Ft), tx0, tx1, tv, sigma2)[0].numpy()
    sht = ttv._score_h(torch.as_tensor(Ht), tx0, tx1, tv, sigma2)[0].numpy()
    np.testing.assert_allclose(sft[unique], sfj[unique], rtol=1e-4, atol=1e-4 * np.abs(sfj).max())
    np.testing.assert_allclose(sht[unique], shj[unique], rtol=1e-4, atol=1e-4 * np.abs(shj).max())


def test_motions_match_jax_as_sets():
    """The 4 E-motions and 8 H-motions of a model equal the JAX package's as
    sets (the SVD's signs may order them differently)."""
    uv0, uv1, valid = two_view_case("plane")
    rj = jtv.reconstruct(JCAM, jnp.asarray(uv0), jnp.asarray(uv1), jnp.asarray(valid), jax.random.PRNGKey(1))
    assert bool(rj.used_h)
    rng = np.random.default_rng(0)
    M = rng.normal(size=(3, 3)).astype(np.float32)
    for fn_t, fn_j in ((ttv._motions_from_f, jtv._motions_from_f), (ttv._motions_from_h, jtv._motions_from_h)):
        Rt, tt = (x.numpy() for x in fn_t(torch.as_tensor(M)))
        Rj, tj = (np.asarray(x) for x in fn_j(jnp.asarray(M)))
        for R, t in zip(Rt, tt):
            d = [np.abs(R - Rb).max() + np.abs(t - tb).max() for Rb, tb in zip(Rj, tj)]
            assert min(d) <= 1e-4


def test_sample_hypotheses():
    """(200, 8) draws among the valid slots only, the same for the same seed."""
    valid = torch.zeros(300, dtype=torch.bool)
    valid[10:200:2] = True
    a, b = ttv._sample_hypotheses(7, valid), ttv._sample_hypotheses(7, valid)
    assert a.shape == (200, 8) and torch.equal(a, b) and bool(valid[a].all())
    assert not torch.equal(a, ttv._sample_hypotheses(8, valid))


def test_reconstruct_cpu_wrapper_is_the_plain_version():
    uv0, uv1, valid = two_view_case("plane")
    args = [torch.as_tensor(a) for a in (uv0, uv1, valid)]
    before = ttv.reconstruct.launches.total()
    rw = ttv.reconstruct(TCAM, *args, 11)
    rp = ttv.reconstruct_plain(TCAM, *args, ttv._sample_hypotheses(11, args[2]))
    for x, y in zip(rw, rp):
        assert torch.equal(x, y)
    assert ttv.reconstruct.launches.total() == before
