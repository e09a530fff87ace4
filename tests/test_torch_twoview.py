"""Batched DLT triangulation of the port (ops/twoview.py, kernel G's plain
version) against the JAX package's ops/twoview.triangulate_dlt on 512
matches between two keyframes, the same numpy inputs on both sides."""
import jax.numpy as jnp
import numpy as np
import torch

from orb_slam3_fast_tpu.ops import twoview as jtv
from orb_slam3_fast_tpu.utils import lie as jlie
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
    before = ttv.triangulate_dlt.launches
    torch.testing.assert_close(ttv.triangulate_dlt(*args), ttv.triangulate_dlt_plain(*args), rtol=0, atol=0)
    assert ttv.triangulate_dlt.launches == before
