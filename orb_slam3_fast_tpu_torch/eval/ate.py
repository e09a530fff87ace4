"""Absolute trajectory error with Horn alignment (+ optional scale).

Copy of ``orb_slam3_fast_tpu/eval/ate.py`` (numpy only).  Python-3
replacement for ORB-SLAM3's evaluation scripts
(``evaluation/evaluate_ate_scale.py`` -- Horn-aligned ATE
RMSE with optimal scale for monocular — and ``associate.py`` timestamp
matching).  Same protocol so numbers are comparable to BASELINE.md.
"""
from __future__ import annotations

import numpy as np


def associate(ts_a: np.ndarray, ts_b: np.ndarray, max_dt: float = 0.02):
    """Greedy nearest-timestamp association (reference associate.py)."""
    ia, ib = [], []
    j = 0
    for i, t in enumerate(ts_a):
        j = int(np.argmin(np.abs(ts_b - t)))
        if abs(ts_b[j] - t) <= max_dt:
            ia.append(i)
            ib.append(j)
    return np.asarray(ia, dtype=np.int64), np.asarray(ib, dtype=np.int64)


def horn_align(model: np.ndarray, data: np.ndarray, with_scale: bool = False):
    """Least-squares rigid (+scale) alignment model -> data, both (N,3).

    Returns (R, t, s) minimizing || data - (s R model + t) ||^2
    (Horn 1987 closed form, as used by evaluate_ate_scale.py).
    """
    mu_m = model.mean(0)
    mu_d = data.mean(0)
    mc = model - mu_m
    dc = data - mu_d
    W = dc.T @ mc
    U, _, Vt = np.linalg.svd(W)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    if with_scale:
        # optimal scale (Umeyama): trace(D S)/var  with D singular values
        rot_mc = (R @ mc.T).T
        s = float((dc * rot_mc).sum() / np.maximum((mc**2).sum(), 1e-12))
    else:
        s = 1.0
    t = mu_d - s * (R @ mu_m)
    return R, t, s


def ate_rmse(
    est_ts: np.ndarray,
    est_pos: np.ndarray,
    gt_ts: np.ndarray,
    gt_pos: np.ndarray,
    with_scale: bool = False,
    max_dt: float = 0.02,
):
    """Associated + Horn-aligned ATE RMSE.  Returns (rmse, n_pairs, scale)."""
    ia, ib = associate(est_ts, gt_ts, max_dt)
    if len(ia) < 3:
        return np.inf, len(ia), 1.0
    est = est_pos[ia]
    gt = gt_pos[ib]
    R, t, s = horn_align(est, gt, with_scale)
    aligned = (s * (R @ est.T)).T + t
    err = np.linalg.norm(aligned - gt, axis=1)
    return float(np.sqrt((err**2).mean())), len(ia), s
