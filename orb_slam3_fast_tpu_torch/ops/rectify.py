"""Native stereo rectification + image remap/resize (host precompute, no cv2).

Copy of ``orb_slam3_fast_tpu/ops/rectify.py`` (numpy only).  Replaces
ORB-SLAM3's OpenCV calls in its settings path
(``src/Settings.cc:525-570``: ``cv::stereoRectify`` +
``cv::initUndistortRectifyMap`` + per-frame ``cv::remap``) with an in-tree
implementation so the framework has no OpenCV runtime dependency:

* :func:`stereo_rectify` — Bouguet-style rectification: split the
  inter-camera rotation evenly between the two cameras, then rotate both so
  the baseline becomes the shared x-axis; returns the per-camera rectifying
  rotations, the common rectified pinhole intrinsics, and ``bf``.
* :func:`undistort_rectify_map` — per-output-pixel source coordinates
  through the inverse rectification + radial-tangential distortion
  (k1, k2, p1, p2, k3), vectorized over the full grid.
* :func:`remap_bilinear` / :func:`resize_bilinear` — numpy bilinear gathers
  (host-side: these run on raw frames BEFORE the device pipeline, and a
  host gather is cheaper than a host->device->host round trip for them).

The rectification maps are precomputed once; only the remap runs per frame.
"""
from __future__ import annotations

import numpy as np


# ---------------------------------------------------------------------------
# small host-side SO(3) helpers (float64; utils.lie is the tensor path)
# ---------------------------------------------------------------------------


def _log_so3(R: np.ndarray) -> np.ndarray:
    cos = np.clip((np.trace(R) - 1.0) * 0.5, -1.0, 1.0)
    th = np.arccos(cos)
    if th < 1e-10:
        return np.zeros(3)
    w = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    return w * (th / (2.0 * np.sin(th)))


def _exp_so3(w: np.ndarray) -> np.ndarray:
    th = np.linalg.norm(w)
    if th < 1e-10:
        return np.eye(3)
    k = w / th
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(th) * K + (1.0 - np.cos(th)) * (K @ K)


# ---------------------------------------------------------------------------


def stereo_rectify(K1, D1, K2, D2, wh, R, T):
    """Rectify a calibrated stereo rig.  ``x2 = R @ x1 + T`` (points from
    cam1's frame into cam2's).  Returns ``(R1, R2, K_new, bf_over_f, bf)``:

    * ``R1``/``R2`` — rotations applied to each camera's rays (old cam frame
      -> rectified frame),
    * ``K_new`` — the shared rectified pinhole (fx = fy, common principal
      point; zero-disparity convention: both cameras share cx),
    * ``bf`` — baseline * focal in pixels (positive).

    The construction mirrors cv::stereoRectify's geometry: the relative
    rotation is split evenly (each camera rotates by half), then both are
    rotated so the baseline is the x-axis; the sign is chosen so that a
    landmark's left-image column is >= its right-image column (positive
    disparity, as ``ops.matching.stereo_match`` requires).
    """
    w_px, h_px = wh
    om = _log_so3(np.asarray(R, np.float64))
    A1 = _exp_so3(0.5 * om)  # cam1 -> averaged orientation
    A2 = _exp_so3(-0.5 * om)  # cam2 -> averaged orientation
    t = A2 @ np.asarray(T, np.float64)
    nt = np.linalg.norm(t)
    if nt < 1e-12:
        raise ValueError("stereo_rectify: zero baseline")
    # x-axis along the (negated) baseline => u_left - u_right = f*b/z > 0
    e1 = -t / nt
    up = np.array([0.0, 0.0, 1.0])
    e2 = np.cross(up, e1)
    n2 = np.linalg.norm(e2)
    if n2 < 1e-6:  # baseline parallel to the optical axis (degenerate rig)
        up = np.array([0.0, 1.0, 0.0])
        e2 = np.cross(up, e1)
        n2 = np.linalg.norm(e2)
    e2 /= n2
    e3 = np.cross(e1, e2)
    Rrect = np.stack([e1, e2, e3], axis=0)
    R1 = Rrect @ A1
    R2 = Rrect @ A2
    # shared focal: mean of the vertical focals (rows must align exactly;
    # a common f keeps both remaps near-identity for similar cameras)
    f = 0.5 * (float(K1[1][1]) + float(K2[1][1]))
    # principal point: place the mean of the two optical axes at the image
    # center (zero-disparity: both cameras get the SAME cx/cy)
    axes = np.stack([R1 @ np.array([0.0, 0.0, 1.0]), R2 @ np.array([0.0, 0.0, 1.0])])
    mean_xy = np.mean(axes[:, :2] / axes[:, 2:3], axis=0)
    cx = 0.5 * (w_px - 1) - f * mean_xy[0]
    cy = 0.5 * (h_px - 1) - f * mean_xy[1]
    K_new = np.array([[f, 0.0, cx], [0.0, f, cy], [0.0, 0.0, 1.0]])
    bf = f * nt
    return R1, R2, K_new, nt, bf


def undistort_rectify_map(K, D, R_rect, K_new, wh):
    """Source-pixel grids for the rectifying remap
    (cv::initUndistortRectifyMap semantics): for each rectified output pixel,
    rotate its ray back into the original camera, apply the radial-tangential
    distortion (k1, k2, p1, p2[, k3]), and project with the ORIGINAL K.
    Returns float32 ``(mapx, mapy)`` of shape (h, w)."""
    w_px, h_px = wh
    K = np.asarray(K, np.float64)
    D = np.ravel(np.asarray(D, np.float64))
    k1, k2, p1, p2 = D[0], D[1], D[2], D[3]
    k3 = D[4] if D.size > 4 else 0.0
    u, v = np.meshgrid(np.arange(w_px, dtype=np.float64),
                       np.arange(h_px, dtype=np.float64))
    x = (u - K_new[0, 2]) / K_new[0, 0]
    y = (v - K_new[1, 2]) / K_new[1, 1]
    ray = np.stack([x, y, np.ones_like(x)], axis=-1) @ R_rect  # == R^T @ ray
    xn = ray[..., 0] / ray[..., 2]
    yn = ray[..., 1] / ray[..., 2]
    r2 = xn * xn + yn * yn
    radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    xd = xn * radial + 2.0 * p1 * xn * yn + p2 * (r2 + 2.0 * xn * xn)
    yd = yn * radial + p1 * (r2 + 2.0 * yn * yn) + 2.0 * p2 * xn * yn
    mapx = (K[0, 0] * xd + K[0, 2]).astype(np.float32)
    mapy = (K[1, 1] * yd + K[1, 2]).astype(np.float32)
    return mapx, mapy


def remap_bilinear(img: np.ndarray, mapx: np.ndarray, mapy: np.ndarray) -> np.ndarray:
    """Bilinear gather at (mapx, mapy); out-of-image samples are 0
    (cv::remap BORDER_CONSTANT).  Vectorized over the whole grid."""
    h, w = img.shape[:2]
    inside = (mapx >= 0) & (mapx <= w - 1) & (mapy >= 0) & (mapy <= h - 1)
    x0c = np.clip(np.floor(mapx).astype(np.int64), 0, w - 2)
    y0c = np.clip(np.floor(mapy).astype(np.int64), 0, h - 2)
    # fractions measured from the CLAMPED base so the last row/column
    # interpolate with weight 1 on the far sample instead of re-reading it
    fx = np.clip(mapx - x0c, 0.0, 1.0)
    fy = np.clip(mapy - y0c, 0.0, 1.0)
    im = img.astype(np.float32)
    tl = im[y0c, x0c]
    tr = im[y0c, x0c + 1]
    bl = im[y0c + 1, x0c]
    br = im[y0c + 1, x0c + 1]
    out = (tl * (1 - fx) + tr * fx) * (1 - fy) + (bl * (1 - fx) + br * fx) * fy
    return np.where(inside, out, 0.0).astype(np.float32)


def resize_bilinear(img: np.ndarray, out_wh: tuple[int, int]) -> np.ndarray:
    """Host bilinear resize with cv2.resize's half-pixel grid convention
    (src = (dst + 0.5) * scale - 0.5)."""
    nw, nh = out_wh
    h, w = img.shape[:2]
    xs = (np.arange(nw, dtype=np.float32) + 0.5) * (w / nw) - 0.5
    ys = (np.arange(nh, dtype=np.float32) + 0.5) * (h / nh) - 0.5
    mapx, mapy = np.meshgrid(np.clip(xs, 0, w - 1), np.clip(ys, 0, h - 1))
    return remap_bilinear(img, mapx, mapy)
