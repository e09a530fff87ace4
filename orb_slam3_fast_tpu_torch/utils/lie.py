"""Lie-group math on tensors: SO(3) exp, SE(3) transforms and exp.

Counterpart of ``orb_slam3_fast_tpu/utils/lie.py`` (``hat``, ``so3_exp``,
``rotation_to_quaternion``, ``so3_log``, ``SE3``, ``se3_exp``,
``normalize_rotation``, ``normalize_rotation_np``), with the same conventions:
rotations are (...,3,3) matrices, an ``SE3`` is a named tuple (R, t) that
maps x -> R @ x + t, and se(3) tangents are ordered [rho(3), phi(3)].
Small-angle branches use ``torch.where`` with both branches NaN-safe.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

_EPS = 1e-8


def hat(w: torch.Tensor) -> torch.Tensor:
    """so(3) hat operator: (...,3) -> (...,3,3) skew-symmetric."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    return torch.stack(
        [
            torch.stack([z, -wz, wy], dim=-1),
            torch.stack([wz, z, -wx], dim=-1),
            torch.stack([-wy, wx, z], dim=-1),
        ],
        dim=-2,
    )


def _sinc_terms(theta2: torch.Tensor):
    """(sin t / t, (1 - cos t) / t^2) from the squared angle, Taylor near 0."""
    theta = torch.sqrt(torch.clamp(theta2, min=_EPS * _EPS))
    small = theta2 < _EPS
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(
        small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / torch.clamp(theta2, min=_EPS * _EPS)
    )
    return a, b


def _eye_like(W: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=W.dtype, device=W.device).expand(W.shape)


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues: (...,3) tangent -> (...,3,3) rotation matrix."""
    theta2 = torch.sum(w * w, dim=-1)
    a, b = _sinc_terms(theta2)
    W = hat(w)
    return _eye_like(W) + a[..., None, None] * W + b[..., None, None] * (W @ W)


def rotation_to_quaternion(R: torch.Tensor) -> torch.Tensor:
    """(...,3,3) -> unit quaternion (...,4) ordered [w, x, y, z], w >= 0.
    Branchless Shepperd extraction: the candidate with the largest pivot."""
    r00, r01, r02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    r10, r11, r12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    r20, r21, r22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = r00 + r11 + r22
    pw = torch.clamp(1.0 + tr, min=0.0)
    px = torch.clamp(1.0 + r00 - r11 - r22, min=0.0)
    py = torch.clamp(1.0 - r00 + r11 - r22, min=0.0)
    pz = torch.clamp(1.0 - r00 - r11 + r22, min=0.0)
    sw, sx, sy, sz = (torch.sqrt(p + _EPS) for p in (pw, px, py, pz))
    qw = torch.stack([sw, (r21 - r12) / sw, (r02 - r20) / sw, (r10 - r01) / sw], dim=-1)
    qx = torch.stack([(r21 - r12) / sx, sx, (r01 + r10) / sx, (r02 + r20) / sx], dim=-1)
    qy = torch.stack([(r02 - r20) / sy, (r01 + r10) / sy, sy, (r12 + r21) / sy], dim=-1)
    qz = torch.stack([(r10 - r01) / sz, (r02 + r20) / sz, (r12 + r21) / sz, sz], dim=-1)
    best = torch.argmax(torch.stack([pw, px, py, pz], dim=-1), dim=-1)
    cands = torch.stack([qw, qx, qy, qz], dim=-2)  # (...,4 candidates,4)
    q = torch.gather(cands, -2, best[..., None, None].expand(*best.shape, 1, 4))[..., 0, :]
    q = 0.5 * q
    q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    return q * torch.where(q[..., :1] < 0, -1.0, 1.0)


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> tangent vector, (...,3,3) -> (...,3), through the
    quaternion: w = 2 atan2(|qv|, qw) qv / |qv|."""
    q = rotation_to_quaternion(R)
    qw, qv = q[..., 0], q[..., 1:]
    nv = torch.sqrt(torch.sum(qv * qv, dim=-1) + 1e-24)
    theta = 2.0 * torch.atan2(nv, qw)
    small = nv < 1e-6
    scale = torch.where(small, 2.0 / torch.clamp(qw, min=_EPS), theta / torch.clamp(nv, min=_EPS))
    return scale[..., None] * qv


def so3_right_jacobian(w: torch.Tensor) -> torch.Tensor:
    """Right Jacobian Jr(w) of SO(3)."""
    theta2 = torch.sum(w * w, dim=-1)
    theta = torch.sqrt(torch.clamp(theta2, min=_EPS * _EPS))
    small = theta2 < _EPS
    W = hat(w)
    b = torch.where(
        small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / torch.clamp(theta2, min=_EPS * _EPS)
    )
    c = torch.where(
        small,
        1.0 / 6.0 - theta2 / 120.0,
        (theta - torch.sin(theta)) / torch.clamp(theta2 * theta, min=_EPS**3),
    )
    return _eye_like(W) - b[..., None, None] * W + c[..., None, None] * (W @ W)


def so3_left_jacobian(w: torch.Tensor) -> torch.Tensor:
    """Left Jacobian Jl(w) = Jr(-w)."""
    return so3_right_jacobian(-w)


def normalize_rotation_np(R) -> np.ndarray:
    """Project a near-rotation back onto SO(3) by an SVD in float64 on the
    host.  The tracker applies it to every pose it keeps: the velocity chain
    amplifies a float32 orthonormality defect about 8x per frame."""
    u, _, vt = np.linalg.svd(np.asarray(R, dtype=np.float64))
    d = np.sign(np.linalg.det(u @ vt))
    u[..., :, 2] *= d[..., None] if np.ndim(d) else d
    return (u @ vt).astype(np.float32)


def normalize_rotation(R: torch.Tensor) -> torch.Tensor:
    """Re-orthonormalise near-rotations (...,3,3) by an SVD, the last column
    of u scaled by det(u vt) (ImuTypes.cc:35-39, the JAX package's formula)."""
    u, _, vt = torch.linalg.svd(R)
    det = torch.linalg.det(u @ vt)
    one = torch.ones_like(det)
    return (u * torch.stack([one, one, det], dim=-1)[..., None, :]) @ vt


class SE3(NamedTuple):
    """Rigid transform: x -> R @ x + t.  Broadcasts over leading dims."""

    R: torch.Tensor  # (...,3,3)
    t: torch.Tensor  # (...,3)

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        return torch.einsum("...ij,...j->...i", self.R, x) + self.t

    def compose(self, other: "SE3") -> "SE3":
        return SE3(self.R @ other.R, torch.einsum("...ij,...j->...i", self.R, other.t) + self.t)

    def inverse(self) -> "SE3":
        Rt = self.R.transpose(-1, -2)
        return SE3(Rt, -torch.einsum("...ij,...j->...i", Rt, self.t))

    @staticmethod
    def identity(device: torch.device | str, dtype=torch.float32, batch=()) -> "SE3":
        R = torch.eye(3, dtype=dtype, device=device).expand(*batch, 3, 3).clone()
        t = torch.zeros(*batch, 3, dtype=dtype, device=device)
        return SE3(R, t)


def se3_exp(xi: torch.Tensor) -> SE3:
    """se(3) exp; xi = (..., 6) ordered [rho(3), phi(3)] (translation first)."""
    rho, phi = xi[..., :3], xi[..., 3:]
    R = so3_exp(phi)
    V = so3_left_jacobian(phi)
    return SE3(R, torch.einsum("...ij,...j->...i", V, rho))
