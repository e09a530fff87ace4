"""Lie-group math on tensors: SO(3) exp, SE(3) transforms and exp.

Counterpart of ``orb_slam3_fast_tpu/utils/lie.py`` (``hat``, ``so3_exp``,
``SE3``, ``se3_exp``, ``normalize_rotation_np``), with the same conventions:
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
