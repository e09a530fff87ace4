"""Camera models: pin-hole (+ radial-tangential distortion) and Kannala-Brandt.

Counterpart of ``orb_slam3_fast_tpu/cameras/models.py`` with the same
parameter layout:
  * PINHOLE: ``[fx, fy, cx, cy, k1, k2, p1, p2, k3]``;
  * KB8: ``[fx, fy, cx, cy, k1, k2, k3, k4]``.
``project_jac`` is closed form for the pin-hole (the JAX package uses
``jax.jacfwd``) and ``torch.func.jacfwd`` for KB8.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

PINHOLE = "pinhole"
KB8 = "kb8"

_EPS = 1e-9


class Camera(NamedTuple):
    """Camera of a static ``kind`` with a (P,) float32 parameter tensor."""

    kind: str
    params: torch.Tensor

    @staticmethod
    def pinhole(fx, fy, cx, cy, dist=(0.0,) * 5, device="cpu") -> "Camera":
        d = tuple(dist) + (0.0,) * (5 - len(dist))
        return Camera(PINHOLE, torch.tensor([fx, fy, cx, cy, *d], dtype=torch.float32, device=device))

    @staticmethod
    def kb8(fx, fy, cx, cy, k1, k2, k3, k4, device="cpu") -> "Camera":
        return Camera(KB8, torch.tensor([fx, fy, cx, cy, k1, k2, k3, k4], dtype=torch.float32, device=device))

    def K(self) -> torch.Tensor:
        """(3,3) intrinsic matrix."""
        fx, fy, cx, cy = self.params[:4]
        z, o = torch.zeros_like(fx), torch.ones_like(fx)
        return torch.stack([torch.stack([fx, z, cx]), torch.stack([z, fy, cy]), torch.stack([z, z, o])])


def _distort_radtan(p: torch.Tensor, x: torch.Tensor, y: torch.Tensor):
    k1, k2, p1, p2, k3 = p[4], p[5], p[6], p[7], p[8]
    r2 = x * x + y * y
    radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    xd = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    yd = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    return xd, yd


def _safe_z(z: torch.Tensor) -> torch.Tensor:
    return torch.where(torch.abs(z) < _EPS, torch.full_like(z, _EPS), z)


def project(cam: Camera, xc: torch.Tensor) -> torch.Tensor:
    """Camera-frame point(s) (...,3) -> pixel coords (...,2)."""
    p = cam.params
    fx, fy, cx, cy = p[0], p[1], p[2], p[3]
    if cam.kind == PINHOLE:
        z = _safe_z(xc[..., 2])
        xd, yd = _distort_radtan(p, xc[..., 0] / z, xc[..., 1] / z)
        return torch.stack([fx * xd + cx, fy * yd + cy], dim=-1)
    if cam.kind == KB8:
        k1, k2, k3, k4 = p[4], p[5], p[6], p[7]
        x, y, z = xc[..., 0], xc[..., 1], xc[..., 2]
        r = torch.sqrt(x * x + y * y + _EPS * _EPS)
        theta = torch.atan2(r, z)
        t2 = theta * theta
        d = theta * (1.0 + t2 * (k1 + t2 * (k2 + t2 * (k3 + t2 * k4))))
        scale = d / r
        return torch.stack([fx * scale * x + cx, fy * scale * y + cy], dim=-1)
    raise ValueError(f"unknown camera kind {cam.kind}")


def project_jac(cam: Camera, xc: torch.Tensor) -> torch.Tensor:
    """Jacobian d(uv)/d(xc): (...,3) -> (...,2,3)."""
    if cam.kind == KB8:
        flat = xc.reshape(-1, 3)
        J = torch.func.vmap(torch.func.jacfwd(lambda v: project(cam, v)))(flat)
        # forward-mode AD promotes the tangent of ``x * x + EPS**2`` (a Python float) to float64: back to xc's type
        return J.reshape(*xc.shape[:-1], 2, 3).to(xc.dtype)
    if cam.kind != PINHOLE:
        raise ValueError(f"unknown camera kind {cam.kind}")
    p = cam.params
    fx, fy, k1, k2, p1, p2, k3 = p[0], p[1], p[4], p[5], p[6], p[7], p[8]
    z = _safe_z(xc[..., 2])
    x, y = xc[..., 0] / z, xc[..., 1] / z
    r2 = x * x + y * y
    radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    dradial = k1 + r2 * (2.0 * k2 + 3.0 * k3 * r2)  # d radial / d r2
    # d(xd, yd) / d(x, y)
    a = radial + 2.0 * x * x * dradial + 2.0 * p1 * y + 6.0 * p2 * x
    b = 2.0 * x * y * dradial + 2.0 * p1 * x + 2.0 * p2 * y  # dxd/dy == dyd/dx
    d = radial + 2.0 * y * y * dradial + 6.0 * p1 * y + 2.0 * p2 * x
    # d(x, y) / d(xc) = [[1/z, 0, -x/z], [0, 1/z, -y/z]]
    iz = 1.0 / z
    du = torch.stack([fx * a * iz, fx * b * iz, -fx * (a * x + b * y) * iz], dim=-1)
    dv = torch.stack([fy * b * iz, fy * d * iz, -fy * (b * x + d * y) * iz], dim=-1)
    return torch.stack([du, dv], dim=-2)


def unproject(cam: Camera, uv: torch.Tensor, newton_iters: int = 10) -> torch.Tensor:
    """Pixel coords (...,2) -> unit-z ray (...,3) [x/z, y/z, 1].  Pin-hole:
    ``newton_iters`` fixed-point steps of rad-tan undistortion (skipped
    without distortion); KB8: Newton on the distortion polynomial."""
    p = cam.params
    fx, fy, cx, cy = p[0], p[1], p[2], p[3]
    mx = (uv[..., 0] - cx) / fx
    my = (uv[..., 1] - cy) / fy
    if cam.kind == PINHOLE:
        x, y = mx, my
        if bool(torch.any(torch.abs(p[4:]) > 0)):
            for _ in range(newton_iters):
                xd, yd = _distort_radtan(p, x, y)
                x, y = mx - (xd - x), my - (yd - y)
        return torch.stack([x, y, torch.ones_like(x)], dim=-1)
    if cam.kind == KB8:
        k1, k2, k3, k4 = p[4], p[5], p[6], p[7]
        d = torch.clamp(torch.sqrt(mx * mx + my * my), 0.0, torch.pi)
        theta = d
        for _ in range(newton_iters):
            t2 = theta * theta
            poly = theta * (1.0 + t2 * (k1 + t2 * (k2 + t2 * (k3 + t2 * k4))))
            dpoly = 1.0 + t2 * (3 * k1 + t2 * (5 * k2 + t2 * (7 * k3 + t2 * 9 * k4)))
            theta = theta - (poly - d) / torch.where(torch.abs(dpoly) < _EPS, torch.full_like(dpoly, _EPS), dpoly)
        scale = torch.where(d < _EPS, torch.ones_like(d), torch.tan(theta) / torch.clamp(d, min=_EPS))
        return torch.stack([mx * scale, my * scale, torch.ones_like(mx)], dim=-1)
    raise ValueError(f"unknown camera kind {cam.kind}")


def stereo_project(cam: Camera, xc: torch.Tensor, bf) -> torch.Tensor:
    """Rectified-stereo projection (u_l, v_l, u_r) with u_r = u_l - bf/z."""
    uv = project(cam, xc)
    ur = uv[..., 0] - bf / _safe_z(xc[..., 2])
    return torch.cat([uv, ur[..., None]], dim=-1)


def stereo_project_jac(cam: Camera, xc: torch.Tensor, bf) -> torch.Tensor:
    """Jacobian d(u_l, v_l, u_r)/d(xc): (...,3) -> (...,3,3)."""
    J = project_jac(cam, xc)
    z = _safe_z(xc[..., 2])
    dz = torch.zeros_like(xc)
    dz[..., 2] = bf / (z * z)
    return torch.cat([J, (J[..., 0, :] + dz)[..., None, :]], dim=-2)
