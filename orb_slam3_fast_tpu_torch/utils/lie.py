"""Lie-group math on tensors: SO(3) exp, SE(3) transforms and exp.

Counterpart of ``orb_slam3_fast_tpu/utils/lie.py`` (``hat``, ``vee``,
``so3_exp``, ``rotation_to_quaternion``, ``so3_log``, the SO(3) Jacobians,
``SE3``, ``se3_exp``, ``se3_log``, ``Sim3``, ``sim3_exp``, ``sim3_log``,
``normalize_rotation``, ``normalize_rotation_np``), with the same
conventions: rotations are (...,3,3) matrices, an ``SE3`` is a named tuple
(R, t) that maps x -> R @ x + t, a ``Sim3`` a named tuple (R, t, s) that
maps x -> s R x + t; se(3) tangents are ordered [rho(3), phi(3)], sim(3)
tangents [rho(3), phi(3), sigma].  Small-angle branches use
``torch.where`` with both branches NaN-safe, so ``torch.func.jacfwd`` runs
through them.
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


def vee(W: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`hat`: (...,3,3) -> (...,3)."""
    return torch.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], dim=-1)


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


def so3_right_jacobian_inv(w: torch.Tensor) -> torch.Tensor:
    """Inverse right Jacobian of SO(3) (ImuTypes.cc:65-83)."""
    theta2 = torch.sum(w * w, dim=-1)
    theta = torch.sqrt(torch.clamp(theta2, min=_EPS * _EPS))
    small = theta2 < _EPS
    W = hat(w)
    denom = 2.0 * theta * torch.sin(theta)  # negative beyond pi
    denom_safe = torch.where(torch.abs(denom) < _EPS, torch.where(denom < 0, -_EPS, _EPS), denom)
    coef = torch.where(
        small,
        1.0 / 12.0 + theta2 / 720.0,
        1.0 / torch.clamp(theta2, min=_EPS * _EPS) - (1.0 + torch.cos(theta)) / denom_safe,
    )
    return _eye_like(W) + 0.5 * W + coef[..., None, None] * (W @ W)


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
    of u scaled by det(u vt) (ImuTypes.cc:35-39, the JAX package's formula).
    A matrix with a non-finite entry gives NaNs, as the JAX package's SVD
    does (PyTorch's would raise): a diverged solve then fails its gates."""
    finite = torch.isfinite(R).all(-1).all(-1)[..., None, None]
    u, _, vt = torch.linalg.svd(torch.where(finite, R, _eye_like(R)))
    det = torch.linalg.det(u @ vt)
    one = torch.ones_like(det)
    out = (u * torch.stack([one, one, det], dim=-1)[..., None, :]) @ vt
    return torch.where(finite, out, torch.full_like(out, float("nan")))


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


def se3_log(T: SE3) -> torch.Tensor:
    """Inverse of :func:`se3_exp`: rho = Jl(phi)^-1 t, Jl^-1(w) = Jr^-1(-w)."""
    phi = so3_log(T.R)
    rho = torch.einsum("...ij,...j->...i", so3_right_jacobian_inv(-phi), T.t)
    return torch.cat([rho, phi], dim=-1)


class Sim3(NamedTuple):
    """Similarity transform: x -> s * R @ x + t (Sim3Solver, sim3.hpp)."""

    R: torch.Tensor  # (...,3,3)
    t: torch.Tensor  # (...,3)
    s: torch.Tensor  # (...,)

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        return self.s[..., None] * torch.einsum("...ij,...j->...i", self.R, x) + self.t

    def compose(self, other: "Sim3") -> "Sim3":
        return Sim3(
            self.R @ other.R,
            self.s[..., None] * torch.einsum("...ij,...j->...i", self.R, other.t) + self.t,
            self.s * other.s,
        )

    def inverse(self) -> "Sim3":
        Rt = self.R.transpose(-1, -2)
        s_inv = 1.0 / self.s
        return Sim3(Rt, -s_inv[..., None] * torch.einsum("...ij,...j->...i", Rt, self.t), s_inv)

    @staticmethod
    def identity(device: torch.device | str = "cpu", dtype=torch.float32, batch=()) -> "Sim3":
        return Sim3(
            torch.eye(3, dtype=dtype, device=device).expand(*batch, 3, 3).clone(),
            torch.zeros(*batch, 3, dtype=dtype, device=device),
            torch.ones(batch, dtype=dtype, device=device),
        )

    @staticmethod
    def from_se3(T: SE3, s=None) -> "Sim3":
        scale = torch.ones(T.t.shape[:-1], dtype=T.t.dtype, device=T.t.device) if s is None else s
        return Sim3(T.R, T.t, scale)


def _sim3_W_coeffs(theta2: torch.Tensor, sigma: torch.Tensor):
    """(C, A, B) of Ws = C I + A hat(phi) + B hat(phi)^2, the integral over
    u in [0, 1] of e^(sigma u) R(u phi) (Strasdat's thesis, eq. 5.7), in
    four branches split at |theta|, |sigma| = 0.05: double Taylor (both
    small), theta-Taylor with exact sigma, sigma-series with exact theta,
    and the closed form of Sophus' calc_W (both large).  The closed form
    alone cancels catastrophically in float32 for small angles."""
    TAU = 0.05
    theta = torch.sqrt(torch.clamp(theta2, min=1e-24))
    small_t = theta < TAU
    small_s = torch.abs(sigma) < TAU
    th = torch.where(small_t, torch.full_like(theta, TAU), theta)  # safe theta for the generic formulas
    sg = torch.where(small_s, torch.full_like(sigma, TAU), sigma)  # safe sigma
    s_sg = torch.exp(sg)
    tiny = torch.abs(sigma) < 1e-12
    sg_any = torch.where(tiny, torch.ones_like(sigma), sigma)
    C = torch.where(tiny, 1.0 + sigma / 2.0, torch.expm1(sigma) / sg_any)
    # both small: double Taylor
    s2 = sigma * sigma
    A_dd = 0.5 + sigma / 3.0 + s2 / 8.0 - theta2 / 24.0 - sigma * theta2 / 30.0
    B_dd = 1.0 / 6.0 + sigma / 8.0 + s2 / 20.0 - theta2 / 120.0 - sigma * theta2 / 144.0
    # theta small: theta-Taylor, En = int_0^1 u^n e^(sigma u) du in closed form
    E1 = (s_sg * (sg - 1.0) + 1.0) / sg**2
    E2 = (s_sg * (sg * sg - 2.0 * sg + 2.0) - 2.0) / sg**3
    E3 = (s_sg * (sg**3 - 3.0 * sg**2 + 6.0 * sg - 6.0) + 6.0) / sg**4
    E4 = (s_sg * (sg**4 - 4.0 * sg**3 + 12.0 * sg**2 - 24.0 * sg + 24.0) - 24.0) / sg**5
    A_ts = E1 - theta2 / 6.0 * E3
    B_ts = E2 / 2.0 - theta2 / 24.0 * E4
    # sigma small: sigma-series, exact theta
    sinth, costh = torch.sin(th), torch.cos(th)
    I0s = (1.0 - costh) / th
    I1s = (sinth - th * costh) / th**2
    I2s = (2.0 * th * sinth + (2.0 - th * th) * costh - 2.0) / th**3
    I0c = 1.0 - sinth / th
    I1c = 0.5 - (costh + th * sinth - 1.0) / th**2
    I2c = 1.0 / 3.0 - ((th * th - 2.0) * sinth + 2.0 * th * costh) / th**3
    A_st = (I0s + sigma * I1s + 0.5 * s2 * I2s) / th
    B_st = (I0c + sigma * I1c + 0.5 * s2 * I2c) / (th * th)
    # both large: the closed form
    a_ = s_sg * sinth
    b_ = s_sg * costh
    cden = sg * sg + th * th
    C_g = (s_sg - 1.0) / sg
    A_gg = (a_ * sg + (1.0 - b_) * th) / (th * cden)
    B_gg = (C_g - ((b_ - 1.0) * sg + a_ * th) / cden) / (th * th)
    A = torch.where(small_t, torch.where(small_s, A_dd, A_ts), torch.where(small_s, A_st, A_gg))
    B = torch.where(small_t, torch.where(small_s, B_dd, B_ts), torch.where(small_s, B_st, B_gg))
    return C, A, B


def _sim3_W(phi: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    C, A, B = _sim3_W_coeffs(torch.sum(phi * phi, dim=-1), sigma)
    W = hat(phi)
    return C[..., None, None] * _eye_like(W) + A[..., None, None] * W + B[..., None, None] * (W @ W)


def sim3_exp(xi: torch.Tensor) -> Sim3:
    """sim(3) exp; xi = (...,7) ordered [rho(3), phi(3), sigma(1)]."""
    rho, phi, sigma = xi[..., :3], xi[..., 3:6], xi[..., 6]
    t = torch.einsum("...ij,...j->...i", _sim3_W(phi, sigma), rho)
    return Sim3(so3_exp(phi), t, torch.exp(sigma))


def sim3_log(S: Sim3) -> torch.Tensor:
    """Inverse of :func:`sim3_exp`: rebuild Ws and solve Ws rho = t."""
    phi = so3_log(S.R)
    sigma = torch.log(S.s)
    rho = torch.linalg.solve(_sim3_W(phi, sigma), S.t[..., None])[..., 0]
    return torch.cat([rho, phi, sigma[..., None]], dim=-1)
