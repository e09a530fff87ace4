"""IMU preintegration on-manifold (Forster et al.), the recurrence of
ImuTypes.cc:187-247.

Counterpart of ``orb_slam3_fast_tpu/imu/preintegration.py``: the same
``ImuNoise`` and ``Preintegrated`` layouts (delta state dR, dV, dP, the
15x15 covariance ordered [phi, v, p, bg, ba], the five bias Jacobians and
the linearisation bias), the same midpoint rule and the same order of
operations in float32.  ``preintegrate`` and ``merge`` run one window of
samples (padded slots carry ``valid`` False and integrate with dt = 0, as
in the JAX package); ``compose`` joins two consecutive windows;
``predict_state`` is plain torch on the frame's device.

``preintegrate``, ``merge`` and ``compose`` are the wrappers of kernel V
(``csrc/imu_preint.cu``); ``*_plain`` are the same functions in PyTorch.

Kernel V -- source note.
  Replaces: ``preintegrate`` / ``merge`` / ``compose``
  (``orb_slam3_fast_tpu/imu/preintegration.py:172, 247, 261``, jitted at
  ``:312-314``, K22), a ``lax.scan`` over the frame's sample bucket.
  Bound on the card: latency.  The work is a strictly sequential recurrence
  over <= 64 samples (200 Hz IMU, 20 fps camera, the bucket doubled); each
  step is ~4k flops (a 9x9 A times the 9x9 covariance block times A^T, the
  cross block, five 3x3 bias Jacobians, a 3x3 SVD) on ~1 kB of state, so
  the card's rates bound it at nanoseconds and the dependency chain of 64
  steps at microseconds.
  Design: one warp per window.  Every lane keeps the small state (dR, dV,
  dP, the Jacobians) in registers and computes it redundantly, so nothing
  of it needs a broadcast; the lanes share out the products of the
  covariance update (81 entries of A C9, then of (A C9) A^T + B N B^T, 54 of
  the cross block A C[:9, 9:]) through shared memory with a __syncwarp
  between the stages, in float32 and the JAX package's order (the 9x9
  block, the cross block, then the walk on the bias block).  The
  re-orthonormalisation of dR is ``jacobi::svd3`` in float64; a non-finite
  entry gives a NaN rotation, as the JAX package's SVD does, so that the
  tracker's bad-IMU test sees it.  ``merge`` is the same scan from a given
  start; ``compose`` runs on one thread in closed form.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from orb_slam3_fast_tpu_torch import _kernels
from orb_slam3_fast_tpu_torch.utils import lie

GRAVITY_VALUE = 9.81  # reference ImuTypes.h:42
PACKED = 292  # floats of a packed Preintegrated: dT | dR | dV | dP | C | JRg JVg JVa JPg JPa | bias


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """``lie.so3_exp`` with a batch axis under it: under ``torch.func``'s
    forward mode a 0-d angle promotes the tangent to float64, a 1-d one
    does not."""
    return lie.so3_exp(w.unsqueeze(0)).squeeze(0) if w.dim() == 1 else lie.so3_exp(w)


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """``lie.so3_log`` with a batch axis under it (see :func:`so3_exp`)."""
    return lie.so3_log(R.unsqueeze(0)).squeeze(0) if R.dim() == 2 else lie.so3_log(R)


def gravity(device, dtype=torch.float32) -> torch.Tensor:
    return torch.tensor([0.0, 0.0, -GRAVITY_VALUE], dtype=dtype, device=device)


class ImuNoise(NamedTuple):
    """Discrete noise standard deviations (float32 values as Python floats):
    Cov = (sigma * freq^0.5)^2 for the white noise, walk / freq^0.5 for the
    random walk (Settings::readIMU -> Calib, ImuTypes.h:105-147)."""

    gyro: float
    acc: float
    gyro_walk: float
    acc_walk: float

    @staticmethod
    def from_continuous(noise_gyro, noise_acc, walk_gyro, walk_acc, freq) -> "ImuNoise":
        sf = float(freq) ** 0.5
        return ImuNoise(*(float(np.float32(x)) for x in (noise_gyro * sf, noise_acc * sf, walk_gyro / sf,
                                                           walk_acc / sf)))


class Preintegrated(NamedTuple):
    dT: torch.Tensor  # ()
    dR: torch.Tensor  # (3,3)
    dV: torch.Tensor  # (3,)
    dP: torch.Tensor  # (3,)
    C: torch.Tensor  # (15,15) covariance [phi, v, p, bg, ba]
    JRg: torch.Tensor  # (3,3) d dR / d bg
    JVg: torch.Tensor
    JVa: torch.Tensor
    JPg: torch.Tensor
    JPa: torch.Tensor
    bias: torch.Tensor  # (6,) [bg, ba] linearisation point

    @staticmethod
    def identity(bias=None, device="cpu") -> "Preintegrated":
        f32 = torch.float32
        b = torch.zeros(6, dtype=f32, device=device) if bias is None else torch.as_tensor(bias, dtype=f32).to(device)
        z33 = torch.zeros((3, 3), dtype=f32, device=b.device)
        return Preintegrated(
            dT=torch.zeros((), dtype=f32, device=b.device), dR=torch.eye(3, dtype=f32, device=b.device),
            dV=torch.zeros(3, dtype=f32, device=b.device), dP=torch.zeros(3, dtype=f32, device=b.device),
            C=torch.zeros((15, 15), dtype=f32, device=b.device), JRg=z33, JVg=z33, JVa=z33, JPg=z33, JPa=z33, bias=b,
        )

    def to(self, device) -> "Preintegrated":
        return Preintegrated(*(x.to(device) for x in self))


def stack(ps) -> Preintegrated:
    """Preintegrated windows stacked along a new leading axis."""
    return Preintegrated(*(torch.stack(xs) for xs in zip(*ps)))


def pack(p: Preintegrated) -> torch.Tensor:
    """(..., 292) float32: dT | dR | dV | dP | C | JRg JVg JVa JPg JPa | bias."""
    lead = p.dR.shape[:-2]
    parts = [p.dT.reshape(*lead, 1)] + [getattr(p, f).reshape(*lead, -1) for f in Preintegrated._fields[1:]]
    return torch.cat([x.to(torch.float32) for x in parts], dim=-1).contiguous()


def unpack(v: torch.Tensor) -> Preintegrated:
    lead = v.shape[:-1]
    sizes = (1, 9, 3, 3, 225, 9, 9, 9, 9, 9, 6)
    shapes = ((), (3, 3), (3,), (3,), (15, 15), (3, 3), (3, 3), (3, 3), (3, 3), (3, 3), (6,))
    out, o = [], 0
    for n, s in zip(sizes, shapes):
        out.append(v[..., o:o + n].reshape(tuple(lead) + s))
        o += n
    return Preintegrated(*out)


def integrate_step(p: Preintegrated, acc, gyro, dt, noise: ImuNoise) -> Preintegrated:
    """One measurement update (reference IntegrateNewMeasurement, ImuTypes.cc:187-247)."""
    f32, dev = torch.float32, p.dR.device
    bg, ba = p.bias[:3], p.bias[3:]
    a = acc - ba
    w = gyro - bg
    dt2 = dt * dt
    Wa = lie.hat(a)
    dRa = p.dR @ Wa
    dP_new = p.dP + p.dV * dt + 0.5 * (p.dR @ a) * dt2
    dV_new = p.dV + (p.dR @ a) * dt
    dRi = lie.so3_exp(w * dt)
    Jr = lie.so3_right_jacobian(w * dt)
    I3 = torch.eye(3, dtype=f32, device=dev)
    A = torch.zeros((9, 9), dtype=f32, device=dev)
    A[0:3, 0:3] = dRi.T
    A[3:6, 0:3] = -dRa * dt
    A[6:9, 0:3] = -0.5 * dRa * dt2
    A[3:6, 3:6] = I3
    A[6:9, 3:6] = I3 * dt
    A[6:9, 6:9] = I3
    B = torch.zeros((9, 6), dtype=f32, device=dev)
    B[0:3, 0:3] = Jr * dt
    B[3:6, 3:6] = p.dR * dt
    B[6:9, 3:6] = 0.5 * p.dR * dt2
    sg, sa, wg, wa = (torch.tensor(x, dtype=f32, device=dev) for x in noise)
    Nga = torch.diag(torch.cat([(sg**2).expand(3), (sa**2).expand(3)]))
    C_rvp = A @ p.C[:9, :9] @ A.T + B @ Nga @ B.T
    NgaWalk = torch.diag(torch.cat([(wg**2).expand(3), (wa**2).expand(3)]))
    C_cross = A @ p.C[:9, 9:15]
    C_new = p.C.clone()
    C_new[:9, :9] = C_rvp
    C_new[:9, 9:15] = C_cross
    C_new[9:15, :9] = C_cross.T
    C_new[9:15, 9:15] = p.C[9:15, 9:15] + NgaWalk * dt
    JPa_new = p.JPa + p.JVa * dt - 0.5 * p.dR * dt2
    JPg_new = p.JPg + p.JVg * dt - 0.5 * dRa @ p.JRg * dt2
    JVa_new = p.JVa - p.dR * dt
    JVg_new = p.JVg - dRa @ p.JRg * dt
    JRg_new = dRi.T @ p.JRg - Jr * dt
    dR_new = lie.normalize_rotation(p.dR @ dRi)
    return Preintegrated(dT=p.dT + dt, dR=dR_new, dV=dV_new, dP=dP_new, C=C_new, JRg=JRg_new, JVg=JVg_new,
                         JVa=JVa_new, JPg=JPg_new, JPa=JPa_new, bias=p.bias)


def merge_plain(prev: Preintegrated, acc, gyro, dt, noise: ImuNoise, valid=None) -> Preintegrated:
    """Plain version of kernel V from a given start: the scan over every
    slot, padded ones (``valid`` False) with dt = 0."""
    if valid is not None:
        dt = torch.where(valid, dt, torch.zeros_like(dt))
    p = prev
    for i in range(acc.shape[0]):
        p = integrate_step(p, acc[i], gyro[i], dt[i], noise)
    return p


def preintegrate_plain(acc, gyro, dt, bias, noise: ImuNoise, valid=None) -> Preintegrated:
    return merge_plain(Preintegrated.identity(bias, acc.device), acc, gyro, dt, noise, valid)


def compose_plain(p1: Preintegrated, p2: Preintegrated) -> Preintegrated:
    """Two consecutive windows (same linearisation bias) as one, without the
    raw samples (Forster et al. eq. 29-31 blockwise)."""
    dR1, dR2, dT2, dV2, dP2 = p1.dR, p2.dR, p2.dT, p2.dV, p2.dP
    dev = dR1.device
    dR = lie.normalize_rotation(dR1 @ dR2)
    dV = p1.dV + dR1 @ dV2
    dP = p1.dP + p1.dV * dT2 + dR1 @ dP2
    JRg = dR2.T @ p1.JRg + p2.JRg
    JVg = p1.JVg + dR1 @ p2.JVg - dR1 @ lie.hat(dV2) @ p1.JRg
    JVa = p1.JVa + dR1 @ p2.JVa
    JPg = p1.JPg + p1.JVg * dT2 + dR1 @ p2.JPg - dR1 @ lie.hat(dP2) @ p1.JRg
    JPa = p1.JPa + p1.JVa * dT2 + dR1 @ p2.JPa
    Z = torch.zeros((3, 3), dtype=torch.float32, device=dev)
    I = torch.eye(3, dtype=torch.float32, device=dev)
    F1 = torch.cat([torch.cat([dR2.T, Z, Z], 1), torch.cat([-dR1 @ lie.hat(dV2), I, Z], 1),
                    torch.cat([-dR1 @ lie.hat(dP2), I * dT2, I], 1)], 0)
    G = torch.block_diag(I, dR1, dR1)
    C9 = F1 @ p1.C[:9, :9] @ F1.T + G @ p2.C[:9, :9] @ G.T
    C = torch.zeros((15, 15), dtype=torch.float32, device=dev)
    C[:9, :9] = C9
    C[9:15, 9:15] = p1.C[9:15, 9:15] + p2.C[9:15, 9:15]
    return Preintegrated(dT=p1.dT + dT2, dR=dR, dV=dV, dP=dP, C=C, JRg=JRg, JVg=JVg, JVa=JVa, JPg=JPg, JPa=JPa,
                         bias=p1.bias)


def _launch(start, bias, acc, gyro, dt, valid, noise: ImuNoise, mode: str) -> Preintegrated:
    f32 = torch.float32
    dev = acc.device
    acc, gyro, dt = (x.to(f32).contiguous() for x in (acc, gyro, dt))
    n = acc.shape[0]
    if valid is None:
        valid = torch.ones(n, dtype=torch.bool, device=dev)
    valid = valid.contiguous()
    _kernels.require_cuda("imu preintegration", acc=(acc, f32), gyro=(gyro, f32), dt=(dt, f32),
                          valid=(valid, torch.bool))
    if acc.shape != (n, 3) or gyro.shape != (n, 3) or dt.shape != (n,) or valid.shape != (n,):
        raise ValueError("imu preintegration: needs (N,3) acc and gyro, (N,) dt and valid")
    start_p = 0 if start is None else start.data_ptr()
    bias = bias.to(f32).contiguous()
    out = torch.empty(PACKED, dtype=f32, device=dev)
    nz = np.asarray(noise, np.float32)
    _kernels.launch("imu_preint_launch", dev, start_p, bias.data_ptr(), acc.data_ptr(), gyro.data_ptr(),
                    dt.data_ptr(), valid.data_ptr(), n, nz.ctypes.data, out.data_ptr())
    preintegrate.launches.add(mode)
    return unpack(out)


def preintegrate(acc, gyro, dt, bias, noise: ImuNoise, valid=None) -> Preintegrated:
    """Integrate a window of (N,3) samples from the identity at ``bias``:
    kernel V on CUDA tensors, its plain version on CPU ones."""
    if acc.device.type == "cpu":
        return preintegrate_plain(acc, gyro, dt, bias, noise, valid)
    return _launch(None, torch.as_tensor(bias).to(acc.device), acc, gyro, dt, valid, noise, "")


def merge(prev: Preintegrated, acc, gyro, dt, noise: ImuNoise, valid=None) -> Preintegrated:
    """Continue integrating ``prev`` with more samples (kernel V from a
    given start on CUDA tensors)."""
    if acc.device.type == "cpu":
        return merge_plain(prev, acc, gyro, dt, noise, valid)
    return _launch(pack(prev.to(acc.device)), prev.bias.to(acc.device), acc, gyro, dt, valid, noise, "merge")


def compose(p1: Preintegrated, p2: Preintegrated) -> Preintegrated:
    """Two consecutive windows as one (kernel V's closed form on CUDA)."""
    if p1.dR.device.type == "cpu":
        return compose_plain(p1, p2)
    return _compose_kernel(p1, p2)


def _compose_kernel(p1: Preintegrated, p2: Preintegrated) -> Preintegrated:
    dev = p1.dR.device
    a, b = pack(p1), pack(p2.to(dev))
    out = torch.empty(PACKED, dtype=torch.float32, device=dev)
    _kernels.launch("imu_compose_launch", dev, a.data_ptr(), b.data_ptr(), out.data_ptr())
    preintegrate.launches.add("compose")
    return unpack(out)


preintegrate.launches = _kernels.LaunchCounter()  # modes "", "merge", "compose"


def delta_rotation(p: Preintegrated, bias: torch.Tensor) -> torch.Tensor:
    """Bias-corrected dR (GetDeltaRotation, ImuTypes.cc:249-258), without
    the SVD, as the JAX package (it sits inside differentiated factors)."""
    dbg = bias[..., :3] - p.bias[..., :3]
    return p.dR @ so3_exp(torch.einsum("...ij,...j->...i", p.JRg, dbg))


def delta_velocity(p: Preintegrated, bias: torch.Tensor) -> torch.Tensor:
    dbg = bias[..., :3] - p.bias[..., :3]
    dba = bias[..., 3:] - p.bias[..., 3:]
    return p.dV + torch.einsum("...ij,...j->...i", p.JVg, dbg) + torch.einsum("...ij,...j->...i", p.JVa, dba)


def delta_position(p: Preintegrated, bias: torch.Tensor) -> torch.Tensor:
    dbg = bias[..., :3] - p.bias[..., :3]
    dba = bias[..., 3:] - p.bias[..., 3:]
    return p.dP + torch.einsum("...ij,...j->...i", p.JPg, dbg) + torch.einsum("...ij,...j->...i", p.JPa, dba)


def predict_state(Rwb, pwb, vwb, p: Preintegrated, bias):
    """IMU state prediction (Tracking::PredictStateIMU, Tracking.cc:1734-1792):
    (Rwb2, pwb2, vwb2) at the end of the window, plain torch on the frame's
    device."""
    t = p.dT
    g = gravity(Rwb.device)
    dR = delta_rotation(p, bias)
    dV = delta_velocity(p, bias)
    dP = delta_position(p, bias)
    Rwb2 = lie.normalize_rotation(Rwb @ dR)
    vwb2 = vwb + g * t + Rwb @ dV
    pwb2 = pwb + vwb * t + 0.5 * g * t * t + Rwb @ dP
    return Rwb2, pwb2, vwb2
