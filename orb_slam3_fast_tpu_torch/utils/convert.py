"""Carry state and constants between the JAX package's layout and the port.

The system has no learned weights; what crosses over is the settings and
their cameras, the keypoints of a frame, the local-map arrays as ``WorldMap`` holds them and a
pose, and the inertial path's state (``inertial_to_torch`` /
``inertial_to_numpy``).  Each ``*_to_torch`` takes numpy arrays in the JAX
package's layout (descriptors unpacked as (N, 256) int8) and returns the port's tensors on
``device`` (descriptors packed as (N, 8) int32); each ``*_to_numpy`` is its
inverse.
"""
from __future__ import annotations

import numpy as np
import torch

from orb_slam3_fast_tpu_torch.cameras.models import Camera
from orb_slam3_fast_tpu_torch.frontend.tracker import LocalMap
from orb_slam3_fast_tpu_torch.imu.preintegration import ImuNoise, Preintegrated
from orb_slam3_fast_tpu_torch.optim.imu_init import InertialInit
from orb_slam3_fast_tpu_torch.optim.inertial import BodyState, PriorState, VIObs
from orb_slam3_fast_tpu_torch.optim.vi_ba import VIBAProblem
from orb_slam3_fast_tpu_torch.ops.extractor import Keypoints
from orb_slam3_fast_tpu_torch.ops.hamming import pack_desc, unpack_desc
from orb_slam3_fast_tpu_torch.utils.lie import SE3


def _f32(a, device) -> torch.Tensor:
    return torch.tensor(np.asarray(a, dtype=np.float32), device=device)


def _bool(a, device) -> torch.Tensor:
    return torch.tensor(np.asarray(a, dtype=bool), device=device)


def desc_to_torch(desc, device) -> torch.Tensor:
    """(N,256) int8 {0,1} -> (N,8) int32 packed."""
    return pack_desc(torch.tensor(np.asarray(desc, dtype=np.int8))).to(device)


def desc_to_numpy(desc: torch.Tensor) -> np.ndarray:
    return unpack_desc(desc.cpu()).numpy()


def camera_to_torch(kind: str, params, device="cpu") -> Camera:
    """``Camera(kind, params)`` of the JAX package -> the port's Camera."""
    return Camera(kind, _f32(params, device))


def camera_to_numpy(cam: Camera) -> tuple[str, np.ndarray]:
    return cam.kind, cam.params.cpu().numpy()


def settings_to_torch(settings):
    """The JAX package's ``Settings`` -> the port's, field by field: the
    cameras (pin-hole or KB8, ``cam2`` of a two-camera rig) as the port's
    host Cameras, the extrinsics (``T_c1_c2``, ``T_b_c1``) and every other
    field as they are."""
    import dataclasses

    from orb_slam3_fast_tpu_torch.slam.settings import Settings

    out = {f.name: getattr(settings, f.name) for f in dataclasses.fields(Settings)}
    for name in ("cam", "cam2"):
        if out[name] is not None:
            out[name] = camera_to_torch(out[name].kind, np.asarray(out[name].params))
    for name in ("T_c1_c2", "T_b_c1"):
        if out[name] is not None:
            out[name] = np.asarray(out[name], np.float64)
    return Settings(**out)


def keypoints_to_torch(xy, level, angle, response, desc, valid, device) -> Keypoints:
    """Fields of the JAX package's ``Keypoints`` -> the port's."""
    return Keypoints(
        xy=_f32(xy, device),
        level=torch.tensor(np.asarray(level, dtype=np.int64), device=device),
        angle=_f32(angle, device),
        response=_f32(response, device),
        desc=desc_to_torch(desc, device),
        valid=_bool(valid, device),
    )


def keypoints_to_numpy(kp: Keypoints) -> dict:
    """The port's Keypoints -> a dict of numpy arrays in the JAX layout."""
    return {
        "xy": kp.xy.cpu().numpy(),
        "level": kp.level.cpu().numpy().astype(np.int32),
        "angle": kp.angle.cpu().numpy(),
        "response": kp.response.cpu().numpy(),
        "desc": desc_to_numpy(kp.desc),
        "valid": kp.valid.cpu().numpy(),
    }


def local_map_to_torch(lm_pos, lm_desc, lm_normal, lm_dmin, lm_dmax, lm_mask, device) -> LocalMap:
    """``WorldMap`` landmark arrays (gathered into a padded block) -> LocalMap."""
    return LocalMap(
        pos=_f32(lm_pos, device),
        desc=desc_to_torch(lm_desc, device),
        normal=_f32(lm_normal, device),
        dmin=_f32(lm_dmin, device),
        dmax=_f32(lm_dmax, device),
        mask=_bool(lm_mask, device),
    )


def local_map_to_numpy(lm: LocalMap) -> dict:
    return {
        "lm_pos": lm.pos.cpu().numpy(),
        "lm_desc": desc_to_numpy(lm.desc),
        "lm_normal": lm.normal.cpu().numpy(),
        "lm_dmin": lm.dmin.cpu().numpy(),
        "lm_dmax": lm.dmax.cpu().numpy(),
        "lm_mask": lm.mask.cpu().numpy(),
    }


def se3_to_torch(R, t, device) -> SE3:
    return SE3(_f32(R, device), _f32(t, device))


def se3_to_numpy(T: SE3) -> tuple[np.ndarray, np.ndarray]:
    return T.R.cpu().numpy(), T.t.cpu().numpy()


# --- inertial state ----------------------------------------------------------
# The JAX package's NamedTuples of the inertial path (ImuNoise, Preintegrated,
# BodyState, PriorState, VIObs, VIBAProblem, InertialInit) cross over field by
# field, as numpy arrays: floats as float32, integers as int32, masks as bool;
# nested NamedTuples (a PriorState's BodyState, a VIBAProblem's stacked
# Preintegrated) recursively.  ImuNoise's fields are Python floats in the port.


def _leaf_to_torch(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype == bool:
        return torch.tensor(a, device=device)
    if np.issubdtype(a.dtype, np.integer):
        return torch.tensor(a.astype(np.int32), device=device)
    return torch.tensor(a.astype(np.float32), device=device)


def _tree_to_torch(obj, cls, device):
    return cls(*(_tree_to_torch(v, INERTIAL_TYPES[type(v).__name__], device) if hasattr(v, "_fields")
                 else _leaf_to_torch(v, device) for v in obj))


def _tree_to_numpy(obj):
    return {name: (_tree_to_numpy(v) if hasattr(v, "_fields") else np.asarray(v.detach().cpu().numpy()
                                                                              if torch.is_tensor(v) else v))
            for name, v in zip(obj._fields, obj)}


def inertial_to_torch(obj, device="cpu"):
    """One of the JAX package's inertial NamedTuples (or a NamedTuple of
    numpy arrays with the same fields) -> the port's, on ``device``.  The
    JAX type is recognised by its class name."""
    cls = INERTIAL_TYPES[type(obj).__name__]
    if cls is ImuNoise:
        return ImuNoise(*(float(np.float32(x)) for x in obj))
    return _tree_to_torch(obj, cls, device)


def inertial_to_numpy(obj) -> dict:
    """The port's inertial NamedTuple -> a dict of numpy arrays (nested
    dicts for nested tuples), the fields of the JAX package's type, which
    ``JaxType(**d)`` rebuilds (nested ones first)."""
    if isinstance(obj, ImuNoise):
        return {name: np.float32(v) for name, v in zip(obj._fields, obj)}
    return _tree_to_numpy(obj)


INERTIAL_TYPES = {cls.__name__: cls for cls in (ImuNoise, Preintegrated, BodyState, PriorState, VIObs, VIBAProblem,
                                                InertialInit)}
