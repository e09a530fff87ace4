"""Carry state and constants between the JAX package's layout and the port.

The system has no learned weights; what crosses over is the camera, the
keypoints of a frame, the local-map arrays as ``WorldMap`` holds them and a
pose.  Each ``*_to_torch`` takes numpy arrays in the JAX package's layout
(descriptors unpacked as (N, 256) int8) and returns the port's tensors on
``device`` (descriptors packed as (N, 8) int32); each ``*_to_numpy`` is its
inverse.
"""
from __future__ import annotations

import numpy as np
import torch

from orb_slam3_fast_tpu_torch.cameras.models import Camera
from orb_slam3_fast_tpu_torch.frontend.tracker import LocalMap
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
