"""The per-frame stereo tracking step.

Counterpart of the device half of ``Tracker.process_stereo`` in
``orb_slam3_fast_tpu/frontend/tracker.py``: ``stereo_front`` is
``_stereo_front``, ``visible_landmarks`` is ``_visible_landmarks``, and
``StereoTrackingStep`` chains them with ``search_by_projection`` and
``pose_optimization`` as ``_track_local_map`` and ``_pose_opt_from_obs``
do.  The host state machine (``Tracker``) is not ported yet.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from orb_slam3_fast_tpu_torch.cameras import models as cam_models
from orb_slam3_fast_tpu_torch.ops import extractor as ext
from orb_slam3_fast_tpu_torch.ops import matching as mat
from orb_slam3_fast_tpu_torch.optim import pose_opt
from orb_slam3_fast_tpu_torch.utils import lie


def stereo_front(il, ir, cfg: ext.ExtractorConfig, bf: float, min_z: float, scales, slot_scales):
    """Dual ORB extraction, banded Hamming stereo match and SAD subpixel
    disparity refinement.  Returns (kp_l, kp_r, stereo matches, refined
    right-u, refinement ok)."""
    kp_l = ext.extract(il, cfg)
    kp_r = ext.extract(ir, cfg)
    sm = mat.stereo_match(kp_l, kp_r, scales, bf=bf, min_z=min_z, slot_scale_r=slot_scales)
    ur_ref, ok = mat.stereo_subpixel_refine(il, ir, kp_l.xy, sm.right_u, sm.valid)
    return kp_l, kp_r, sm, ur_ref, ok


def visible_landmarks(cam, R, t, lm_pos, lm_mask, lm_normal, lm_dmin, lm_dmax, wh,
                      log_sf: float = math.log(1.2), n_lvl: int = 8):
    """Frustum, distance-band and view-angle test (Frame::isInFrustum) and
    PredictScale for a padded landmark block.  Returns (uv, pred_level,
    visible)."""
    xc = lm_pos @ R.T + t
    uv = cam_models.project(cam, xc)
    z_ok = xc[:, 2] > 0.05
    in_img = (uv[:, 0] >= 0) & (uv[:, 0] < wh[0]) & (uv[:, 1] >= 0) & (uv[:, 1] < wh[1])
    po = lm_pos - (-(R.T @ t))[None, :]
    dist = torch.linalg.vector_norm(po, dim=-1)
    dist_ok = (dist >= lm_dmin * 0.8) & (dist <= lm_dmax * 1.2)
    view_cos = torch.sum(po * lm_normal, dim=-1) / torch.clamp(dist, min=1e-9)
    angle_ok = view_cos > 0.5
    ratio = torch.clamp(lm_dmax / torch.clamp(dist, min=1e-9), min=1.0)
    pred_level = torch.clamp(torch.ceil(torch.log(ratio) / log_sf).long(), 0, n_lvl - 1)
    return uv, pred_level, lm_mask & z_ok & in_img & dist_ok & angle_ok


class LocalMap(NamedTuple):
    """Padded local-map block, as ``WorldMap`` holds it."""

    pos: torch.Tensor  # (M,3) float32 world position
    desc: torch.Tensor  # (M,8) int32 packed descriptor
    normal: torch.Tensor  # (M,3) float32 mean viewing direction
    dmin: torch.Tensor  # (M,) float32 scale-invariance distance band
    dmax: torch.Tensor  # (M,)
    mask: torch.Tensor  # (M,) bool live slot


class StepResult(NamedTuple):
    T: lie.SE3  # new T_cw, rotation projected onto SO(3)
    inlier: torch.Tensor  # (N,) bool per keypoint slot
    n_matches: torch.Tensor  # () int projection matches fed to the pose opt
    n_inliers: torch.Tensor  # () int


class StereoTrackingStep(nn.Module):
    """One rectified-stereo tracking step against a local map:
    stereo_front -> depth / right-u -> visible_landmarks ->
    search_by_projection -> PoseObs -> pose_optimization.

    The camera's parameters are read as scalars; keep them on the host (a
    CPU ``Camera``) to avoid a device read per frame."""

    def __init__(self, cam: cam_models.Camera, bf: float, image_wh: tuple[int, int],
                 cfg: ext.ExtractorConfig = ext.ExtractorConfig(), map_radius: float = 3.0,
                 device: torch.device | str = "cpu"):
        super().__init__()
        self.cam = cam
        self.bf = float(bf)
        self.cfg = cfg
        self.wh = image_wh
        self.map_radius = map_radius
        self.min_z = max(2.0 * self.bf / float(cam.params[0]), 0.1)  # tracker.py:265
        n_lvl = cfg.n_levels
        self.register_buffer(
            "scales", torch.tensor(cfg.scale_factor ** np.arange(n_lvl), dtype=torch.float32, device=device)
        )
        self.register_buffer("slot_scales", torch.as_tensor(ext.slot_scales(cfg), device=device))
        self.register_buffer(
            "inv_sigma2", torch.as_tensor(1.0 / ext.level_sigma2(cfg), dtype=torch.float32, device=device)
        )

    def front(self, img_l: torch.Tensor, img_r: torch.Tensor):
        """Stereo front half; returns (left keypoints, right-u per slot, -1
        where the slot has no metric depth), as tracker.py:264-277."""
        kp, _, _, ur, ok = stereo_front(img_l, img_r, self.cfg, self.bf, self.min_z, self.scales, self.slot_scales)
        disp = torch.clamp(kp.xy[:, 0] - ur, min=0.01)
        depth = torch.where(ok & (disp >= 0.5), self.bf / disp, torch.full_like(disp, -1.0))
        return kp, torch.where(depth > 0, ur, torch.full_like(ur, -1.0))

    def match_map(self, kp: ext.Keypoints, T_pred: lie.SE3, lm: LocalMap):
        """Frustum test and projection match against the local map; returns
        (keypoint slot per landmark, accept per landmark)."""
        uv, pred_level, visible = visible_landmarks(
            self.cam, T_pred.R, T_pred.t, lm.pos, lm.mask, lm.normal, lm.dmin, lm.dmax, self.wh,
            log_sf=math.log(self.cfg.scale_factor), n_lvl=self.cfg.n_levels,
        )
        return mat.search_by_projection(kp, uv, visible, lm.desc, pred_level, self.scales, radius=self.map_radius)

    def pose_obs(self, kp: ext.Keypoints, right_u, idx, accept, lm: LocalMap) -> pose_opt.PoseObs:
        """PoseObs over the keypoint slots, as _pose_opt_from_obs builds it:
        mono edges everywhere, stereo ones where right-u is valid.  Accepted
        matches hit distinct slots; the others land in a dump row."""
        n = kp.n
        dev = kp.xy.device
        slot = torch.where(accept, idx, torch.full_like(idx, n))
        xw = torch.zeros((n + 1, 3), dtype=torch.float32, device=dev).index_copy_(0, slot, lm.pos)[:n]
        valid = torch.zeros(n + 1, dtype=torch.bool, device=dev).index_copy_(0, slot, accept)[:n]
        stereo = valid & (right_u > 0)
        uvr = torch.cat([kp.xy, torch.where(stereo, right_u, torch.full_like(right_u, -1.0))[:, None]], dim=1)
        uvr = torch.where(valid[:, None], uvr, torch.full_like(uvr, -1.0))
        inv_s2 = torch.where(valid, self.inv_sigma2[kp.level], torch.ones_like(kp.xy[:, 0]))
        return pose_opt.PoseObs(
            xw=xw.contiguous(), uv=uvr.contiguous(), inv_sigma2=inv_s2.contiguous(),
            is_stereo=stereo.contiguous(), valid=valid.contiguous(),
        )

    def forward(self, img_l: torch.Tensor, img_r: torch.Tensor, T_pred: lie.SE3, lm: LocalMap) -> StepResult:
        kp, right_u = self.front(img_l, img_r)
        idx, accept = self.match_map(kp, T_pred, lm)
        obs = self.pose_obs(kp, right_u, idx, accept, lm)
        T, inlier, n_inl = pose_opt.pose_optimization(self.cam, self.bf, T_pred, obs)
        # project back to SO(3) on the host, as the tracker does (tracker.py:596)
        R = torch.as_tensor(lie.normalize_rotation_np(T.R.cpu().numpy()), device=T.R.device)
        return StepResult(lie.SE3(R, T.t), inlier, obs.valid.sum(), n_inl)
