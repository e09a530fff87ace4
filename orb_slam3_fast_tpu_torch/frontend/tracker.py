"""Tracking front end: the per-frame state machine of the monocular, stereo
and RGB-D System, and the fixed-map tracking step.

Counterpart of ``orb_slam3_fast_tpu/frontend/tracker.py`` (Tracking::Track,
Tracking.cc:1798-2292): the state machine runs on the host, the keypoints
stay on ``device``, the map is the host ``WorldMap``.  Per frame:
one extraction (mono), ``stereo_front`` (dual extraction, banded stereo
match, SAD refine), ``fisheye_front`` for a two-camera Kannala-Brandt rig
(dual extraction, the fisheye match and triangulation: a depth per left
keypoint and no right-u, so every pose edge is monocular) or, for RGB-D,
one extraction and the depth map sampled at the keypoints -> motion-model
match + pose opt, with the
reference-keyframe fallback, or relocalisation when lost -> local-map match
+ pose opt -> keyframe decision -> keyframe indexing and local mapping.
Mono initialisation matches a reference frame (``search_for_initialization``)
and bootstraps the map with ``twoview.reconstruct``; relocalisation takes
the keyframe database's candidates through a mutual match, ``pnp_ransac``
and pose optimisation.

``stereo_front`` is ``_stereo_front``, ``visible_landmarks`` is
``_visible_landmarks`` (the wrapper of kernel L); ``StereoTrackingStep`` is
the fixed-map step that chains them with ``search_by_projection`` and
``pose_optimization`` as ``_track_local_map`` does.

With a loop closer every keyframe goes to ``LoopCloser.process_keyframe``
after local mapping, and tracking goes on from the corrected keyframe pose;
with an Atlas a lost map (or a timestamp jump) is kept and a new one
started, or reset when it is poor, keyframe-database rows are global, and
a merge rebases the tracker's cached ids and pose
(``_remap_after_merge``).  With an async backend (``backend=``, a
``backend.pipeline.AsyncBackend``) a new keyframe is written into the map
under the backend's lock and queued to its worker thread instead of being
mapped inline, and before each tracked frame ``_sync_backend`` takes the
worker's loop and merge events and, when the worker changed the map,
rebases the last pose through its reference keyframe (Tracking.cc:
1884-1891).  ``_predict_lost_pose`` and ``_lost_state`` are the hooks the
inertial tracker (``frontend/vi_tracker.py``) overrides.  With no vocabulary,
``_index_kf`` does nothing and ``_relocalize`` fails, as in the JAX
package.

Kernel L -- source note.
  Replaces: ``_visible_landmarks`` (``orb_slam3_fast_tpu/frontend/
  tracker.py:92``), a jitted program of ~40 elementwise operations over the
  4096 landmark slots.
  Bound on the card: launch latency.  It reads 33 bytes and writes 17 per
  slot (~0.2 MB at 4096 slots, 60 ns at 3.35 TB/s) and does ~100 flops per
  slot.
  Design: one thread per landmark slot, R and t read from device memory
  (no host read of the pose), intrinsics and distortion passed as floats
  from the host Camera (a KB8 camera takes the kernel's KB8 instance,
  ``csrc/camera.cuh``); it computes what the plain version computes, in
  float32, with the compiler's FMA contraction, so uv agrees to float
  rounding and a level or flag differs only where a quantity lies within
  rounding of its threshold.  It stays a kernel of its own rather than a
  prologue of kernel C: the tracker reads ``visible`` on the host for its
  ``lm_visible`` bookkeeping anyway.
"""
from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np
import torch
from torch import nn

from orb_slam3_fast_tpu_torch import _kernels
from orb_slam3_fast_tpu_torch.cameras import models as cam_models
from orb_slam3_fast_tpu_torch.map.worldmap import WorldMap, host
from orb_slam3_fast_tpu_torch.ops import extractor as ext
from orb_slam3_fast_tpu_torch.ops import matching as mat
from orb_slam3_fast_tpu_torch.ops import twoview
from orb_slam3_fast_tpu_torch.optim import pnp, pose_opt
from orb_slam3_fast_tpu_torch.utils import lie, verbose
from orb_slam3_fast_tpu_torch.utils.timers import StageTimers
from orb_slam3_fast_tpu_torch.vocab import vocabulary as voc_mod

# tracking states (Tracking.h:122-130)
NOT_INITIALIZED = "NOT_INITIALIZED"
OK = "OK"
RECENTLY_LOST = "RECENTLY_LOST"
LOST = "LOST"


class TrackerConfig(NamedTuple):
    """The JAX package's TrackerConfig."""

    extractor: ext.ExtractorConfig = ext.ExtractorConfig(n_features=1024)
    lm_cap: int = 4096  # local-map landmark slots per tracking call
    min_init_matches: int = 100  # Tracking.cc mono init threshold
    min_motion_inliers: int = 20
    min_map_inliers: int = 30  # TrackLocalMap accept (Tracking.cc:2944)
    kf_tracked_ratio: float = 0.9  # NeedNewKeyFrame thRefRatio (mono)
    max_frames_between_kf: int = 10
    motion_radius: float = 15.0
    map_radius: float = 3.0
    max_recently_lost: int = 20  # frames before LOST
    th_depth: float = 40.0  # stereo close-point threshold (x baseline)
    max_stereo_lm_per_kf: int = 350
    use_stereo_pose_edges: bool = True  # u_r residuals in pose opt (EdgeStereo)
    # a gap between frames above this (or a clock going back) starts a new
    # Atlas map (Tracking.cc:1818-1848)
    timestamp_jump: float = 1.0
    # a lost map with more keyframes than this is kept in the Atlas, a
    # poorer one reset (Tracking.cc:1824-1848)
    min_kf_keep_map: int = 10


@dataclass
class FrameState:
    kp: object  # Keypoints on the device
    ts: float
    R: np.ndarray  # T_cw
    t: np.ndarray
    obs_lm: np.ndarray  # (N,) landmark id per keypoint slot (-1 none)
    depth: Optional[np.ndarray] = None
    right_u: Optional[np.ndarray] = None


def stereo_front(il, ir, cfg: ext.ExtractorConfig, bf: float, min_z: float, scales, slot_scales):
    """Dual ORB extraction, banded Hamming stereo match and SAD subpixel
    disparity refinement.  Returns (kp_l, kp_r, stereo matches, refined
    right-u, refinement ok)."""
    kp_l = ext.extract(il, cfg)
    kp_r = ext.extract(ir, cfg)
    sm = mat.stereo_match(kp_l, kp_r, scales, bf=bf, min_z=min_z, slot_scale_r=slot_scales)
    ur_ref, ok = mat.stereo_subpixel_refine(il, ir, kp_l.xy, sm.right_u, sm.valid)
    return kp_l, kp_r, sm, ur_ref, ok


def fisheye_front(il, ir, cfg: ext.ExtractorConfig, cam, cam2, R_rl, t_rl, sigma2):
    """Two-camera (KB8) front half: dual ORB extraction, then the fisheye
    match and triangulation of the overlap.  Returns (kp_l, kp_r, fisheye
    matches)."""
    kp_l = ext.extract(il, cfg)
    kp_r = ext.extract(ir, cfg)
    return kp_l, kp_r, mat.fisheye_stereo_match(cam, cam2, kp_l, kp_r, R_rl, t_rl, sigma2)


def visible_landmarks_plain(cam, R, t, lm_pos, lm_mask, lm_normal, lm_dmin, lm_dmax, wh,
                            log_sf: float = math.log(1.2), n_lvl: int = 8):
    """Plain version of kernel L: (uv, pred_level, visible)."""
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


def visible_landmarks(cam, R, t, lm_pos, lm_mask, lm_normal, lm_dmin, lm_dmax, wh,
                      log_sf: float = math.log(1.2), n_lvl: int = 8):
    """Frustum, distance-band and view-angle test (Frame::isInFrustum) and
    PredictScale for a padded landmark block.  Returns (uv (M,2), pred_level
    (M,) int64, visible (M,) bool).  Kernel L on CUDA tensors (``cam`` a host
    pin-hole or KB8 Camera, read as scalars), its plain version on CPU ones."""
    if lm_pos.device.type == "cpu":
        return visible_landmarks_plain(cam, R, t, lm_pos, lm_mask, lm_normal, lm_dmin, lm_dmax, wh, log_sf, n_lvl)
    return _visible_kernel(cam, R, t, lm_pos, lm_mask, lm_normal, lm_dmin, lm_dmax, wh, log_sf, n_lvl)


def _visible_kernel(cam, R, t, lm_pos, lm_mask, lm_normal, lm_dmin, lm_dmax, wh, log_sf, n_lvl):
    """Kernel L's launch."""
    f32 = torch.float32
    R, t = R.to(f32).contiguous(), t.to(f32).contiguous()
    _kernels.require_cuda(
        "visible_landmarks", R=(R, f32), t=(t, f32), lm_pos=(lm_pos, f32), lm_mask=(lm_mask, torch.bool),
        lm_normal=(lm_normal, f32), lm_dmin=(lm_dmin, f32), lm_dmax=(lm_dmax, f32),
    )
    m = lm_pos.shape[0]
    if R.shape != (3, 3) or t.shape != (3,) or lm_pos.shape != (m, 3) or lm_normal.shape != (m, 3) or \
            lm_mask.shape != (m,) or lm_dmin.shape != (m,) or lm_dmax.shape != (m,):
        raise ValueError("visible_landmarks: needs R (3,3), t (3,), (M,3) positions and normals, (M,) mask and band")
    dev = lm_pos.device
    params = np.zeros(9, np.float32)  # pin-hole [fx fy cx cy k1 k2 p1 p2 k3] or KB8 [fx fy cx cy k1 k2 k3 k4 0]
    params[:len(cam.params)] = cam.params.tolist()
    kind = pose_opt.KB8_KIND if cam.kind == cam_models.KB8 else pose_opt.RADTAN_KIND
    uv = torch.empty((m, 2), dtype=f32, device=dev)
    level = torch.empty(m, dtype=torch.int64, device=dev)
    visible = torch.empty(m, dtype=torch.bool, device=dev)
    _kernels.launch(
        "visible_landmarks_launch", dev,
        R.data_ptr(), t.data_ptr(), lm_pos.data_ptr(), lm_mask.data_ptr(), lm_normal.data_ptr(), lm_dmin.data_ptr(),
        lm_dmax.data_ptr(), m, params.ctypes.data, kind, float(wh[0]), float(wh[1]), float(log_sf), int(n_lvl),
        uv.data_ptr(), level.data_ptr(), visible.data_ptr(),
    )
    visible_landmarks.launches.add(camera="kb8" if kind == pose_opt.KB8_KIND else "")
    return uv, level, visible


visible_landmarks.launches = _kernels.LaunchCounter()  # camera instance "kb8" for a KB8 camera


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
                 device: torch.device | str = "cuda"):
        super().__init__()
        device = _kernels.resolve_device(device)
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


class Tracker:
    """Host orchestrator of a mono camera, a rectified stereo / RGB-D rig or
    a two-camera fisheye rig (Tracking)."""

    def __init__(self, cam: cam_models.Camera, cfg: TrackerConfig = TrackerConfig(), bf: float = 0.0,
                 image_wh: tuple = (640, 480), cam2: cam_models.Camera | None = None,
                 T_c1_c2: np.ndarray | None = None, world: Optional[WorldMap] = None, mapper=None, voc=None,
                 kfdb=None, loopcloser=None, map_id: int = 0, atlas=None, backend=None, timers=None,
                 device: torch.device | str = "cuda"):
        """``cam`` stays on the host (a CPU Camera); keypoints, matching and
        pose optimisation run on ``device``: the card unless the caller
        passes ``device="cpu"``.  ``voc`` (a Vocabulary on ``device``) and
        ``kfdb`` (a KeyFrameDatabase) enable keyframe indexing and
        relocalisation, ``loopcloser`` (a LoopCloser) loop closing, ``atlas``
        (an Atlas, whose current map replaces ``world``) several maps,
        ``backend`` (an AsyncBackend) local mapping and loop closing on its
        threads.  ``cam2`` (a host Camera) and ``T_c1_c2`` (the (4,4) pose of
        camera 2 in camera 1) make ``process_stereo`` match and triangulate
        across two non-rectified cameras (the fisheye rig)."""
        self.cam = cam
        self.cam2 = cam2
        # the two-camera rig: R_rl, t_rl map LEFT-camera points to the RIGHT camera (T_c1_c2 inverted), on the host
        self.T_rl = None
        if T_c1_c2 is not None:
            T = np.asarray(T_c1_c2, np.float64)
            R_lr, t_lr = T[:3, :3], T[:3, 3]
            self.T_rl = (torch.as_tensor(R_lr.T, dtype=torch.float32),
                         torch.as_tensor(-R_lr.T @ t_lr, dtype=torch.float32))
        self.cfg = cfg
        self.bf = float(bf)
        self.device = _kernels.resolve_device(device)
        self.timers = timers if timers is not None else StageTimers()
        self.voc = voc
        self.kfdb = kfdb
        self.loopcloser = loopcloser
        self.atlas = atlas
        self.backend = backend
        self._seen_map_version = 0
        self.map_updated = False  # mbMapUpdated (Tracking.cc:1884-1891)
        self._rel_to_ref = None  # the last frame's pose relative to its reference keyframe
        self._lost_since_ts = None  # when the current lost spell began
        self._lost_pred_pose = None  # a pose the subclass advanced while lost (IMU prediction)
        self.map_id = map_id if atlas is None else atlas.current_id
        if atlas is not None:
            world = atlas.current
        self.wh = (float(image_wh[0]), float(image_wh[1]))
        self.kp_cap = ext.total_capacity(cfg.extractor)
        self.world = world or WorldMap(kp_cap=self.kp_cap)
        self.mapper = mapper
        self.state = NOT_INITIALIZED
        self.scales = torch.as_tensor(
            cfg.extractor.scale_factor ** np.arange(cfg.extractor.n_levels), dtype=torch.float32
        ).to(self.device)
        self.sigma2 = ext.level_sigma2(cfg.extractor)
        self.sigma2_t = torch.as_tensor(self.sigma2, dtype=torch.float32).to(self.device)
        self.slot_scales = torch.as_tensor(ext.slot_scales(cfg.extractor)).to(self.device)
        self.last: Optional[FrameState] = None
        self.velocity = lie.SE3.identity(self.device)  # T_cur_last
        self.init_ref: Optional[FrameState] = None  # mono initialisation's reference frame
        self.ref_kf: int = -1
        self.frames_since_kf = 0
        self.lost_count = 0
        self.trajectory: list = []  # (ts, R_rel, t_rel, ref_kf, map_id, ok) per frame
        self.stats = {"matches": [], "inliers": []}

    # ------------------------------------------------------------------
    def process_mono(self, img: np.ndarray, ts: float):
        im = torch.as_tensor(np.asarray(img, dtype=np.float32)).to(self.device)
        with self.timers.span("orb_extract"):
            kp = ext.extract(im, self.cfg.extractor)
        return self._track(kp, ts, depth=None, right_u=None)

    def process_rgbd(self, img: np.ndarray, depth: np.ndarray, ts: float):
        """RGB-D: the depth map sampled at the keypoints (ComputeStereoFromRGBD,
        Frame.cc:1086-1154), a virtual right-u ``x - bf / d`` per keypoint."""
        im = torch.as_tensor(np.asarray(img, dtype=np.float32)).to(self.device)
        with self.timers.span("orb_extract"):
            kp = ext.extract(im, self.cfg.extractor)
        with self.timers.span("depth_sample"):
            # one host transfer of what the depth lookup needs
            kx, ky, valid = host(torch.stack([kp.xy[:, 0], kp.xy[:, 1], kp.valid.to(torch.float32)]))
            # nearest pixel (np.round: half to even): corners sit on depth edges
            h, w = depth.shape
            xs = np.clip(np.round(kx).astype(np.int32), 0, w - 1)
            ys = np.clip(np.round(ky).astype(np.int32), 0, h - 1)
            d = depth[ys, xs].astype(np.float32)
            d = np.where((valid > 0.5) & (d > 0), d, -1.0)
            ru = np.where(d > 0, kx - self.bf / np.maximum(d, 1e-6), -1.0)
        return self._track(kp, ts, depth=d, right_u=ru)

    def process_stereo(self, img_l: np.ndarray, img_r: np.ndarray, ts: float):
        il = torch.as_tensor(np.asarray(img_l, dtype=np.float32)).to(self.device)
        ir = torch.as_tensor(np.asarray(img_r, dtype=np.float32)).to(self.device)
        if self.cam2 is not None and self.T_rl is not None:
            # the non-rectified two-camera rig (Frame::ComputeStereoFishEyeMatches + TriangulateMatches)
            with self.timers.span("orb_extract"):
                kp_l, _, fm = fisheye_front(il, ir, self.cfg.extractor, self.cam, self.cam2, *self.T_rl,
                                            self.sigma2_t)
            with self.timers.span("stereo_match"):
                depth = host(fm.depth)
            # no rectified right-u exists: the pose optimisation takes mono edges, and the metric scale comes
            # through the triangulated landmark depths (the JAX package's tracker.py:252)
            return self._track(kp_l, ts, depth=depth, right_u=np.full(depth.shape, -1.0, np.float32))
        base = self.bf / float(self.cam.params[0])
        with self.timers.span("orb_extract"):
            kp_l, _, _, ur_ref, ok = stereo_front(
                il, ir, self.cfg.extractor, self.bf, max(base * 2.0, 0.1), self.scales, self.slot_scales
            )
        with self.timers.span("stereo_match"):
            # one host transfer for what the state machine needs from the front half
            ok, ur, kx = host(torch.stack([ok.to(torch.float32), ur_ref, kp_l.xy[:, 0]]))
            ok = ok > 0.5
        disp = np.maximum(kx - ur, 0.01)
        depth = np.where(ok & (disp >= 0.5), self.bf / disp, -1.0)
        ru = np.where(depth > 0, ur, -1.0)
        return self._track(kp_l, ts, depth=depth, right_u=ru)

    # ------------------------------------------------------------------
    def _track(self, kp, ts, depth, right_u):
        # a timestamp jump or a clock going back (Tracking.cc:1818-1848): a rich
        # map is kept and a new one started, a poor one reset
        if (self.state != NOT_INITIALIZED and self.last is not None and self.atlas is not None
                and (ts - self.last.ts > self.cfg.timestamp_jump or ts < self.last.ts)):
            if self.world.n_kf > self.cfg.min_kf_keep_map:
                self._create_map_in_atlas()
            else:
                self._reset_active_map()
        if self.state == NOT_INITIALIZED:
            self._initialize(kp, ts, depth, right_u)
        else:
            self._track_frame(kp, ts, depth, right_u)
        result = (self.state, self._cur_pose())
        if self.last is not None:
            # reference-relative log (Tracking.cc:2268-2287), so that BA
            # corrections of keyframes reach every past frame at save time
            r = self.ref_kf
            if r >= 0:
                R_ref, t_ref = self.world.kf_R[r], self.world.kf_t[r]
                R_rel = self.last.R @ R_ref.T
                t_rel = self.last.t - R_rel @ t_ref
                self._rel_to_ref = (R_rel, t_rel)  # for the rebase after a backend map change
            else:
                R_rel, t_rel = self.last.R.copy(), self.last.t.copy()
            self.trajectory.append((ts, R_rel, t_rel, r, self.map_id,
                                    self.state == OK or self.state == NOT_INITIALIZED))
        return result

    def trajectory_world(self):
        """Absolute per-frame poses T_cw: the logged relative pose composed
        with the current pose of its reference keyframe, in the map the frame
        belongs to now (System.cc:748-785).  Returns a list of (ts, R, t,
        ok)."""
        out = []
        for ts, R_rel, t_rel, r, mid, ok in self.trajectory:
            wm = self.world
            if self.atlas is not None and self.atlas.maps[mid] is not None:
                wm = self.atlas.maps[mid]
            if 0 <= r < wm.n_kf:
                R = R_rel @ wm.kf_R[r]
                t = R_rel @ wm.kf_t[r] + t_rel
            else:
                R, t = R_rel, t_rel
            out.append((ts, R, t, ok))
        return out

    def _remap_after_merge(self, src_id: int, dst_id: int, kf_off: int, lm_off: int, S_dst_src=None):
        """Rebase the cached local ids after the Atlas merged the active map
        into a stored one; the cached frame pose moves by ``S_dst_src`` as
        ``Atlas.merge_into`` moves the keyframes."""
        self.world = self.atlas.current
        self.map_id = dst_id
        if self.ref_kf >= 0:
            self.ref_kf += kf_off
        if self.last is not None:
            obs = self.last.obs_lm
            obs[obs >= 0] += lm_off
            if S_dst_src is not None:
                S = lie.Sim3(*(torch.as_tensor(x).detach().cpu().to(torch.float64) for x in S_dst_src))
                R, t, s = S.R.numpy(), S.t.numpy(), float(S.s)
                Rp = self.last.R.astype(np.float64) @ R.T
                self.last.t = (-Rp @ t + s * self.last.t.astype(np.float64)).astype(np.float32)
                self.last.R = lie.normalize_rotation_np(Rp)
        self.velocity = lie.SE3.identity(self.device)
        if self.mapper is not None:
            self.mapper.recent_lm = [ids + lm_off for ids in self.mapper.recent_lm]
        self.trajectory = [
            (ts, R_rel, t_rel, (r + kf_off) if r >= 0 else r, dst_id, ok) if mid == src_id
            else (ts, R_rel, t_rel, r, mid, ok)
            for ts, R_rel, t_rel, r, mid, ok in self.trajectory
        ]

    def _cur_pose(self):
        if self.last is None:
            return None
        return self.last.R, self.last.t

    def _kf_row(self, k: int) -> int:
        """The keyframe-database row of keyframe k: global under an Atlas,
        the local id otherwise."""
        if self.atlas is not None:
            return self.atlas.register_kf(self.map_id, k)
        return k

    def _index_kf(self, k: int, kp):
        """Add keyframe k to the place-recognition database (kernel N for the
        BoW); nothing to do without a vocabulary."""
        if self.voc is not None and self.kfdb is not None:
            _, _, bow = voc_mod.transform(self.voc, kp.desc, kp.valid)
            self.kfdb.add(self._kf_row(k), host(bow), map_id=self.map_id)

    def _se3(self, R, t) -> lie.SE3:
        f32 = torch.float32
        return lie.SE3(torch.as_tensor(np.asarray(R), dtype=f32).to(self.device),
                       torch.as_tensor(np.asarray(t), dtype=f32).to(self.device))

    # ------------------------------------------------------------------
    def _initialize(self, kp, ts, depth, right_u) -> bool:
        if depth is not None:
            return self._initialize_depth(kp, ts, depth, right_u)
        return self._initialize_mono(kp, ts)

    def _initialize_depth(self, kp, ts, depth, right_u) -> bool:
        """StereoInitialization (Tracking.cc:2294): the first frame with
        >= 500 keypoints (and >= 100 with depth) becomes keyframe 0 at the
        origin."""
        valid = host(kp.valid)
        good = valid & (depth > 0)
        if valid.sum() < 500 or good.sum() < 100:
            return False
        R0, t0 = np.eye(3, dtype=np.float32), np.zeros(3, np.float32)
        k0 = self.world.add_keyframe(kp, R0, t0, ts, depth=depth, right_u=right_u)
        self.world.init_kf_ids = [k0]
        slots = np.nonzero(good)[0]
        ray = cam_models.unproject(self.cam, torch.as_tensor(host(kp.xy)[slots])).numpy()
        ids = self.world.add_landmarks(ray * depth[slots][:, None], host(kp.desc)[slots], k0, slots,
                                       host(kp.level)[slots])
        obs_lm = np.full(self.kp_cap, -1, dtype=np.int32)
        obs_lm[slots] = ids
        self._index_kf(k0, kp)
        self.last = FrameState(kp, ts, R0, t0, obs_lm, depth, right_u)
        self.ref_kf = k0
        self.state = OK
        self.frames_since_kf = 0
        return True

    def _initialize_mono(self, kp, ts) -> bool:
        """MonocularInitialization (Tracking.cc:2341-2431): match against the
        reference frame, two-view reconstruction, the map scaled to a median
        depth of 1, two keyframes and their landmarks, full BA."""
        R0, t0 = np.eye(3, dtype=np.float32), np.zeros(3, np.float32)
        if self.init_ref is None:
            self.init_ref = FrameState(kp, ts, R0, t0, np.full(self.kp_cap, -1, np.int32))
            return False
        ref = self.init_ref
        idx, accept = mat.search_for_initialization(ref.kp, kp, 100.0)
        if int(accept.sum()) < self.cfg.min_init_matches:
            self.init_ref = FrameState(kp, ts, R0, t0, np.full(self.kp_cap, -1, np.int32))
            return False
        res = twoview.reconstruct(self.cam, ref.kp.xy, kp.xy[idx], accept, int(ts * 1e3) & 0x7FFFFFFF)
        if not bool(res.success):
            return False
        good, X = host(res.good), host(res.X)
        # median depth 1 (CreateInitialMapMonocular, Tracking.cc:2498)
        med = float(np.median(X[good, 2]))
        if med <= 0:
            return False
        X = X / med
        R1, t1 = host(res.R), host(res.t) / med
        k0 = self.world.add_keyframe(ref.kp, R0, t0, ref.ts)
        k1 = self.world.add_keyframe(kp, R1, t1, ts)
        self.world.init_kf_ids = [k0, k1]
        slots0 = np.nonzero(good)[0]
        slots1 = host(idx)[slots0]
        ids = self.world.add_landmarks(X[slots0], host(ref.kp.desc)[slots0], k0, slots0, host(ref.kp.level)[slots0])
        self.world.add_observations(k1, slots1, ids)
        if self.mapper is not None:  # polish the two-view map with full BA
            self.mapper.initial_ba(self.world, (k0, k1))
            self.world.update_landmark_stats(ids)
        obs_lm = np.full(self.kp_cap, -1, dtype=np.int32)
        obs_lm[slots1] = ids
        self._index_kf(k0, ref.kp)
        self._index_kf(k1, kp)
        self.last = FrameState(kp, ts, self.world.kf_R[k1], self.world.kf_t[k1], obs_lm)
        self.ref_kf = k1
        self.velocity = lie.SE3.identity(self.device)
        self.state = OK
        self.frames_since_kf = 0
        self.init_ref = None
        return True

    # ------------------------------------------------------------------
    def _sync_backend(self):
        """Take the async backend's events before a frame is tracked: apply
        a merge's remap, drop the motion model across a loop correction, and
        when the worker changed the map rebase the last pose through the
        reference keyframe (the change-index handshake, Tracking.cc:
        1884-1891)."""
        b = self.backend
        if b is None:
            return
        while b.results:
            kind, info = b.results.popleft()
            if kind == "merge":
                with b.lock:
                    self._remap_after_merge(info["src_id"], info["dst_id"], info["kf_offset"], info["lm_offset"],
                                            S_dst_src=info["S_dst_src"])
            else:  # a loop closed: the motion model does not hold across the correction
                self.velocity = lie.SE3.identity(self.device)
        if b.map_version != self._seen_map_version:
            self._seen_map_version = b.map_version
            self.map_updated = True
            r = self.ref_kf
            if r >= 0 and self.last is not None and self._rel_to_ref is not None:
                R_rel, t_rel = self._rel_to_ref
                with b.lock:
                    R_ref, t_ref = self.world.kf_R[r].copy(), self.world.kf_t[r].copy()
                self.last.R = lie.normalize_rotation_np(R_rel @ R_ref)
                self.last.t = (R_rel @ t_ref + t_rel).astype(np.float32)
                self.velocity = lie.SE3.identity(self.device)

    def _track_frame(self, kp, ts, depth, right_u) -> bool:
        self._sync_backend()
        last = self.last
        self._cur_right_u = right_u  # stereo edges of the current frame
        T_last = self._se3(last.R, last.t)
        T_pred = self.velocity.compose(T_last)
        if self.state == OK:
            with self.timers.span("pose_pred"):
                ok, T_est, obs_lm, n_inl = self._track_motion_model(kp, T_pred, last)
                if not ok:
                    ok, T_est, obs_lm, n_inl = self._track_reference_kf(kp, T_last)
        else:
            # lost: a pose the subclass predicts (the IMU, Tracking.cc:1966-1977) bridges the gap, else
            # relocalisation (Tracking.cc:2053-2078)
            self._lost_pred_pose = None
            T_pred_lost = self._predict_lost_pose(ts)
            if T_pred_lost is not None:
                ok, T_est, obs_lm, n_inl = True, T_pred_lost, np.full(self.kp_cap, -1, np.int32), 0
            else:
                ok, T_est, obs_lm, n_inl = self._relocalize(kp)
                if ok:
                    self.velocity = lie.SE3.identity(self.device)
        if ok:
            with self.timers.span("lm_track"):
                ok2, T_est, obs_lm, n_inl = self._track_local_map(kp, T_est, obs_lm)
            ok = ok and ok2
        if not ok:
            if self.lost_count == 0:
                self._lost_since_ts = ts
            self.lost_count += 1
            self.state = self._lost_state(ts)
            # hold the last good pose, unless the subclass advanced it while lost
            pred = self._lost_pred_pose
            hold_R, hold_t = pred if pred is not None else (last.R.copy(), last.t.copy())
            self.last = FrameState(kp, ts, hold_R, hold_t, np.full(self.kp_cap, -1, np.int32), depth, right_u)
            if self.state == LOST and self.atlas is not None:
                # Tracking.cc:1824-1848: a rich map is kept and a new one started, a poor one reset
                if self.world.n_kf > self.cfg.min_kf_keep_map:
                    self._create_map_in_atlas()
                else:
                    self._reset_active_map()
            return False
        self.lost_count = 0
        self.state = OK
        # back onto SO(3): the velocity chain amplifies float32 drift (lie.normalize_rotation_np)
        R_est = lie.normalize_rotation_np(host(T_est.R))
        t_est = host(T_est.t)
        T_est = self._se3(R_est, t_est)
        self.velocity = T_est.compose(T_last.inverse())
        self.last = FrameState(kp, ts, R_est, t_est, obs_lm, depth, right_u)
        self.frames_since_kf += 1
        self.stats["inliers"].append(n_inl)
        with self.timers.span("kf_decision"):
            need_kf = self._need_new_keyframe(n_inl, depth)
        if need_kf:
            with self.timers.span("kf_insert"):
                self._create_keyframe()
        return True

    def _pose_opt_from_obs(self, kp, T0, obs_lm):
        """PoseObs from the slot -> landmark association, then kernel D."""
        slots = np.nonzero(obs_lm >= 0)[0]
        n = self.kp_cap
        xw = np.zeros((n, 3), np.float32)
        uv = np.full((n, 3), -1.0, np.float32)
        valid = np.zeros(n, bool)
        stereo = np.zeros(n, bool)
        inv_s2 = np.ones(n, np.float32)
        xw[slots] = self.world.lm_pos[obs_lm[slots]]
        uv[slots, :2] = host(kp.xy)[slots]
        inv_s2[slots] = 1.0 / self.sigma2[host(kp.level)[slots]]
        valid[slots] = True
        ru = getattr(self, "_cur_right_u", None) if self.cfg.use_stereo_pose_edges else None
        if ru is not None and self.bf > 0:
            has_ru = ru[slots] > 0
            uv[slots, 2] = np.where(has_ru, ru[slots], -1.0)
            stereo[slots] = has_ru
        dev = self.device
        obs = pose_opt.PoseObs(
            xw=torch.as_tensor(xw).to(dev), uv=torch.as_tensor(uv).to(dev), inv_sigma2=torch.as_tensor(inv_s2).to(dev),
            is_stereo=torch.as_tensor(stereo).to(dev), valid=torch.as_tensor(valid).to(dev),
        )
        T, inlier, n_inl = pose_opt.pose_optimization(self.cam, self.bf, T0, obs)
        obs_out = obs_lm.copy()
        obs_out[~host(inlier)] = -1
        return T, obs_out, int(n_inl)

    def _track_motion_model(self, kp, T_pred, last: FrameState):
        """TrackWithMotionModel (Tracking.cc:2783-2876), padded to kp_cap."""
        has = last.obs_lm >= 0
        if has.sum() < 10:
            return False, T_pred, None, 0
        dev = self.device
        lm_ids = np.where(has, last.obs_lm, 0)
        pos = torch.as_tensor(self.world.lm_pos[lm_ids]).to(dev)
        proj = cam_models.project(self.cam, T_pred.apply(pos))
        pvalid = torch.as_tensor(self.world.lm_valid[lm_ids] & has).to(dev)
        idx, accept = mat.search_frame_to_frame(
            kp, proj, pvalid, torch.as_tensor(self.world.lm_desc[lm_ids]).to(dev), last.kp.level, last.kp.angle,
            self.scales, radius=self.cfg.motion_radius,
        )
        acc = host(accept)
        if acc.sum() < self.cfg.min_motion_inliers:
            return False, T_pred, None, 0
        obs_lm = np.full(self.kp_cap, -1, dtype=np.int32)
        obs_lm[host(idx)[acc]] = lm_ids[acc]
        T, obs_lm, n_inl = self._pose_opt_from_obs(kp, T_pred, obs_lm)
        return n_inl >= self.cfg.min_motion_inliers, T, obs_lm, n_inl

    def _track_reference_kf(self, kp, T_last):
        """TrackReferenceKeyFrame (Tracking.cc:2663-2718): mutual descriptor
        match against the reference keyframe's landmarks."""
        k = self.ref_kf
        if k < 0:
            return False, T_last, None, 0
        dev = self.device
        has_lm = self.world.kf_obs[k] >= 0
        idx, accept = mat.search_descriptors_mutual(
            torch.as_tensor(self.world.kf_desc[k]).to(dev), torch.as_tensor(has_lm & self.world.kf_kp_valid[k]).to(dev),
            kp.desc, kp.valid, th=100, ratio=0.85,
        )
        acc = host(accept)
        if acc.sum() < 15:
            return False, T_last, None, 0
        obs_lm = np.full(self.kp_cap, -1, dtype=np.int32)
        obs_lm[host(idx)[acc]] = self.world.kf_obs[k][acc]
        T, obs_lm, n_inl = self._pose_opt_from_obs(kp, T_last, obs_lm)
        return n_inl >= self.cfg.min_motion_inliers, T, obs_lm, n_inl

    def _relocalize(self, kp):
        """Relocalization (Tracking.cc:3518-3676): the keyframe database's
        candidates for the frame's BoW (kernel N), then for up to 5 of them
        a mutual match against the candidate's landmarks, PnP RANSAC (kernel
        P) and pose optimisation; fails without a vocabulary."""
        T0 = lie.SE3.identity(self.device)
        if self.voc is None or self.kfdb is None:
            return False, T0, None, 0
        _, _, bow = voc_mod.transform(self.voc, kp.desc, kp.valid)
        cands = self.kfdb.detect_reloc_candidates(host(bow), query_map=self.map_id)
        if self.atlas is not None:  # the rows are global: resolve them to local ids
            cands = [self.atlas.resolve_row(int(r))[1] for r in cands]
        dev = self.device
        kxy, klvl = host(kp.xy), host(kp.level)
        for k in cands[:5]:
            k = int(k)
            has_lm = self.world.kf_obs[k] >= 0
            idx, accept = mat.search_descriptors_mutual(
                torch.as_tensor(self.world.kf_desc[k]).to(dev),
                torch.as_tensor(has_lm & self.world.kf_kp_valid[k]).to(dev), kp.desc, kp.valid, th=100, ratio=0.75,
            )
            acc = host(accept)
            if acc.sum() < 15:
                continue
            lm_ids = self.world.kf_obs[k][acc]
            slots = host(idx)[acc]
            n = self.kp_cap
            xw = np.zeros((n, 3), np.float32)
            uv = np.zeros((n, 2), np.float32)
            inv_s2 = np.ones(n, np.float32)
            valid = np.zeros(n, bool)
            xw[slots] = self.world.lm_pos[lm_ids]
            uv[slots] = kxy[slots]
            inv_s2[slots] = 1.0 / self.sigma2[klvl[slots]]
            valid[slots] = self.world.lm_valid[lm_ids]
            res = pnp.pnp_ransac(self.cam, *(torch.as_tensor(a).to(dev) for a in (xw, uv, inv_s2, valid)),
                                 self.world.n_kf * 1315423911 + k)
            if not bool(res.ok):
                continue
            obs_lm = np.full(self.kp_cap, -1, dtype=np.int32)
            keep = host(res.inliers)[slots]
            obs_lm[slots[keep]] = lm_ids[keep]
            T, obs_out, n_inl = self._pose_opt_from_obs(kp, lie.SE3(res.R, res.t), obs_lm)
            if n_inl >= 20:  # the local-map pass that follows widens the matches
                self.ref_kf = k
                return True, T, obs_out, n_inl
        return False, T0, None, 0

    def _predict_lost_pose(self, ts):
        """A pose for a lost frame: None here (the visual tracker
        relocalises); the inertial tracker predicts one from the IMU."""
        return None

    def _lost_state(self, ts):
        """RECENTLY_LOST or LOST: a count of frames here; the inertial
        tracker's wall-clock grace window (Tracking.cc:69) overrides it."""
        return RECENTLY_LOST if self.lost_count < self.cfg.max_recently_lost else LOST

    def _create_map_in_atlas(self):
        """Tracking::CreateMapInAtlas (Tracking.cc:2607-2649): keep the old
        map in the Atlas and track into a new one."""
        verbose.print_mess(f"Creation of new map with id {self.atlas.current_id + 1}", verbose.VERBOSITY_NORMAL)
        self.world = self.atlas.create_new_map()
        self.map_id = self.atlas.current_id
        self._reset_tracking_state()

    def _reset_active_map(self):
        """Tracking::ResetActiveMap (Tracking.cc:3734): a young map is not
        worth keeping; replace it in place."""
        if self.kfdb is not None:
            self.kfdb.clear_map(self.map_id)
        self.atlas.maps[self.map_id] = self.atlas._make()
        self.world = self.atlas.current
        self._reset_tracking_state()

    def _reset_tracking_state(self):
        self.state = NOT_INITIALIZED
        self.last = None
        self.init_ref = None
        self.ref_kf = -1
        self.velocity = lie.SE3.identity(self.device)
        self.lost_count = 0
        self.frames_since_kf = 0
        if self.mapper is not None:
            self.mapper.recent_lm = []

    def _local_landmark_ids(self) -> np.ndarray:
        """UpdateLocalKeyFrames / Points (Tracking.cc:3370/3341): the
        reference keyframe, its covisible neighbours and the 3 newest."""
        k = self.ref_kf
        kfs = [k] + list(self.world.best_covisible(k, 10, min_shared=5))
        for r in range(max(0, self.world.n_kf - 3), self.world.n_kf):
            if r not in kfs:
                kfs.append(r)
        return self.world.local_landmarks(np.asarray(kfs, dtype=np.int64))

    def _track_local_map(self, kp, T_est, obs_lm):
        """TrackLocalMap (Tracking.cc:2879-2970)."""
        lm_ids = self._local_landmark_ids()
        cap = self.cfg.lm_cap
        if len(lm_ids) > cap:
            verbose.warn_cap("tracker.local_map_landmarks", cap, len(lm_ids))
            lm_ids = lm_ids[np.random.default_rng(0).choice(len(lm_ids), cap, replace=False)]
        pad = cap - len(lm_ids)
        lm_ids_p = np.concatenate([lm_ids, np.zeros(pad, dtype=lm_ids.dtype)])
        lm_mask = np.concatenate([np.ones(len(lm_ids), bool), np.zeros(pad, bool)])
        dev = self.device
        w = self.world

        def d(a):
            return torch.as_tensor(a).to(dev)

        uv, pred_level, visible = visible_landmarks(
            self.cam, T_est.R, T_est.t, d(w.lm_pos[lm_ids_p]), d(lm_mask & w.lm_valid[lm_ids_p]),
            d(w.lm_normal[lm_ids_p]), d(w.lm_dmin[lm_ids_p]), d(w.lm_dmax[lm_ids_p]), self.wh,
            log_sf=float(np.log(self.cfg.extractor.scale_factor)), n_lvl=int(self.cfg.extractor.n_levels),
        )
        vis_np = host(visible)
        np.add.at(w.lm_visible, lm_ids_p[vis_np], 1)  # GetFoundRatio bookkeeping
        already = np.isin(lm_ids_p, obs_lm[obs_lm >= 0])
        radius = self.cfg.map_radius if self.state == OK else 15.0  # SearchLocalPoints th (Tracking.cc:3296-3307)
        idx, accept = mat.search_by_projection(
            kp, uv, visible & d(~already), d(w.lm_desc[lm_ids_p]), pred_level, self.scales, radius=radius,
        )
        acc = host(accept)
        new_obs = obs_lm.copy()
        tgt = host(idx)[acc]
        free = new_obs[tgt] < 0  # only fill slots that are still free
        new_obs[tgt[free]] = lm_ids_p[acc][free]
        T, new_obs, n_inl = self._pose_opt_from_obs(kp, T_est, new_obs)
        matched = new_obs >= 0
        np.add.at(w.lm_found, new_obs[matched], 1)
        self.stats["matches"].append(int(matched.sum()))
        return n_inl >= self.cfg.min_map_inliers, T, new_obs, n_inl

    # ------------------------------------------------------------------
    def _need_new_keyframe(self, n_inl, depth) -> bool:
        """NeedNewKeyFrame (Tracking.cc:2971-3127), its core conditions: the
        frame budget, and the tracked ratio against the reference keyframe
        (0.9 mono, 0.75 with depth) or, with depth, close points to insert."""
        if self.mapper is None:
            return False
        ref_obs = self.world.kf_obs[self.ref_kf]
        ref_lm = ref_obs[ref_obs >= 0]
        min_obs = 3 if self.world.n_kf > 2 else 2  # Tracking.cc:2996-2998
        ref_tracked = int(((self.world.lm_n_obs[ref_lm] >= min_obs) & self.world.lm_valid[ref_lm]).sum())
        ref_tracked = max(ref_tracked, 15)
        c1a = self.frames_since_kf >= self.cfg.max_frames_between_kf
        ratio = self.cfg.kf_tracked_ratio
        need_close = False
        if depth is not None:
            # stereo / RGB-D: "need to insert close points" (Tracking.cc:3028-3045)
            ratio = 0.75
            base = self.bf / float(self.cam.params[0])
            close = (depth > 0) & (depth < self.cfg.th_depth * base)
            tracked_close = int((close & (self.last.obs_lm >= 0)).sum())
            untracked_close = int((close & (self.last.obs_lm < 0)).sum())
            need_close = tracked_close < 100 and untracked_close > 70
        c2 = (n_inl < ref_tracked * ratio or need_close) and n_inl > self.cfg.min_map_inliers
        min_gap = 1 if need_close else 2
        return bool((c1a or c2) and self.frames_since_kf >= min_gap)

    def _create_keyframe(self):
        """CreateNewKeyFrame (Tracking.cc:3127-3247), then local mapping and
        loop closing: queued to the async backend's worker (the reference's
        LocalMapping::InsertKeyFrame), or inline without one."""
        last = self.last
        with self.backend.lock if self.backend is not None else contextlib.nullcontext():
            k = self.world.add_keyframe(last.kp, last.R, last.t, last.ts, depth=last.depth, right_u=last.right_u)
            slots = np.nonzero(last.obs_lm >= 0)[0]
            self.world.add_observations(k, slots, last.obs_lm[slots])
            if last.depth is not None:
                self._create_stereo_landmarks(k, last)
            if self.backend is not None:
                self._keyframe_state(k)  # what a subclass keeps per keyframe, in the map before the worker sees k
        self._index_kf(k, last.kp)  # KeyFrameDatabase::add, at insertion
        self.ref_kf = k
        self.frames_since_kf = 0
        if self.backend is not None:
            self.backend.insert_keyframe(self.world, k, map_id=self.map_id, atlas=self.atlas)
            return
        if self.mapper is not None:
            self.mapper.process_new_keyframe(self.world, k, kfdb=self.kfdb)
        if self.loopcloser is not None:
            closed = self.loopcloser.process_keyframe(self.world, k, map_id=self.map_id, atlas=self.atlas)
            if closed:
                # the motion model does not hold across a loop or merge correction
                # (the reference rebases through its change index, Tracking.cc:1884)
                kind, info = closed
                self.velocity = lie.SE3.identity(self.device)
                if kind == "merge":
                    self._remap_after_merge(info["src_id"], info["dst_id"], info["kf_offset"], info["lm_offset"],
                                            S_dst_src=info["S_dst_src"])
                    k = k + info["kf_offset"]
                    self.ref_kf = k
        if self.mapper is not None or self.loopcloser is not None:
            # tracking goes on from the (BA- or loop-) adjusted keyframe pose
            self.last.R = self.world.kf_R[k].copy()
            self.last.t = self.world.kf_t[k].copy()

    def _keyframe_state(self, k: int) -> None:
        """Store a subclass's per-keyframe state for keyframe k (nothing
        here; the inertial tracker's window, velocity and bias)."""

    def _create_stereo_landmarks(self, k: int, last: FrameState):
        """Landmarks for the closest unmatched points with depth (at most
        ``max_stereo_lm_per_kf``, closest first)."""
        base = self.bf / float(self.cam.params[0])
        close = (last.obs_lm < 0) & (last.depth > 0) & (last.depth < self.cfg.th_depth * base) & host(last.kp.valid)
        slots = np.nonzero(close)[0]
        if len(slots) == 0:
            return
        order = np.argsort(last.depth[slots])
        slots = slots[order[: self.cfg.max_stereo_lm_per_kf]]
        ray = cam_models.unproject(self.cam, torch.as_tensor(host(last.kp.xy)[slots])).numpy()
        pos_c = ray * last.depth[slots][:, None]
        Rwc = last.R.T
        pos_w = pos_c @ Rwc.T + (-Rwc @ last.t)[None, :]
        ids = self.world.add_landmarks(pos_w.astype(np.float32), host(last.kp.desc)[slots], k, slots,
                                       host(last.kp.level)[slots])
        self.last.obs_lm[slots] = ids
