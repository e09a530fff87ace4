"""System facade: the user-facing API of the SLAM engine.

Counterpart of ``orb_slam3_fast_tpu/slam/system.py`` (System.cc,
System.h:105-195) for the ``MONOCULAR``, rectified ``STEREO`` and ``RGBD``
sensors: the constructor loads the vocabulary (the default one unless
``vocabulary`` is given, System.cc:130-137) and builds the keyframe
database, then wires the map, the local mapper and the tracker on one
device, the card unless the caller passes ``device="cpu"``;
``track_monocular`` / ``track_stereo`` / ``track_rgbd`` feed frames; local
mapping and, with ``enable_loop_closing``, loop closing run inline per
keyframe (scale fixed for stereo and RGB-D); with ``multi_map`` an Atlas
keeps several maps and merges them; every keyframe is indexed and a lost
tracker relocalises; the trajectory savers write ORB-SLAM3's TUM / EuRoC /
KITTI formats (System.cc:579/641/672/1244); ``save_atlas`` writes the
Atlas (or the one map without one) and the vocabulary's checksum beside
it, in the JAX package's files, and ``load_atlas`` refuses what was saved
with another vocabulary.

Not ported yet, each raising ``NotImplementedError`` that names its ROADMAP
§A item: the inertial sensors (10), fisheye two-camera stereo (11),
``async_backend`` (``backend/pipeline.py``, 6).  Callers pass
``async_backend=False``.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from orb_slam3_fast_tpu_torch import _kernels
from orb_slam3_fast_tpu_torch.backend.loopcloser import LoopCloser, LoopCloserConfig
from orb_slam3_fast_tpu_torch.backend.mapper import Mapper
from orb_slam3_fast_tpu_torch.frontend import tracker as trk
from orb_slam3_fast_tpu_torch.map.atlas import Atlas
from orb_slam3_fast_tpu_torch.map.worldmap import WorldMap
from orb_slam3_fast_tpu_torch.ops import extractor as ext
from orb_slam3_fast_tpu_torch.slam.settings import Settings
from orb_slam3_fast_tpu_torch.utils import lie
from orb_slam3_fast_tpu_torch.utils.timers import StageTimers
from orb_slam3_fast_tpu_torch.vocab import database as db_mod
from orb_slam3_fast_tpu_torch.vocab import vocabulary as voc_mod

MONOCULAR = "monocular"
STEREO = "stereo"
RGBD = "rgbd"
IMU_MONOCULAR = "monocular-inertial"
IMU_STEREO = "stereo-inertial"
IMU_RGBD = "rgbd-inertial"

_WAITING = {
    IMU_MONOCULAR: "ROADMAP §A item 10 (inertial)",
    IMU_STEREO: "ROADMAP §A item 10 (inertial)",
    IMU_RGBD: "ROADMAP §A item 10 (inertial)",
}


class System:
    def __init__(
        self,
        settings: Settings | str,
        sensor: str = MONOCULAR,
        vocabulary: voc_mod.Vocabulary | None = None,
        max_keyframes: int = 512,
        enable_loop_closing: bool = True,
        tracker_overrides: dict | None = None,
        async_backend: bool = True,
        multi_map: bool = True,
        device: torch.device | str = "cuda",
    ):
        """``device`` is where tracking and mapping run: the card by
        default, which raises without one; ``"cpu"`` runs the kernels' plain
        versions.  The map, the keyframe database and the state machine stay
        on the host."""
        if sensor not in (MONOCULAR, STEREO, RGBD):
            raise NotImplementedError(f"sensor {sensor!r} waits for {_WAITING.get(sensor, 'a later slice')}")
        if async_backend:
            raise NotImplementedError("backend/pipeline.py waits for ROADMAP §A item 6; pass async_backend=False")
        if isinstance(settings, str):
            settings = Settings.from_yaml(settings, sensor=sensor)
        if settings.camera_type == "KannalaBrandt8" and settings.cam2 is not None:
            raise NotImplementedError("fisheye two-camera stereo waits for ROADMAP §A item 11")
        self.settings = settings
        self.sensor = sensor
        self.device = _kernels.resolve_device(device)
        self.voc = (vocabulary or voc_mod.default_vocabulary()).to(self.device)
        self.kfdb = db_mod.KeyFrameDatabase(self.voc.n_words, max_kf=max_keyframes)
        ecfg = ext.ExtractorConfig(
            n_features=settings.n_features, n_levels=settings.n_levels, scale_factor=settings.scale_factor,
            ini_th_fast=settings.ini_th_fast, min_th_fast=settings.min_th_fast,
        )
        tcfg = trk.TrackerConfig(extractor=ecfg, th_depth=settings.th_depth)._replace(**dict(tracker_overrides or {}))
        sigma2 = ext.level_sigma2(ecfg)
        wh = (settings.new_width or settings.width, settings.new_height or settings.height)

        def make_map():
            return WorldMap(kp_cap=ext.total_capacity(ecfg), max_kf=max_keyframes, n_levels=settings.n_levels,
                            scale_factor=settings.scale_factor)

        self.atlas = Atlas(make_map) if multi_map else None
        self.world = self.atlas.current if self.atlas else make_map()
        self.mapper = Mapper(settings.cam, bf=settings.bf, sigma2=sigma2, device=self.device)
        self.loopcloser = None
        if enable_loop_closing:
            self.loopcloser = LoopCloser(settings.cam, self.voc, self.kfdb, self.mapper, bf=settings.bf,
                                         cfg=LoopCloserConfig(fix_scale=(sensor != MONOCULAR)), sigma2=sigma2)
        self.timers = StageTimers()
        self.tracker = trk.Tracker(settings.cam, tcfg, bf=settings.bf, image_wh=wh, world=self.world,
                                   mapper=self.mapper, voc=self.voc, kfdb=self.kfdb, loopcloser=self.loopcloser,
                                   atlas=self.atlas, timers=self.timers, device=self.device)
        self._finished = False

    # ------------------------------------------------------------------
    def _preprocess(self, img: np.ndarray) -> np.ndarray:
        """Colour -> grey and the optional resize (System::TrackStereo
        288-298, Tracking::GrabImage* cvtColor 1394-1411)."""
        img = np.asarray(img)
        if img.ndim == 3:
            w = np.array([0.299, 0.587, 0.114] if self.settings.rgb else [0.114, 0.587, 0.299], np.float32)
            img = img.astype(np.float32) @ w
        img = img.astype(np.float32)
        nw, nh = self.settings.new_width, self.settings.new_height
        if nw and nh and (img.shape[1] != nw or img.shape[0] != nh):
            from orb_slam3_fast_tpu_torch.ops import rectify as rect

            with self.timers.span("resize"):
                img = rect.resize_bilinear(img, (nw, nh))
        return img

    def track_monocular(self, img, ts: float, imu=()):
        """One monocular frame (System::TrackMonocular, System.cc:478-527)."""
        if self.sensor != MONOCULAR:
            raise ValueError(f"track_monocular on a {self.sensor!r} System")
        if len(imu):
            raise NotImplementedError(f"IMU input waits for {_WAITING[IMU_MONOCULAR]}")
        img = self._preprocess(img)
        with self.timers.span("track_total"):
            state, pose = self.tracker.process_mono(img, ts)
        return state, pose

    def track_rgbd(self, img, depth, ts: float, imu=()):
        """One RGB-D frame: the depth map in the units of the settings'
        ``depth_map_factor`` (System::TrackRGBD, System.cc:402-476)."""
        if self.sensor != RGBD:
            raise ValueError(f"track_rgbd on a {self.sensor!r} System")
        if len(imu):
            raise NotImplementedError(f"IMU input waits for {_WAITING[IMU_RGBD]}")
        img = self._preprocess(img)
        depth = np.asarray(depth, dtype=np.float32)
        if self.settings.depth_map_factor != 1.0:
            depth = depth / self.settings.depth_map_factor
        with self.timers.span("track_total"):
            state, pose = self.tracker.process_rgbd(img, depth, ts)
        return state, pose

    def track_stereo(self, img_l, img_r, ts: float, imu=()):
        if self.sensor != STEREO:
            raise ValueError(f"track_stereo on a {self.sensor!r} System")
        if len(imu):
            raise NotImplementedError(f"IMU input waits for {_WAITING[IMU_STEREO]}")
        img_l = self._preprocess(img_l)
        img_r = self._preprocess(img_r)
        if self.settings.rect_map_left is not None:
            with self.timers.span("rectify"):
                img_l, img_r = self.settings.rectify(img_l, img_r)
        with self.timers.span("track_total"):
            state, pose = self.tracker.process_stereo(img_l, img_r, ts)
        return state, pose

    # ------------------------------------------------------------------
    def shutdown(self):
        """System::Shutdown (System.cc:528-572): local mapping runs inline,
        so there is nothing to drain; the map is saved if the settings ask."""
        self._finished = True
        if self.settings.save_atlas:
            self.save_atlas(self.settings.save_atlas + ".npz")

    def get_tracking_state(self):
        return self.tracker.state

    def map_changed(self) -> bool:
        """Change-index handshake (System::MapChanged, System.cc:508): True
        once per map update (a BA write-back, a loop, a merge) since the
        previous query."""
        cur = self.tracker.world.change_index
        if self.loopcloser is not None:
            cur += self.loopcloser.n_loops_closed + self.loopcloser.n_maps_merged
        changed = cur != getattr(self, "_last_map_change", 0)
        self._last_map_change = cur
        return changed

    # ------------------------------------------------------------------
    # trajectory savers (the reference's formats)
    # ------------------------------------------------------------------
    def _world_frames(self, only_ok=True):
        for ts, R, t, ok in self.tracker.trajectory_world():
            if only_ok and not ok:
                continue
            Rwc = R.T
            yield ts, Rwc, -Rwc @ t

    @staticmethod
    def _quat(Rwc) -> np.ndarray:
        """[w, x, y, z]."""
        return lie.rotation_to_quaternion(torch.as_tensor(np.asarray(Rwc, np.float32))).numpy()

    def save_trajectory_tum(self, path: str):
        """TUM: 'ts tx ty tz qx qy qz qw' (System::SaveTrajectoryTUM, System.cc:579-640)."""
        with open(path, "w") as f:
            for ts, Rwc, c in self._world_frames():
                q = self._quat(Rwc)
                f.write(f"{ts:.6f} {c[0]:.7f} {c[1]:.7f} {c[2]:.7f} {q[1]:.7f} {q[2]:.7f} {q[3]:.7f} {q[0]:.7f}\n")

    def save_trajectory_euroc(self, path: str):
        """EuRoC: timestamps in ns (System::SaveTrajectoryEuRoC, System.cc:672-790)."""
        with open(path, "w") as f:
            for ts, Rwc, c in self._world_frames():
                q = self._quat(Rwc)
                f.write(f"{ts*1e9:.0f} {c[0]:.9f} {c[1]:.9f} {c[2]:.9f} {q[1]:.9f} {q[2]:.9f} {q[3]:.9f} {q[0]:.9f}\n")

    def save_keyframe_trajectory_tum(self, path: str):
        """System::SaveKeyFrameTrajectoryTUM (System.cc:1244-1300)."""
        w = self.tracker.world
        with open(path, "w") as f:
            for k in range(w.n_kf):
                if not w.kf_valid[k]:
                    continue
                Rwc = w.kf_R[k].T
                c = -Rwc @ w.kf_t[k]
                q = self._quat(Rwc)
                f.write(f"{w.kf_ts[k]:.6f} {c[0]:.7f} {c[1]:.7f} {c[2]:.7f} {q[1]:.7f} {q[2]:.7f} {q[3]:.7f} {q[0]:.7f}\n")

    def save_trajectory_kitti(self, path: str):
        """KITTI: a 3x4 row-major pose per line (System::SaveTrajectoryKITTI, System.cc:1567-1640)."""
        with open(path, "w") as f:
            for ts, Rwc, c in self._world_frames():
                P = np.concatenate([Rwc, c[:, None]], axis=1).reshape(-1)
                f.write(" ".join(f"{v:.9e}" for v in P) + "\n")

    # ------------------------------------------------------------------
    def save_atlas(self, path: str):
        """System::SaveAtlas (System.cc:1430): the whole Atlas when there is
        one, else the one map, in the JAX package's files, and ``<path>.md5``
        with the vocabulary's checksum (CalculateCheckSum, System.cc:1531)."""
        if self.atlas is not None:
            self.atlas.save(path)
        else:
            self.tracker.world.save(path)
        try:
            with open(path + ".md5", "w") as f:
                f.write(self.voc.checksum())
        except OSError:
            pass

    def load_atlas(self, path: str):
        """System::LoadAtlas: refuses a map saved with another vocabulary
        (System.cc:1505-1529)."""
        md5_path = path + ".md5"
        if os.path.exists(md5_path):
            with open(md5_path) as f:
                saved = f.read().strip()
            if saved != self.voc.checksum():
                raise ValueError("vocabulary checksum mismatch: the atlas was built with a different vocabulary "
                                 "(System::LoadAtlas guard, System.cc:1505-1529)")
        if self.atlas is not None and os.path.exists(f"{path}.atlas.npz"):
            self.atlas = Atlas.load(path, self.atlas._make)
            self.tracker.atlas = self.atlas
            self.world = self.atlas.current
            self.tracker.world = self.world
            self.tracker.map_id = self.atlas.current_id
            return
        self.world = WorldMap.load(path)
        self.tracker.world = self.world
        if self.atlas is not None:
            self.atlas.maps[self.atlas.current_id] = self.world

    def print_time_stats(self):
        """Tracking::PrintTimeStats (Tracking.cc:189-268): the tracker's
        stages, then local mapping's and loop closing's."""
        timers = [self.timers, self.mapper.timers] + ([self.loopcloser.timers] if self.loopcloser else [])
        return "\n".join(s for s in (t.summary() for t in timers) if s)
