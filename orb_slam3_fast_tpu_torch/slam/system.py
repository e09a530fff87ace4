"""System facade: the user-facing API of the SLAM engine.

Counterpart of ``orb_slam3_fast_tpu/slam/system.py`` (System.cc,
System.h:105-195) for the ``MONOCULAR``, rectified ``STEREO`` and ``RGBD``
sensors: the constructor loads the vocabulary (the default one unless
``vocabulary`` is given, System.cc:130-137) and builds the keyframe
database, then wires the map, the local mapper and the tracker on one
device, the card unless the caller passes ``device="cpu"``;
``track_monocular`` / ``track_stereo`` / ``track_rgbd`` feed frames; local
mapping and, with ``enable_loop_closing``, loop closing (scale fixed for
stereo and RGB-D) run per keyframe on the async backend's worker thread
and the global BA on its GBA thread (``async_backend``, the default, as in
the JAX package; ``backend/pipeline.py``), or inline per keyframe with
``async_backend=False``, which repeats exactly run after run; with
``multi_map`` an Atlas keeps several maps and merges them; every keyframe
is indexed and a lost tracker relocalises; ``shutdown`` drains the
backend; the trajectory savers write ORB-SLAM3's TUM / EuRoC / KITTI
formats (System.cc:579/641/672/1244); ``save_atlas`` writes the Atlas (or
the one map without one) and the vocabulary's checksum beside it, in the
JAX package's files, and ``load_atlas`` refuses what was saved with
another vocabulary.

The inertial sensors (``IMU_MONOCULAR``, ``IMU_STEREO``, ``IMU_RGBD``) get
the inertial tracker (``frontend/vi_tracker.py``) built from the settings'
IMU block as the JAX package builds it (System.cc:203, Tracking.cc:567-654):
the discrete noise from the continuous densities, an IMU bucket from the
IMU and camera rates, the scale fixed for stereo and RGB-D, ``T_b_c1``;
``track_*`` take each frame's samples as ``imu=``.  With loop closing the
loop closer gets the inertial tracker's hooks (System.cc:150-167 of the
JAX package): the windowed VI-BA, MergeInertialBA and FullInertialBA; an
inertial map's loop runs the 4-DoF essential graph.

A Kannala-Brandt two-camera rig (TUM-VI: ``Camera.type:
"KannalaBrandt8"`` with a ``Camera2`` block and ``Stereo.T_c1_c2``) gets the
tracker's fisheye branch (``cam2`` and ``T_c1_c2`` routed as the JAX
package's System.cc wiring does, whatever the sensor: ``process_mono``
ignores them) for ``STEREO`` and ``IMU_STEREO``, its loop closer the left
camera (``settings.cam``, KB8: kernels Q, R and AA in their KB8 instances),
as the JAX package's does.  ``MONOCULAR`` and ``IMU_MONOCULAR`` on that
configuration track its first camera alone: kernel M initialises the map
in its KB8 instance, and the monocular loop closer runs Q and R with the
scale free.

Several ranks (``parallel/multihost.py``; torchrun's variables, or a
process group brought up before the constructor): the constructor brings
the group up, and where the world has more than one rank and its size
divides ``max_keyframes`` the keyframe database scores on the ranks
(``attach_mesh``, kernel AE), as the JAX package's System.cc wiring does
(``slam/system.py:65-76``); the loop closer's global BA then runs over
observation shards (kernel AF).  Every rank runs the same program on the
same frames and holds the same map.  Only the synchronous backend
(``async_backend=False``) runs so: the worker threads of the async one
would schedule differently on each rank and the ranks' collectives would
not match, so it raises ``ValueError`` there.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from orb_slam3_fast_tpu_torch import _kernels
from orb_slam3_fast_tpu_torch.backend.loopcloser import LoopCloser, LoopCloserConfig
from orb_slam3_fast_tpu_torch.backend.mapper import Mapper
from orb_slam3_fast_tpu_torch.backend.pipeline import AsyncBackend
from orb_slam3_fast_tpu_torch.frontend import tracker as trk
from orb_slam3_fast_tpu_torch.map.atlas import Atlas
from orb_slam3_fast_tpu_torch.map.worldmap import WorldMap
from orb_slam3_fast_tpu_torch.ops import extractor as ext
from orb_slam3_fast_tpu_torch.parallel import multihost
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
        on the host.  ``async_backend`` runs local mapping and loop closing
        on a worker thread and the global BA on another (the reference's
        threads, System.cc:221,241); False runs them inline per keyframe,
        which repeats exactly."""
        if sensor not in (MONOCULAR, STEREO, RGBD, IMU_MONOCULAR, IMU_STEREO, IMU_RGBD):
            raise ValueError(f"unknown sensor {sensor!r}")
        self.inertial = "inertial" in sensor
        if isinstance(settings, str):
            settings = Settings.from_yaml(settings, sensor=sensor)
        self.settings = settings
        self.sensor = sensor
        self.device = _kernels.resolve_device(device)
        multihost.initialize(device=self.device)  # a no-op in a lone process
        world_size = multihost.process_info()[1]
        if world_size > 1 and async_backend:
            raise ValueError(f"System: {world_size} ranks need async_backend=False: the async backend's worker threads "
                             "would schedule differently on each rank, and the ranks' collectives would not match")
        self.voc = (vocabulary or voc_mod.default_vocabulary()).to(self.device)
        self.kfdb = db_mod.KeyFrameDatabase(self.voc.n_words, max_kf=max_keyframes)
        if world_size > 1 and max_keyframes % world_size == 0:
            self.kfdb.attach_mesh(multihost.global_mesh(self.device))
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
        self.backend = AsyncBackend(self.mapper, self.loopcloser, kfdb=self.kfdb) if async_backend else None
        self.timers = StageTimers()
        common = dict(bf=settings.bf, image_wh=wh, world=self.world, mapper=self.mapper, voc=self.voc,
                      kfdb=self.kfdb, loopcloser=self.loopcloser, atlas=self.atlas, backend=self.backend,
                      timers=self.timers, device=self.device)
        if settings.camera_type == "KannalaBrandt8" and settings.cam2 is not None:
            # the non-rectified fisheye rig (TUM-VI): the tracker matches and triangulates across the two cameras
            common.update(cam2=settings.cam2, T_c1_c2=settings.T_c1_c2)
        if self.inertial:
            from orb_slam3_fast_tpu_torch.frontend.vi_tracker import InertialConfig, InertialTracker
            from orb_slam3_fast_tpu_torch.imu import preintegration as pre

            noise = pre.ImuNoise.from_continuous(settings.imu_noise_gyro, settings.imu_noise_acc,
                                                 settings.imu_gyro_walk, settings.imu_acc_walk,
                                                 settings.imu_frequency)
            n_bucket = int(2 ** np.ceil(np.log2(max(2 * settings.imu_frequency / max(settings.fps, 1.0), 16))))
            self.tracker = InertialTracker(settings.cam, tcfg, T_bc=settings.T_b_c1, noise=noise,
                                           icfg=InertialConfig(fix_scale=(sensor != IMU_MONOCULAR),
                                                               imu_bucket=n_bucket), **common)
        else:
            self.tracker = trk.Tracker(settings.cam, tcfg, **common)
        if self.inertial and self.loopcloser is not None:
            # the loop closer's inertial hooks (MergeInertialBA, FullInertialBA, the windowed VI-BA of a map
            # other than the tracker's, which leaves the tracker's state alone)
            tracker = self.tracker
            self.loopcloser.inertial_ba = (
                lambda w, kn, window=None: tracker._local_inertial_ba(kn, window=window, world=w, sync_tracker=False))
            self.loopcloser.inertial_gba = tracker._full_inertial_ba
            self.loopcloser.merge_inertial_ba = tracker._merge_inertial_ba
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
        if self.sensor not in (MONOCULAR, IMU_MONOCULAR):
            raise ValueError(f"track_monocular on a {self.sensor!r} System")
        if self.inertial and len(imu):  # a visual System ignores samples, as the JAX System does
            self.tracker.grab_imu(imu)
        img = self._preprocess(img)
        with self.timers.span("track_total"):
            state, pose = self.tracker.process_mono(img, ts)
        return state, pose

    def track_rgbd(self, img, depth, ts: float, imu=()):
        """One RGB-D frame: the depth map in the units of the settings'
        ``depth_map_factor`` (System::TrackRGBD, System.cc:402-476)."""
        if self.sensor not in (RGBD, IMU_RGBD):
            raise ValueError(f"track_rgbd on a {self.sensor!r} System")
        if self.inertial and len(imu):  # a visual System ignores samples, as the JAX System does
            self.tracker.grab_imu(imu)
        img = self._preprocess(img)
        depth = np.asarray(depth, dtype=np.float32)
        if self.settings.depth_map_factor != 1.0:
            depth = depth / self.settings.depth_map_factor
        with self.timers.span("track_total"):
            state, pose = self.tracker.process_rgbd(img, depth, ts)
        return state, pose

    def track_stereo(self, img_l, img_r, ts: float, imu=()):
        if self.sensor not in (STEREO, IMU_STEREO):
            raise ValueError(f"track_stereo on a {self.sensor!r} System")
        if self.inertial and len(imu):  # a visual System ignores samples, as the JAX System does
            self.tracker.grab_imu(imu)
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
        """System::Shutdown (System.cc:528-572): drain the async backend and
        stop its threads, then save the map if the settings ask."""
        self._finished = True
        if self.backend is not None:
            self.backend.wait_idle(timeout=60)
            self.backend.shutdown()
        if self.settings.save_atlas:
            self.save_atlas(self.settings.save_atlas + ".npz")

    def get_tracking_state(self):
        return self.tracker.state

    def _map_change_index(self) -> int:
        cur = self.tracker.world.change_index
        if self.backend is not None:
            cur += self.backend.map_version
        if self.loopcloser is not None:
            cur += self.loopcloser.n_loops_closed + self.loopcloser.n_maps_merged
        return cur

    def map_changed(self) -> bool:
        """Change-index handshake (System::MapChanged, System.cc:508 /
        Map::GetMapChangeIndex, Map.cc:306-324): True once per map update (a
        BA write-back, a backend pass, a loop, a merge) since the previous
        query."""
        cur = self._map_change_index()
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
