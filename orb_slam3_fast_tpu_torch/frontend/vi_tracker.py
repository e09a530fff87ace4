"""Visual-inertial tracking front end: the IMU_MONOCULAR / IMU_STEREO /
IMU_RGBD modes of Tracking (Tracking.cc) and the inertial half of local
mapping that the JAX package runs from the tracker.

Counterpart of ``orb_slam3_fast_tpu/frontend/vi_tracker.py``: samples queued
by ``grab_imu`` (GrabImuData, Tracking.cc:1617-1628) are preintegrated per
frame into the frame's and the keyframe's windows (kernel V), with the host
decimation of bursts and the count of bad (non-finite) windows that resets
the active map; once the IMU is initialised the prediction of the state
(PredictStateIMU) replaces the constant-velocity model, drives the pose
while lost within the grace window, and the frame's 15-D body state is
optimised with the inertial factors (kernel W, the KF-anchored or the
last-frame form); each keyframe stores its window and state, the IMU is
initialised once enough keyframes and time have passed (gravity, scale,
velocities and bias, kernel X, then ``apply_scaled_rotation``), the scale
is refined every ~5 s of keyframe time (kernel X's second entry), and each
keyframe after initialisation runs the windowed local inertial BA (kernel
Y).  The state machine runs on the host; the preintegrated windows, the
body states and the solves stay on ``device``.

Where the JAX package pads to power-of-2 buckets for XLA's compile cache,
the port keeps the padding only where it changes the result: the local
inertial BA's states (padded states repeat the newest keyframe and observe
its landmarks again, fixed) and its edge table; the landmarks and the
observations of that BA, the chain of the IMU initialisation and every
array of FullInertialBA are not padded (padded entries there contribute
nothing).

The loop closer's inertial hooks are here too: MergeInertialBA
(``_merge_inertial_ba``, a 6+6 welding window on kernel Y) and
FullInertialBA (``_full_inertial_ba``, every keyframe, landmark and the
whole chain on kernel AA, abortable between segments).  With the async
backend (``backend=``) every gather from the map and every write-back of
the inertial tracker's solves (the IMU initialisation, the local VI-BA,
the scale refinement, FullInertialBA) holds the backend's map lock, never
around a kernel; the JAX package runs them on the tracker thread with no
lock while the worker maps.  On a world of several ranks
(``parallel/multihost.py``) FullInertialBA runs over observation shards
(``parallel/dist_ba.make_distributed_vi_ba_cg``, kernel AG), its abort flag
read once after the solve, as the JAX package's sharded branch does.
"""
from __future__ import annotations

import contextlib
from typing import NamedTuple, Optional

import numpy as np
import torch

from orb_slam3_fast_tpu_torch.frontend.tracker import LOST, OK, RECENTLY_LOST, Tracker
from orb_slam3_fast_tpu_torch.imu import preintegration as pre
from orb_slam3_fast_tpu_torch.map.worldmap import host
from orb_slam3_fast_tpu_torch.backend.mapper import correct_new_since_snapshot
from orb_slam3_fast_tpu_torch.optim import imu_init, inertial, vi_ba, vi_ba_cg
from orb_slam3_fast_tpu_torch.parallel import dist_ba, multihost
from orb_slam3_fast_tpu_torch.utils import lie, verbose


class InertialConfig(NamedTuple):
    """The JAX package's InertialConfig."""

    init_min_kfs: int = 10  # InitializeIMU gates (LocalMapping.cc:228-233)
    init_min_time: float = 2.0
    # minimum span of one edge of the initialisation's chain: consecutive
    # keyframe windows are composed until each spans this long
    init_edge_dt: float = 0.35
    viba_window: int = 10  # LocalInertialBA temporal window (Optimizer.cc:2481)
    viba_obs_cap: int = 8192
    viba_lm_cap: int = 2048
    imu_bucket: int = 64  # per-frame IMU sample capacity
    fix_scale: bool = False  # stereo / RGB-D inertial: the scale is known
    recently_lost_time: float = 10.0  # time_recently_lost (Tracking.cc:69)
    bad_imu_limit: int = 5  # consecutive non-finite windows before the active map is reset


def body_from_camera(T_cb: lie.SE3, R_cw, t_cw):
    """T_cw -> (R_wb, p_wb): T_bw = T_cb^-1 T_cw."""
    T_bw = T_cb.inverse().compose(lie.SE3(R_cw, t_cw))
    R_wb = T_bw.R.transpose(-1, -2)
    return R_wb, -torch.einsum("...ij,...j->...i", R_wb, T_bw.t)


def camera_from_body(T_cb: lie.SE3, R_wb, p_wb):
    """(R_wb, p_wb) -> T_cw = T_cb T_bw."""
    R_bw = R_wb.transpose(-1, -2)
    T = T_cb.compose(lie.SE3(R_bw, -torch.einsum("...ij,...j->...i", R_bw, p_wb)))
    return T.R, T.t


class InertialTracker(Tracker):
    """Tracker with an IMU channel: the same host orchestration, with
    prediction and pose refinement on the inertial factors once the IMU is
    initialised."""

    def __init__(self, *args, T_bc=None, noise: pre.ImuNoise, icfg: InertialConfig = InertialConfig(), **kwargs):
        super().__init__(*args, **kwargs)
        T_bc = np.eye(4, dtype=np.float32) if T_bc is None else np.asarray(T_bc, dtype=np.float32)
        dev = self.device
        self.T_cb = lie.SE3(torch.as_tensor(T_bc[:3, :3]).to(dev), torch.as_tensor(T_bc[:3, 3]).to(dev)).inverse()
        self.noise = noise
        self.icfg = icfg
        self.imu_queue: list = []
        self.last_imu_ts: float | None = None
        self.frame_preint: Optional[pre.Preintegrated] = None  # last frame -> current
        self.kf_preint: Optional[pre.Preintegrated] = None  # last keyframe -> current
        self.cur_bias = torch.zeros(6, dtype=torch.float32, device=dev)
        self.cur_vel = torch.zeros(3, dtype=torch.float32, device=dev)
        self.first_imu_frame_ts: float | None = None
        self._prior: inertial.PriorState | None = None  # ConstraintPoseImu, dropped when the world moves
        self._bad_imu_count = 0
        self._pred_vel = None
        self._imu_init_ts = 0.0
        self._last_scale_refine: float | None = None
        self.n_ba_discarded = 0  # inertial BAs of a worker whose map changed frame while they were solved

    def _t(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, dtype=np.float32)).to(self.device)

    def _map_lock(self):
        """The async backend's map lock (a null context without a backend)."""
        return self.backend.lock if self.backend is not None else contextlib.nullcontext()

    # ------------------------------------------------------------------
    def grab_imu(self, imu):
        """Queue samples (ts, ax, ay, az, wx, wy, wz) arriving before the
        next frame (Tracking::GrabImuData, Tracking.cc:1617-1628)."""
        self.imu_queue.extend(np.asarray(imu, dtype=np.float64).reshape(-1, 7))

    def _preintegrate_frame(self, ts: float):
        """PreintegrateIMU (Tracking.cc:1630-1733): the queued samples up to
        the frame's timestamp into the frame's and the keyframe's windows."""
        take = [m for m in self.imu_queue if m[0] <= ts + 1e-9]
        self.imu_queue = [m for m in self.imu_queue if m[0] > ts + 1e-9]
        nb = self.icfg.imu_bucket
        # a burst beyond one bucket is decimated by averaging adjacent samples (the integrated time kept)
        while len(take) > nb - 1:
            merged = []
            for i in range(0, len(take) - 1, 2):
                m = 0.5 * (np.asarray(take[i], np.float64) + np.asarray(take[i + 1], np.float64))
                m[0] = take[i + 1][0]
                merged.append(m)
            if len(take) % 2:
                merged.append(np.asarray(take[-1], np.float64))
            take = merged
        acc = np.zeros((nb, 3), np.float32)
        gyr = np.zeros((nb, 3), np.float32)
        dts = np.zeros(nb, np.float32)
        val = np.zeros(nb, bool)
        t_prev = self.last_imu_ts if self.last_imu_ts is not None else (take[0][0] if take else ts)
        for i, m in enumerate(take):
            acc[i] = m[1:4]
            gyr[i] = m[4:7]
            dts[i] = max(m[0] - t_prev, 0.0)
            val[i] = True
            t_prev = m[0]
        if take and ts > t_prev:  # close the window at the frame (the last sample extended, Tracking.cc:1681-1717)
            i = min(len(take), nb - 1)
            acc[i] = take[-1][1:4]
            gyr[i] = take[-1][4:7]
            dts[i] = ts - t_prev
            val[i] = True
        self.last_imu_ts = ts
        if not val.any():
            self.frame_preint = None
            return
        a, g, d, v = (self._t(x) if x.dtype != bool else torch.as_tensor(x).to(self.device)
                      for x in (acc, gyr, dts, val))
        fp = pre.preintegrate(a, g, d, self.cur_bias, self.noise, valid=v)
        # bad IMU (mbBadImu, LocalMapping.h:89): a non-finite window; enough in a row reset the active map
        if not bool(torch.isfinite(torch.cat([fp.dV, fp.dP, fp.dR.reshape(-1)])).all()):
            self._bad_imu_count += 1
            self.frame_preint = None
            if self._bad_imu_count >= self.icfg.bad_imu_limit and self.atlas is not None:
                self._reset_active_map()
                self._bad_imu_count = 0
            return
        self._bad_imu_count = 0
        self.frame_preint = fp
        self.kf_preint = fp if self.kf_preint is None else pre.merge(self.kf_preint, a, g, d, self.noise, valid=v)

    # ------------------------------------------------------------------
    def _track(self, kp, ts, depth, right_u):
        self._preintegrate_frame(ts)
        if self.first_imu_frame_ts is None:
            self.first_imu_frame_ts = ts
        was_init = self.state == "NOT_INITIALIZED"
        out = super()._track(kp, ts, depth, right_u)
        if was_init and self.state == OK:
            # the map's first keyframes were made without _create_keyframe: the keyframe window restarts here
            self.kf_preint = None
        return out

    def _reset_tracking_state(self):
        super()._reset_tracking_state()
        self.cur_bias = torch.zeros(6, dtype=torch.float32, device=self.device)
        self.cur_vel = torch.zeros(3, dtype=torch.float32, device=self.device)
        self.frame_preint = None
        self.kf_preint = None
        self._prior = None
        self.first_imu_frame_ts = None

    # ------------------------------------------------------------------
    def _predict(self, R_cw, t_cw):
        """The IMU prediction over the frame's window from a camera pose:
        (R_cw, t_cw, v_w) of the new frame."""
        R_wb, p_wb = body_from_camera(self.T_cb, self._t(R_cw), self._t(t_cw))
        R2, p2, v2 = pre.predict_state(R_wb, p_wb, self.cur_vel, self.frame_preint, self.cur_bias)
        Rc, tc = camera_from_body(self.T_cb, R2, p2)
        return Rc, tc, v2

    def _predict_lost_pose(self, ts):
        """IMU-only prediction while RECENTLY_LOST (Tracking.cc:1966-1977);
        None once the grace window has passed or without an initialised IMU."""
        if not (self.world.imu_initialized and self.frame_preint is not None and self.last is not None):
            return None
        since = self._lost_since_ts if self._lost_since_ts is not None else ts
        if ts - since > self.icfg.recently_lost_time:
            return None
        Rc, tc, v2 = self._predict(self.last.R, self.last.t)
        self.cur_vel = v2
        self._prior = None  # no visual anchor: the marginal is stale
        R_np = lie.normalize_rotation_np(host(Rc))
        t_np = host(tc)
        self._lost_pred_pose = (R_np, t_np)
        return self._se3(R_np, t_np)

    def _lost_state(self, ts):
        if self.world.imu_initialized:
            since = ts if self._lost_since_ts is None else self._lost_since_ts
            return RECENTLY_LOST if ts - since <= self.icfg.recently_lost_time else LOST
        return super()._lost_state(ts)

    def _track_frame(self, kp, ts, depth, right_u) -> bool:
        if self.state != OK:
            self._prior = None  # a lost or relocalised frame has no marginal to carry
        if self.world.imu_initialized and self.frame_preint is not None and self.last is not None:
            # the IMU prediction replaces the constant-velocity model
            Rc, tc, v2 = self._predict(self.last.R, self.last.t)
            T_last = self._se3(self.last.R, self.last.t)
            self.velocity = lie.SE3(Rc, tc).compose(T_last.inverse())
            self._pred_vel = v2
        return super()._track_frame(kp, ts, depth, right_u)

    # ------------------------------------------------------------------
    def _pose_opt_from_obs(self, kp, T0, obs_lm):
        """Inertial pose optimisation once the IMU is initialised (kernel W:
        PoseInertialOptimizationLastKeyFrame / LastFrame, Optimizer.cc:4544,
        4933); the visual pose optimisation before."""
        if not (self.world.imu_initialized and self.frame_preint is not None and self.last is not None):
            return super()._pose_opt_from_obs(kp, T0, obs_lm)
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
        obs = inertial.VIObs(xw=self._t(xw), uv=self._t(uv), inv_sigma2=self._t(inv_s2),
                             is_stereo=torch.as_tensor(stereo).to(dev), valid=torch.as_tensor(valid).to(dev))
        R0, p0 = body_from_camera(self.T_cb, T0.R.to(torch.float32), T0.t.to(torch.float32))
        v0 = self._pred_vel if self._pred_vel is not None else self.cur_vel
        s0 = inertial.BodyState(R0, p0, v0, self.cur_bias)
        # the anchor (Tracking.cc:2897-2921): after a map update the last keyframe, fixed; else the last frame,
        # free under its marginalisation prior
        w = self.world
        k_last = w.n_kf - 1
        use_kf = (self.map_updated and k_last >= 0 and self.kf_preint is not None
                  and float(self.kf_preint.dT) > 1e-6)
        bf = self.bf
        if use_kf:
            R_prev, p_prev = body_from_camera(self.T_cb, self._t(w.kf_R[k_last]), self._t(w.kf_t[k_last]))
            s_prev = inertial.BodyState(R_prev, p_prev, self._t(w.kf_vel[k_last]), self._t(w.kf_bias[k_last]))
            state, inlier, n_inl, H = inertial.pose_inertial_optimization(self.cam, bf, self.T_cb, s_prev,
                                                                         self.kf_preint, s0, obs)
        else:
            R_prev, p_prev = body_from_camera(self.T_cb, self._t(self.last.R), self._t(self.last.t))
            s_prev = inertial.BodyState(R_prev, p_prev, self.cur_vel, self.cur_bias)
            if self._prior is not None:
                state, inlier, n_inl, H = inertial.pose_inertial_optimization_last_frame(
                    self.cam, bf, self.T_cb, s_prev, self._prior, self.frame_preint, s0, obs)
            else:
                state, inlier, n_inl, H = inertial.pose_inertial_optimization(self.cam, bf, self.T_cb, s_prev,
                                                                             self.frame_preint, s0, obs)
        self.map_updated = False
        inl, n_inl, finite = host(inlier), int(n_inl), bool(torch.isfinite(H).all())
        self._prior = inertial.PriorState(state=state, H=H) if finite else None
        self.cur_vel = state.v
        self.cur_bias = state.bias
        Rc, tc = camera_from_body(self.T_cb, state.R, state.p)
        obs_out = obs_lm.copy()
        obs_out[~inl] = -1
        return lie.SE3(Rc, tc), obs_out, n_inl

    # ------------------------------------------------------------------
    def _keyframe_state(self, k: int) -> None:
        """The keyframe-to-keyframe window and the inertial state of keyframe k."""
        w = self.world
        if self.kf_preint is not None and k > 0:
            w.kf_preint[k] = self.kf_preint
        w.kf_vel[k] = host(self.cur_vel)
        w.kf_bias[k] = host(self.cur_bias)
        self.kf_preint = None

    def _create_keyframe(self):
        k_before = self.world.n_kf
        super()._create_keyframe()  # with a backend, the keyframe's state was stored under the lock before queueing
        k = self.world.n_kf - 1
        if k < k_before:
            return
        w = self.world
        if self.backend is None:  # after local mapping and loop closing, as in the JAX package
            self._keyframe_state(k)
        if not w.imu_initialized:  # LocalMapping::InitializeIMU
            self._try_initialize_imu()
        elif len(w.kf_preint) >= 2:
            self._local_inertial_ba(k)
            # ScaleRefinement (LocalMapping.cc:1420), here every ~5 s of keyframe time after initialisation
            ts_now = w.kf_ts[k]
            last = self._last_scale_refine if self._last_scale_refine is not None else self._imu_init_ts
            if ts_now - last >= 5.0:
                self._scale_refinement()
                self._last_scale_refine = ts_now

    def _coarse_chain(self, ks):
        """The keyframe windows composed (kernel V's closed form) until each
        edge spans ``init_edge_dt``: (chain of keyframe ids, windows)."""
        w = self.world
        chain = [ks[0] - 1]
        pre_list = []
        acc_p = None
        for k in ks:
            p = w.kf_preint[k]
            acc_p = p if acc_p is None else pre.compose(acc_p, p)
            if float(acc_p.dT) >= self.icfg.init_edge_dt or k == ks[-1]:
                chain.append(k)
                pre_list.append(acc_p)
                acc_p = None
        return chain, pre_list

    def _chain_body(self, chain):
        w = self.world
        return body_from_camera(self.T_cb, self._t(w.kf_R[chain]), self._t(w.kf_t[chain]))

    def _try_initialize_imu(self):
        """InitializeIMU (LocalMapping.cc:1154-1418): the inertial-only
        optimisation over the coarse chain (kernel X), the world rotated and
        scaled onto gravity, velocities and biases set, then an inertial BA
        over every keyframe of the chain."""
        w = self.world
        icfg = self.icfg
        with self._map_lock():
            ks = [k for k in range(1, w.n_kf) if k in w.kf_preint]
            if len(ks) + 1 < icfg.init_min_kfs:
                return
            if w.kf_ts[ks[-1]] - w.kf_ts[ks[0] - 1] < icfg.init_min_time:
                return
            chain, pre_list = self._coarse_chain(ks)
            if len(pre_list) < 3:
                return
            R_wb, p_wb = self._chain_body(chain)
        init = imu_init.inertial_only_optimization(R_wb, p_wb, pre.stack(pre_list), fix_scale=icfg.fix_scale)
        s = float(init.scale)
        if not (0.1 < s < 10.0) or not np.isfinite(s):
            return
        with self._map_lock():
            self._apply_initialization(init, s, ks, chain)
        verbose.print_mess(f"IMU initialized: scale {s:.4f}, {len(chain)} nodes", verbose.VERBOSITY_NORMAL)
        self._local_inertial_ba(w.n_kf - 1, window=len(ks) + 1)  # FullInertialBA (LocalMapping.cc:1340)

    def _apply_initialization(self, init, s: float, ks, chain):
        """The world rotated and scaled onto gravity, the velocities and the
        biases set, the tracker's state rebased (the caller holds the lock)."""
        w = self.world
        R_gw = host(init.Rwg).T
        w.apply_scaled_rotation(R_gw, s)
        w.kf_vel[chain] = s * (host(init.vel)[: len(chain)] @ R_gw.T)  # estimated in the old world frame
        full = [ks[0] - 1] + ks
        for j in full:  # keyframes between the coarse nodes: velocities from the now metric positions
            if j in chain:
                continue
            lo, hi = max(full[0], j - 1), min(full[-1], j + 1)
            dt = w.kf_ts[hi] - w.kf_ts[lo]
            if dt > 1e-6:
                w.kf_vel[j] = (w.camera_center(hi) - w.camera_center(lo)) / dt
        bias = host(init.bias)
        w.kf_bias[: w.n_kf] = bias
        self.cur_bias = self._t(bias)
        self.cur_vel = self._t(w.kf_vel[full[-1]])
        if self.last is not None:  # rebase the cached pose onto the transformed world
            self.last.R = self.last.R @ R_gw.T
            self.last.t = s * self.last.t
        self.velocity = lie.SE3.identity(self.device)
        w.imu_initialized = True
        self._prior = None
        self._imu_init_ts = float(w.kf_ts[w.n_kf - 1])

    def _scale_refinement(self):
        """ScaleRefinement: gravity and scale over the chain with the rest
        frozen (kernel X's second entry); a change |s - 1| > 0.002 applied."""
        w = self.world
        with self._map_lock():
            ks = [k for k in range(1, w.n_kf) if k in w.kf_preint]
            if len(ks) < 4:
                return
            chain, pre_list = self._coarse_chain(ks)
            if len(pre_list) < 3:
                return
            R_wb, p_wb = self._chain_body(chain)
            vel = self._t(w.kf_vel[chain])
        Rwg, s = imu_init.scale_gravity_refinement(R_wb, p_wb, vel, self.cur_bias, pre.stack(pre_list))
        s = float(s)
        if not np.isfinite(s) or not (0.5 < s < 2.0):
            return
        if abs(s - 1.0) > 0.002:
            R_gw = host(Rwg).T
            with self._map_lock():
                w.apply_scaled_rotation(R_gw, s)
            if self.last is not None:
                self.last.R = lie.normalize_rotation_np(self.last.R @ R_gw.T)
                self.last.t = (s * self.last.t).astype(np.float32)
            self.cur_vel = self._t(s * (host(self.cur_vel) @ R_gw.T))
            self.velocity = lie.SE3.identity(self.device)
            self._prior = None

    # ------------------------------------------------------------------
    def _local_inertial_ba(self, k: int, window: int | None = None, world=None, sync_tracker: bool = True):
        """LocalInertialBA (Optimizer.cc:2426): the temporal window of body
        states chained by their windows, and their landmarks (kernel Y);
        tracking goes on from the adjusted newest keyframe.  With ``world``
        and ``sync_tracker=False`` the loop closer runs it on another map
        (a merged one, or the global BA's fallback) without touching the
        tracker's state."""
        w = world if world is not None else self.world
        win = window or self.icfg.viba_window
        with self._map_lock():
            chain = [j for j in range(max(1, k - win + 1), k + 1) if j in w.kf_preint]
            if len(chain) < 2:
                return
            real_ids = [chain[0] - 1] + chain
            edges = [(i, i + 1, w.kf_preint[j]) for i, j in enumerate(chain)]
        real = self._solve_windowed_viba(w, real_ids, edges, fixed_real=[0], min_bucket=win + 1)
        if real is None or not sync_tracker:
            return
        self.cur_vel = self._t(w.kf_vel[real[-1]])
        self.cur_bias = self._t(w.kf_bias[real[-1]])
        self.last.R = w.kf_R[real[-1]].copy()
        self.last.t = w.kf_t[real[-1]].copy()

    def _solve_windowed_viba(self, w, real_ids, edges, fixed_real, min_bucket: int = 8):
        """Gather, solve (kernel Y) and write back the windowed VI-BA, the
        gather and the write-back under the map lock.  The states are padded
        to the JAX package's power-of-2 bucket with repeats of the newest
        keyframe, fixed; the padded edges are invalid.  Returns the real
        keyframe ids, or None (also where the map changed frame while the
        solve ran: a loop closer's call on the worker, discarded and
        counted in ``n_ba_discarded``)."""
        with self._map_lock():
            epoch = w.frame_epoch
            gathered = self._gather_windowed_viba(w, real_ids, edges, fixed_real, min_bucket)
        if gathered is None:
            return None
        prob, kf_ids, n_real, fixed, lm_ids = gathered
        R2, p2, v2, b2, xw2, _ = vi_ba.vi_bundle_adjust(self.cam, self.bf, self.T_cb, prob)
        Rc, tc = camera_from_body(self.T_cb, R2, p2)
        free = ~fixed
        real = kf_ids[:n_real]
        free_r = free[:n_real]
        with self._map_lock():
            if w.frame_epoch != epoch:  # turned and scaled meanwhile (a loop closer's call on the worker)
                self.n_ba_discarded += 1
                return None
            w.kf_R[kf_ids[free]] = lie.normalize_rotation_np(host(Rc)[free])
            w.kf_t[kf_ids[free]] = host(tc)[free]
            w.kf_vel[real[free_r]] = host(v2)[:n_real][free_r]
            w.kf_bias[real[free_r]] = host(b2)[:n_real][free_r]
            w.lm_pos[lm_ids] = host(xw2)
        return real

    def _gather_windowed_viba(self, w, real_ids, edges, fixed_real, min_bucket: int):
        """The windowed VI-BA's problem (prob, kf_ids, n_real, fixed, lm_ids), or None."""
        icfg = self.icfg
        dev = self.device
        K = int(2 ** np.ceil(np.log2(max(len(real_ids), min_bucket, 4))))
        kf_ids = np.asarray(list(real_ids) + [real_ids[-1]] * (K - len(real_ids)))
        n_real = len(real_ids)
        lm_ids = w.local_landmarks(kf_ids[:n_real])
        if len(lm_ids) == 0:
            return None
        if len(lm_ids) > icfg.viba_lm_cap:
            verbose.warn_cap("vi_tracker.viba_landmarks", icfg.viba_lm_cap, len(lm_ids))
            lm_ids = lm_ids[: icfg.viba_lm_cap]
        obs_kf, obs_lm, slots = w.observations_of(lm_ids, kf_ids)
        if len(obs_kf) == 0:
            return None
        if len(obs_kf) > icfg.viba_obs_cap:
            verbose.warn_cap("vi_tracker.viba_obs", icfg.viba_obs_cap, len(obs_kf))
            sel = np.random.default_rng(0).choice(len(obs_kf), icfg.viba_obs_cap, replace=False)
            obs_kf, obs_lm, slots = obs_kf[sel], obs_lm[sel], slots[sel]
        kf_sel = kf_ids[obs_kf]
        o_uv = np.full((len(obs_kf), 3), -1.0, np.float32)
        o_uv[:, :2] = w.kf_xy[kf_sel, slots]
        ru = w.kf_right_u[kf_sel, slots]
        use_st = (ru > 0) & (self.bf > 0)
        o_uv[:, 2] = np.where(use_st, ru, -1.0)
        E = K - 1
        e_i = np.zeros(E, np.int32)
        e_j = np.ones(E, np.int32)
        e_val = np.zeros(E, bool)
        pre_list = []
        for e, (i, j, p) in enumerate(edges[:E]):
            e_i[e], e_j[e], e_val[e] = i, j, True
            pre_list.append(p)
        if not pre_list:
            return None
        pre_list += [pre_list[-1]] * (E - len(pre_list))
        fixed = np.zeros(K, bool)
        fixed[n_real:] = True
        fixed[list(fixed_real)] = True
        R_wb, p_wb = body_from_camera(self.T_cb, self._t(w.kf_R[kf_ids]), self._t(w.kf_t[kf_ids]))

        def b(a):
            return torch.as_tensor(np.asarray(a)).to(dev)

        prob = vi_ba.VIBAProblem(
            R_wb=R_wb, p_wb=p_wb, v_w=self._t(w.kf_vel[kf_ids]), bias=self._t(w.kf_bias[kf_ids]),
            state_fixed=b(fixed), xw=self._t(w.lm_pos[lm_ids]), lm_valid=b(w.lm_valid[lm_ids]),
            obs_kf=b(obs_kf.astype(np.int32)), obs_lm=b(obs_lm.astype(np.int32)), obs_uv=self._t(o_uv),
            obs_inv_sigma2=self._t(1.0 / self.sigma2[w.kf_level[kf_sel, slots]]), obs_is_stereo=b(use_st),
            obs_valid=torch.ones(len(obs_kf), dtype=torch.bool, device=dev), edge_i=b(e_i), edge_j=b(e_j),
            edge_valid=b(e_val), preint=pre.stack([p.to(dev) for p in pre_list]),
        )
        return prob, kf_ids, n_real, fixed, lm_ids

    # ------------------------------------------------------------------
    def _merge_inertial_ba(self, world, k_new: int, c2: int, half_window: int = 6):
        """MergeInertialBA (Optimizer.cc:3996-4543): a 6+6 welding window
        across two freshly merged maps -- the last ``half_window`` keyframes
        of the transplanted side ending at ``k_new`` and ``half_window``
        temporal neighbours of the matched keyframe ``c2`` -- with each
        side's predecessor fixed and each side's chain as inertial edges (no
        window spans the weld itself), on kernel Y.  Returns the real
        keyframe ids, or None where no such window exists."""
        w = world
        with self._map_lock():
            src = [j for j in range(max(1, k_new - half_window + 1), k_new + 1) if w.kf_valid[j] and j in w.kf_preint]
            lo = max(1, c2 - half_window // 2)
            dst = [j for j in range(lo, min(w.n_kf, lo + half_window)) if w.kf_valid[j] and j in w.kf_preint]
            dst = [j for j in dst if j not in src]
            if len(src) < 2 or len(dst) < 1:
                return None
            src_anchor, dst_anchor = src[0] - 1, dst[0] - 1  # the outer boundary, fixed (Optimizer.cc:4001-4040)
            real_ids = []
            for j in [src_anchor] + src + [dst_anchor] + dst:
                if j >= 0 and w.kf_valid[j] and j not in real_ids:
                    real_ids.append(j)
            idx = {j: i for i, j in enumerate(real_ids)}
            edges = [(idx[j - 1], idx[j], w.kf_preint[j]) for side in (src, dst) for j in side
                     if j in idx and (j - 1) in idx]
        if len(edges) < 2:
            return None
        fixed_real = [idx[j] for j in (src_anchor, dst_anchor) if j in idx] or [0]
        return self._solve_windowed_viba(w, real_ids, edges, fixed_real=fixed_real, min_bucket=2 * half_window + 2)

    def full_inertial_problem(self, w, fixed_ids):
        """FullInertialBA's problem over every valid keyframe of ``w``: the
        chain of every stored window between two valid keyframes, every
        landmark they observe and every observation, ``fixed_ids`` fixed (the
        first state where none is valid).  Returns (prob, keyframe ids, fixed
        flags, landmark ids, each observation's landmark index, keyframe and
        slot), or None with fewer than 3 keyframes, 2 edges, a landmark or an
        observation.  The caller holds the map lock."""
        n_kf = w.n_kf
        dev = self.device
        kf_ids = np.nonzero(w.kf_valid[:n_kf])[0]
        if len(kf_ids) < 3:
            return None
        edges = [(k - 1, k) for k in sorted(w.kf_preint) if 0 < k < n_kf and w.kf_valid[k] and w.kf_valid[k - 1]]
        if len(edges) < 2:
            return None
        idx_of = -np.ones(n_kf, np.int64)
        idx_of[kf_ids] = np.arange(len(kf_ids))
        lm_ids = w.local_landmarks(kf_ids)
        if len(lm_ids) == 0:
            return None
        obs_kf, obs_lm, slots = w.observations_of(lm_ids, kf_ids)
        if len(obs_kf) == 0:
            return None
        kf_sel = kf_ids[obs_kf]
        o_uv = np.full((len(obs_kf), 3), -1.0, np.float32)
        o_uv[:, :2] = w.kf_xy[kf_sel, slots]
        ru = w.kf_right_u[kf_sel, slots]
        use_st = (ru > 0) & (self.bf > 0)
        o_uv[:, 2] = np.where(use_st, ru, -1.0)
        fixed = np.zeros(len(kf_ids), bool)
        for f in np.atleast_1d(fixed_ids):
            if 0 <= f < n_kf and idx_of[f] >= 0:
                fixed[idx_of[f]] = True
        if not fixed.any():
            fixed[0] = True  # the gauge anchor
        R_wb, p_wb = body_from_camera(self.T_cb, self._t(w.kf_R[kf_ids]), self._t(w.kf_t[kf_ids]))

        def b(a):
            return torch.as_tensor(np.asarray(a)).to(dev)

        prob = vi_ba.VIBAProblem(
            R_wb=R_wb, p_wb=p_wb, v_w=self._t(w.kf_vel[kf_ids]), bias=self._t(w.kf_bias[kf_ids]),
            state_fixed=b(fixed), xw=self._t(w.lm_pos[lm_ids]), lm_valid=b(w.lm_valid[lm_ids]),
            obs_kf=b(obs_kf.astype(np.int32)), obs_lm=b(obs_lm.astype(np.int32)), obs_uv=self._t(o_uv),
            obs_inv_sigma2=self._t(1.0 / self.sigma2[w.kf_level[kf_sel, slots]]), obs_is_stereo=b(use_st),
            obs_valid=torch.ones(len(obs_kf), dtype=torch.bool, device=dev),
            edge_i=b(idx_of[[e[0] for e in edges]].astype(np.int32)),
            edge_j=b(idx_of[[e[1] for e in edges]].astype(np.int32)),
            edge_valid=torch.ones(len(edges), dtype=torch.bool, device=dev),
            preint=pre.stack([w.kf_preint[j].to(dev) for _, j in edges]),
        )
        return prob, kf_ids, fixed, lm_ids, obs_lm, kf_sel, slots

    def _full_inertial_ba(self, world, fixed_ids, map_lock=None, abort_flag=None, iters=(5, 8), cg_iters: int = 40):
        """FullInertialBA (Optimizer.cc:374-780, the loop closer's global BA
        of an inertial map, LoopClosing.cc:2397-2650): every valid
        keyframe's 15-D state, the whole preintegration chain and every
        landmark and observation, no caps, through kernel AA
        (``optim/vi_ba_cg.py``), or on a world of several ranks over
        observation shards through kernel AG (``parallel/dist_ba.py``).  The
        gather and the write-back hold ``map_lock``; the solve runs outside
        it and polls ``abort_flag`` between its segments (on several ranks
        once after it).  Keyframes made meanwhile follow the
        correction (``correct_new_since_snapshot``), their velocities turned
        with their poses, and an outlier observation is erased only where
        its slot still holds the landmark that was gathered.  Returns True
        when the solve completed (False: aborted, nothing to solve, or the
        map changed frame while it ran, ``n_ba_discarded``)."""
        w = world
        lock = map_lock if map_lock is not None else contextlib.nullcontext()
        with lock:
            epoch = w.frame_epoch
            gathered = self.full_inertial_problem(w, fixed_ids)
            if gathered is None:
                return False
            prob, kf_ids, fixed, lm_ids, obs_lm, kf_sel, slots = gathered
            K_snap, M_snap = w.n_kf, w.n_lm
            R_before, t_before = w.kf_R[:K_snap].copy(), w.kf_t[:K_snap].copy()
        if multihost.process_info()[1] > 1:
            mesh = multihost.global_mesh(self.device)
            run = dist_ba.get_distributed_vi_ba_cg(mesh, self.cam, self.bf, self.T_cb, iters[0], iters[1], cg_iters)
            R2, p2, v2, b2, xw2, inlier = run(dist_ba.shard_vi_problem(prob, mesh))
            aborted = abort_flag is not None and abort_flag.is_set()
        else:
            R2, p2, v2, b2, xw2, inlier, aborted = vi_ba_cg.full_inertial_ba_cg(
                self.cam, self.bf, self.T_cb, prob, iters1=iters[0], iters2=iters[1], cg_iters=cg_iters,
                abort_flag=abort_flag)
        if aborted:
            return False  # an aborted global BA is discarded (LoopClosing.cc:2412-2422)
        Rc, tc = camera_from_body(self.T_cb, R2, p2)
        Rc, tc, v2, b2, xw2, inl = (host(x) for x in (Rc, tc, v2, b2, xw2, inlier))
        with lock:
            if w.frame_epoch != epoch:  # the tracker turned and scaled the map while the solve ran
                self.n_ba_discarded += 1
                return False
            free = ~fixed
            w.kf_R[kf_ids[free]] = lie.normalize_rotation_np(Rc[free])
            w.kf_t[kf_ids[free]] = tc[free]
            w.kf_vel[kf_ids[free]] = v2[free]
            w.kf_bias[kf_ids[free]] = b2[free]
            w.lm_pos[lm_ids] = xw2
            # an outlier observation is erased where its slot still holds the gathered landmark: the map may
            # have changed it while the solve ran (the JAX package erases through the gathered slots unchecked)
            bad = ~inl
            kb, sb, lb = kf_sel[bad], slots[bad], lm_ids[obs_lm[bad]]
            still = w.kf_obs[kb, sb] == lb
            w.kf_obs[kb[still], sb[still]] = -1
            np.subtract.at(w.lm_n_obs, lb[still], 1)
            # keyframes made during the solve move with their parents' correction, their velocities turned
            # by the same rotation R_wk' R_kw (the JAX package leaves those velocities in the old frame)
            R_made = w.kf_R[K_snap:w.n_kf].copy()  # the new keyframes' rotations before the correction
            correct_new_since_snapshot(w, K_snap, M_snap, R_before, t_before)
            for i, k in enumerate(range(K_snap, w.n_kf)):
                if w.kf_valid[k]:
                    w.kf_vel[k] = (w.kf_R[k].T @ R_made[i]) @ w.kf_vel[k]
            w.change_index += 1
        return True
