"""Local mapping: landmark culling, new-landmark triangulation, neighbour
fusion, local BA, landmark statistics, descriptor refresh, keyframe
culling.

Counterpart of ``orb_slam3_fast_tpu/backend/mapper.py`` (LocalMapping::Run,
LocalMapping.cc:82-326), one synchronous pass per keyframe.  The map is the
host ``WorldMap``; the device work goes to the port's kernels: kernel C's
epipolar mode (``search_for_triangulation``) and window mode
(``search_by_projection``), kernel G (``triangulate_dlt``) and kernels E,
F and AC (``bundle_adjust``), and for the global BA of loop closing
(``_run_gba``) kernels E, T and AC (``optim/ba_cg.bundle_adjust_cg``).  Shapes
are padded as the JAX package pads them (``_bucket``, powers of two in
``_gather_problem``), so both packages see the same arrays.

Mono (``bf <= 0``): triangulation skips neighbours whose baseline is
below 1% of their median landmark depth, BA takes mono edges only, and
``initial_ba`` polishes the two-view map of mono initialisation.  A
keyframe culled here is erased from the keyframe database when one is
passed.  On the async backend (``backend/pipeline.py``) the mapper runs on
its worker thread and takes the backend's map lock around every change to
the map and every gather from it, never around a kernel: the local BA's
and the global BA's problems are gathered and written back under the lock
and solved outside it; the local BA is skipped when a newer keyframe
waits (``abort_flag``), and the global BA polls its abort flag between LM
segments, keyframes and landmarks made while it ran being carried along
by ``correct_new_since_snapshot``.  A solve whose map was turned and
scaled meanwhile (the tracker's IMU initialisation or scale refinement,
``WorldMap.frame_epoch``) is discarded, not written back in the old frame
(``n_ba_discarded``).  On a world of several ranks
(``parallel/multihost.py``) ``_run_gba(distributed=True)``, the loop
closer's global BA, shards the observations over the ranks and runs kernel
AF's CG run (``parallel/dist_ba.py``), and ``_run_ba(distributed=True)``
its dense run; each rank gathers the same problem and writes back the same
state.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass

import numpy as np
import torch

from orb_slam3_fast_tpu_torch import _kernels, native
from orb_slam3_fast_tpu_torch.cameras import models as cam_models
from orb_slam3_fast_tpu_torch.map.worldmap import WorldMap, popcount_words
from orb_slam3_fast_tpu_torch.ops import matching as mat
from orb_slam3_fast_tpu_torch.ops import twoview
from orb_slam3_fast_tpu_torch.ops.extractor import Keypoints
from orb_slam3_fast_tpu_torch.optim import ba, ba_cg
from orb_slam3_fast_tpu_torch.parallel import dist_ba, multihost
from orb_slam3_fast_tpu_torch.utils import lie, verbose
from orb_slam3_fast_tpu_torch.utils.timers import StageTimers


def _kf_keypoints(world: WorldMap, k: int, device) -> Keypoints:
    return Keypoints(
        xy=torch.as_tensor(world.kf_xy[k]).to(device),
        level=torch.as_tensor(world.kf_level[k]).long().to(device),
        angle=torch.as_tensor(world.kf_angle[k]).to(device),
        response=torch.zeros(world.kp_cap, device=device),
        desc=torch.as_tensor(world.kf_desc[k]).to(device),
        valid=torch.as_tensor(world.kf_kp_valid[k]).to(device),
    )


def _project_np(cam, xc: np.ndarray) -> np.ndarray:
    """Projection of host points with the host camera, in float32."""
    return cam_models.project(cam, torch.as_tensor(np.asarray(xc, np.float32))).numpy()


def _unproject_np(cam, uv: np.ndarray) -> np.ndarray:
    return cam_models.unproject(cam, torch.as_tensor(np.asarray(uv, np.float32))).numpy()


def compute_f12(world: WorldMap, cam, k1: int, k2: int) -> np.ndarray:
    """Fundamental matrix between two keyframes (GeometricTools::ComputeF12,
    GeometricTools.cc:28-47), pin-hole K: x_k1^T F x_k2 = 0, so F maps
    points of keyframe k2 to epipolar lines in k1.  A KB8 camera gets the
    pin-hole F of its K on the distorted pixels, as in the JAX package
    (its mapper.py:39-55): the epipolar search then misses true matches far
    off the optical axis, kept so that the fisheye rig's readings stay the
    JAX package's (ROADMAP §C)."""
    R1, t1 = world.kf_R[k1], world.kf_t[k1]
    R2, t2 = world.kf_R[k2], world.kf_t[k2]
    R12 = R1 @ R2.T
    t12 = -R12 @ t2 + t1
    tx = np.array([[0, -t12[2], t12[1]], [t12[2], 0, -t12[0]], [-t12[1], t12[0], 0]], dtype=np.float32)
    K = cam.K().numpy()
    Kinv = np.linalg.inv(K)
    return Kinv.T @ tx @ R12 @ Kinv


def correct_new_since_snapshot(world: WorldMap, K_snap: int, M_snap: int, R_before: np.ndarray,
                               t_before: np.ndarray):
    """Carry the keyframes and landmarks made while a global BA ran along
    with its correction (LoopClosing.cc:2443-2649, the spanning-tree walk
    with mTcwBefGBA): a new keyframe k keeps its pose relative to its parent
    p < k (the most covisible earlier keyframe, the latest on ties; k - 1
    without one), T_k' = T_k T_p^-1 T_p'; a new landmark keeps its position
    in its first keyframe's camera.  The caller holds the map lock."""
    old_R: dict[int, np.ndarray] = {}
    old_t: dict[int, np.ndarray] = {}
    for k in range(K_snap, world.n_kf):
        if not world.kf_valid[k]:
            continue
        counts = world.covisibility_counts(k)[:k]
        p = k - 1 - int(np.argmax(counts[::-1])) if len(counts) and counts.max() > 0 else k - 1
        p_R_old = R_before[p] if p < K_snap else old_R.get(p, world.kf_R[p])
        p_t_old = t_before[p] if p < K_snap else old_t.get(p, world.kf_t[p])
        R_k_old, t_k_old = world.kf_R[k].copy(), world.kf_t[k].copy()
        old_R[k], old_t[k] = R_k_old, t_k_old
        R_rel = R_k_old @ p_R_old.T
        t_rel = t_k_old - R_rel @ p_t_old
        world.kf_R[k] = lie.normalize_rotation_np(R_rel @ world.kf_R[p])
        world.kf_t[k] = R_rel @ world.kf_t[p] + t_rel
    new_lm = np.arange(M_snap, world.n_lm)
    new_lm = new_lm[world.lm_valid[new_lm]] if len(new_lm) else new_lm
    for m in new_lm:
        a = int(world.lm_first_kf[m])
        if a < 0:
            continue
        a_R_old = R_before[a] if a < K_snap else old_R.get(a)
        a_t_old = t_before[a] if a < K_snap else old_t.get(a)
        if a_R_old is None:
            continue
        xc = a_R_old @ world.lm_pos[m] + a_t_old
        world.lm_pos[m] = world.kf_R[a].T @ (xc - world.kf_t[a])


def _bucket(n: int, base: int = 256) -> int:
    """Round up to base * 2^k (the JAX package's stable jitted shapes)."""
    b = base
    while b < n:
        b *= 2
    return b


@dataclass
class MapperConfig:
    n_neighbors_tri: int = 10  # CreateNewMapPoints nn (LocalMapping.cc:423)
    ba_window: int = 12  # covisible KFs in local BA
    ba_fixed: int = 8  # fixed boundary KFs
    ba_lm_cap: int = 4096
    ba_obs_cap: int = 16384
    min_parallax_cos: float = 0.99996
    cull_found_ratio: float = 0.25  # MapPointCulling (LocalMapping.cc:388)
    recent_window: int = 3


class Mapper:
    def __init__(self, cam, bf: float, cfg: MapperConfig = MapperConfig(), sigma2: np.ndarray | None = None,
                 timers=None, device: torch.device | str = "cuda"):
        """``cam`` stays on the host (a CPU Camera); ``device`` is where the
        matchers, the triangulation and the BA run: the card unless the
        caller passes ``device="cpu"``.  ``bf`` is baseline * fx (virtual
        for RGB-D), 0 for mono."""
        self.cam = cam
        self.bf = float(bf)
        self.cfg = cfg
        self.device = _kernels.resolve_device(device)
        self.timers = timers if timers is not None else StageTimers()
        self.sigma2 = sigma2 if sigma2 is not None else (1.2 ** (2 * np.arange(8))).astype(np.float32)
        self.n_levels = len(self.sigma2)
        self.level_scales = np.sqrt(self.sigma2 / self.sigma2[0]).astype(np.float32)
        self.log_sf = float(np.log(self.level_scales[1])) if self.n_levels > 1 else 1.0
        self.recent_lm: list[np.ndarray] = []  # per recent keyframe: the landmark ids it created
        self.n_local_ba = 0
        self.n_ba_skipped = 0  # local BAs skipped because a newer keyframe waited
        self.n_ba_discarded = 0  # local and global BAs whose map changed frame while they were solved
        self.n_triangulated = 0

    def initial_ba(self, world: WorldMap, kf_ids):
        """Full BA of the two-view map of mono initialisation, the first
        keyframe fixed (CreateInitialMapMonocular -> GlobalBundleAdjustemnt,
        Tracking.cc:2433-2533)."""
        self._run_ba(world, np.asarray(kf_ids), fixed=np.asarray([kf_ids[0]]), iters=(8, 12))

    # ------------------------------------------------------------------
    def process_new_keyframe(self, world: WorldMap, k: int, kfdb=None, map_lock=None, abort_flag=None):
        """One LocalMapping::Run iteration for keyframe k; ``kfdb`` (a
        KeyFrameDatabase) loses the keyframes culled here.  ``map_lock``
        (the async backend's) is held around the map's changes;
        ``abort_flag`` set means a newer keyframe waits, and the local BA is
        skipped so that the queue drains (the reference aborts it midway,
        mbAbortBA, LocalMapping.cc:906)."""
        lock = map_lock if map_lock is not None else contextlib.nullcontext()
        with lock, self.timers.span("map_cull_landmarks"):
            self._cull_landmarks(world, k)
        with self.timers.span("map_triangulate"):
            created = self._triangulate_new(world, k, lock)
        with lock:
            self.recent_lm.append(created)
            if len(self.recent_lm) > self.cfg.recent_window:
                self.recent_lm.pop(0)
        with self.timers.span("map_fuse"):
            self._fuse_neighbors(world, k, lock)
        if abort_flag is None or not abort_flag.is_set():
            with self.timers.span("map_local_ba"):
                self._local_ba(world, k, map_lock=map_lock)
        else:
            self.n_ba_skipped += 1
        with lock:
            with self.timers.span("map_stats_cull_kf"):
                touched = np.unique(world.kf_obs[k][world.kf_obs[k] >= 0])
                world.update_landmark_stats(touched)
                self._refresh_descriptors(world, k)
                self._cull_keyframes(world, k, kfdb)

    # ------------------------------------------------------------------
    def _cull_keyframes(self, world: WorldMap, k: int, kfdb=None):
        """KeyFrameCulling (LocalMapping.cc:908-1050): a covisible keyframe
        is redundant if >= 90% of its landmarks are seen by at least 3 other
        keyframes at the same or a finer scale."""
        cand = world.best_covisible(k, 20, min_shared=5)
        K = world.n_kf
        n_culled = 0
        for c in cand:
            c = int(c)
            if c in (world.init_kf_ids or [0, 1]) or c == k or not world.kf_valid[c]:
                continue
            if c in world.kf_preint or (c + 1) in world.kf_preint:  # inertial chain members stay
                continue
            slots = np.nonzero(world.kf_obs[c] >= 0)[0]
            if len(slots) < 30:
                world.remove_keyframe(c)
                if kfdb is not None:
                    kfdb.erase(c)
                n_culled += 1
                continue
            lm = world.kf_obs[c, slots]
            lvl_c = world.kf_level[c, slots]
            other = np.nonzero(world.kf_valid[:K])[0]
            other = other[other != c]
            lm_to_i = -np.ones(world.max_lm, dtype=np.int32)
            lm_to_i[lm] = np.arange(len(lm))
            counts = native.redundancy_counts(
                world.kf_obs, world.kf_level, other.astype(np.int64), lm_to_i, lvl_c.astype(np.int32)
            )
            if counts is None:  # numpy fallback (no toolchain)
                obs_o = world.kf_obs[other]
                lvl_o = world.kf_level[other]
                counts = np.zeros(len(lm), dtype=np.int32)
                rows, cols = np.nonzero(obs_o >= 0)
                li = lm_to_i[obs_o[rows, cols]]
                ok = li >= 0
                rows, cols, li = rows[ok], cols[ok], li[ok]
                scale_ok = lvl_o[rows, cols] <= lvl_c[li] + 1
                np.add.at(counts, li[scale_ok], 1)
            if int((counts >= 3).sum()) > 0.9 * len(lm):
                world.remove_keyframe(c)
                if kfdb is not None:
                    kfdb.erase(c)
                n_culled += 1
            if n_culled >= 2:  # bound the culling work per keyframe
                break

    def _refresh_descriptors(self, world: WorldMap, k: int, max_obs: int = 8):
        """MapPoint::ComputeDistinctiveDescriptors (MapPoint.cc:372-441): the
        observation with the least median Hamming distance to the others,
        from the last ``max_obs`` observations, by XOR-popcount on packed
        words."""
        slots = np.nonzero(world.kf_obs[k] >= 0)[0]
        lm_ids = np.unique(world.kf_obs[k, slots])
        if len(lm_ids) == 0:
            return
        K = world.n_kf
        kfs, lml, ss = world.observations_of(lm_ids, np.arange(K))
        descs = np.zeros((len(lm_ids), max_obs, 8), dtype=np.int32)
        counts = np.zeros(len(lm_ids), dtype=np.int32)
        if len(kfs):
            # triplets are kf-major ascending: keep the last max_obs per landmark
            order = np.argsort(lml, kind="stable")
            lml_s, kfs_s, ss_s = lml[order], kfs[order], ss[order]
            group_end = np.searchsorted(lml_s, np.arange(len(lm_ids)), side="right")
            rank_from_end = group_end[lml_s] - 1 - np.arange(len(lml_s))
            keep = rank_from_end < max_obs
            descs[lml_s[keep], rank_from_end[keep]] = world.kf_desc[kfs_s[keep], ss_s[keep]]
            counts = np.minimum(np.bincount(lml_s[keep], minlength=len(lm_ids)).astype(np.int32), max_obs)
        have = counts > 0
        d = descs[have]
        ham = popcount_words(d[:, :, None, :] ^ d[:, None, :, :])  # (n, max_obs, max_obs)
        slot_ok = np.arange(max_obs)[None, :] < counts[have][:, None]
        big = 10_000
        ham = np.where(slot_ok[:, :, None] & slot_ok[:, None, :], ham, big)
        med = np.where(slot_ok, np.median(ham, axis=2), big)
        best = med.argmin(1)
        world.lm_desc[lm_ids[have]] = d[np.arange(have.sum()), best]

    # ------------------------------------------------------------------
    def _skip_neighbor(self, world: WorldMap, k: int, n: int) -> bool:
        """Too short a baseline to triangulate against neighbour n: below the
        stereo baseline, or (mono) below 1% of n's median landmark depth
        (ratioBaselineDepth, LocalMapping.cc:489)."""
        baseline = np.linalg.norm(world.camera_center(k) - world.camera_center(n))
        if self.bf > 0:
            return baseline < self.bf / float(self.cam.params[0])
        lm = world.kf_obs[n]
        lm = lm[lm >= 0]
        if len(lm) == 0:
            return True
        depths = (world.lm_pos[lm] @ world.kf_R[n][2]) + world.kf_t[n][2]
        med = np.median(depths[depths > 0]) if (depths > 0).any() else 1.0
        return baseline / max(med, 1e-6) < 0.01

    def _triangulate_new(self, world: WorldMap, k: int, lock=contextlib.nullcontext()) -> np.ndarray:
        """CreateNewMapPoints (LocalMapping.cc:414-729).  ``lock`` is held
        while the map is read and written, not while a kernel runs."""
        dev = self.device
        with lock:
            neighbors = world.best_covisible(k, self.cfg.n_neighbors_tri, min_shared=5)
            kp_k = _kf_keypoints(world, k, dev)
        sigma2 = torch.as_tensor(self.sigma2, dtype=torch.float32).to(dev)
        created = []
        cam = self.cam
        for n in neighbors:
            with lock:
                if self._skip_neighbor(world, k, n):
                    continue
                kp_n = _kf_keypoints(world, n, dev)
                F_kn = compute_f12(world, cam, n, k)  # points of k -> epipolar lines in n
                free_k = torch.as_tensor((world.kf_obs[k] < 0) & world.kf_kp_valid[k]).to(dev)
                free_n = torch.as_tensor((world.kf_obs[n] < 0) & world.kf_kp_valid[n]).to(dev)
            idx, accept = mat.search_for_triangulation(
                kp_k, kp_n, free_k, free_n, torch.as_tensor(F_kn, dtype=torch.float32).to(dev), sigma2
            )
            acc = accept.cpu().numpy()
            if acc.sum() == 0:
                continue
            slots_k = np.nonzero(acc)[0]
            slots_n = idx.cpu().numpy()[slots_k]
            nb = _bucket(len(slots_k))  # the JAX package's padding, kept so both see the same rows
            sk = np.zeros(nb, dtype=np.int64)
            sk[: len(slots_k)] = slots_k
            sn = np.zeros(nb, dtype=np.int64)
            sn[: len(slots_n)] = slots_n
            with lock:
                x_k = _unproject_np(cam, world.kf_xy[k, sk])[:, :2]
                x_n = _unproject_np(cam, world.kf_xy[n, sn])[:, :2]
                P_k = np.concatenate([world.kf_R[k], world.kf_t[k][:, None]], 1)
                P_n = np.concatenate([world.kf_R[n], world.kf_t[n][:, None]], 1)
            X = twoview.triangulate_dlt(
                *(torch.as_tensor(a, dtype=torch.float32).to(dev) for a in (P_k, P_n, x_k, x_n))
            ).cpu().numpy()[: len(slots_k)]
            with lock:
                ok = self._triangulation_gates(world, k, n, slots_k, slots_n, X)
                if ok.sum() == 0:
                    continue
                slots_k, slots_n, X = slots_k[ok], slots_n[ok], X[ok]
                ids = world.add_landmarks(X.astype(np.float32), world.kf_desc[k, slots_k], k, slots_k,
                                          world.kf_level[k, slots_k])
                world.add_observations(n, slots_n, ids)
            created.append(ids)
        created = np.concatenate(created) if created else np.zeros(0, dtype=np.int32)
        self.n_triangulated += len(created)
        return created

    def _triangulation_gates(self, world, k, n, slots_k, slots_n, X):
        """Finite, depth > 0.02 and reprojection chi2 in both keyframes,
        parallax, and scale consistency (LocalMapping.cc:690-712)."""
        ok = np.all(np.isfinite(X), axis=1)
        for kf, slots in ((k, slots_k), (n, slots_n)):
            xc = X @ world.kf_R[kf].T + world.kf_t[kf]
            ok &= xc[:, 2] > 0.02
            uv = _project_np(self.cam, xc)
            err2 = ((uv - world.kf_xy[kf, slots]) ** 2).sum(1)
            ok &= err2 <= 5.991 * self.sigma2[world.kf_level[kf, slots]]
        d_k = X - world.camera_center(k)[None]
        d_n = X - world.camera_center(n)[None]
        cosp = (d_k * d_n).sum(1) / np.maximum(np.linalg.norm(d_k, axis=1) * np.linalg.norm(d_n, axis=1), 1e-9)
        ok &= cosp < self.cfg.min_parallax_cos
        ratio_dist = np.linalg.norm(d_k, axis=1) / np.maximum(np.linalg.norm(d_n, axis=1), 1e-9)
        sf = float(self.level_scales[1]) if self.n_levels > 1 else 1.2
        ratio_octave = sf ** (
            world.kf_level[k, slots_k].astype(np.float32) - world.kf_level[n, slots_n].astype(np.float32)
        )
        ratio_factor = 1.5 * sf
        ok &= (ratio_dist < ratio_octave * ratio_factor) & (ratio_dist * ratio_factor > ratio_octave)
        return ok

    # ------------------------------------------------------------------
    def _fuse_neighbors(self, world: WorldMap, k: int, lock=contextlib.nullcontext()):
        """SearchInNeighbors (LocalMapping.cc:730-906): project k's landmarks
        into its neighbours and back; add missing observations, and merge
        duplicates keeping the landmark with more observations.  ``lock`` is
        held while the map is read and written, not while a kernel runs."""
        dev = self.device
        with lock:
            neighbors = world.best_covisible(k, 5, min_shared=5)
        scales = torch.as_tensor(self.level_scales).to(dev)
        for a, b in [(k, n) for n in neighbors] + [(n, k) for n in neighbors]:
            with lock:
                lm = world.kf_obs[a]
                lm_ids_raw = lm[lm >= 0]
                if len(lm_ids_raw) == 0:
                    continue
                nb = world.kp_cap  # pad to the keypoint capacity
                lm_ids = np.zeros(nb, dtype=np.int64)
                lm_ids[: len(lm_ids_raw)] = lm_ids_raw
                lm_mask = np.zeros(nb, dtype=bool)
                lm_mask[: len(lm_ids_raw)] = True
                R, t = world.kf_R[b], world.kf_t[b]
                xc = world.lm_pos[lm_ids] @ R.T + t
                infront = xc[:, 2] > 0.05
                uv = _project_np(self.cam, xc)
                kp_b = _kf_keypoints(world, b, dev)
                dist = np.linalg.norm(world.lm_pos[lm_ids] - world.camera_center(b), axis=1)
                ratio = np.maximum(world.lm_dmax[lm_ids] / np.maximum(dist, 1e-9), 1.0)
                pred_level = np.clip(np.ceil(np.log(ratio) / self.log_sf).astype(np.int32), 0, self.n_levels - 1)
                mask = torch.as_tensor(infront & world.lm_valid[lm_ids] & lm_mask).to(dev)
                desc = torch.as_tensor(world.lm_desc[lm_ids]).to(dev)
            idx, accept = mat.search_by_projection(
                kp_b, torch.as_tensor(uv).to(dev), mask, desc, torch.as_tensor(pred_level).long().to(dev), scales,
                radius=3.0, th_dist=50, ratio=1.0,
            )
            acc = accept.cpu().numpy()
            if not acc.any():
                continue
            tgt_slots = idx.cpu().numpy()[acc]
            src_lm = lm_ids[acc]
            with lock:
                existing = world.kf_obs[b, tgt_slots]
                fresh = existing < 0
                world.add_observations(b, tgt_slots[fresh], src_lm[fresh])
                dup = (~fresh) & (existing != src_lm)
                n_new = world.lm_n_obs[src_lm[dup]]
                n_old = world.lm_n_obs[existing[dup]]
                keeps = np.where(n_new >= n_old, src_lm[dup], existing[dup])
                drops = np.where(n_new >= n_old, existing[dup], src_lm[dup])
                world.replace_landmarks(list(zip(keeps, drops)))

    # ------------------------------------------------------------------
    def _cull_landmarks(self, world: WorldMap, k: int):
        """MapPointCulling (LocalMapping.cc:380-414): recent landmarks must
        keep found / visible >= 0.25 and reach 3 observations."""
        for age, ids in enumerate(reversed(self.recent_lm)):
            if len(ids) == 0:
                continue
            alive = ids[world.lm_valid[ids]]
            bad = world.lm_found[alive] / np.maximum(world.lm_visible[alive], 1) < self.cfg.cull_found_ratio
            if age >= 2:
                bad |= world.lm_n_obs[alive] < 3
            world.remove_landmarks(alive[bad])

    # ------------------------------------------------------------------
    def _local_ba(self, world: WorldMap, k: int, map_lock=None):
        """LocalBundleAdjustment window (Optimizer.cc:1109-1516): covisible
        keyframes free, their neighbours fixed, the origin keyframes always
        fixed (the gauge, Optimizer.cc:1224)."""
        with map_lock if map_lock is not None else contextlib.nullcontext():
            window, fixed = self._ba_window(world, k)
        self._run_ba(world, np.asarray(window + fixed), fixed=np.asarray(fixed), iters=(5, 10), map_lock=map_lock)

    def _ba_window(self, world: WorldMap, k: int):
        """The local BA's free and fixed keyframes of keyframe k."""
        window = [k] + list(world.best_covisible(k, self.cfg.ba_window - 1, min_shared=5))
        fixed = []
        for w in window:
            for c in world.best_covisible(w, 5, min_shared=5):
                if c not in window and c not in fixed:
                    fixed.append(c)
                if len(fixed) >= self.cfg.ba_fixed:
                    break
            if len(fixed) >= self.cfg.ba_fixed:
                break
        init_ids = [i for i in (world.init_kf_ids or [0]) if i < world.n_kf and world.kf_valid[i]]
        for g in init_ids:
            if g in window and len(window) > 1:
                window.remove(g)
            if g not in fixed and g not in window:
                fixed.append(g)
        if not fixed:
            # no boundary and the origin out of reach: fix the oldest keyframes
            oldest = sorted(window)[: min(2, len(window) - 1)] or [sorted(window)[0]]
            for g in oldest:
                window.remove(g)
                fixed.append(g)
        return window, fixed

    def _gather_problem(self, world: WorldMap, kf_ids, fixed, lm_cap=None, obs_cap=None, lock=None):
        """COO observation gather (under ``lock``) and power-of-two padding,
        as the JAX package pads; ``lm_cap`` / ``obs_cap`` None gather all.
        Returns (prob, lm_ids, obs_kf, obs_lm, slots, pose_fixed, n_o, the
        map's frame epoch at the gather) or None."""
        with lock if lock is not None else contextlib.nullcontext():
            epoch = world.frame_epoch
            lm_ids = world.local_landmarks(kf_ids)
            if len(lm_ids) == 0:
                return None
            if lm_cap is not None and len(lm_ids) > lm_cap:
                verbose.warn_cap("mapper.local_ba_landmarks", lm_cap, len(lm_ids))
                lm_ids = lm_ids[:lm_cap]
            obs_kf, obs_lm, slots = world.observations_of(lm_ids, kf_ids)
        if len(obs_kf) == 0:
            return None
        if obs_cap is not None and len(obs_kf) > obs_cap:
            verbose.warn_cap("mapper.local_ba_obs", obs_cap, len(obs_kf))
            sel = np.random.default_rng(0).choice(len(obs_kf), obs_cap, replace=False)
            obs_kf, obs_lm, slots = obs_kf[sel], obs_lm[sel], slots[sel]
        K = int(2 ** np.ceil(np.log2(max(len(kf_ids), 2))))
        M = int(2 ** np.ceil(np.log2(max(len(lm_ids), 256))))
        O = int(2 ** np.ceil(np.log2(max(len(obs_kf), 1024))))
        kf_pad = np.zeros(K, dtype=np.int64)
        kf_pad[: len(kf_ids)] = kf_ids
        lm_pad = np.zeros(M, dtype=np.int64)
        lm_pad[: len(lm_ids)] = lm_ids
        pose_fixed = np.ones(K, dtype=bool)
        pose_fixed[: len(kf_ids)] = np.isin(kf_ids, fixed)
        lm_valid = np.zeros(M, dtype=bool)
        lm_valid[: len(lm_ids)] = world.lm_valid[lm_ids]
        o_kf = np.zeros(O, dtype=np.int32)
        o_lm = np.zeros(O, dtype=np.int32)
        o_uv = np.full((O, 3), -1.0, dtype=np.float32)
        o_is2 = np.ones(O, dtype=np.float32)
        o_stereo = np.zeros(O, dtype=bool)
        o_valid = np.zeros(O, dtype=bool)
        n_o = len(obs_kf)
        o_kf[:n_o] = obs_kf
        o_lm[:n_o] = obs_lm
        kf_sel = kf_ids[obs_kf]
        o_uv[:n_o, :2] = world.kf_xy[kf_sel, slots]
        ru = world.kf_right_u[kf_sel, slots]
        use_stereo = (ru > 0) & (self.bf > 0)
        o_uv[:n_o, 2] = np.where(use_stereo, ru, -1.0)
        o_stereo[:n_o] = use_stereo
        o_is2[:n_o] = 1.0 / self.sigma2[world.kf_level[kf_sel, slots]]
        o_valid[:n_o] = True
        prob = ba.make_problem(
            world.kf_R[kf_pad], world.kf_t[kf_pad], pose_fixed, world.lm_pos[lm_pad], lm_valid, o_kf, o_lm, o_uv,
            o_is2, o_stereo, o_valid, device=self.device,
        )
        return prob, lm_ids, obs_kf, obs_lm, slots, pose_fixed, n_o, epoch

    @staticmethod
    def _read_back(kf_ids, lm_ids, n_o, R, t, xw, inlier):
        """The solved poses (projected to SO(3)), landmarks and inlier flags
        on the host; the caller holds no lock while the device finishes."""
        return (lie.normalize_rotation_np(R.cpu().numpy()[: len(kf_ids)]), t.cpu().numpy()[: len(kf_ids)],
                xw.cpu().numpy()[: len(lm_ids)], inlier.cpu().numpy()[:n_o])

    def _write_back(self, world: WorldMap, kf_ids, lm_ids, obs_kf, obs_lm, slots, pose_fixed, R_np, t_np, xw_np,
                    inl):
        """Write the free poses and the landmarks, and drop the outlier
        observations (Optimizer.cc:1398-1420)."""
        free = ~pose_fixed[: len(kf_ids)]
        world.kf_R[kf_ids[free]] = R_np[free]
        world.kf_t[kf_ids[free]] = t_np[free]
        world.lm_pos[lm_ids] = xw_np
        bad = ~inl
        world.kf_obs[kf_ids[obs_kf[bad]], slots[bad]] = -1
        np.subtract.at(world.lm_n_obs, lm_ids[obs_lm][bad], 1)
        world.change_index += 1  # Map::IncreaseChangeIndex (Map.cc:306)

    def _stale(self, world: WorldMap, epoch: int) -> bool:
        """Whether the map changed frame since a gather at ``epoch`` (the
        caller holds the lock); such a solve is counted and discarded."""
        if world.frame_epoch == epoch:
            return False
        self.n_ba_discarded += 1
        return True

    def _mesh(self):
        """The ranks' mesh on this mapper's device where the world has
        several ranks, else None."""
        return multihost.global_mesh(self.device) if multihost.process_info()[1] > 1 else None

    def _run_ba(self, world: WorldMap, kf_ids: np.ndarray, fixed: np.ndarray, iters=(5, 10), map_lock=None,
                distributed: bool = False):
        """The problem gathered and written back under ``map_lock``, solved
        (kernels E, F and AC) outside it; discarded where the map changed
        frame meanwhile.  ``distributed`` on a world of several ranks shards
        the observations over them (kernel AF's dense run, F on the
        gathered W)."""
        lock = map_lock if map_lock is not None else contextlib.nullcontext()
        got = self._gather_problem(world, kf_ids, fixed, lm_cap=self.cfg.ba_lm_cap, obs_cap=self.cfg.ba_obs_cap,
                                   lock=lock)
        if got is None:
            return
        prob, lm_ids, obs_kf, obs_lm, slots, pose_fixed, n_o, epoch = got
        mesh = self._mesh() if distributed else None
        if mesh is not None:
            run = dist_ba.get_distributed_ba(mesh, self.cam, self.bf, *iters)
            R, t, xw, inlier, _ = run(dist_ba.shard_problem(prob, mesh, whole=True))
        else:
            R, t, xw, inlier = ba.bundle_adjust(self.cam, self.bf, prob, iters1=iters[0], iters2=iters[1])
        solved = self._read_back(kf_ids, lm_ids, n_o, R, t, xw, inlier)
        with lock:
            if self._stale(world, epoch):
                return
            self._write_back(world, kf_ids, lm_ids, obs_kf, obs_lm, slots, pose_fixed, *solved)
        self.n_local_ba += 1

    def _run_gba(self, world: WorldMap, kf_ids: np.ndarray, fixed: np.ndarray, iters=(8, 12), map_lock=None,
                 abort_flag=None, distributed: bool = False, cg_iters: int = 32) -> bool:
        """Global BA over every given keyframe, all their landmarks and every
        observation, with no cap (Optimizer::GlobalBundleAdjustemnt,
        Optimizer.cc:47-373), through kernels E, T and AC
        (``ba_cg.bundle_adjust_cg``, host segments with ``abort_flag`` polled
        between them); never through kernel F, whose reduced system holds at
        most ``ba.MAX_POSES`` poses.  ``map_lock`` is held while the problem
        is gathered and written back, not while it is solved.  Keyframes and
        landmarks made meanwhile follow through ``correct_new_since_snapshot``.
        ``distributed`` on a world of several ranks shards the observations
        over them (kernel AF's CG run, ``parallel/dist_ba.py``), the abort
        flag then read once after the solve (the JAX package's
        ``mapper.py:674-675``); on one rank it changes nothing.  Returns
        True when the BA ran to its end and was written back (an aborted
        one is discarded, LoopClosing.cc:2412-2422, and so is one whose map
        changed frame meanwhile)."""
        lock = map_lock if map_lock is not None else contextlib.nullcontext()
        got = self._gather_problem(world, kf_ids, fixed, lock=lock)
        if got is None:
            return False
        prob, lm_ids, obs_kf, obs_lm, slots, pose_fixed, n_o, epoch = got
        with lock:
            K_snap, M_snap = world.n_kf, world.n_lm
            R_before, t_before = world.kf_R[:K_snap].copy(), world.kf_t[:K_snap].copy()
        mesh = self._mesh() if distributed else None
        if mesh is not None:
            run = dist_ba.get_distributed_ba_cg(mesh, self.cam, self.bf, *iters, cg_iters=cg_iters)
            R, t, xw, inlier, _ = run(dist_ba.shard_problem(prob, mesh))
            aborted = abort_flag is not None and abort_flag.is_set()
        else:
            R, t, xw, inlier, aborted = ba_cg.bundle_adjust_cg(self.cam, self.bf, prob, iters1=iters[0],
                                                               iters2=iters[1], cg_iters=cg_iters,
                                                               abort_flag=abort_flag)
        if aborted:
            return False
        solved = self._read_back(kf_ids, lm_ids, n_o, R, t, xw, inlier)
        with lock:
            if self._stale(world, epoch):
                return False
            self._write_back(world, kf_ids, lm_ids, obs_kf, obs_lm, slots, pose_fixed, *solved)
            correct_new_since_snapshot(world, K_snap, M_snap, R_before, t_before)
        return True
