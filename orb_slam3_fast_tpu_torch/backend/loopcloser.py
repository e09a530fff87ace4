"""Loop closing: place-recognition candidates -> Sim3 verification -> loop
correction -> essential graph -> global BA; and the merge of the active map
into a stored one.

Counterpart of ``orb_slam3_fast_tpu/backend/loopcloser.py`` (the reference's
LoopClosing thread, run synchronously per keyframe):

* NewDetectCommonRegions (LoopClosing.cc:345-578) ->
  :meth:`LoopCloser.process_keyframe`: keyframe-database candidates,
  geometric verification, the consistency count over covisibility groups,
  and the DetectAndReffineSim3FromLastKF fast path (:580-641);
* DetectCommonRegionsFromBoW (:643-986) -> :meth:`_verify`: the mutual
  descriptor match (kernel C), ``sim3_ransac`` (kernel Q),
  ``_search_by_sim3`` (kernel C's window mode), ``optimize_sim3`` (kernel R)
  and the guided projection gate;
* CorrectLoop (:1063-1345) -> :meth:`_correct`: Sim3 propagation over the
  covisible window, ``correct_landmarks``, the duplicate fusion, the
  essential graph (``optimize_sim3_graph``: kernel S, kernel U above 128
  keyframes; an inertial map's 4-DoF graph, ``optimize_4dof_graph``:
  kernel Z, OptimizeEssentialGraph4DoF) and the global BA
  (``Mapper._run_gba``: kernels E and T; an inertial map's FullInertialBA,
  ``inertial_gba``: kernel AA);
* MergeLocal (:1347-1930) -> :meth:`_merge`: ``Atlas.merge_into``, the
  welding-window fusion, a local BA (kernels E and F) and, for an inertial
  map, MergeInertialBA (``merge_inertial_ba``, falling back to
  ``inertial_ba`` when it finds no window: kernel Y).

The map stays on the host; matching and the solvers run on ``device`` (the
mapper's).  On the async backend (``backend/pipeline.py``) this runs on
its worker thread after the mapper, and ``gba_hook``, set by the backend,
hands the global BA to its GBA thread; without a backend the global BA
runs inline.  The inertial hooks (``inertial_ba``, ``inertial_gba``,
``merge_inertial_ba``) are the inertial tracker's, wired by the System.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from orb_slam3_fast_tpu_torch import native
from orb_slam3_fast_tpu_torch.backend.mapper import _kf_keypoints, _project_np
from orb_slam3_fast_tpu_torch.map.worldmap import WorldMap
from orb_slam3_fast_tpu_torch.ops import matching as mat
from orb_slam3_fast_tpu_torch.optim import pose_graph as pg
from orb_slam3_fast_tpu_torch.optim import sim3 as sim3_mod
from orb_slam3_fast_tpu_torch.utils import lie, verbose
from orb_slam3_fast_tpu_torch.utils.timers import StageTimers


@dataclass
class LoopCloserConfig:
    n_candidates: int = 3  # DetectNBestCandidates(.., 3) (LoopClosing.cc:519)
    min_bow_matches: int = 20  # nBoWMatches (LoopClosing.cc:655)
    min_sim3_inliers: int = 20  # nSim3Inliers after OptimizeSim3 (:658)
    min_proj_matches: int = 50  # nProjMatches guided re-search (:657)
    min_covis_edge: int = 30  # essential-graph covisibility weight (ref. 100)
    temporal_gap: int = 10  # a candidate must be at least this many keyframes old
    # consecutive keyframes whose verified candidates share a covisibility
    # group before a loop is accepted (LoopClosing.cc:345-578)
    consecutive_required: int = 3
    fix_scale: bool = False  # stereo / RGB-D: 6-DoF instead of 7
    # DetectAndReffineSim3FromLastKF (LoopClosing.cc:580-641): re-confirm the
    # previous keyframe's candidate by projection through the propagated Sim3
    use_refine_from_last: bool = True
    run_gba: bool = True
    gba_iters: tuple = (8, 12)
    pose_graph_iters: int = 12


def _host_sim3(S: lie.Sim3) -> lie.Sim3:
    """S as float32 CPU tensors (a host read where S lives on the card)."""
    return lie.Sim3(*(torch.as_tensor(x).detach().to("cpu", torch.float32) for x in S))


def _apply_np(S: lie.Sim3, x: np.ndarray) -> np.ndarray:
    return S.apply(torch.as_tensor(np.asarray(x, np.float32))).numpy()


def _sim3_of(R, t, s=1.0) -> lie.Sim3:
    f32 = torch.float32
    return lie.Sim3(torch.as_tensor(np.asarray(R), dtype=f32), torch.as_tensor(np.asarray(t), dtype=f32),
                    torch.tensor(float(s), dtype=f32))


class LoopCloser:
    def __init__(self, cam, voc, kfdb, mapper, bf: float = 0.0, cfg: LoopCloserConfig = LoopCloserConfig(),
                 sigma2: np.ndarray | None = None, timers=None):
        """``cam`` stays on the host; the matchers and solvers run on the
        mapper's device."""
        self.cam = cam
        self.voc = voc
        self.kfdb = kfdb
        self.mapper = mapper
        self.bf = float(bf)
        self.cfg = cfg
        self.device = mapper.device
        self.timers = timers if timers is not None else StageTimers()
        self.sigma2 = sigma2 if sigma2 is not None else (1.2 ** (2 * np.arange(8))).astype(np.float32)
        self.consec_count = 0
        self.last_candidate = -1
        self.last_group: set = set()
        self.last_S = None  # the last verified Sim3 (host) and the keyframe it anchored
        self.last_verified_kf = -1
        self.n_loops_closed = 0
        self.n_maps_merged = 0
        # the inertial hooks, wired by the inertial System: the tracker's windowed
        # VI-BA ``inertial_ba(world, k, window=None)``, FullInertialBA
        # ``inertial_gba(world, fixed_ids, map_lock=, abort_flag=) -> bool`` and
        # MergeInertialBA ``merge_inertial_ba(world, k_new, c2)`` (None: no window)
        self.inertial_ba = None
        self.inertial_gba = None
        self.merge_inertial_ba = None
        # AsyncBackend.request_gba, set by the async backend; None runs the global BA inline
        self.gba_hook = None

    # ------------------------------------------------------------------
    def process_keyframe(self, world: WorldMap, k: int, map_id: int = 0, atlas=None):
        """One LoopClosing::Run iteration for keyframe k.  Returns False,
        ("loop", None) when a loop in the active map was closed, or
        ("merge", info) when the active map was welded into a stored one
        (info: the id offsets and the Sim3, for the tracker to rebase)."""
        if world.n_kf < self.cfg.temporal_gap + 2:
            return False

        def row_of(local):  # keyframe-database rows are global under an Atlas
            return atlas.register_kf(map_id, int(local)) if atlas is not None else int(local)

        bow = self.kfdb.dense_row(row_of(k))
        covis = world.best_covisible(k, 30, min_shared=5)
        recent = np.arange(max(0, k - self.cfg.temporal_gap), world.n_kf)  # a loop must be distant
        exclude = np.unique(np.asarray([row_of(c) for c in np.concatenate([covis, recent, [k]])]))

        def groups_fn(row):
            # the covisibility group of one candidate row, built when asked
            mid, local = atlas.resolve_row(row) if atlas is not None else (map_id, row)
            wm = world if mid == map_id else atlas.maps[mid]
            if wm is None:
                return np.zeros(0, np.int64)
            g = wm.best_covisible(int(local), 10, min_shared=5)
            if atlas is not None:
                return np.asarray([atlas.register_kf(mid, int(c)) for c in g])
            return g

        with self.timers.span("loop_detect"):
            refined = None
            if (self.cfg.use_refine_from_last and self.consec_count > 0 and self.last_candidate >= 0
                    and world.kf_valid[self.last_candidate]):
                refined = self._refine_from_last(world, k, world, self.last_candidate)
            if refined is not None:
                loop_c = np.asarray([self.last_candidate], np.int64)
                merge_c = np.zeros(0, np.int64)
                resolve_rows = False
            else:
                loop_c, merge_c = self.kfdb.detect_n_best_candidates(
                    bow, exclude, self.cfg.n_candidates, covis_groups=groups_fn, query_map=map_id,
                )
                resolve_rows = True
        for c in loop_c:
            c = int(c)
            if resolve_rows and atlas is not None:
                _, c = atlas.resolve_row(c)
            if not world.kf_valid[c]:
                continue
            if refined is not None and c == self.last_candidate:
                out = refined
            else:
                with self.timers.span("loop_verify"):
                    out = self._verify(world, k, world, c)
            if out is None:
                continue
            S_kc, n_inl = out
            # temporal consistency over covisibility groups (LoopClosing.cc:345-578)
            group = set(int(g) for g in world.best_covisible(c, 10, min_shared=5)) | {c}
            if self.last_group and (group & self.last_group):
                self.consec_count += 1
            else:
                self.consec_count = 1
            self.last_group = group
            self.last_candidate = c
            self.last_S = S_kc
            self.last_verified_kf = k
            if self.consec_count >= self.cfg.consecutive_required:
                with self.timers.span("loop_correct"):
                    self._correct(world, k, c, S_kc)
                self.consec_count = 0
                self.last_group = set()
                self.last_candidate = -1
                self.last_S = None
                self.last_verified_kf = -1
                self.n_loops_closed += 1
                verbose.print_mess(f"Loop detected and closed: KF {k} <-> KF {c}", verbose.VERBOSITY_NORMAL)
                return ("loop", None)
        # cross-map merge candidates (MergeLocal, LoopClosing.cc:1347)
        if atlas is not None:
            for row in merge_c:
                mid2, c2 = atlas.resolve_row(int(row))
                world2 = atlas.maps[mid2]
                if world2 is None or not world2.kf_valid[c2]:
                    continue
                with self.timers.span("loop_verify"):
                    out = self._verify(world, k, world2, c2)
                if out is None:
                    continue
                S_kc, n_inl = out
                with self.timers.span("loop_merge"):
                    info = self._merge(atlas, world, k, map_id, world2, c2, mid2, S_kc)
                self.n_maps_merged += 1
                verbose.print_mess(f"Map {map_id} merged into map {mid2} (weld KF {k} <-> {c2})",
                                   verbose.VERBOSITY_NORMAL)
                return ("merge", info)
        return False

    # ------------------------------------------------------------------
    def _merge(self, atlas, world, k, src_id, world2, c2, dst_id, S_kc):
        """Weld the active map into the matched stored map (MergeLocal,
        LoopClosing.cc:1347-1930): transplant the arrays by the world-to-world
        Sim3, fuse duplicates in the welding window, local BA of the weld."""
        # x_dst = T_c2w2^-1 o S_kc^-1 o T_c1w1 (x_src)
        S_kc = _host_sim3(S_kc)
        T_c1w1 = _sim3_of(world.kf_R[k], world.kf_t[k])
        T_c2w2 = _sim3_of(world2.kf_R[c2], world2.kf_t[c2])
        S_w2w1 = T_c2w2.inverse().compose(S_kc.inverse()).compose(T_c1w1)
        info = atlas.merge_into(src_id, dst_id, S_w2w1, kfdb=self.kfdb)
        dst = atlas.current
        k_new = k + info["kf_offset"]
        self._fuse_loop(dst, k_new, c2)
        touched = np.unique(dst.kf_obs[k_new][dst.kf_obs[k_new] >= 0])
        dst.update_landmark_stats(touched)
        self.mapper._local_ba(dst, k_new)
        # MergeLocal2 / MergeInertialBA (LoopClosing.cc:1932, Optimizer.cc:3996): an inertial map's weld is
        # rigid (_verify fixed the scale) and the 6+6 welding window is re-optimised with each side's chain;
        # where that finds no window the newest keyframes' temporal window is (the JAX package skips the
        # fallback once merge_inertial_ba is set, and so leaves such a weld without an inertial BA)
        if dst.imu_initialized:
            done = self.merge_inertial_ba(dst, k_new, c2) if self.merge_inertial_ba is not None else None
            if done is None and self.inertial_ba is not None:
                self.inertial_ba(dst, k_new)
        info["S_dst_src"] = S_w2w1
        info["dst_id"] = dst_id
        info["src_id"] = src_id
        return info

    # ------------------------------------------------------------------
    def _level_tables(self):
        """(levels, per-level scale, log(scale factor)) from sigma2."""
        n_lvl = len(self.sigma2)
        lvl_scales = np.sqrt(self.sigma2 / self.sigma2[0]).astype(np.float32)
        log_sf = float(np.log(lvl_scales[1])) if n_lvl > 1 else 1.0
        return n_lvl, lvl_scales, log_sf

    def _dev(self, a, dtype=None) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), dtype=dtype).to(self.device)

    def _search_proj(self, wb: WorldMap, b: int, uv, mask, desc, pred_level, radius: float, th_dist: int):
        """Kernel C's window mode over keyframe b's keypoints; returns host
        (idx, accept)."""
        scales = self._dev(self._level_tables()[1])
        idx, accept = mat.search_by_projection(
            _kf_keypoints(wb, b, self.device), self._dev(uv, torch.float32), self._dev(mask), self._dev(desc),
            self._dev(pred_level, torch.int64), scales, radius=radius, th_dist=th_dist, ratio=1.0,
        )
        return idx.cpu().numpy(), accept.cpu().numpy()

    def _pred_level(self, dmax, dist):
        n_lvl, _, log_sf = self._level_tables()
        ratio = np.maximum(dmax / np.maximum(dist, 1e-9), 1.0)
        return np.clip(np.ceil(np.log(ratio) / log_sf).astype(np.int32), 0, n_lvl - 1)

    # ------------------------------------------------------------------
    def _matched_pairs(self, world: WorldMap, k: int, world_c: WorldMap, c: int):
        """Mutual descriptor match restricted to landmark-bearing keypoints
        (the stand-in for SearchByBoW(KF, KF), ORBmatcher.cc:766-884);
        ``world_c`` may be another Atlas map."""
        has_k = (world.kf_obs[k] >= 0) & world.kf_kp_valid[k]
        has_c = (world_c.kf_obs[c] >= 0) & world_c.kf_kp_valid[c]
        idx, accept = mat.search_descriptors_mutual(
            self._dev(world.kf_desc[k]), self._dev(has_k), self._dev(world_c.kf_desc[c]), self._dev(has_c),
            th=100, ratio=0.9,
        )
        acc = accept.cpu().numpy()
        slots_k = np.nonzero(acc)[0]
        slots_c = idx.cpu().numpy()[slots_k]
        lm_k = world.kf_obs[k, slots_k]
        lm_c = world_c.kf_obs[c, slots_c]
        good = world.lm_valid[lm_k] & world_c.lm_valid[lm_c]
        return slots_k[good], slots_c[good], lm_k[good], lm_c[good]

    def _pack_pairs(self, world, k, world_c, c, slots_k, slots_c, lm_k, lm_c):
        """Camera-frame point pairs and their pixels, padded to kp_cap
        (Sim3Solver's input, Sim3Solver.cc:66)."""
        n = world.kp_cap
        xc1 = np.zeros((n, 3), np.float32)
        xc2 = np.zeros((n, 3), np.float32)
        uv1 = np.zeros((n, 2), np.float32)
        uv2 = np.zeros((n, 2), np.float32)
        is1 = np.ones(n, np.float32)
        is2 = np.ones(n, np.float32)
        valid = np.zeros(n, bool)
        m = min(len(slots_k), n)
        slots_k, slots_c, lm_k, lm_c = slots_k[:m], slots_c[:m], lm_k[:m], lm_c[:m]
        xc1[:m] = world.lm_pos[lm_k] @ world.kf_R[k].T + world.kf_t[k]
        xc2[:m] = world_c.lm_pos[lm_c] @ world_c.kf_R[c].T + world_c.kf_t[c]
        uv1[:m] = world.kf_xy[k, slots_k]
        uv2[:m] = world_c.kf_xy[c, slots_c]
        is1[:m] = 1.0 / self.sigma2[world.kf_level[k, slots_k]]
        is2[:m] = 1.0 / self.sigma2[world_c.kf_level[c, slots_c]]
        valid[:m] = True
        return tuple(self._dev(a) for a in (xc1, xc2, uv1, uv2, is1, is2, valid))

    def _search_by_sim3(self, world, k, world_c, c, S_kc):
        """ORBmatcher::SearchBySim3 (ORBmatcher.cc:1417-1512): each keyframe's
        landmarks projected into the other through the Sim3 (kernel C's window
        mode, radius 7.5), the mutually agreeing pairs kept.  The pair loop
        is host Python, as in the JAX package."""
        S_kc = _host_sim3(S_kc)
        dirs = []
        for wa, a, wb, b, S in ((world_c, c, world, k, S_kc), (world, k, world_c, c, S_kc.inverse())):
            obs = wa.kf_obs[a]
            has = (obs >= 0) & wa.kf_kp_valid[a]
            lm = np.where(has, obs, 0)
            has &= wa.lm_valid[lm]
            xca = wa.lm_pos[lm] @ wa.kf_R[a].T + wa.kf_t[a]
            xcb = _apply_np(S, xca)
            uv = _project_np(self.cam, xcb)
            pred_level = self._pred_level(wa.lm_dmax[lm], np.linalg.norm(xcb, axis=1))
            dirs.append(self._search_proj(wb, b, uv, has & (xcb[:, 2] > 0.05), wa.lm_desc[lm], pred_level,
                                          radius=7.5, th_dist=100))  # th = 7.5 (ORBmatcher.cc:1447)
        (idx1, acc1), (idx2, acc2) = dirs  # 1: c-slot -> k-slot, 2: k-slot -> c-slot
        pairs_k, pairs_c = [], []
        for j in np.nonzero(acc1)[0]:
            i = int(idx1[j])
            if acc2[i] and int(idx2[i]) == int(j):  # mutual agreement (:1500)
                pairs_k.append(i)
                pairs_c.append(int(j))
        if not pairs_k:
            return None
        sk = np.asarray(pairs_k, np.int64)
        sc = np.asarray(pairs_c, np.int64)
        return sk, sc, world.kf_obs[k, sk], world_c.kf_obs[c, sc]

    def _fix_scale(self, world) -> bool:
        return self.cfg.fix_scale or bool(world.imu_initialized)

    def _refine_from_last(self, world: WorldMap, k: int, world_c: WorldMap, c: int):
        """DetectAndReffineSim3FromLastKF (LoopClosing.cc:580-641): the last
        verified Sim3 propagated through the motion since its keyframe,
        re-matched by projection (>= 30, :598), OptimizeSim3 (kernel R), and a
        stricter projection gate (>= 100, :640); skips the database query and
        the RANSAC.  Returns (S, n_inliers) or None."""
        if self.last_S is None or self.last_verified_kf < 0:
            return None
        lk = self.last_verified_kf
        if not world.kf_valid[lk]:
            return None
        R_rel = world.kf_R[k] @ world.kf_R[lk].T
        t_rel = world.kf_t[k] - R_rel @ world.kf_t[lk]
        S_guess = _sim3_of(R_rel, t_rel).compose(_host_sim3(self.last_S))
        extra = self._search_by_sim3(world, k, world_c, c, S_guess)
        if extra is None or len(extra[0]) < 30:  # nNumProjMatches (:598)
            return None
        pairs = self._pack_pairs(world, k, world_c, c, *extra)
        S0 = lie.Sim3(*(x.to(self.device) for x in S_guess))
        S, _, n_inl = sim3_mod.optimize_sim3(self.cam, self.cam, S0, *pairs, fix_scale=self._fix_scale(world))
        if int(n_inl) < self.cfg.min_sim3_inliers:
            return None
        if self._guided_projection_count(world, k, world_c, c, S) < 2 * self.cfg.min_proj_matches:  # 100 (:640)
            return None
        return S, int(n_inl)

    def _verify(self, world: WorldMap, k: int, world_c: WorldMap, c: int):
        """Geometric verification: Sim3 RANSAC (kernel Q), SearchBySim3
        densification, OptimizeSim3 (kernel R) and the guided projection
        gate.  Returns (S_kc, n_inliers) or None.  The scale is fixed for
        stereo / RGB-D (LoopClosing.cc:651 bFixedScale)."""
        cfg = self.cfg
        fix_scale = self._fix_scale(world)
        slots_k, slots_c, lm_k, lm_c = self._matched_pairs(world, k, world_c, c)
        if len(slots_k) < cfg.min_bow_matches:
            return None
        pairs = self._pack_pairs(world, k, world_c, c, slots_k, slots_c, lm_k, lm_c)
        # the JAX package's PRNGKey(k * 2654435761 + c) keeps the key's low word
        res = sim3_mod.sim3_ransac(self.cam, self.cam, *pairs, sim3_mod.jax_seed(k * 2654435761 + c),
                                   fix_scale=fix_scale)
        if not bool(res.ok):
            return None
        # densify through the RANSAC Sim3, union with the BoW pairs; OptimizeSim3's
        # re-gate arbitrates (it receives every match, as vpMatches1 does)
        inliers = res.inliers
        extra = self._search_by_sim3(world, k, world_c, c, res.S12)
        if extra is not None:
            # skip features that already have a match (ORBmatcher.cc:1425-1433)
            known_k, known_c = set(slots_k.tolist()), set(slots_c.tolist())
            fresh = [i for i, (sk, sc) in enumerate(zip(extra[0].tolist(), extra[1].tolist()))
                     if sk not in known_k and sc not in known_c]
            if fresh:
                slots_k = np.concatenate([slots_k, extra[0][fresh]])
                slots_c = np.concatenate([slots_c, extra[1][fresh]])
                lm_k = np.concatenate([lm_k, extra[2][fresh]])
                lm_c = np.concatenate([lm_c, extra[3][fresh]])
                pairs = self._pack_pairs(world, k, world_c, c, slots_k, slots_c, lm_k, lm_c)
                inliers = pairs[-1]
        S, _, n_inl = sim3_mod.optimize_sim3(self.cam, self.cam, res.S12, *pairs[:-1], inliers, fix_scale=fix_scale)
        if int(n_inl) < cfg.min_sim3_inliers:
            return None
        # guided projection gate: the loop side's local map through the
        # corrected pose into keyframe k (SearchByProjection(KF, Scw), :406-506)
        if self._guided_projection_count(world, k, world_c, c, S) < cfg.min_proj_matches:
            return None
        return S, int(n_inl)

    def _padded_landmarks(self, ids_raw: np.ndarray, nb: int, label: str):
        lm_ids = np.zeros(nb, dtype=np.int64)
        take = min(len(ids_raw), nb)
        if take < len(ids_raw):
            verbose.warn_cap(label, take, len(ids_raw))
        lm_ids[:take] = ids_raw[:take]
        lm_mask = np.zeros(nb, bool)
        lm_mask[:take] = True
        return lm_ids, lm_mask

    def _guided_projection_count(self, world: WorldMap, k: int, world_c: WorldMap, c: int, S_kc) -> int:
        window = np.unique(np.concatenate([[c], world_c.best_covisible(c, 10, min_shared=5)]))
        lm_ids_raw = world_c.local_landmarks(window)
        if len(lm_ids_raw) == 0:
            return 0
        lm_ids, lm_mask = self._padded_landmarks(lm_ids_raw, world.kp_cap, "loopcloser.guided_projection_lms")
        # S_cw maps world -> c camera; the corrected k camera is S_kc T_cw
        S_kw = _host_sim3(S_kc).compose(_sim3_of(world_c.kf_R[c], world_c.kf_t[c]))
        xc = _apply_np(S_kw, world_c.lm_pos[lm_ids])
        uv = _project_np(self.cam, xc)
        center = (-S_kw.R.T @ (S_kw.t / S_kw.s)).numpy()
        pred_level = self._pred_level(world_c.lm_dmax[lm_ids], np.linalg.norm(world_c.lm_pos[lm_ids] - center, axis=1))
        _, accept = self._search_proj(world, k, uv, (xc[:, 2] > 0.05) & world_c.lm_valid[lm_ids] & lm_mask,
                                      world_c.lm_desc[lm_ids], pred_level, radius=8.0, th_dist=100)
        return int(accept.sum())

    # ------------------------------------------------------------------
    def _correct(self, world: WorldMap, k: int, c: int, S_kc):
        """CorrectLoop (LoopClosing.cc:1063-1345) over the K keyframes the
        map holds when it starts.  On the async backend the tracker may add
        keyframes meanwhile; they keep their poses, where the JAX package
        reads the count again in the essential graph and indexes past its
        K-row arrays (an IndexError of its own worker, on the CPU)."""
        cfg = self.cfg
        K = world.n_kf
        R_old = world.kf_R[:K].copy()
        t_old = world.kf_t[:K].copy()
        s_old = np.ones(K, np.float32)
        # the corrected pose of k: S_kw = S_kc T_cw (mg2oScw, :1095-1134)
        S = _host_sim3(S_kc)
        S_R, S_t, S_s = S.R.numpy(), S.t.numpy(), float(S.s)
        S_kw_R = S_R @ R_old[c]
        S_kw_t = S_s * (S_R @ t_old[c]) + S_t
        S_kw_s = S_s
        # propagate over k's covisible window (:1136-1218): S_nw' = S_nk S_kw'
        window = np.unique(np.concatenate([[k], world.best_covisible(k, 30, min_shared=5)]))
        window = window[window < K]
        R_init, t_init, s_init = R_old.copy(), t_old.copy(), s_old.copy()
        for n in window:
            R_nk = R_old[n] @ R_old[k].T
            t_nk = t_old[n] - R_nk @ t_old[k]
            R_init[n] = R_nk @ S_kw_R
            t_init[n] = S_kw_s * (R_nk @ S_kw_t) + t_nk
            s_init[n] = S_kw_s
        # the window's landmarks move with their first observing window keyframe (:1164-1218)
        win_lms = world.local_landmarks(window)
        if len(win_lms):
            anchor = np.full(len(win_lms), -1, np.int64)
            lm_to_i = {int(m): i for i, m in enumerate(win_lms)}
            for n in window:  # host Python, as in the JAX package
                obs = world.kf_obs[n]
                for m in obs[obs >= 0]:
                    i = lm_to_i.get(int(m))
                    if i is not None and anchor[i] < 0:
                        anchor[i] = n
            ok = anchor >= 0
            T = torch.as_tensor
            world.lm_pos[win_lms[ok]] = pg.correct_landmarks(
                T(world.lm_pos[win_lms[ok]]), T(anchor[ok]), T(R_old), T(t_old), T(s_old), T(R_init), T(t_init),
                T(s_init),
            ).numpy()
        # the corrected window poses as SE3, T = [R, t / s] (:1210-1217)
        R_init[window] = lie.normalize_rotation_np(R_init[window])
        world.kf_R[window] = R_init[window]
        world.kf_t[window] = t_init[window] / s_init[window][:, None]
        with self.timers.span("loop_fuse"):
            self._fuse_loop(world, k, c)  # loop-side landmarks into the corrected window (:2261)
        with self.timers.span("loop_essential_graph"):
            self._essential_graph(world, k, c, K, R_old, t_old, s_old, R_init, t_init, s_init)
        if not cfg.run_gba:
            return
        # global BA (:1327-1334) over every live keyframe, landmark and observation; an inertial map's is
        # FullInertialBA over the whole chain too (RunGlobalBundleAdjustment, LoopClosing.cc:2065 ->
        # Optimizer.cc:1276), or, without that hook, the tracker's windowed VI-BA over every keyframe
        if world.imu_initialized and self.inertial_gba is not None:
            ig = self.inertial_gba

            def gba_thunk(abort_flag=None, map_lock=None, _c=c):
                return ig(world, fixed_ids=np.asarray([_c]), map_lock=map_lock, abort_flag=abort_flag)
        elif world.imu_initialized and self.inertial_ba is not None:
            ib = self.inertial_ba

            def gba_thunk(abort_flag=None, map_lock=None, _K=K):
                ib(world, _K - 1, window=_K)
                return True
        else:
            kf_ids = np.nonzero(world.kf_valid[:K])[0]

            def gba_thunk(abort_flag=None, map_lock=None, _ids=kf_ids, _c=c):
                return self.mapper._run_gba(world, _ids, fixed=np.asarray([_c]), iters=cfg.gba_iters,
                                            map_lock=map_lock, abort_flag=abort_flag, distributed=True)

        with self.timers.span("loop_gba"):
            if self.gba_hook is not None:
                self.gba_hook(gba_thunk)
            else:
                gba_thunk()

    def _fuse_loop(self, world: WorldMap, k: int, c: int):
        """SearchAndFuse (:2261-2330): the loop side's landmarks projected into
        the current window (kernel C's window mode, radius 4); duplicates
        replaced by the loop landmark (MapPoint::Replace)."""
        window = np.unique(np.concatenate([[k], world.best_covisible(k, 10, min_shared=5)]))
        loop_window = np.unique(np.concatenate([[c], world.best_covisible(c, 10, min_shared=5)]))
        loop_lms_raw = world.local_landmarks(loop_window)
        if len(loop_lms_raw) == 0:
            return
        lm_ids, lm_mask = self._padded_landmarks(loop_lms_raw, world.kp_cap, "loopcloser.fuse_loop_lms")
        for n in window:
            xc = world.lm_pos[lm_ids] @ world.kf_R[n].T + world.kf_t[n]
            uv = _project_np(self.cam, xc)
            pred_level = self._pred_level(world.lm_dmax[lm_ids],
                                          np.linalg.norm(world.lm_pos[lm_ids] - world.camera_center(n), axis=1))
            idx, acc = self._search_proj(world, n, uv, (xc[:, 2] > 0.05) & world.lm_valid[lm_ids] & lm_mask,
                                         world.lm_desc[lm_ids], pred_level, radius=4.0, th_dist=50)
            if not acc.any():
                continue
            tgt = idx[acc]
            src = lm_ids[acc]
            existing = world.kf_obs[n, tgt]
            fresh = existing < 0
            world.add_observations(n, tgt[fresh], src[fresh])
            dup = (~fresh) & (existing != src)
            world.replace_landmarks(list(zip(src[dup], existing[dup])))  # the loop landmark wins (:1245)

    def _essential_graph(self, world, k, c, K, R_old, t_old, s_old, R_init, t_init, s_init):
        """OptimizeEssentialGraph (Optimizer.cc:1518-1827) over the whole map:
        the temporal chain (the spanning tree's stand-in), the strong
        covisibility edges and the loop edge; measurements from the poses
        before the correction, initial values after it, the loop candidate
        fixed.  The graph is not padded (the JAX package pads the vertices and
        edges to powers of two against recompiles; a padded vertex is fixed
        and touched by no edge, so the solution is the same).  An inertial
        map takes the 4-DoF graph (yaw and translation; LoopClosing.cc:
        1288-1306 routes to OptimizeEssentialGraph4DoF, Optimizer.cc:1830):
        gravity's direction and the scale are the IMU's."""
        cfg = self.cfg
        pairs = [(i, i - 1) for i in range(1, K)]
        C = native.covis_matrix(world.kf_obs[:K], world.max_lm)
        if C is not None:
            ii, jj = np.nonzero(C >= cfg.min_covis_edge)
            pairs += [(int(i), int(j)) for i, j in zip(ii, jj) if j < i - 1]  # the chain covers (i, i-1)
        else:
            for i in range(K):
                ci = world.covisibility_counts(i)
                pairs += [(i, int(j)) for j in np.nonzero(ci >= cfg.min_covis_edge)[0] if j < i - 1]
        pairs.append((k, c))  # the loop edge
        pairs = list(dict.fromkeys(pairs))
        E = len(pairs)
        ei = np.asarray([p[0] for p in pairs], np.int32)
        ej = np.asarray([p[1] for p in pairs], np.int32)
        mR = np.empty((E, 3, 3), np.float32)
        mt = np.empty((E, 3), np.float32)
        ms = np.ones(E, np.float32)
        for e, (i, j) in enumerate(pairs):
            if (i, j) == (k, c):  # the loop edge: the verified S_kc = S_kw_init S_cw_old^-1
                R = R_init[k] @ R_old[c].T
                mR[e] = R
                mt[e] = t_init[k] - s_init[k] * (R @ t_old[c])
                ms[e] = s_init[k]
            else:
                R = R_old[i] @ R_old[j].T
                mR[e] = R
                mt[e] = t_old[i] - R @ t_old[j]
        fixed = np.zeros(K, bool)
        fixed[c] = True
        d = self._dev
        common = dict(edge_i=d(ei), edge_j=d(ej), meas_R=d(mR), meas_t=d(mt), edge_valid=d(np.ones(E, bool)),
                      fixed=d(fixed), edge_w=d(np.ones(E, np.float32)))
        if world.imu_initialized:
            g4 = pg.SE3Graph(R=d(R_init[:K]), t=d(t_init[:K]), **common)
            Rn, tn = (x.cpu().numpy() for x in pg.optimize_4dof_graph(g4, iters=cfg.pose_graph_iters)[:2])
            sn = np.ones(K, np.float32)
        else:
            g = pg.Sim3Graph(R=d(R_init[:K]), t=d(t_init[:K]), s=d(s_init[:K]), meas_s=d(ms), **common)
            Rn, tn, sn = (x.cpu().numpy() for x in pg.optimize_sim3_graph(g, iters=cfg.pose_graph_iters)[:3])
        Rn = lie.normalize_rotation_np(Rn)
        # every landmark moves with its reference keyframe's Sim3 change (:1780)
        lm_ids = np.nonzero(world.lm_valid[: world.n_lm])[0]
        if len(lm_ids):
            ref = np.clip(world.lm_first_kf[lm_ids].astype(np.int64), 0, K - 1)
            T = torch.as_tensor
            world.lm_pos[lm_ids] = pg.correct_landmarks(
                T(world.lm_pos[lm_ids]), T(ref), T(R_init[:K]), T(t_init[:K]), T(s_init[:K]), T(Rn), T(tn), T(sn),
            ).numpy()
        # the poses as T_cw = [R, t / s] (Optimizer.cc:1757-1779)
        world.kf_R[:K] = Rn
        world.kf_t[:K] = tn / sn[:, None]
