"""SoA world map: keyframes, landmarks, observations, covisibility.

Counterpart of ``orb_slam3_fast_tpu/map/worldmap.py``: the same host-side
structure-of-arrays tables (numpy), the same methods and the same rules.
One layout differs: descriptors are stored packed, ``kf_desc`` (K,N,8) and
``lm_desc`` (M,8) int32, where the JAX package keeps (K,N,256) / (M,256)
int8 bits (bit k of the unpacked row is bit k % 32 of word k // 32, as in
``ops.hamming.pack_desc``).  ``save`` unpacks and ``load`` packs, so a map
saved by either package loads in the other.

Device programs (matching, BA) receive padded slices of these arrays; the
keypoints handed to ``add_keyframe`` may be torch tensors on any device.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from orb_slam3_fast_tpu_torch import native
from orb_slam3_fast_tpu_torch.imu.preintegration import Preintegrated
from orb_slam3_fast_tpu_torch.utils.lie import normalize_rotation_np

_SHIFTS = np.arange(32, dtype=np.uint32)


def pack_bits(bits: np.ndarray) -> np.ndarray:
    """(...,256) {0,1} -> (...,8) int32 packed words."""
    b = np.asarray(bits).astype(np.uint32).reshape(*bits.shape[:-1], 8, 32)
    return (b << _SHIFTS).sum(axis=-1, dtype=np.uint32).view(np.int32)


def unpack_bits(words: np.ndarray) -> np.ndarray:
    """(...,8) int32 packed words -> (...,256) int8 in {0,1}."""
    w = np.ascontiguousarray(words, dtype=np.int32).view(np.uint32)
    return ((w[..., None] >> _SHIFTS) & 1).reshape(*w.shape[:-1], 256).astype(np.int8)


def popcount_words(x: np.ndarray) -> np.ndarray:
    """Set bits of each row of packed words: (...,8) int32 -> (...,) int64."""
    x = np.ascontiguousarray(x, dtype=np.int32)
    return np.unpackbits(x.view(np.uint8), axis=-1).sum(axis=-1, dtype=np.int64)


def host(x) -> np.ndarray:
    """A torch tensor (any device) or array-like as a numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


@dataclass
class WorldMap:
    kp_cap: int  # keypoint slots per keyframe
    max_kf: int = 256
    max_lm: int = 40000
    n_levels: int = 8
    scale_factor: float = 1.2

    def __post_init__(self):
        K, N, M = self.max_kf, self.kp_cap, self.max_lm
        self.n_kf = 0
        self.change_index = 0  # Map::IncreaseChangeIndex (Map.cc:306-324)
        # gauge anchors fixed in every local BA (GetInitKFid, Optimizer.cc:1224)
        self.init_kf_ids: list = []
        self.kf_valid = np.zeros(K, dtype=bool)
        self.kf_R = np.tile(np.eye(3, dtype=np.float32), (K, 1, 1))  # T_cw
        self.kf_t = np.zeros((K, 3), dtype=np.float32)
        self.kf_ts = np.zeros(K, dtype=np.float64)
        self.kf_xy = np.zeros((K, N, 2), dtype=np.float32)
        self.kf_level = np.zeros((K, N), dtype=np.int32)
        self.kf_angle = np.zeros((K, N), dtype=np.float32)
        self.kf_desc = np.zeros((K, N, 8), dtype=np.int32)  # packed
        self.kf_kp_valid = np.zeros((K, N), dtype=bool)
        self.kf_depth = np.full((K, N), -1.0, dtype=np.float32)
        self.kf_right_u = np.full((K, N), -1.0, dtype=np.float32)
        self.kf_obs = np.full((K, N), -1, dtype=np.int32)  # landmark id per slot
        self.kf_vel = np.zeros((K, 3), dtype=np.float32)
        self.kf_bias = np.zeros((K, 6), dtype=np.float32)
        self.imu_initialized = False  # Map::SetImuInitialized (Map.cc:103)
        self.kf_preint: dict = {}  # k -> Preintegrated from keyframe k-1 to k
        self.n_lm = 0
        self.lm_valid = np.zeros(M, dtype=bool)
        self.lm_pos = np.zeros((M, 3), dtype=np.float32)
        self.lm_desc = np.zeros((M, 8), dtype=np.int32)  # packed
        self.lm_normal = np.zeros((M, 3), dtype=np.float32)
        self.lm_dmin = np.zeros(M, dtype=np.float32)
        self.lm_dmax = np.zeros(M, dtype=np.float32)
        self.lm_first_kf = np.full(M, -1, dtype=np.int32)
        self.lm_visible = np.zeros(M, dtype=np.int32)  # GetFoundRatio counters
        self.lm_found = np.zeros(M, dtype=np.int32)
        self.lm_n_obs = np.zeros(M, dtype=np.int32)

    # ------------------------------------------------------------------
    # keyframes
    # ------------------------------------------------------------------
    def _grow_kf(self):
        """Double keyframe capacity (an amortised array copy)."""
        old = self.max_kf
        self.max_kf = old * 2
        for name, arr in list(self.__dict__.items()):
            if isinstance(arr, np.ndarray) and arr.shape[:1] == (old,) and name.startswith("kf_"):
                fill = -1 if name == "kf_obs" else (-1.0 if name in ("kf_depth", "kf_right_u") else 0)
                self.__dict__[name] = np.concatenate([arr, np.full(arr.shape, fill, dtype=arr.dtype)], axis=0)
        self.kf_R[old:] = np.eye(3, dtype=np.float32)

    def _grow_lm(self):
        old = self.max_lm
        self.max_lm = old * 2
        for name, arr in list(self.__dict__.items()):
            if isinstance(arr, np.ndarray) and arr.shape[:1] == (old,) and name.startswith("lm_"):
                fill = -1 if name == "lm_first_kf" else 0
                self.__dict__[name] = np.concatenate([arr, np.full(arr.shape, fill, dtype=arr.dtype)], axis=0)

    def add_keyframe(self, kp, R, t, ts, depth=None, right_u=None) -> int:
        """kp: the port's Keypoints (packed descriptors; tensors on any
        device) or anything with numpy-convertible fields."""
        k = self.n_kf
        if k >= self.max_kf:
            self._grow_kf()
        self.kf_valid[k] = True
        self.kf_R[k] = host(R)
        self.kf_t[k] = host(t)
        self.kf_ts[k] = ts
        n = min(self.kp_cap, kp.xy.shape[0])
        self.kf_xy[k, :n] = host(kp.xy)[:n]
        self.kf_level[k, :n] = host(kp.level)[:n]
        self.kf_angle[k, :n] = host(kp.angle)[:n]
        self.kf_desc[k, :n] = host(kp.desc)[:n]
        self.kf_kp_valid[k, :n] = host(kp.valid)[:n]
        if depth is not None:
            self.kf_depth[k, :n] = host(depth)[:n]
        if right_u is not None:
            self.kf_right_u[k, :n] = host(right_u)[:n]
        self.n_kf += 1
        return k

    def remove_keyframe(self, k: int):
        """KeyFrame::SetBadFlag: detach the observations and mask the
        keyframe out; its pose entry stays for trajectory recovery."""
        obs = self.kf_obs[k]
        lm = obs[obs >= 0]
        if len(lm):
            np.subtract.at(self.lm_n_obs, lm, 1)
        self.kf_obs[k] = -1
        self.kf_kp_valid[k] = False
        self.kf_valid[k] = False
        self.kf_preint.pop(k, None)

    def set_pose(self, k: int, R, t):
        self.kf_R[k] = host(R)
        self.kf_t[k] = host(t)

    def camera_center(self, k: int) -> np.ndarray:
        return -self.kf_R[k].T @ self.kf_t[k]

    # ------------------------------------------------------------------
    # landmarks
    # ------------------------------------------------------------------
    def add_landmarks(self, pos, desc, first_kf, kp_idx, levels) -> np.ndarray:
        """Create landmarks observed by keyframe ``first_kf`` at slots
        ``kp_idx`` (``desc`` packed); returns the new ids.  Scale limits as
        MapPoint::UpdateNormalAndDepth (MapPoint.cc:461-540)."""
        n = len(pos)
        ids = np.arange(self.n_lm, self.n_lm + n, dtype=np.int32)
        while self.n_lm + n > self.max_lm:
            self._grow_lm()
        self.lm_valid[ids] = True
        self.lm_pos[ids] = pos
        self.lm_desc[ids] = host(desc)
        center = self.camera_center(first_kf)
        d = pos - center[None, :]
        dist = np.linalg.norm(d, axis=-1)
        self.lm_normal[ids] = d / np.maximum(dist[:, None], 1e-9)
        level_sf = self.scale_factor ** np.asarray(levels).astype(np.float32)
        self.lm_dmax[ids] = dist * level_sf
        self.lm_dmin[ids] = self.lm_dmax[ids] / (self.scale_factor ** (self.n_levels - 1))
        self.lm_first_kf[ids] = first_kf
        self.kf_obs[first_kf, kp_idx] = ids
        self.lm_n_obs[ids] = 1
        self.lm_visible[ids] = 1
        self.lm_found[ids] = 1
        self.n_lm += n
        return ids

    def add_observations(self, kf: int, kp_idx: np.ndarray, lm_ids: np.ndarray):
        prev = self.kf_obs[kf, kp_idx]
        fresh = prev < 0
        self.kf_obs[kf, kp_idx[fresh]] = lm_ids[fresh]
        np.add.at(self.lm_n_obs, lm_ids[fresh], 1)

    def remove_landmarks(self, lm_ids: np.ndarray):
        """SetBadFlag: mask out and detach the observations."""
        self.lm_valid[lm_ids] = False
        obs = self.kf_obs[: self.n_kf]
        obs[np.isin(obs, lm_ids)] = -1

    def replace_landmarks(self, pairs):
        """Batched MapPoint::Replace (MapPoint.cc:298-366): each (keep, drop)
        pair merges ``drop`` into ``keep`` in one remap pass; chains resolve
        through union-find."""
        pairs = [(int(a), int(b)) for a, b in pairs if int(a) != int(b)]
        if not pairs:
            return
        remap = np.arange(self.max_lm, dtype=np.int64)

        def root(x):
            while remap[x] != x:
                x = remap[x]
            return x

        for keep, drop in pairs:
            rk, rd = root(keep), root(drop)
            if rk != rd:
                remap[rd] = rk
        r = remap
        for _ in range(8):  # path compression to a fixpoint (chains are short)
            r2 = r[r]
            if np.array_equal(r2, r):
                break
            r = r2
        obs = self.kf_obs[: self.n_kf]
        pos = obs >= 0
        obs[pos] = r[obs[pos]]
        dropped = np.nonzero(r != np.arange(self.max_lm))[0]
        self.lm_valid[dropped] = False
        roots = np.unique(r[dropped])
        np.add.at(self.lm_found, r[dropped], self.lm_found[dropped])
        np.add.at(self.lm_visible, r[dropped], self.lm_visible[dropped])
        counts = np.bincount(obs[pos], minlength=self.max_lm)
        self.lm_n_obs[roots] = counts[roots]

    def update_landmark_stats(self, lm_ids: np.ndarray):
        """Recompute normal and distance limits from the current
        observations (MapPoint::UpdateNormalAndDepth), one pass over the
        observation table for the whole set."""
        lm_ids = np.asarray(lm_ids)
        if len(lm_ids) == 0:
            return
        K = self.n_kf
        centers = -np.einsum("kji,kj->ki", self.kf_R[:K], self.kf_t[:K])
        lm_local = np.full(self.max_lm, -1, dtype=np.int32)
        lm_local[lm_ids] = np.arange(len(lm_ids), dtype=np.int32)
        out = native.landmark_stats(self.kf_obs[:K], lm_local, centers, self.lm_pos, len(lm_ids))
        if out is not None:
            nrm_sum, nobs, first_kf, first_slot = out
        else:  # numpy fallback, same one-pass semantics
            kfs, lml, slots = self.observations_of(lm_ids, np.arange(K))
            nrm_sum = np.zeros((len(lm_ids), 3), np.float32)
            nobs = np.zeros(len(lm_ids), np.int32)
            first_kf = np.full(len(lm_ids), -1, np.int32)
            first_slot = np.zeros(len(lm_ids), np.int32)
            if len(kfs):
                d = self.lm_pos[lm_ids[lml]] - centers[kfs]
                d /= np.maximum(np.linalg.norm(d, axis=-1, keepdims=True), 1e-9)
                np.add.at(nrm_sum, lml, d.astype(np.float32))
                np.add.at(nobs, lml, 1)
                uniq, first_idx = np.unique(lml, return_index=True)  # kf-major: first wins
                first_kf[uniq] = kfs[first_idx]
                first_slot[uniq] = slots[first_idx]
        seen = nobs > 0
        ids = lm_ids[seen]
        if len(ids) == 0:
            return
        self.lm_normal[ids] = nrm_sum[seen] / nobs[seen][:, None]
        self.lm_n_obs[ids] = nobs[seen]
        ref = first_kf[seen]
        dist0 = np.linalg.norm(self.lm_pos[ids] - centers[ref], axis=-1)
        lvl = self.kf_level[ref, first_slot[seen]]
        self.lm_dmax[ids] = dist0 * self.scale_factor ** lvl.astype(np.float32)
        self.lm_dmin[ids] = self.lm_dmax[ids] / (self.scale_factor ** (self.n_levels - 1))

    def apply_scaled_rotation(self, R_yw: np.ndarray, s: float):
        """The gauge transform after IMU initialisation (Map::
        ApplyScaledRotation, Map.cc:231-265): landmarks x <- s R_yw x; poses
        R_cw <- R_cw R_yw^T, t_cw <- s t_cw; velocities s R_yw v."""
        K = self.n_kf
        self.change_index += 1
        R_yw = np.asarray(R_yw, dtype=np.float32)
        s = float(s)
        self.kf_R[:K] = normalize_rotation_np(self.kf_R[:K] @ R_yw.T)
        self.kf_t[:K] = s * self.kf_t[:K]
        self.kf_vel[:K] = s * (self.kf_vel[:K] @ R_yw.T)
        ids = np.nonzero(self.lm_valid[: self.n_lm])[0]
        self.lm_pos[ids] = s * (self.lm_pos[ids] @ R_yw.T)
        self.lm_normal[ids] = self.lm_normal[ids] @ R_yw.T
        self.lm_dmin[ids] *= s
        self.lm_dmax[ids] *= s

    # ------------------------------------------------------------------
    # covisibility
    # ------------------------------------------------------------------
    def _lm_scratch(self) -> np.ndarray:
        """Scratch byte array (size max_lm) for the native covisibility count."""
        s = getattr(self, "_scratch", None)
        if s is None or len(s) != self.max_lm:
            s = np.zeros(self.max_lm, dtype=np.uint8)
            self._scratch = s
        return s

    def covisibility_counts(self, k: int) -> np.ndarray:
        """Shared-landmark counts between keyframe k and every keyframe
        (UpdateConnections weights, KeyFrame.cc:379-475)."""
        K = self.n_kf
        obs_k = self.kf_obs[k]
        obs_k = obs_k[obs_k >= 0]
        if len(obs_k) == 0:
            return np.zeros(K, dtype=np.int32)
        counts = native.covis_counts(self.kf_obs[:K], obs_k, self._lm_scratch())
        counts[k] = 0
        return counts

    def best_covisible(self, k: int, n: int, min_shared: int = 15) -> np.ndarray:
        c = self.covisibility_counts(k)
        order = np.argsort(-c)
        order = order[c[order] >= max(min_shared, 1)]
        return order[:n]

    def local_landmarks(self, kf_ids: np.ndarray) -> np.ndarray:
        """Union of the live landmarks observed by the given keyframes."""
        obs = self.kf_obs[kf_ids]
        ids = np.unique(obs[obs >= 0])
        return ids[self.lm_valid[ids]]

    def observations_of(self, lm_ids: np.ndarray, kf_ids: np.ndarray):
        """COO observation triplets restricted to (kf_ids x lm_ids): returns
        (obs_kf_local, obs_lm_local, slots), the first two indexing the given
        id arrays."""
        lm_to_local = -np.ones(self.max_lm, dtype=np.int32)
        lm_to_local[lm_ids] = np.arange(len(lm_ids))
        out = native.observations_of(self.kf_obs, np.asarray(kf_ids, np.int64), lm_to_local)
        if out is not None:
            return out
        rows = []
        for i, k in enumerate(kf_ids):
            slots = np.nonzero(self.kf_obs[k] >= 0)[0]
            lml = lm_to_local[self.kf_obs[k, slots]]
            good = lml >= 0
            rows.append((np.full(good.sum(), i, dtype=np.int32), lml[good], slots[good]))
        if not rows:
            return (np.zeros(0, np.int32),) * 3
        return tuple(np.concatenate(x) for x in zip(*rows))

    # ------------------------------------------------------------------
    # persistence, in the JAX package's .npz layout
    # ------------------------------------------------------------------
    def save(self, path: str):
        """``np.savez_compressed`` of every table, descriptors unpacked to
        the JAX package's (…,256) int8 layout."""
        arrays = {k: v for k, v in self.__dict__.items() if isinstance(v, np.ndarray) and not k.startswith("_")}
        arrays["kf_desc"] = unpack_bits(self.kf_desc)
        arrays["lm_desc"] = unpack_bits(self.lm_desc)
        if self.kf_preint:  # the inertial chain, stacked field by field
            ks = sorted(self.kf_preint)
            arrays["preint_keys"] = np.asarray(ks, dtype=np.int64)
            for f in Preintegrated._fields:
                arrays[f"preint_{f}"] = np.stack([host(getattr(self.kf_preint[k], f)) for k in ks])
        np.savez_compressed(path, **arrays, n_kf=self.n_kf, n_lm=self.n_lm, kp_cap=self.kp_cap,
                            max_kf=self.max_kf, max_lm=self.max_lm, imu_initialized=self.imu_initialized,
                            init_kf_ids=np.asarray(self.init_kf_ids, dtype=np.int64))

    @staticmethod
    def load(path: str) -> "WorldMap":
        """Load a map saved by either package; descriptors are packed."""
        z = np.load(path)
        wm = WorldMap(int(z["kp_cap"]), int(z["max_kf"]), int(z["max_lm"]))
        for k in wm.__dict__:
            if isinstance(getattr(wm, k), np.ndarray) and k in z:
                v = z[k]
                setattr(wm, k, pack_bits(v) if k in ("kf_desc", "lm_desc") else v.copy())
        wm.n_kf = int(z["n_kf"])
        wm.n_lm = int(z["n_lm"])
        if "imu_initialized" in z:
            wm.imu_initialized = bool(z["imu_initialized"])
        if "init_kf_ids" in z:
            wm.init_kf_ids = [int(i) for i in z["init_kf_ids"]]
        if "preint_keys" in z:
            for i, k in enumerate(z["preint_keys"]):
                wm.kf_preint[int(k)] = Preintegrated(*(torch.as_tensor(z[f"preint_{f}"][i], dtype=torch.float32)
                                                       for f in Preintegrated._fields))
        return wm
