"""Atlas: several maps, a new one when tracking is lost, and the Sim3 merge
of the active map into a stored one.

Counterpart of ``orb_slam3_fast_tpu/map/atlas.py`` (the reference's Atlas:
CreateNewMap, Atlas.cc:53-73, called by Tracking::CreateMapInAtlas,
Tracking.cc:2607; the transplant of LoopClosing::MergeLocal,
LoopClosing.cc:1347-1930).  Each map is a host ``WorldMap``; a merge
transforms the active map's arrays by the world-to-world Sim3 and appends
them to the stored map with id offsets.  The Atlas also owns the global
keyframe-database rows: keyframe ids are per map, so a row maps to a (map
id, local keyframe id) pair.  ``save`` and ``load`` write and read the JAX
package's files (``<path>.map<i>.npz`` per live map and
``<path>.atlas.npz``), so either package loads what the other saved.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from orb_slam3_fast_tpu_torch.map.worldmap import WorldMap
from orb_slam3_fast_tpu_torch.utils import lie


def _np64(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float64)


class Atlas:
    def __init__(self, make_map: Callable[[], WorldMap]):
        self._make = make_map
        self.maps: list[Optional[WorldMap]] = [make_map()]
        self.current_id = 0
        self.row_map: list[tuple[int, int]] = []  # keyframe-database row -> (map id, local keyframe id)
        self._row_of: dict[tuple[int, int], int] = {}

    @property
    def current(self) -> WorldMap:
        return self.maps[self.current_id]

    def n_maps(self) -> int:
        return sum(1 for m in self.maps if m is not None)

    def create_new_map(self) -> WorldMap:
        """Atlas::CreateNewMap (Atlas.cc:53): keep the current map, start a
        fresh one."""
        self.maps.append(self._make())
        self.current_id = len(self.maps) - 1
        return self.current

    def register_kf(self, map_id: int, local_kf: int) -> int:
        """The global keyframe-database row of a keyframe, allocated at first
        use."""
        key = (map_id, local_kf)
        row = self._row_of.get(key)
        if row is None:
            row = len(self.row_map)
            self.row_map.append(key)
            self._row_of[key] = row
        return row

    def resolve_row(self, row: int) -> tuple[int, int]:
        return self.row_map[row]

    def rows_of_map(self, map_id: int) -> np.ndarray:
        return np.asarray([r for r, (m, _) in enumerate(self.row_map) if m == map_id], dtype=np.int64)

    # ------------------------------------------------------------------
    def merge_into(self, src_id: int, dst_id: int, S_dst_src: lie.Sim3, kfdb=None) -> dict:
        """Weld map ``src`` into map ``dst`` (the MergeLocal transplant):
        transform src by ``S_dst_src`` (x_dst = s R x_src + t; tensors or
        arrays), append its arrays to dst with id offsets, retag its
        keyframe-database rows.  Returns {"kf_offset", "lm_offset"} for the
        caller to remap cached local ids."""
        src = self.maps[src_id]
        dst = self.maps[dst_id]
        R, t, s = _np64(S_dst_src.R), _np64(S_dst_src.t), float(_np64(S_dst_src.s))
        kf_off, lm_off = dst.n_kf, dst.n_lm
        while dst.max_kf < kf_off + src.n_kf:
            dst._grow_kf()
        while dst.max_lm < lm_off + src.n_lm:
            dst._grow_lm()
        Ks, Ms = src.n_kf, src.n_lm
        kf = slice(kf_off, kf_off + Ks)
        # poses: scaling the camera frame by s leaves the projection as it is, so
        # with x_src = (1/s) R^T (x - t): cam' = R_cw R^T x - R_cw R^T t + s t_cw
        Rp = np.einsum("kij,jl->kil", src.kf_R[:Ks].astype(np.float64), R.T)
        tp = -np.einsum("kij,j->ki", Rp, t) + s * src.kf_t[:Ks].astype(np.float64)
        dst.kf_R[kf] = lie.normalize_rotation_np(Rp)
        dst.kf_t[kf] = tp.astype(np.float32)
        dst.kf_ts[kf] = src.kf_ts[:Ks]
        dst.kf_valid[kf] = src.kf_valid[:Ks]
        for name in ("kf_xy", "kf_level", "kf_angle", "kf_desc", "kf_kp_valid"):
            getattr(dst, name)[kf] = getattr(src, name)[:Ks]
        dst.kf_depth[kf] = np.where(src.kf_depth[:Ks] > 0, s * src.kf_depth[:Ks], src.kf_depth[:Ks])  # depths scale
        dst.kf_right_u[kf] = src.kf_right_u[:Ks]
        obs = src.kf_obs[:Ks].copy()
        obs[obs >= 0] += lm_off
        dst.kf_obs[kf] = obs
        dst.kf_vel[kf] = s * np.einsum("ij,kj->ki", R, src.kf_vel[:Ks].astype(np.float64)).astype(np.float32)
        dst.kf_bias[kf] = src.kf_bias[:Ks]
        dst.n_kf += Ks
        # landmarks: x_dst = s R x_src + t
        lm = slice(lm_off, lm_off + Ms)
        dst.lm_pos[lm] = (s * (src.lm_pos[:Ms].astype(np.float64) @ R.T) + t).astype(np.float32)
        dst.lm_normal[lm] = (src.lm_normal[:Ms].astype(np.float64) @ R.T).astype(np.float32)
        dst.lm_dmin[lm] = s * src.lm_dmin[:Ms]
        dst.lm_dmax[lm] = s * src.lm_dmax[:Ms]
        for name in ("lm_valid", "lm_desc", "lm_visible", "lm_found", "lm_n_obs"):
            getattr(dst, name)[lm] = getattr(src, name)[:Ms]
        fk = src.lm_first_kf[:Ms].copy()
        fk[fk >= 0] += kf_off
        dst.lm_first_kf[lm] = fk
        dst.n_lm += Ms
        # src's keyframe-database rows now belong to dst, with offset ids
        for r, (m, k) in enumerate(self.row_map):
            if m == src_id:
                self.row_map[r] = (dst_id, k + kf_off)
                self._row_of.pop((src_id, k), None)
                self._row_of[(dst_id, k + kf_off)] = r
        if kfdb is not None:
            kfdb.map_id[kfdb.map_id == src_id] = dst_id
        self.maps[src_id] = None  # retired
        self.current_id = dst_id
        return {"kf_offset": kf_off, "lm_offset": lm_off}

    # ------------------------------------------------------------------
    # persistence (System::SaveAtlas / LoadAtlas, System.cc:1430-1529): the
    # whole multi-map atlas
    # ------------------------------------------------------------------
    def save(self, path: str):
        """Every live map as ``<path>.map<i>.npz`` and the registry as
        ``<path>.atlas.npz``."""
        live = [i for i, m in enumerate(self.maps) if m is not None]
        for i in live:
            self.maps[i].save(f"{path}.map{i}.npz")
        rows = np.asarray([(r, m, k) for r, (m, k) in enumerate(self.row_map)], dtype=np.int64).reshape(-1, 3)
        np.savez(f"{path}.atlas.npz", live=np.asarray(live, np.int64), current=self.current_id,
                 n_slots=len(self.maps), rows=rows)

    @staticmethod
    def load(path: str, make_map) -> "Atlas":
        z = np.load(f"{path}.atlas.npz")
        atlas = Atlas(make_map)
        atlas.maps = [None] * int(z["n_slots"])
        for i in z["live"]:
            atlas.maps[int(i)] = WorldMap.load(f"{path}.map{int(i)}.npz")
        atlas.current_id = int(z["current"])
        atlas.row_map = []
        atlas._row_of = {}
        for r, m, k in z["rows"]:
            atlas.row_map.append((int(m), int(k)))
            atlas._row_of[(int(m), int(k))] = int(r)
        return atlas
