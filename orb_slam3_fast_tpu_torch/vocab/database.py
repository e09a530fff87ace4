"""Keyframe database: the bag-of-words place-recognition index.

Counterpart of ``orb_slam3_fast_tpu/vocab/database.py`` (KeyFrameDatabase,
KeyFrameDatabase.cc), host numpy as there: per keyframe a sparse row of its
distinct word ids and tf-idf weights, so memory is independent of the
vocabulary's size.  The DBoW2 L1 score of two L1-normalised vectors is
``sum over shared words of min(v, w)``, one dense query table and one (K, T)
gather per query.

The JAX package scores on the device only when ``attach_mesh`` spreads the
rows over more than one device (``parallel/dist_kfdb.py``); that waits for
ROADMAP §A item 12, and ``attach_mesh`` raises.
"""
from __future__ import annotations

import numpy as np


class KeyFrameDatabase:
    def __init__(self, n_words: int, max_kf: int = 512, row_words: int = 1024):
        """``row_words``: capacity of a sparse row (a keyframe holds at most
        as many distinct words as keypoints)."""
        self.n_words = n_words
        self.max_kf = max_kf
        self.row_words = row_words
        self.ids = np.full((max_kf, row_words), -1, dtype=np.int32)
        self.w = np.zeros((max_kf, row_words), dtype=np.float32)
        self.valid = np.zeros(max_kf, dtype=bool)
        self.map_id = np.full(max_kf, -1, dtype=np.int32)

    @property
    def bow(self) -> np.ndarray:
        """Dense (K, n_words) view, built on demand (tests only)."""
        out = np.zeros((self.max_kf, self.n_words), dtype=np.float32)
        rows, cols = np.nonzero(self.ids >= 0)
        out[rows, self.ids[rows, cols]] = self.w[rows, cols]
        return out

    def dense_row(self, kf: int) -> np.ndarray:
        """One keyframe's dense (n_words,) BoW vector."""
        out = np.zeros(self.n_words, dtype=np.float32)
        sel = self.ids[kf] >= 0
        out[self.ids[kf, sel]] = self.w[kf, sel]
        return out

    def _sparsify(self, bow: np.ndarray):
        nz = np.nonzero(bow)[0]
        if len(nz) > self.row_words:  # keep the heaviest words
            nz = nz[np.argsort(-bow[nz])[: self.row_words]]
        ids = np.full(self.row_words, -1, np.int32)
        w = np.zeros(self.row_words, np.float32)
        ids[: len(nz)] = nz
        w[: len(nz)] = bow[nz]
        return ids, w

    def attach_mesh(self, mesh):
        raise NotImplementedError("scoring the database on a device mesh waits for ROADMAP §A item 12 (multi-device)")

    def add(self, kf: int, bow: np.ndarray, map_id: int = 0):
        """KeyFrameDatabase::add (:37); the table doubles while ``kf`` lies
        beyond it."""
        while kf >= self.max_kf:
            pad = self.max_kf
            self.ids = np.concatenate([self.ids, np.full((pad, self.row_words), -1, np.int32)])
            self.w = np.concatenate([self.w, np.zeros((pad, self.row_words), np.float32)])
            self.valid = np.concatenate([self.valid, np.zeros(pad, bool)])
            self.map_id = np.concatenate([self.map_id, np.full(pad, -1, np.int32)])
            self.max_kf *= 2
        self.ids[kf], self.w[kf] = self._sparsify(np.asarray(bow))
        self.valid[kf] = True
        self.map_id[kf] = map_id

    def erase(self, kf: int):
        """KeyFrameDatabase::erase (:47)."""
        self.valid[kf] = False

    def clear_map(self, map_id: int):
        """KeyFrameDatabase::clearMap (:74)."""
        self.valid[self.map_id == map_id] = False

    def _scores(self, query_bow: np.ndarray, exclude: np.ndarray):
        """(common words, L1 score, eligible mask) of every stored row."""
        elig = self.valid.copy()
        elig[exclude] = False
        lut = np.zeros(self.n_words + 1, dtype=np.float32)
        lut[: self.n_words] = np.asarray(query_bow, dtype=np.float32)
        qw = lut[np.where(self.ids >= 0, self.ids, self.n_words)]  # (K,T)
        shared = (qw > 0) & (self.w > 0)
        common = shared.sum(1).astype(np.int64)
        score = np.where(shared, np.minimum(self.w, qw), 0.0).sum(1)
        return common, score, elig

    def detect_n_best_candidates(self, query_bow: np.ndarray, covisible: np.ndarray, n: int,
                                 covis_groups=None, query_map: int = -1):
        """DetectNBestCandidates (KeyFrameDatabase.cc:612-741): keyframes
        sharing more than 0.8x the most common words, ranked by the score
        accumulated over their covisible group (``covis_groups``: a dict or a
        callable row -> group rows), the best member of each group, ``n`` at
        most.  Returns (same-map candidates, other-map candidates)."""
        common, score, elig = self._scores(query_bow, np.asarray(covisible, dtype=np.int64))
        elig &= common > 0
        empty = np.zeros(0, np.int64)
        if not elig.any():
            return empty, empty
        elig &= common > 0.8 * common[elig].max()  # :661
        ids = np.nonzero(elig)[0]
        if len(ids) == 0:
            return empty, empty
        acc = np.zeros(len(ids), dtype=np.float32)
        best_member = ids.copy()
        for i, k in enumerate(ids):
            if callable(covis_groups):
                group = covis_groups(int(k))
            elif covis_groups:
                group = covis_groups.get(int(k), empty)
            else:
                group = empty
            group = np.asarray(group, dtype=np.int64)
            group = group[(group >= 0) & elig[np.clip(group, 0, self.max_kf - 1)]] if len(group) else group
            members = np.concatenate([[k], group])
            s = score[members]
            acc[i] = s.sum()
            best_member[i] = members[s.argmax()]
        picked, seen = [], set()
        for j in np.argsort(-acc):
            m = int(best_member[j])
            if m not in seen:
                seen.add(m)
                picked.append(m)
            if len(picked) >= n:
                break
        picked = np.asarray(picked, dtype=np.int64)
        same = self.map_id[picked] == query_map
        return picked[same], picked[~same]

    def detect_reloc_candidates(self, query_bow: np.ndarray, query_map: int = -1):
        """DetectRelocalizationCandidates (KeyFrameDatabase.cc:742-857):
        keyframes sharing more than 0.8x the most common words and scoring at
        least 0.75x the best, best first."""
        common, score, elig = self._scores(query_bow, np.zeros(0, np.int64))
        if query_map >= 0:
            elig &= self.map_id == query_map
        elig &= common > 0
        if not elig.any():
            return np.zeros(0, np.int64)
        elig &= common > 0.8 * common[elig].max()
        ids = np.nonzero(elig)[0]
        s = score[ids]
        keep = s >= 0.75 * s.max()  # :846 (0.75f*bestAccScore)
        ids = ids[keep]
        return ids[np.argsort(-s[keep])]
