"""Sharded place-recognition scoring: the keyframe database's sparse BoW
rows split by rows over the ranks.

Counterpart of ``orb_slam3_fast_tpu/parallel/dist_kfdb.py`` (``ShardedKFDB``
:56-97).  Rank r holds rows ``[r K/n, (r+1) K/n)`` of the (K, T) word ids
and tf-idf weights on its device.  A query becomes a dense (n_words + 1,)
table (the trailing zero for the id -1 of an empty slot); each rank scores
its rows (kernel AE) and ``all_gather``s the (K/n,) common-word counts and
scores, so every rank holds the same (K,) vectors.  ``set_row`` writes one
keyframe's row on the rank that owns it, an in-place slice copy (the JAX
package's ``_set_row``, ``dist_kfdb.py:51``, is a donated ``.at[kf].set``:
a copy, not a computation).  ``KeyFrameDatabase.attach_mesh`` routes its
``_scores`` here.

Kernel AE -- source note.
  Replaces: ``score_local`` of ``_make_score_fn`` (``orb_slam3_fast_tpu/
  parallel/dist_kfdb.py:33``, ``:40-48``, K17; the host form
  ``vocab/database.py:103 _scores``): the table gather, the shared-word
  mask, its count and the sum of ``min(w, qw)`` per row.
  Bound on the card: bytes.  It reads each row's T ids and weights once
  (K T 8 bytes) and gathers one table entry per slot, ~2 flops a slot.
  Design: one warp per row (``csrc/kfdb_score.cu``), 8 rows a CTA; a lane
  walks the row's columns 32 apart, reading 128 contiguous bytes per warp
  and step, and a shuffle tree sums the lanes in a fixed order, so a row
  scores the same bits on every rank and at every world size.
  ``score_rows_plain`` sums in the kernel's order.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from orb_slam3_fast_tpu_torch import _kernels
from orb_slam3_fast_tpu_torch.parallel.multihost import Mesh


def score_rows_plain(ids: torch.Tensor, w: torch.Tensor, lut: torch.Tensor):
    """Plain version of kernel AE: (common (K,) int32, score (K,) float32)
    of rows ``ids`` / ``w`` (K, T) against the query table ``lut``, each
    score summed as the kernel's warp sums it (lane j takes columns j, j +
    32, ... in order, then a shuffle tree)."""
    K, T = ids.shape
    qw = lut[torch.where(ids >= 0, ids, lut.shape[0] - 1).long()]
    shared = (qw > 0) & (w > 0)
    common = shared.sum(1, dtype=torch.int32)
    terms = torch.where(shared, torch.minimum(w, qw), torch.zeros_like(w))
    terms = F.pad(terms, (0, -T % 32)).view(K, -1, 32)
    lanes = terms[:, 0]
    for j in range(1, terms.shape[1]):
        lanes = lanes + terms[:, j]
    for s in (16, 8, 4, 2, 1):
        lanes = lanes[:, :s] + lanes[:, s:2 * s]
    return common, lanes[:, 0].contiguous()


def score_rows(ids: torch.Tensor, w: torch.Tensor, lut: torch.Tensor):
    """Kernel AE on CUDA tensors, its plain version on CPU ones: (common
    (K,) int32, score (K,) float32)."""
    if ids.device.type == "cpu":
        return score_rows_plain(ids, w, lut)
    return _score_rows_kernel(ids, w, lut)


def _score_rows_kernel(ids: torch.Tensor, w: torch.Tensor, lut: torch.Tensor):
    _kernels.require_cuda("score_rows", ids=(ids, torch.int32), w=(w, torch.float32), lut=(lut, torch.float32))
    K, T = ids.shape
    if w.shape != (K, T) or lut.dim() != 1:
        raise ValueError("score_rows: needs ids and w of one (K, T) shape and a (n_words + 1,) table")
    common = torch.empty(K, dtype=torch.int32, device=ids.device)
    score = torch.empty(K, dtype=torch.float32, device=ids.device)
    _kernels.launch("kfdb_score_launch", ids.device, ids.data_ptr(), w.data_ptr(), lut.data_ptr(), K, T,
                    lut.shape[0] - 1, common.data_ptr(), score.data_ptr())
    score_rows.launches.add()
    return common, score


score_rows.launches = _kernels.LaunchCounter()


class ShardedKFDB:
    """Device-resident mirror of a ``KeyFrameDatabase``, its rows split over
    the mesh's ranks."""

    def __init__(self, mesh: Mesh, n_words: int, max_kf: int, row_words: int = 1024):
        if max_kf % mesh.world:
            raise ValueError("max_kf must be divisible by the world size")
        self.mesh = mesh
        self.n_words = n_words
        self.max_kf = max_kf
        self.row_words = row_words
        self.lo, self.hi = mesh.rank * max_kf // mesh.world, (mesh.rank + 1) * max_kf // mesh.world
        self.ids = torch.full((self.hi - self.lo, row_words), -1, dtype=torch.int32, device=mesh.device)
        self.w = torch.zeros((self.hi - self.lo, row_words), dtype=torch.float32, device=mesh.device)

    @classmethod
    def from_host(cls, mesh: Mesh, ids: np.ndarray, w: np.ndarray, n_words: int) -> "ShardedKFDB":
        s = cls(mesh, n_words, ids.shape[0], row_words=ids.shape[1])
        s.ids = torch.as_tensor(np.ascontiguousarray(ids[s.lo:s.hi]), dtype=torch.int32).to(mesh.device)
        s.w = torch.as_tensor(np.ascontiguousarray(w[s.lo:s.hi]), dtype=torch.float32).to(mesh.device)
        return s

    def set_row(self, kf: int, row_ids: np.ndarray, row_w: np.ndarray):
        """Write one keyframe's sparse row (KeyFrameDatabase::add) where this
        rank owns it."""
        if self.lo <= kf < self.hi:
            self.ids[kf - self.lo].copy_(torch.as_tensor(np.asarray(row_ids, np.int32)))
            self.w[kf - self.lo].copy_(torch.as_tensor(np.asarray(row_w, np.float32)))

    def scores(self, query_bow: np.ndarray):
        """(common words, shared-min score) of every stored row, (K,) numpy,
        the same on every rank."""
        lut = np.zeros(self.n_words + 1, dtype=np.float32)
        lut[: self.n_words] = np.asarray(query_bow, dtype=np.float32)
        common, score = score_rows(self.ids, self.w, torch.from_numpy(lut).to(self.mesh.device))
        return self.mesh.all_gather(common).cpu().numpy(), self.mesh.all_gather(score).cpu().numpy()
