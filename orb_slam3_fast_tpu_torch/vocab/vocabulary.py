"""Hierarchical binary vocabulary: tree descent to words and nodes, and the
tf-idf bag of words.

Counterpart of ``orb_slam3_fast_tpu/vocab/vocabulary.py`` (DBoW2's
TemplatedVocabulary): a complete B-ary tree, level l holding B^(l+1)
nodes, child j of node p at index ``p * B + j``; dead branches are masked
by ``alive``.  The port keeps every level in one table of (nodes, 8) int32
packed words (``ops.hamming.pack_desc``'s layout), level after level, which
the plain descent and kernel N index alike, and reads the JAX package's
``.npz`` files by path; ``checksum`` hashes the
unpacked int8 centroids with their 0x7F sentinels and the weights, exactly
as the JAX package does, so a map saved by either package loads in the
other.  Training waits for ROADMAP §A item 8's remainder (a missing file
raises).

``transform`` is the wrapper of kernel N (``csrc/vocab_transform.cu``);
``transform_plain`` is the JAX descent in PyTorch.

Kernel N -- source note.
  Replaces: ``_transform_jit`` / ``_descend``
  (``orb_slam3_fast_tpu/vocab/vocabulary.py:228-271``, K16), per level a
  (N, B, 256) int8 gather and an int32 MXU einsum over unpacked bits, then
  an idf scatter-add and an L1 normalisation.
  Bound on the card: latency.  768 descriptors x 4 levels x 10 children
  are 31k Hamming distances (~0.8 Mop) over the distinct tree rows the
  descent reads (the upper levels are shared by every descriptor); with
  the 10^6-word vocabulary the (W,) zeroing and normalisation (8 MB of
  writes and reads) is what binds.
  Design: one warp per descriptor.  At each level lanes 0..B-1 take one
  child each: 8 XOR + ``__popc`` on the packed words, ``1 << 20`` for a
  dead child; a shuffle argmin on (distance, child) sends ties to the
  lowest child as ``argmin`` does.  Lane 0 writes the word and the node (-1
  where invalid) and ``atomicAdd``s the idf weight into the (W,) BoW and
  into a float64 total; a second launch divides by the total.  Words and
  nodes are exact; the BoW differs from the plain version by the order of
  its float sums.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from orb_slam3_fast_tpu_torch import _kernels

_SENTINEL = 0x7F  # centroid byte of a dead branch in the JAX package's tables
DEAD_DIST = 1 << 20  # distance of a dead child
VOCAB_DIR = Path(__file__).resolve().parents[2] / "orb_slam3_fast_tpu" / "vocab"  # the .npz files, read by path
_DEFAULT_PATH = VOCAB_DIR / "_default_voc.npz"
_LARGE_PATH = VOCAB_DIR / "_large_voc.npz"
_HUGE_PATH = VOCAB_DIR / "_huge_voc.npz"
# bit-reversal of a byte: np.packbits' big-endian bytes -> little-endian bit order
_REVERSE = np.array([int(f"{b:08b}"[::-1], 2) for b in range(256)], np.uint8)


def _pack_np(bits: np.ndarray) -> np.ndarray:
    """(n,256) {0,1} -> (n,8) int32 in ``pack_desc``'s layout (bit k is bit
    k % 32 of word k // 32)."""
    return np.packbits(bits.astype(bool), axis=1, bitorder="little").view("<u4").view(np.int32)


def _unpack_np(words: np.ndarray) -> np.ndarray:
    """(n,8) int32 -> (n,256) int8 {0,1}."""
    return np.unpackbits(np.ascontiguousarray(words).view(np.uint8), axis=1, bitorder="little").astype(np.int8)


@dataclass(frozen=True)
class Vocabulary:
    """Dense complete-tree vocabulary in one table.

    ``centroids``: (sum_l B^(l+1), 8) int32 packed centroids, level after
    level, node p of level l at row ``offset(l) + p``; ``alive``: the rows'
    (sum_l B^(l+1),) bool; ``weights``: (B^depth,) float32 idf; leaves are
    the nodes of level ``depth - 1`` and a word is a leaf index.
    """

    branching: int
    depth: int
    centroids: torch.Tensor
    alive: torch.Tensor
    weights: torch.Tensor
    levels_up: int = 2

    @property
    def n_words(self) -> int:
        return self.branching**self.depth

    def offset(self, level: int) -> int:
        """Row of level ``level``'s first node in the table."""
        return sum(self.branching ** (k + 1) for k in range(level))

    def level(self, level: int) -> tuple[torch.Tensor, torch.Tensor]:
        """Level ``level``'s (B^(level+1), 8) centroids and alive flags, as
        views of the table."""
        rows = slice(self.offset(level), self.offset(level + 1))
        return self.centroids[rows], self.alive[rows]

    def checksum(self) -> str:
        """MD5 of the tree as the JAX package computes it
        (System::CalculateCheckSum, System.cc:1531): the branching and depth,
        each level's unpacked int8 centroids with 0x7F on dead rows, then the
        weights."""
        h = hashlib.md5()
        h.update(str((self.branching, self.depth)).encode())
        for lvl in range(self.depth):
            c, a = (x.cpu().numpy() for x in self.level(lvl))
            for s in range(0, len(c), 1 << 16):  # in row chunks: the 10^6-word level is 256 MB unpacked
                rows = _unpack_np(c[s : s + (1 << 16)])
                rows[~a[s : s + (1 << 16)]] = _SENTINEL
                h.update(rows.tobytes())
        h.update(self.weights.cpu().numpy().astype(np.float32).tobytes())
        return h.hexdigest()

    def to(self, device) -> "Vocabulary":
        """The same vocabulary with its tables on ``device``."""
        return Vocabulary(self.branching, self.depth, self.centroids.to(device), self.alive.to(device),
                          self.weights.to(device), self.levels_up)

    @staticmethod
    def load(path) -> "Vocabulary":
        """Read a vocabulary ``.npz`` of the JAX package (``Vocabulary.save``):
        packed (np.packbits) or plain int8 centroids."""
        z = np.load(path)
        depth = int(z["depth"])
        packed = "packed" in z.files
        cents, alive = [], []
        for l in range(depth):
            c, a = z[f"c{l}"], z[f"a{l}"].astype(bool)
            if packed:  # (nodes, 32) big-endian bytes -> little-endian words
                words = _REVERSE[c].view("<u4").view(np.int32)
            else:
                live = c[a]
                if not (np.isin(live, (0, 1)).all() and (c[~a] == _SENTINEL).all()):
                    raise ValueError(f"{path}: level {l} holds centroid bytes other than 0/1 and the dead-row sentinel")
                words = _pack_np(c == 1)
            cents.append(words)
            alive.append(a)
        return Vocabulary(int(z["branching"]), depth, torch.as_tensor(np.concatenate(cents)),
                          torch.as_tensor(np.concatenate(alive)), torch.as_tensor(z["weights"].astype(np.float32)),
                          int(z["levels_up"]))


def _load_cached(path: Path, branching: int, depth: int) -> Vocabulary:
    """The vocabulary at ``path`` if it has this branching and depth."""
    if path.exists():
        v = Vocabulary.load(path)
        if v.branching == branching and v.depth == depth:
            return v
    raise NotImplementedError(
        f"no {branching}x{depth} vocabulary at {path}: training a vocabulary waits for ROADMAP §A item 8"
    )


def default_vocabulary(branching: int = 10, depth: int = 4) -> Vocabulary:
    """The stock vocabulary, 10^4 words (the ORBvoc.txt analogue)."""
    return _load_cached(_DEFAULT_PATH, branching, depth)


def large_vocabulary(branching: int = 10, depth: int = 5) -> Vocabulary:
    """10^5 words."""
    return _load_cached(_LARGE_PATH, branching, depth)


def huge_vocabulary(branching: int = 10, depth: int = 6) -> Vocabulary:
    """10^6 words, the size of the reference's ORBvoc.txt (System.cc:131)."""
    return _load_cached(_HUGE_PATH, branching, depth)


# --- transform ----------------------------------------------------------------


def _popcount32(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each int32 word, in int64 arithmetic."""
    x = x.to(torch.int64) & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & 0xFFFFFFFF) >> 24


def descend(voc: Vocabulary, desc: torch.Tensor) -> torch.Tensor:
    """Tree descent: (N,8) packed descriptors -> per-level node ids (depth, N)
    int64; at each level the child of least Hamming distance, the lowest
    child on ties, never a dead one."""
    n, B = desc.shape[0], voc.branching
    node = torch.zeros(n, dtype=torch.int64, device=desc.device)
    kids = torch.arange(B, device=desc.device)
    levels = []
    for lvl in range(voc.depth):
        cand = node[:, None] * B + kids  # (N,B) node ids of the children
        rows = voc.offset(lvl) + cand  # their rows in the table, as kernel N indexes it
        ham = _popcount32(desc[:, None, :] ^ voc.centroids[rows]).sum(-1)
        ham = torch.where(voc.alive[rows], ham, torch.full_like(ham, DEAD_DIST))
        node = torch.gather(cand, 1, torch.argmin(ham, dim=-1, keepdim=True))[:, 0]
        levels.append(node)
    return torch.stack(levels)


def transform_words(voc: Vocabulary, desc: torch.Tensor) -> torch.Tensor:
    """Descriptor -> leaf word id (N,)."""
    return descend(voc, desc)[-1]


def transform_plain(voc: Vocabulary, desc: torch.Tensor, valid: torch.Tensor):
    """Plain version of kernel N: (words (N,), nodes (N,), bow (W,))."""
    levels = descend(voc, desc)
    words = levels[-1]
    nodes = levels[max(voc.depth - 1 - voc.levels_up, 0)]
    w = torch.where(valid, voc.weights[words], torch.zeros((), device=desc.device))
    bow = torch.zeros(voc.n_words, dtype=torch.float32, device=desc.device).index_add_(0, words, w)
    bow = bow / torch.clamp(bow.sum(), min=1e-12)
    neg = torch.full_like(words, -1)
    return torch.where(valid, words, neg), torch.where(valid, nodes, neg), bow


def transform(voc: Vocabulary, desc: torch.Tensor, valid: torch.Tensor):
    """DBoW2's transform (TemplatedVocabulary::transform): leaf word ids
    (N,) int64, FeatureVector node ids at level ``max(depth - 1 - levels_up,
    0)`` (N,) int64, both -1 where invalid, and the L1-normalised tf-idf
    BoW (W,) float32.  Kernel N on CUDA tensors (``voc`` on the same
    device), its plain version on CPU ones."""
    if desc.device.type == "cpu":
        return transform_plain(voc, desc, valid)
    cents, alive = voc.centroids, voc.alive.view(torch.uint8)
    _kernels.require_cuda(
        "vocab_transform", desc=(desc, torch.int32), valid=(valid, torch.bool), centroids=(cents, torch.int32),
        alive=(alive, torch.uint8), weights=(voc.weights, torch.float32),
    )
    n = desc.shape[0]
    if desc.shape != (n, 8) or valid.shape != (n,) or not 1 <= voc.branching <= 32:
        raise ValueError("vocab_transform: needs (N,8) packed descriptors, (N,) valid and a branching of 1..32")
    dev = desc.device
    words = torch.empty(n, dtype=torch.int64, device=dev)
    nodes = torch.empty(n, dtype=torch.int64, device=dev)
    bow = torch.empty(voc.n_words, dtype=torch.float32, device=dev)
    total = torch.empty(1, dtype=torch.float64, device=dev)
    _kernels.launch(
        "vocab_transform_launch", dev,
        cents.data_ptr(), alive.data_ptr(), voc.weights.data_ptr(), voc.branching, voc.depth,
        max(voc.depth - 1 - voc.levels_up, 0), desc.data_ptr(), valid.data_ptr(), n, voc.n_words,
        words.data_ptr(), nodes.data_ptr(), bow.data_ptr(), total.data_ptr(),
    )
    transform.launches.add()
    return words, nodes, bow


transform.launches = _kernels.LaunchCounter()


def score_l1(bow_a: torch.Tensor, bow_b: torch.Tensor) -> torch.Tensor:
    """DBoW2's L1 score of two L1-normalised vectors, 1 - 0.5 |a - b|_1 in
    [0, 1]; broadcasts over the leading dims of b."""
    return 1.0 - 0.5 * torch.abs(bow_a - bow_b).sum(-1)
