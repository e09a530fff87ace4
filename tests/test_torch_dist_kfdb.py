"""The port's sharded keyframe database (orb_slam3_fast_tpu_torch/parallel/
dist_kfdb.py, kernel AE's plain version on the CPU) against the JAX
package's (tests/test_dist_kfdb.py's three cases) and the host database,
at a world of one in this process and at two gloo ranks spawned once for
the module: the counts equal the host's, the scores within 1e-5 of them
(the JAX package's bound, tests/test_dist_kfdb.py:34) and of the JAX
package's sharded scores on its 8 virtual devices; a row is scored whole
on one rank, so the scores are the same bits at either world size; the
candidates equal; the mirror re-shards as the table grows."""
import numpy as np
import pytest
import torch

from orb_slam3_fast_tpu.parallel import multihost as jmh
from orb_slam3_fast_tpu.vocab import database as jdb
from orb_slam3_fast_tpu_torch.parallel import dist_kfdb
from tests import torch_dist_cases as cases
from tests.torch_ranks import Ranks

torch.set_num_threads(1)

N_WORDS, MAX_KF = 512, 64  # tests/test_dist_kfdb.py's database


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    r = Ranks(2, tmp_path_factory.mktemp("dist_kfdb_ranks"))
    yield r
    r.close()


def jax_db(bows, attach: bool):
    db = jdb.KeyFrameDatabase(N_WORDS, max_kf=MAX_KF)
    if attach:
        db.attach_mesh(jmh.global_mesh())
    for k, bow in enumerate(bows):
        db.add(k, bow, map_id=0)
    return db


def test_scores_match_host_and_jax(ranks):
    """tests/test_dist_kfdb.py:24-35: 24 rows, a query, keyframe 3
    excluded.  The port's world of one and each of its two ranks: the host
    database's counts and eligibility exactly, its scores within 1e-5; the
    same bits at both world sizes and on both ranks; each rank holds rows
    [32 r, 32 (r + 1)).  The JAX package's sharded scores within 1e-5."""
    bows = cases.kfdb_rows(N_WORDS, 24, seed=7)
    rng = np.random.default_rng(0)
    q = rng.uniform(0, 1, N_WORDS).astype(np.float32)
    q[rng.uniform(0, 1, N_WORDS) < 0.8] = 0.0
    q /= q.sum()
    ch, sh, eh = cases.make_db(N_WORDS, MAX_KF, bows, attach=False)._scores(q, np.asarray([3]))
    one = cases.kfdb_scores(N_WORDS, MAX_KF, bows, q, [3])
    two = ranks.run(cases.kfdb_scores, N_WORDS, MAX_KF, bows, q, [3])
    for r, (c, s, e, lo, hi) in enumerate([one] + two):
        np.testing.assert_array_equal(c, ch)
        np.testing.assert_allclose(s, sh, atol=1e-5)
        np.testing.assert_array_equal(e, eh)
        np.testing.assert_array_equal(s, one[1])
    assert [(o[3], o[4]) for o in two] == [(0, 32), (32, 64)]
    cj, sj, _ = jax_db(bows, attach=True)._scores(q, np.asarray([3]))
    np.testing.assert_array_equal(cj, ch)
    np.testing.assert_allclose(one[1], sj, atol=1e-5)


def test_candidates_match_host(ranks):
    """tests/test_dist_kfdb.py:38-48: a near-duplicate query of row 5, which
    is erased; detect_n_best_candidates on either world size equals the
    host database's and the JAX package's."""
    bows = cases.kfdb_rows(N_WORDS, 24, seed=11)
    host = cases.make_db(N_WORDS, MAX_KF, bows, attach=False)
    q = host.bow[5].copy()
    host.erase(5)
    lh, mh = host.detect_n_best_candidates(q, np.asarray([4, 6]), 3, query_map=0)
    jd = jax_db(bows, attach=True)
    jd.erase(5)
    lj, mj = jd.detect_n_best_candidates(q, np.asarray([4, 6]), 3, query_map=0)
    np.testing.assert_array_equal(lh, lj)
    np.testing.assert_array_equal(mh, mj)
    for ls, ms in [cases.kfdb_candidates(N_WORDS, MAX_KF, bows, 5)] + ranks.run(cases.kfdb_candidates, N_WORDS, MAX_KF,
                                                                                bows, 5):
        np.testing.assert_array_equal(lh, ls)
        np.testing.assert_array_equal(mh, ms)


def test_growth_reshards(ranks):
    """tests/test_dist_kfdb.py:51-63: 8 rows of capacity, 20 added (8 -> 16
    -> 32), the mirror re-sharded at each growth; the last row's query
    counts its shared words in every row, at both world sizes."""
    rng = np.random.default_rng(3)
    bows = []
    for _ in range(20):
        bow = rng.uniform(0, 1, N_WORDS).astype(np.float32)
        bows.append(bow / bow.sum())
    for max_kf, mirror_kf, c, s, dense in [cases.kfdb_growth(N_WORDS, bows)] + ranks.run(cases.kfdb_growth,
                                                                                           N_WORDS, bows):
        assert max_kf == 32 and mirror_kf == 32
        np.testing.assert_array_equal(c, ((dense > 0) & (dense[19] > 0)[None]).sum(1))


def test_plain_score_order_and_empty_slots():
    """Kernel AE's plain version: the -1 slots read the table's trailing
    zero, rows of a width that is not a multiple of 32 are padded, and the
    score is each row's terms summed as the kernel's warp sums them (32
    lanes, then a shuffle tree), within one float32 rounding per term of
    the host's pairwise sum."""
    rng = np.random.default_rng(5)
    ids = rng.integers(0, 100, (6, 45)).astype(np.int32)
    ids[:, 40:] = -1
    w = rng.uniform(0.0, 1.0, ids.shape).astype(np.float32)
    lut = np.concatenate([rng.uniform(0, 1, 100).astype(np.float32) * (rng.uniform(size=100) < 0.5), [0.0]])
    c, s = dist_kfdb.score_rows_plain(torch.from_numpy(ids), torch.from_numpy(w),
                                      torch.from_numpy(lut.astype(np.float32)))
    qw = lut[np.where(ids >= 0, ids, 100)]
    shared = (qw > 0) & (w > 0)
    np.testing.assert_array_equal(c.numpy(), shared.sum(1))
    np.testing.assert_allclose(s.numpy(), np.where(shared, np.minimum(w, qw), 0).sum(1), rtol=1e-6)
    lanes = np.pad(np.where(shared, np.minimum(w, qw), 0).astype(np.float32), ((0, 0), (0, 19))).reshape(6, 2, 32)
    acc = lanes[:, 0] + lanes[:, 1]
    for sft in (16, 8, 4, 2, 1):
        acc = acc[:, :sft] + acc[:, sft:2 * sft]
    np.testing.assert_array_equal(s.numpy(), acc[:, 0])
