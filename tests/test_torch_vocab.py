"""The port's vocabulary and keyframe database (vocab/) against the JAX
package's: the committed vocabularies load to the same tables and checksum,
the transform of one corridor frame's descriptors (the JAX extraction,
packed for the port) gives the same words and nodes and a BoW within float
rounding, ``score_l1`` agrees, and the database keeps the same rows and
returns the same candidates on the same BoW rows."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from orb_slam3_fast_tpu.cameras import models as jcam
from orb_slam3_fast_tpu.ops import extractor as jext
from orb_slam3_fast_tpu.vocab import database as jdb
from orb_slam3_fast_tpu.vocab import vocabulary as jvoc
from orb_slam3_fast_tpu_torch.ops import hamming as tham
from orb_slam3_fast_tpu_torch.vocab import database as tdb
from orb_slam3_fast_tpu_torch.vocab import vocabulary as tvoc

torch.set_num_threads(1)

CAM = jcam.Camera.pinhole(400.0, 400.0, 320.0, 240.0)


@pytest.fixture(scope="module")
def vocs():
    return jvoc.default_vocabulary(), tvoc.default_vocabulary()


@pytest.fixture(scope="module")
def frame_desc():
    """The JAX extraction (768 features) of corridor frames 0, 5 and 10 of
    the mono sequence: a list of (desc (N,256) int8, valid (N,))."""
    imgs, _ = chip_smoke.mono_frames(11)
    out = []
    for i in (0, 5, 10):
        kp = jext.extract(jnp.asarray(imgs[i]), jext.ExtractorConfig(n_features=768))
        out.append((np.asarray(kp.desc), np.asarray(kp.valid)))
    return out


@pytest.mark.parametrize("name", ["default", "large"])
def test_load_matches_jax(name):
    """Centroids (unpacked, with the 0x7F rows of dead branches), alive,
    weights, levels_up and the checksum are the JAX package's."""
    jv, tv = getattr(jvoc, f"{name}_vocabulary")(), getattr(tvoc, f"{name}_vocabulary")()
    assert (tv.branching, tv.depth, tv.levels_up, tv.n_words) == (jv.branching, jv.depth, jv.levels_up, jv.n_words)
    assert tv.centroids.shape == (sum(c.shape[0] for c in jv.centroids), 8)
    for lvl, (c_j, a_j) in enumerate(zip(jv.centroids, jv.alive)):
        c_t, a_t = tv.level(lvl)
        assert c_t.dtype == torch.int32 and c_t.shape == (c_j.shape[0], 8)
        bits = tham.unpack_desc(c_t).numpy()
        bits[~a_t.numpy()] = 0x7F
        np.testing.assert_array_equal(bits, np.asarray(c_j))
        np.testing.assert_array_equal(a_t.numpy(), np.asarray(a_j))
    np.testing.assert_array_equal(tv.weights.numpy(), np.asarray(jv.weights))
    assert tv.checksum() == jv.checksum()


def test_missing_vocabulary_raises():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tvoc.default_vocabulary(branching=9)


def test_transform_matches_jax(vocs, frame_desc):
    """Words and nodes equal; the BoW on the same words within 1e-6
    relative (the order of the float sums)."""
    jv, tv = vocs
    for desc, valid in frame_desc:
        wj, nj, bj = (np.asarray(x) for x in jvoc.transform(jv, jnp.asarray(desc), jnp.asarray(valid)))
        wt, nt, bt = tvoc.transform_plain(tv, tham.pack_desc(torch.as_tensor(desc)), torch.as_tensor(valid))
        np.testing.assert_array_equal(wt.numpy(), wj)
        np.testing.assert_array_equal(nt.numpy(), nj)
        np.testing.assert_array_equal(bt.numpy() != 0, bj != 0)
        nz = bj != 0
        assert np.abs(bt.numpy()[nz] - bj[nz]).max() <= 1e-6 * bj[nz].max()
        np.testing.assert_array_equal(tvoc.transform_words(tv, tham.pack_desc(torch.as_tensor(desc))).numpy(),
                                      np.asarray(jvoc.transform_words(jv, jnp.asarray(desc))))


def test_transform_with_dead_branches(vocs):
    """Random descriptors reach the dead children's sentinel rows often; a
    quarter of them invalid (-1 words, nothing in the BoW)."""
    jv, tv = vocs
    rng = np.random.default_rng(3)
    desc = rng.integers(0, 2, (300, 256)).astype(np.int8)
    valid = rng.uniform(size=300) > 0.25
    wj, nj, bj = (np.asarray(x) for x in jvoc.transform(jv, jnp.asarray(desc), jnp.asarray(valid)))
    wt, nt, bt = tvoc.transform_plain(tv, tham.pack_desc(torch.as_tensor(desc)), torch.as_tensor(valid))
    np.testing.assert_array_equal(wt.numpy(), wj)
    np.testing.assert_array_equal(nt.numpy(), nj)
    np.testing.assert_allclose(bt.numpy(), bj, rtol=1e-6, atol=1e-9)


def test_cpu_wrapper_is_the_plain_version(vocs, frame_desc):
    _, tv = vocs
    desc, valid = frame_desc[0]
    args = (tham.pack_desc(torch.as_tensor(desc)), torch.as_tensor(valid))
    before = tvoc.transform.launches.total()
    for x, y in zip(tvoc.transform(tv, *args), tvoc.transform_plain(tv, *args)):
        assert torch.equal(x, y)
    assert tvoc.transform.launches.total() == before


def test_score_l1_matches_jax():
    rng = np.random.default_rng(1)
    a = rng.uniform(size=50).astype(np.float32) * (rng.uniform(size=50) < 0.3)
    b = rng.uniform(size=(4, 50)).astype(np.float32) * (rng.uniform(size=(4, 50)) < 0.3)
    a, b = a / a.sum(), b / b.sum(1, keepdims=True)
    np.testing.assert_allclose(tvoc.score_l1(torch.as_tensor(a), torch.as_tensor(b)).numpy(),
                               np.asarray(jvoc.score_l1(jnp.asarray(a), jnp.asarray(b))), rtol=1e-6)


def _bows(vocs, frame_desc):
    """The BoWs of the three frames and of noisy copies: nine rows."""
    jv, _ = vocs
    rng = np.random.default_rng(2)
    rows = []
    for desc, valid in frame_desc:
        for flip in (0.0, 0.02, 0.05):
            d = np.where(rng.uniform(size=desc.shape) < flip, 1 - desc, desc).astype(np.int8)
            rows.append(np.asarray(jvoc.transform(jv, jnp.asarray(d), jnp.asarray(valid))[2]))
    return rows


def _same_db(a, b):
    for k in ("ids", "w", "valid", "map_id"):
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k))
    assert a.max_kf == b.max_kf


def test_database_matches_jax(vocs, frame_desc):
    """add (with growth past max_kf), erase, clear_map, dense_row and bow,
    the reloc candidates and the n-best candidates with covisibility groups
    (a dict and a callable), on the same rows in both packages."""
    bows = _bows(vocs, frame_desc)
    n_words = vocs[0].n_words
    dbj, dbt = jdb.KeyFrameDatabase(n_words, max_kf=4, row_words=512), tdb.KeyFrameDatabase(n_words, max_kf=4,
                                                                                           row_words=512)
    for k, bow in enumerate(bows):
        for db in (dbj, dbt):
            db.add(k, bow, map_id=k % 2)
    _same_db(dbj, dbt)
    assert dbt.max_kf == 16
    np.testing.assert_array_equal(dbt.dense_row(4), dbj.dense_row(4))
    np.testing.assert_array_equal(dbt.bow, dbj.bow)
    for q in (bows[1], bows[4], bows[8]):
        for m in (-1, 0, 1):
            np.testing.assert_array_equal(dbt.detect_reloc_candidates(q, query_map=m),
                                          dbj.detect_reloc_candidates(q, query_map=m))
        groups = {k: np.array([(k + 1) % 9, (k + 3) % 9]) for k in range(9)}
        for cov in (groups, lambda k: groups[k], None):
            for a, b in zip(dbt.detect_n_best_candidates(q, np.array([0]), 3, cov, query_map=0),
                            dbj.detect_n_best_candidates(q, np.array([0]), 3, cov, query_map=0)):
                np.testing.assert_array_equal(a, b)
    for db in (dbj, dbt):
        db.erase(3)
        db.clear_map(1)
    _same_db(dbj, dbt)
    np.testing.assert_array_equal(dbt.detect_reloc_candidates(bows[4]), dbj.detect_reloc_candidates(bows[4]))
    empty = np.zeros(n_words, np.float32)
    assert len(dbt.detect_reloc_candidates(empty)) == len(dbj.detect_reloc_candidates(empty)) == 0


def test_attach_mesh_waits_for_multi_device():
    with pytest.raises(NotImplementedError, match="item 12"):
        tdb.KeyFrameDatabase(100).attach_mesh(None)
