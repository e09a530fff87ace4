"""Kernel AD's plain version (``ops/hamming.match_epilogue_plain``) and the
port's searches against the JAX package's gates, on the CPU.

Every search's stage set (``chip_smoke.EPILOGUES``) gets the same best-2
inputs on both sides, seeded and tie-heavy (``chip_smoke.epilogue_case``:
dedup ties on equal distances, ratio products on the float32 edge,
rotation counts tied and at exactly 0.1x the first, angle differences on bin
edges and negative, a stereo case with every slot accepted and an even
count, so that the median is the mean of the middle pair, with distances at
and beside the 2.1x cut).  The JAX side composes ``ratio_gate``,
``mutual_consistency``, ``resolve_duplicate_targets`` and
``rotation_consistency`` as each search in ``ops/matching.py`` does, and
``stereo_match``'s median prune and depth (``ops/matching.py:249-259``).
The masks, right u and depth are equal exactly.  Then the port's searches
against the JAX package's on seeded keypoints, exactly."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from orb_slam3_fast_tpu.ops import hamming as jham
from orb_slam3_fast_tpu.ops import matching as jmat
from orb_slam3_fast_tpu_torch.ops import hamming as tham
from orb_slam3_fast_tpu_torch.ops import matching as tmat
from tests.test_torch_matching import SCALES, flip, kp_pair

torch.set_num_threads(1)

KINDS = list(chip_smoke.EPILOGUES)
N, M = 64, 64


def jax_epilogue(kind: str, case: dict):
    """The JAX package's gates of a search of ``kind`` on ``case``."""
    e = chip_smoke.EPILOGUES[kind]
    stereo = bool(e.get("stereo"))
    dt = jnp.float32 if stereo else jnp.int32
    idx = jnp.asarray(case["idx"].astype(np.int32))
    b = jham.Best2(idx, jnp.asarray(case["dist"]).astype(dt), jnp.asarray(case["dist2"]).astype(dt), idx)
    if "ratio" in e:
        accept = jham.ratio_gate(b, e["ratio"], e["th"])
    else:
        accept = b.dist <= e["th"]
    if e.get("mutual"):
        accept = accept & jham.mutual_consistency(b.idx, jnp.asarray(case["col"].astype(np.int32)))
    if e.get("dedup"):
        accept = jham.resolve_duplicate_targets(b.idx, b.dist, accept, case["angle_b"].shape[0])
    if e.get("rotation"):
        accept = jham.rotation_consistency(jnp.asarray(case["angle_a"]), jnp.asarray(case["angle_b"])[b.idx], accept)
    if not stereo:
        return np.asarray(accept)
    # ops/matching.py:249-259
    dist_f = jnp.where(accept, b.dist, jham.INF_DIST).astype(jnp.float32)
    med = jnp.median(jnp.where(accept, dist_f, jnp.nan))
    med = jnp.nan_to_num(med, nan=float(jham.TH_HIGH))
    accept = accept & (dist_f <= 2.1 * med)
    ur = jnp.asarray(case["xy_r"])[b.idx, 0]
    disparity = jnp.maximum(jnp.asarray(case["xy_l"])[:, 0] - ur, 1.0)
    depth = jnp.where(accept, chip_smoke.EPILOGUE_BF / disparity, -1.0)
    accept = accept & (depth > 0) & (depth < 1e6)
    return tuple(np.asarray(x) for x in (jnp.where(accept, ur, -1.0), jnp.where(accept, depth, -1.0), accept))


def plain_epilogue(kind: str, case: dict):
    b, th, kw = chip_smoke.epilogue_inputs(case, kind, "cpu")
    out = tham.match_epilogue_plain(b, th, **kw)
    return out.numpy() if isinstance(out, torch.Tensor) else tuple(x.numpy() for x in out)


@pytest.mark.parametrize("ties", [False, True], ids=["seeded", "tie-heavy"])
@pytest.mark.parametrize("kind", KINDS)
def test_plain_epilogue_matches_jax(kind, ties):
    """match_epilogue_plain against the JAX package's gates, exactly; the
    tie-heavy inputs keep what they were built for: the dedup's winners
    (rows 40-47 take columns 0-7 with a lower distance, the lowest row the
    others), the rotation's kept bins (3 and 7, tied at 10, and 12, tied with
    20 at exactly 0.1x the first), and in stereo every slot accepted before
    the median (30), whose 2.1x cut rounds below 63 in float32."""
    case = chip_smoke.epilogue_case(np.random.default_rng(7), kind, N, M, ties)
    want, got = jax_epilogue(kind, case), plain_epilogue(kind, case)
    if isinstance(want, tuple):
        for w, g in zip(want, got):
            np.testing.assert_array_equal(g, w)
        acc = got[2]
    else:
        np.testing.assert_array_equal(got, want)
        acc = got
    assert 0 < acc.sum() < N
    e = chip_smoke.EPILOGUES[kind]
    if ties and e.get("rotation"):
        np.testing.assert_array_equal(np.nonzero(acc)[0], np.r_[8:21, 40:48])  # columns 0-20, not 21 (bin 20)
    elif ties and e.get("dedup"):
        np.testing.assert_array_equal(np.nonzero(acc)[0], np.r_[8:22, 40:48])
    if ties and e.get("stereo"):
        assert acc.sum() == N - 3  # the cut keeps its own value and drops 63, the float above it and 70
        np.testing.assert_array_equal(np.sort(case["dist"][~acc]), np.float32([63.0, np.nextafter(np.float32(63), 99),
                                                                                70.0]))


def test_mod_two_pi_and_round_match_jax():
    """The rotation's bin arithmetic on edges: jnp.mod (fmod, then + 2 pi
    where the remainder is negative) on negative, zero, +-2 pi and near-edge
    differences, and jnp.round's half to even, equal to the plain version's."""
    two_pi = 2.0 * np.pi
    x = np.concatenate([np.arange(-31, 32) * (two_pi / 30), (np.arange(-31, 31) + 0.5) * (two_pi / 30),
                        [0.0, -0.0, two_pi, -two_pi, 2 * two_pi, 1e-7, -1e-7, np.nextafter(two_pi, 0)]])
    x = x.astype(np.float32)
    np.testing.assert_array_equal(tham._mod_two_pi(torch.as_tensor(x)).numpy(), np.asarray(jnp.mod(x, two_pi)))
    acc = np.ones(len(x), bool)
    zero = np.zeros(len(x), np.float32)
    np.testing.assert_array_equal(
        tham.rotation_consistency(torch.as_tensor(x), torch.as_tensor(zero), torch.as_tensor(acc)).numpy(),
        np.asarray(jham.rotation_consistency(jnp.asarray(x), jnp.asarray(zero), jnp.asarray(acc))))


def test_depth_is_one_rounding():
    """The stereo depth is bf / disparity in one float32 rounding, as the JAX
    package's (PyTorch's ``bf / tensor`` is reciprocal() * bf, off by an ulp
    for about a quarter of these)."""
    rng = np.random.default_rng(3)
    n = 4096
    case = dict(idx=np.arange(n), dist=np.full(n, 10.0, np.float32), dist2=np.full(n, 90.0, np.float32),
                col=np.arange(n), angle_a=np.zeros(n, np.float32), angle_b=np.zeros(n, np.float32),
                xy_l=np.stack([rng.uniform(100, 600, n), np.zeros(n)], 1).astype(np.float32))
    case["xy_r"] = (case["xy_l"] - np.stack([rng.uniform(1, 80, n), np.zeros(n)], 1)).astype(np.float32)
    want, got = jax_epilogue("stereo", case), plain_epilogue("stereo", case)
    assert want[2].all()
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)


def _keypoints(rng, n, angle=True):
    xy = np.stack([rng.uniform(20, 620, n), rng.uniform(20, 460, n)], -1)
    lvl = rng.integers(0, 3, n)
    desc = rng.integers(0, 2, (n, 256)).astype(np.int8)
    j, t = kp_pair(xy, lvl, desc)
    if angle:
        ang = rng.uniform(-np.pi, np.pi, n).astype(np.float32)
        j, t = j._replace(angle=jnp.asarray(ang)), t._replace(angle=torch.as_tensor(ang))
    return (xy, lvl, desc), j, t


def test_searches_match_jax_exactly():
    """The port's searches (kernel C's plain version, then
    match_epilogue_plain) against the JAX package's on seeded keypoints
    with near copies of the descriptors, at the same inputs: the indices and
    masks equal, the stereo right u and depth bit for bit."""
    rng = np.random.default_rng(11)
    n = 96
    (xy, lvl, desc), j0, t0 = _keypoints(rng, n)
    xy1 = xy + rng.normal(0, 1.5, xy.shape)
    desc1 = np.stack([flip(rng, d, int(k)) for d, k in zip(desc, rng.integers(0, 60, n))])
    desc1[::4] = rng.integers(0, 2, (len(desc1[::4]), 256))  # a quarter without a partner
    ang1 = (np.asarray(j0.angle) + rng.choice([0.2, 0.21, -6.0, 3.3], n)).astype(np.float32)
    j1, t1 = kp_pair(xy1, lvl, desc1)
    j1, t1 = j1._replace(angle=jnp.asarray(ang1)), t1._replace(angle=torch.as_tensor(ang1))
    lvl0 = np.zeros(n, np.int64)
    j0z, t0z = j0._replace(level=jnp.asarray(lvl0.astype(np.int32))), t0._replace(level=torch.as_tensor(lvl0))
    j1z, t1z = j1._replace(level=jnp.asarray(lvl0.astype(np.int32))), t1._replace(level=torch.as_tensor(lvl0))
    pairs = [(jmat.search_for_initialization(j0z, j1z, 100.0), tmat.search_for_initialization(t0z, t1z, 100.0))]
    uv = xy1 + rng.normal(0, 1.0, xy1.shape)
    valid = rng.uniform(size=n) > 0.1
    pairs.append((jmat.search_frame_to_frame(j1, jnp.asarray(uv, jnp.float32), jnp.asarray(valid), j0.desc, j0.level,
                                             j0.angle, jnp.asarray(SCALES)),
                  tmat.search_frame_to_frame(t1, torch.as_tensor(uv, dtype=torch.float32), torch.as_tensor(valid),
                                             t0.desc, t0.level, t0.angle, torch.as_tensor(SCALES))))
    pairs.append((jmat.search_descriptors_mutual(j0.desc, j0.valid, j1.desc, j1.valid, th=100, ratio=0.85),
                  tmat.search_descriptors_mutual(t0.desc, t0.valid, t1.desc, t1.valid, th=100, ratio=0.85)))
    for (ij, aj), (it, at) in pairs:
        acc = np.asarray(aj)
        np.testing.assert_array_equal(at.numpy(), acc)
        np.testing.assert_array_equal(it.numpy()[acc], np.asarray(ij)[acc])
        assert 0 < acc.sum() < n
    # stereo: right keypoints on the same rows, every left slot with a partner
    xy_r = np.stack([xy[:, 0] - rng.uniform(2, 40, n), xy[:, 1] + rng.uniform(-0.5, 0.5, n)], -1)
    desc_r = np.stack([flip(rng, d, int(k)) for d, k in zip(desc, rng.integers(0, 30, n))])
    jr, tr = kp_pair(xy_r, lvl, desc_r)
    sj = jmat.stereo_match(j0, jr, jnp.asarray(SCALES), bf=40.0, min_z=0.5)
    st = tmat.stereo_match(t0, tr, torch.as_tensor(SCALES), bf=40.0, min_z=0.5)
    for x, y in zip(st, sj):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))
    assert 0 < st.valid.sum() < n


def test_wrapper_cpu_plain_other_devices_raise():
    """match_epilogue takes the plain version for CPU tensors and counts no
    launch; a tensor on another device than the CPU or CUDA gets no plain
    path; the ratio test does not go with the inclusive threshold."""
    for kind in KINDS:
        case = chip_smoke.epilogue_case(np.random.default_rng(2), kind, N, M)
        b, th, kw = chip_smoke.epilogue_inputs(case, kind, "cpu")
        n0 = tham.match_epilogue.launches.total()
        assert chip_smoke.epilogues_equal(tham.match_epilogue(b, th, **kw), tham.match_epilogue_plain(b, th, **kw))
        assert tham.match_epilogue.launches.total() == n0
        mb, _, mkw = chip_smoke.epilogue_inputs(case, kind, "meta")
        with pytest.raises(ValueError, match="CUDA"):
            tham.match_epilogue(mb, th, **mkw)
    with pytest.raises(ValueError, match="ratio"):
        tham.match_epilogue_plain(b, 50, inclusive=True, ratio=0.8)
    # kernel C's mode numbers, beside AD's stage flags in the same module
    assert [tham.MODE_NAMES[m] for m in (tham._STEREO, tham._WINDOW, tham._EPIPOLAR, tham._MUTUAL)] == list(
        tham.MODE_NAMES)
    assert {kind: tham.stage_set(tham._flags(kw["inclusive"], kw["ratio"], kw.get("col"), kw.get("dedup_m"),
                                             kw.get("angles"), kw.get("stereo")))
            for kind in KINDS for _, _, kw in [chip_smoke.epilogue_inputs(chip_smoke.epilogue_case(
                np.random.default_rng(0), kind, N, M), kind, "cpu")]} == chip_smoke.STAGE_SETS
