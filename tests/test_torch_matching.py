"""Parity of the port's matchers with the JAX package: Hamming primitives,
kernel C's plain version in both modes, stereo_match (soft gate, mutual
check, averaged median), search_by_projection and the SAD subpixel refine.
Every matcher gets the SAME keypoints on both sides."""
import jax.numpy as jnp
import numpy as np
import torch

from orb_slam3_fast_tpu.ops import extractor as jext
from orb_slam3_fast_tpu.ops import hamming as jham
from orb_slam3_fast_tpu.ops import matching as jmat
from orb_slam3_fast_tpu_torch.ops import hamming as tham
from orb_slam3_fast_tpu_torch.ops import matching as tmat
from orb_slam3_fast_tpu_torch.utils import convert

torch.set_num_threads(1)

SCALES = (1.2 ** np.arange(8)).astype(np.float32)


def kp_pair(xy, level, desc, valid=None):
    """The same keypoints as a JAX Keypoints and as the port's."""
    n = len(xy)
    valid = np.ones(n, bool) if valid is None else valid
    fields = dict(
        xy=np.asarray(xy, np.float32), level=np.asarray(level, np.int32),
        angle=np.zeros(n, np.float32), response=np.ones(n, np.float32),
        desc=np.asarray(desc, np.int8), valid=valid,
    )
    return jext.Keypoints(**{k: jnp.asarray(v) for k, v in fields.items()}), convert.keypoints_to_torch(
        **fields, device="cpu"
    )


def flip(rng, d, k):
    d = d.copy()
    d[rng.choice(256, k, replace=False)] ^= 1
    return d


def test_hamming_primitives(rng):
    a = rng.integers(0, 2, (40, 256)).astype(np.int8)
    b = np.concatenate([a[:10], rng.integers(0, 2, (30, 256)).astype(np.int8)])
    H_j = np.asarray(jham.hamming_matrix(jnp.asarray(a), jnp.asarray(b)))
    pa, pb = tham.pack_desc(torch.as_tensor(a)), tham.pack_desc(torch.as_tensor(b))
    H_t = tham.hamming_matrix(pa, pb).numpy()
    np.testing.assert_array_equal(H_t, H_j)
    mask = rng.uniform(size=H_j.shape) > 0.6
    mask[3] = False  # a row with no candidate
    bj = jham.masked_best2(jnp.asarray(H_j), jnp.asarray(mask))
    bt = tham.masked_best2(torch.as_tensor(H_t), torch.as_tensor(mask))
    for x, y in zip(bt, bj):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))
    tie = np.tile(np.array([[5.0, 3.0, 3.0, 9.0]], np.float32), (2, 1))  # ties -> lowest index
    pj, pt = jham.penalized_best2(jnp.asarray(tie)), tham.penalized_best2(torch.as_tensor(tie))
    for x, y in zip(pt, pj):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))
    np.testing.assert_array_equal(
        tham.ratio_gate(bt, 0.8, 100).numpy(), np.asarray(jham.ratio_gate(bj, 0.8, 100))
    )
    acc = np.asarray(bj.dist) < 120
    np.testing.assert_array_equal(
        tham.resolve_duplicate_targets(bt.idx, bt.dist, torch.as_tensor(acc), 40).numpy(),
        np.asarray(jham.resolve_duplicate_targets(bj.idx, bj.dist, jnp.asarray(acc), 40)),
    )
    back = rng.integers(0, 40, 40)
    np.testing.assert_array_equal(
        tham.mutual_consistency(bt.idx, torch.as_tensor(back)).numpy(),
        np.asarray(jham.mutual_consistency(bj.idx, jnp.asarray(back))),
    )
    ang_a, ang_b = rng.uniform(-3, 3, 40).astype(np.float32), rng.uniform(-3, 3, 40).astype(np.float32)
    ang_b[:25] = ang_a[:25] + 0.3
    acc = rng.uniform(size=40) > 0.2
    np.testing.assert_array_equal(
        tham.rotation_consistency(torch.as_tensor(ang_a), torch.as_tensor(ang_b), torch.as_tensor(acc)).numpy(),
        np.asarray(jham.rotation_consistency(jnp.asarray(ang_a), jnp.asarray(ang_b), jnp.asarray(acc))),
    )


def test_resolve_duplicate_targets_ties():
    idx = np.array([2, 2, 2, 0, 0], np.int32)
    dist = np.array([7, 5, 5, 9, 9], np.int32)
    acc = np.array([True, True, True, True, False])
    got = tham.resolve_duplicate_targets(
        torch.as_tensor(idx).long(), torch.as_tensor(dist), torch.as_tensor(acc), 4
    ).numpy()
    want = np.asarray(jham.resolve_duplicate_targets(jnp.asarray(idx), jnp.asarray(dist), jnp.asarray(acc), 4))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, [False, True, False, True, False])


def stereo_scene(rng):
    """Eight left keypoints, each with a right partner at a known Hamming
    distance; every left slot is accepted, so the median is the average of
    the middle pair (6 and 10 -> 8, prune at 16.8: 14 stays, 30 and 40 go;
    torch.median's 6 would prune 14 too).  Row 0's true partner (distance
    14) loses to a decoy at Hamming 0 that lies 0.001 px outside the row
    band: the soft gate charges it only 10."""
    n = 8
    dists = [14, 2, 4, 4, 6, 10, 30, 40]
    desc_l = rng.integers(0, 2, (n, 256)).astype(np.int8)
    xy_l = np.stack([rng.uniform(60, 600, n), 20.0 + 40.0 * np.arange(n)], -1).astype(np.float32)
    lvl = np.array([0, 0, 1, 1, 2, 0, 1, 0])
    disp = rng.uniform(4, 30, n)
    xy_r = np.stack([xy_l[:, 0] - disp, xy_l[:, 1] + rng.uniform(-0.5, 0.5, n)], -1)
    desc_r = np.stack([flip(rng, desc_l[i], dists[i]) for i in range(n)])
    band = 2.0 * SCALES[lvl[0]]
    decoy_xy = [xy_l[0, 0] - 10.0, xy_l[0, 1] - band - 0.001]
    xy_r = np.concatenate([xy_r, [decoy_xy]]).astype(np.float32)
    desc_r = np.concatenate([desc_r, desc_l[:1]])
    lvl_r = np.concatenate([lvl, [lvl[0]]])
    return (xy_l, lvl, desc_l), (xy_r, lvl_r, desc_r)


def _stereo_both(left, right, bf=40.0, min_z=0.5, slot_scale=False):
    jl, tl = kp_pair(*left)
    jr, tr = kp_pair(*right)
    kw_j, kw_t = {}, {}
    if slot_scale:
        ss = SCALES[np.asarray(right[1])]
        kw_j["slot_scale_r"], kw_t["slot_scale_r"] = jnp.asarray(ss), torch.as_tensor(ss)
    sj = jmat.stereo_match(jl, jr, jnp.asarray(SCALES), bf=bf, min_z=min_z, **kw_j)
    st = tmat.stereo_match(tl, tr, torch.as_tensor(SCALES), bf=bf, min_z=min_z, **kw_t)
    return sj, st


def test_stereo_match_soft_gate_and_median(rng):
    left, right = stereo_scene(rng)
    sj, st = _stereo_both(left, right)
    for x, y in zip(st, sj):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=1e-6)
    valid = st.valid.numpy()
    np.testing.assert_array_equal(valid, [True, True, True, True, True, True, False, False])
    assert st.right_u.numpy()[0] == right[0][8, 0]  # the decoy won row 0
    m = tmat._median(torch.tensor([1.0, 2.0, 3.0, 4.0]))
    assert float(m) == 2.5 and float(torch.median(torch.tensor([1.0, 2.0, 3.0, 4.0]))) == 2.0
    assert torch.isnan(tmat._median(torch.tensor([1.0, float("nan"), 3.0, 4.0])))


def test_stereo_match_random(rng):
    """Dense random case: 96 x 96 keypoints on few rows, so bands overlap;
    slot scales as the tracker passes them.  The median is NaN here (not
    every slot is accepted) exactly as in the reference."""
    n = 96
    xy_l = np.stack([rng.uniform(40, 600, n), rng.integers(0, 6, n) * 20.0 + rng.uniform(-1, 1, n)], -1)
    lvl_l = rng.integers(0, 4, n)
    desc_l = rng.integers(0, 2, (n, 256)).astype(np.int8)
    xy_r = xy_l + np.stack([-rng.uniform(0, 40, n), rng.uniform(-3, 3, n)], -1)
    desc_r = np.stack([flip(rng, d, int(k)) for d, k in zip(desc_l, rng.integers(0, 90, n))])
    lvl_r = np.clip(lvl_l + rng.integers(-2, 3, n), 0, 7)
    valid_r = rng.uniform(size=n) > 0.1
    sj, st = _stereo_both((xy_l, lvl_l, desc_l), (xy_r, lvl_r, desc_r, valid_r), slot_scale=True)
    for x, y in zip(st, sj):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=1e-6)
    assert 10 < st.valid.sum() < n


def test_search_by_projection(rng):
    n_kp, n_lm = 80, 160
    xy = np.stack([rng.uniform(0, 640, n_kp), rng.uniform(0, 480, n_kp)], -1).astype(np.float32)
    lvl = rng.integers(0, 8, n_kp)
    desc = rng.integers(0, 2, (n_kp, 256)).astype(np.int8)
    valid = rng.uniform(size=n_kp) > 0.1
    src = rng.integers(0, n_kp, n_lm)  # several landmarks per keypoint -> dedup
    uv = (xy[src] + rng.normal(0, 2.5, (n_lm, 2))).astype(np.float32)
    lm_desc = np.stack([flip(rng, desc[s], int(k)) for s, k in zip(src, rng.integers(0, 110, n_lm))])
    pred = np.clip(lvl[src] + rng.integers(-2, 3, n_lm), 0, 7).astype(np.int32)
    pvalid = rng.uniform(size=n_lm) > 0.1
    jk, tk = kp_pair(xy, lvl, desc, valid)
    ij, aj = jmat.search_by_projection(
        jk, jnp.asarray(uv), jnp.asarray(pvalid), jnp.asarray(lm_desc), jnp.asarray(pred), jnp.asarray(SCALES)
    )
    it, at = tmat.search_by_projection(
        tk, torch.as_tensor(uv), torch.as_tensor(pvalid), convert.desc_to_torch(lm_desc, "cpu"),
        torch.as_tensor(pred).long(), torch.as_tensor(SCALES),
    )
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_array_equal(at.numpy(), np.asarray(aj))
    assert at.sum() > 20
    # kernel C's plain contract, second-best included, against the reference's
    # masked_best2 on the reference's mask
    r = 3.0 * SCALES[pred]
    dx = np.abs(uv[:, None, 0] - xy[None, :, 0])
    dy = np.abs(uv[:, None, 1] - xy[None, :, 1])
    mask = (dx <= r[:, None]) & (dy <= r[:, None]) & (np.abs(lvl[None, :] - pred[:, None]) <= 1)
    mask &= pvalid[:, None] & valid[None, :]
    bj = jham.masked_best2(jham.hamming_matrix(jnp.asarray(lm_desc), jnp.asarray(desc)), jnp.asarray(mask))
    gate = tham.WindowGate(
        torch.as_tensor(uv[:, 0]), torch.as_tensor(uv[:, 1]), torch.as_tensor(r),
        torch.as_tensor(pred, dtype=torch.float32), torch.as_tensor(pvalid, dtype=torch.float32),
        tk.xy[:, 0].contiguous(), tk.xy[:, 1].contiguous(), tk.level.float(), tk.valid.float(),
    )
    bt, none = tham.hamming_best2(convert.desc_to_torch(lm_desc, "cpu"), tk.desc, gate)
    assert none is None
    for x, y in zip(bt, bj):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))


def test_stereo_subpixel_refine(rng):
    h, w = 120, 200
    img_l = rng.uniform(0, 255, (h, w)).astype(np.float32)
    img_l = (img_l + np.roll(img_l, 1, 1) + np.roll(img_l, 1, 0)) / 3.0  # some smoothness
    img_r = np.roll(img_l, -7, axis=1) + rng.normal(0, 2, (h, w)).astype(np.float32)
    n = 40
    xy = np.stack([rng.uniform(20, w - 20, n), rng.uniform(8, h - 8, n)], -1).astype(np.float32)
    ru = (xy[:, 0] - 7 + rng.integers(-6, 7, n)).astype(np.float32)
    valid = rng.uniform(size=n) > 0.2
    rj, oj = jmat.stereo_subpixel_refine(
        jnp.asarray(img_l), jnp.asarray(img_r), jnp.asarray(xy), jnp.asarray(ru), jnp.asarray(valid)
    )
    rt, ot = tmat.stereo_subpixel_refine(
        torch.as_tensor(img_l), torch.as_tensor(img_r), torch.as_tensor(xy), torch.as_tensor(ru), torch.as_tensor(valid)
    )
    np.testing.assert_array_equal(ot.numpy(), np.asarray(oj))
    # SAD sums of 121 terms in another order: float32 rounding of the parabola
    np.testing.assert_allclose(rt.numpy(), np.asarray(rj), atol=1e-3)
    assert ot.sum() > 5


# --- the matchers the System adds: frame to frame, mutual, triangulation -----


def _frames(rng, shift=(5, 3), h=160, w=224):
    """Two crops of one textured canvas, the second moved by ``shift`` px;
    the port's extractor gives the keypoints, handed to both packages."""
    from orb_slam3_fast_tpu_torch.ops import extractor as text

    cv = rng.uniform(0, 50, (h + 16, w + 16)).astype(np.float32)
    for _ in range(70):
        cy, cx = rng.integers(0, h - 8), rng.integers(0, w - 8)
        cv[cy : cy + rng.integers(6, 20), cx : cx + rng.integers(6, 20)] += rng.uniform(80, 170)
    cv = np.clip(cv, 0, 255)
    cfg = text.ExtractorConfig(256, 4, 1.2, 20.0, 7.0, 32, 8)
    out = []
    for dy, dx in ((0, 0), shift):
        kp = text.extract(torch.as_tensor(cv[8 + dy : 8 + dy + h, 8 + dx : 8 + dx + w].copy()), cfg)
        f = convert.keypoints_to_numpy(kp)
        out.append((jext.Keypoints(**{k: jnp.asarray(v) for k, v in f.items()}), kp, f))
    return out


def test_search_frame_to_frame(rng):
    (j0, t0, f0), (j1, t1, f1) = _frames(rng)
    uv = (f0["xy"] - np.array([3.0, 5.0], np.float32) + rng.normal(0, 1.0, f0["xy"].shape)).astype(np.float32)
    pvalid = f0["valid"] & (rng.uniform(size=len(uv)) > 0.1)
    scales = SCALES[:4]
    ij, aj = jmat.search_frame_to_frame(
        j1, jnp.asarray(uv), jnp.asarray(pvalid), j0.desc, j0.level, j0.angle, jnp.asarray(scales)
    )
    it, at = tmat.search_frame_to_frame(
        t1, torch.as_tensor(uv), torch.as_tensor(pvalid), t0.desc, t0.level, t0.angle, torch.as_tensor(scales)
    )
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_array_equal(at.numpy(), np.asarray(aj))
    assert at.sum() > 40


def test_search_descriptors_mutual(rng):
    (j0, t0, f0), (j1, t1, f1) = _frames(rng, shift=(-4, 7))
    has = f0["valid"] & (rng.uniform(size=len(f0["valid"])) > 0.3)
    for th, ratio in ((100, 0.85), (50, 0.75)):
        ij, aj = jmat.search_descriptors_mutual(j0.desc, jnp.asarray(has), j1.desc, j1.valid, th=th, ratio=ratio)
        it, at = tmat.search_descriptors_mutual(t0.desc, torch.as_tensor(has), t1.desc, t1.valid, th=th, ratio=ratio)
        np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
        np.testing.assert_array_equal(at.numpy(), np.asarray(aj))
        assert at.sum() > 20
    # kernel C's mutual-mode plain contract: the column argmin of the masked matrix
    gate = tham.MutualGate(torch.as_tensor(has, dtype=torch.float32), t1.valid.float())
    b, col = tham.hamming_best2_plain(t0.desc, t1.desc, gate)
    bj = jham.masked_best2(jham.hamming_matrix(j0.desc, j1.desc).T, jnp.asarray(has[None, :] & f1["valid"][:, None]))
    np.testing.assert_array_equal(col.numpy(), np.asarray(bj.idx))


def test_search_for_triangulation(rng):
    """F of a sideways step, keypoints of two shifted crops: the same idx and
    accept, apart from candidates within 1e-5 (relative) of the chi2 band
    edge, whose float32 rounding may differ between the two einsum orders."""
    (j0, t0, f0), (j1, t1, f1) = _frames(rng, shift=(0, 6))
    # a pure x step: epipolar lines are rows; fx = 200, so x_b^T F x_a = 0 at equal v
    K = np.array([[200.0, 0, 112], [0, 200.0, 80], [0, 0, 1]])
    tx = np.array([[0, 0, 0], [0, 0, 1.0], [0, -1.0, 0]])  # t = (-1, 0, 0)
    Kinv = np.linalg.inv(K)
    F = (Kinv.T @ tx @ Kinv).astype(np.float32)
    sigma2 = (1.44 ** np.arange(4)).astype(np.float32)
    free_a = f0["valid"] & (rng.uniform(size=len(f0["valid"])) > 0.2)
    free_b = f1["valid"] & (rng.uniform(size=len(f1["valid"])) > 0.2)
    ij, aj = jmat.search_for_triangulation(j0, j1, jnp.asarray(free_a), jnp.asarray(free_b), jnp.asarray(F),
                                           jnp.asarray(sigma2))
    it, at = tmat.search_for_triangulation(t0, t1, torch.as_tensor(free_a), torch.as_tensor(free_b),
                                           torch.as_tensor(F), torch.as_tensor(sigma2))
    ij, aj, it, at = np.asarray(ij), np.asarray(aj), it.numpy(), at.numpy()
    differ = np.nonzero((ij != it) | (aj != at))[0]
    if len(differ):
        xa = np.concatenate([f0["xy"], np.ones((len(f0["xy"]), 1))], 1).astype(np.float64)
        xb = np.concatenate([f1["xy"], np.ones((len(f1["xy"]), 1))], 1).astype(np.float64)
        lines = xa @ F.T.astype(np.float64)
        dsq = (lines @ xb.T) ** 2 / (lines[:, :1] ** 2 + lines[:, 1:2] ** 2)
        thr = 3.84 * sigma2[f1["level"]][None, :]
        edge = np.abs(dsq / thr - 1.0) < 1e-5
        for i in differ:
            cols = {ij[i], it[i]}
            assert edge[i].any() or edge[:, list(cols)].any(), f"row {i} differs away from the band edge"
    assert at.sum() > 20
    # kernel C's epipolar-mode plain contract against the reference's mask
    xa = np.concatenate([f0["xy"], np.ones((len(f0["xy"]), 1), np.float32)], 1)
    lines = torch.as_tensor(xa) @ torch.as_tensor(F).T
    gate = tham.EpipolarGate(
        lines[:, 0].contiguous(), lines[:, 1].contiguous(), lines[:, 2].contiguous(), lines[:, 0] ** 2 + lines[:, 1] ** 2,
        torch.as_tensor(free_a & f0["valid"], dtype=torch.float32), t1.xy[:, 0].contiguous(),
        t1.xy[:, 1].contiguous(), 3.84 * tmat._pow_level(t1.level, torch.as_tensor(sigma2)),
        torch.as_tensor(free_b & f1["valid"], dtype=torch.float32),
    )
    b, col = tham.hamming_best2_plain(t0.desc, t1.desc, gate)
    np.testing.assert_array_equal(b.idx.numpy()[at], it[at])
    assert col.shape == (len(f1["xy"]),)


def test_search_for_initialization(rng):
    """Kernel C's window mode with the level-0 test in the validity flags:
    the same idx and accept as the JAX matcher, on the mono corridor's
    frames 0 and 5 (the JAX extraction) and on shifted crops whose levels
    vary."""
    import chip_smoke

    imgs, _ = chip_smoke.mono_frames(6)
    cfg = jext.ExtractorConfig(n_features=768)
    pairs = []
    for i in (0, 5):
        kp = jext.extract(jnp.asarray(imgs[i]), cfg)
        pairs.append((kp, convert.keypoints_to_torch(**{k: np.asarray(getattr(kp, k)) for k in kp._fields},
                                                     device="cpu")))
    (j0, t0), (j1, t1) = pairs
    (c0, u0, _), (c1, u1, _) = _frames(rng, shift=(-6, 4))
    for (ja, ta), (jb, tb) in (((j0, t0), (j1, t1)), ((c0, u0), (c1, u1))):
        ij, aj = jmat.search_for_initialization(ja, jb, 100.0)
        it, at = tmat.search_for_initialization(ta, tb, 100.0)
        np.testing.assert_array_equal(at.numpy(), np.asarray(aj))
        np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
        assert at.sum() > 20
