"""Parity of the port's ORB extractor with the JAX package: pyramid and blur,
FAST + NMS (kernel A's plain version), selection, subpixel refinement,
intensity-centroid angle and BRIEF (kernel B's plain version), and the whole
extraction."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam3_fast_tpu.ops import extractor as jext
from orb_slam3_fast_tpu.ops import fast as jfast
from orb_slam3_fast_tpu.ops import image as jimage
from orb_slam3_fast_tpu_torch.ops import extractor as text
from orb_slam3_fast_tpu_torch.ops import fast as tfast
from orb_slam3_fast_tpu_torch.ops import hamming as tham
from orb_slam3_fast_tpu_torch.ops import image as timage

torch.set_num_threads(1)


def scene(rng, h=128, w=160, n_blobs=40):
    """bench.py's recipe: noise plus bright rectangles."""
    img = rng.uniform(0, 50, (h, w)).astype(np.float32)
    for _ in range(n_blobs):
        cy, cx = rng.integers(4, h - 12), rng.integers(4, w - 12)
        img[cy : cy + rng.integers(6, 20), cx : cx + rng.integers(6, 20)] += rng.uniform(80, 170)
    return np.clip(img, 0, 255)


def test_blur_and_pyramid(rng):
    img = scene(rng)
    # separable 7-tap blur, same tap order: float32 rounding only
    b_j = np.asarray(jimage.gaussian_blur(jnp.asarray(img)))
    b_t = timage.gaussian_blur(torch.as_tensor(img)).numpy()
    np.testing.assert_allclose(b_t, b_j, atol=1e-4)
    # F.interpolate vs jax.image.resize: ~3e-5 per resize at this scale,
    # accumulated along the 7-resize chain
    lv_j = jimage.build_pyramid(jnp.asarray(img))
    lv_t = timage.build_pyramid(torch.as_tensor(img))
    assert [l.shape for l in lv_t] == [tuple(l.shape) for l in lv_j]
    for a, b in zip(lv_t, lv_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=5e-4)


def test_has_run9_all_masks():
    m = np.arange(1 << 16, dtype=np.int32)
    np.testing.assert_array_equal(
        tfast._has_run9(torch.as_tensor(m)).numpy(), np.asarray(jfast._has_run9(jnp.asarray(m)))
    )


@pytest.mark.parametrize("blobs", [0, 40])
def test_fast_nms_matches_reference(rng, blobs):
    """Kernel A's plain version against the JAX chain on the SAME level
    image: exact (same float32 operations in the same order).  blobs=0 has
    cells where nothing fires at 20, so the 7 fallback is exercised."""
    img = scene(rng, n_blobs=blobs) * (0.7 if blobs == 0 else 1.0)
    img = img + rng.uniform(0, 1, img.shape).astype(np.float32)  # non-integer values
    raw_j = jfast.fast_with_fallback(jnp.asarray(img), 20.0, 7.0)
    nms_j = jfast.nonmax_3x3(raw_j)
    h, w = img.shape
    yy, xx = np.mgrid[0:h, 0:w]
    b = jext.EDGE_BORDER
    inb = (yy >= b) & (yy < h - b) & (xx >= b) & (xx < w - b)
    raw_t, nms_t = tfast.fast_nms(torch.as_tensor(img), 20.0, 7.0, b)
    np.testing.assert_array_equal(raw_t.numpy(), np.where(inb, np.asarray(raw_j), 0.0))
    np.testing.assert_array_equal(nms_t.numpy(), np.where(inb, np.asarray(nms_j), 0.0))
    assert (nms_t > 0).sum() > 10


def test_select_keypoints_with_ties(rng):
    """lax.top_k breaks ties by the lower index; so must the port."""
    score = np.zeros((64, 96), np.float32)
    idx = rng.choice(score.size, 300, replace=False)
    score.reshape(-1)[idx] = rng.integers(1, 6, 300).astype(np.float32)  # many equal values
    for n in (20, 48):
        xy_j, r_j, v_j = jext.select_keypoints(jnp.asarray(score), n, 32, 8)
        xy_t, r_t, v_t = text.select_keypoints(torch.as_tensor(score), n, 32, 8)
        np.testing.assert_array_equal(xy_t.numpy(), np.asarray(xy_j))
        np.testing.assert_array_equal(r_t.numpy(), np.asarray(r_j))
        np.testing.assert_array_equal(v_t.numpy(), np.asarray(v_j))


def test_subpixel_refine(rng):
    score = rng.uniform(0, 50, (40, 50)).astype(np.float32)
    xy = np.stack([rng.integers(0, 50, 64), rng.integers(0, 40, 64)], -1).astype(np.int32)
    o_j = np.asarray(jext.subpixel_refine(jnp.asarray(score), jnp.asarray(xy)))
    o_t = text.subpixel_refine(torch.as_tensor(score), torch.as_tensor(xy).long()).numpy()
    np.testing.assert_allclose(o_t, o_j, atol=1e-6)


def angle_tol(patches: np.ndarray) -> np.ndarray:
    """Per-patch angle tolerance: the moments are sums of 961 float32
    products taken in another order, so each may move by a few
    eps * sum|terms|, which turns the angle by that over |m|.  Measured: the
    JAX sum sits within 4.2 of this unit of the float64 value, the port's
    within 0.2; the tolerance is 8 units."""
    p = patches.astype(np.float64)
    terms = np.abs(p * jext.IC_X).sum((1, 2)) + np.abs(p * jext.IC_Y).sum((1, 2))
    m = np.hypot((p * jext.IC_X).sum((1, 2)), (p * jext.IC_Y).sum((1, 2)))
    return 8 * np.finfo(np.float32).eps * terms / m + 1e-6


def test_ic_angle_and_brief_from_same_patches(rng):
    """Angles within ``angle_tol``.  BRIEF fed the same patches and the same
    angles: bits equal exactly, since both round the samples to bf16 before
    comparing."""
    n = 96
    pic = rng.uniform(0, 255, (n, 31, 31)).astype(np.float32)
    pbr = rng.uniform(0, 255, (n, 29, 29)).astype(np.float32)
    pbr[:8] = np.round(pbr[:8] / 4.0)  # many equal samples: ties must not set bits
    a_j = np.asarray(jext.ic_angles_from_patches(jnp.asarray(pic)))
    a_t = text.ic_angles_from_patches(torch.as_tensor(pic)).numpy()
    assert np.all(np.abs(a_t - a_j) <= angle_tol(pic))
    ang = rng.uniform(-np.pi, np.pi, n).astype(np.float32)
    ang[:4] = [0.0, np.pi / 2, -np.pi, np.pi / 4]  # rotated samples on .5 boundaries
    d_j = np.asarray(jext.brief_from_patches(jnp.asarray(pbr), jnp.asarray(ang)))
    d_t = text.brief_from_patches(torch.as_tensor(pbr), torch.as_tensor(ang)).numpy()
    np.testing.assert_array_equal(d_t, d_j)


def test_orb_describe_plain_matches_reference(rng):
    """Kernel B's plain version over all levels of a pyramid against the JAX
    per-level patches + angle + BRIEF: angles within ``angle_tol``; a bit
    may flip only where that angle difference moves a rotated sample across
    a rounding boundary, so at most 0.1% of bits differ."""
    img = scene(rng)
    levels = jimage.build_pyramid(jnp.asarray(img))
    xy_all, lvl_all, ang_j, desc_j, tol = [], [], [], [], []
    for l, lv in enumerate(levels):
        h, w = lv.shape
        xy = np.stack([rng.integers(16, w - 16, 12), rng.integers(16, h - 16, 12)], -1).astype(np.int32)
        pic = jext.extract_patches(lv, jnp.asarray(xy), jext.PATCH_RADIUS)
        tol.append(angle_tol(np.asarray(pic)))
        ang = jext.ic_angles_from_patches(pic)
        blur = jimage.gaussian_blur(lv)
        desc_j.append(np.asarray(jext.brief_from_patches(jext.extract_patches(blur, jnp.asarray(xy), jext.BRIEF_RADIUS), ang)))
        ang_j.append(np.asarray(ang))
        xy_all.append(xy)
        lvl_all.append(np.full(12, l))
    lv_t = [torch.tensor(np.asarray(lv)) for lv in levels]
    blur_t = [timage.gaussian_blur(lv) for lv in lv_t]
    a_t, d_t = text.orb_describe(
        lv_t, blur_t, torch.as_tensor(np.concatenate(xy_all)).long(), torch.as_tensor(np.concatenate(lvl_all))
    )
    assert np.all(np.abs(a_t.numpy() - np.concatenate(ang_j)) <= np.concatenate(tol))
    bits = tham.unpack_desc(d_t).numpy()
    assert np.mean(bits != np.concatenate(desc_j)) <= 1e-3


def test_extract_matches_reference(rng):
    """The whole extraction on one image.  Level 0 sees the same pixels, so
    its keypoints agree exactly; coarser levels are resampled by two
    libraries (~1e-4 apart), which can move a corner across a FAST
    threshold, so there 95% of slots must agree."""
    img = scene(rng)
    cfg = text.ExtractorConfig(n_features=128)
    kj = jext.extract(jnp.asarray(img), jext.ExtractorConfig(n_features=128))
    kt = text.extract(torch.as_tensor(img), cfg)
    np.testing.assert_array_equal(kt.level.numpy(), np.asarray(kj.level))
    lvl = np.asarray(kj.level)
    l0 = lvl == 0
    np.testing.assert_array_equal(kt.valid.numpy()[l0], np.asarray(kj.valid)[l0])
    np.testing.assert_allclose(kt.xy.numpy()[l0], np.asarray(kj.xy)[l0], atol=1e-5)
    np.testing.assert_array_equal(tham.unpack_desc(kt.desc).numpy()[l0], np.asarray(kj.desc)[l0])
    same = np.all(np.abs(kt.xy.numpy() - np.asarray(kj.xy)) < 1e-2, axis=1)
    assert same.mean() >= 0.95
