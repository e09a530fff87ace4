"""The whole stereo tracking step of the port against the same chain built
from the JAX package's functions (tracker._stereo_front,
tracker._visible_landmarks, matching.search_by_projection,
pose_opt.pose_optimization) on a small textured plane."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from orb_slam3_fast_tpu.cameras import models as jcam
from orb_slam3_fast_tpu.frontend import tracker as jtr
from orb_slam3_fast_tpu.ops import extractor as jext
from orb_slam3_fast_tpu.optim import pose_opt as jpo
from orb_slam3_fast_tpu.utils import lie as jlie
from orb_slam3_fast_tpu_torch.cameras import models as tcam
from orb_slam3_fast_tpu_torch.frontend import tracker as ttr
from orb_slam3_fast_tpu_torch.ops import extractor as text
from orb_slam3_fast_tpu_torch.utils import convert

torch.set_num_threads(1)

H, W = 192, 256
FX = FY = 220.0
CX, CY = W / 2.0, H / 2.0
BF = 0.1 * FX
DISP = 8  # px: the plane's depth is BF / DISP
Z = BF / DISP
SHIFT = 2  # px per frame
CFG = (256, 8, 1.2, 20.0, 7.0, 32, 8)


def canvas(rng, width):
    """bench.py's texture (noise plus bright rectangles) on a wide canvas."""
    img = rng.uniform(0, 50, (H, width)).astype(np.float32)
    for _ in range(120 * H * width // (480 * 640)):
        cy, cx = rng.integers(4, H - 24), rng.integers(0, width - 24)
        img[cy : cy + rng.integers(8, 24), cx : cx + rng.integers(8, 24)] += rng.uniform(80, 170)
    return np.clip(img, 0, 255)


def crop(cv, k, x0=16):
    """Left and right images of frame k (the right camera sees DISP px on)."""
    o = x0 + k * SHIFT
    return cv[:, o : o + W].copy(), cv[:, o + DISP : o + DISP + W].copy()


def local_map(cv, frames, cap=768):
    """Plane points back-projected from the port's keypoints of reference
    frames, with normal and distance band set as WorldMap sets them."""
    cfg = text.ExtractorConfig(*CFG)
    pos, desc, lvl = [], [], []
    for k in frames:
        kp = text.extract(torch.as_tensor(crop(cv, k)[0]), cfg)
        v = kp.valid.numpy()
        xy = kp.xy.numpy()[v]
        cx_world = k * SHIFT * Z / FX
        pos.append(np.stack([(xy[:, 0] - CX) * Z / FX + cx_world, (xy[:, 1] - CY) * Z / FY, np.full(len(xy), Z)], -1))
        desc.append(convert.desc_to_numpy(kp.desc)[v])
        lvl.append(kp.level.numpy()[v])
        center = np.array([cx_world, 0.0, 0.0])
    pos, desc, lvl = np.concatenate(pos)[:cap], np.concatenate(desc)[:cap], np.concatenate(lvl)[:cap]
    n = len(pos)
    d = pos - center[None]
    dist = np.linalg.norm(d, axis=-1)
    dmax = dist * 1.2 ** lvl
    pad = cap - n
    return {
        "lm_pos": np.concatenate([pos, np.zeros((pad, 3))]).astype(np.float32),
        "lm_desc": np.concatenate([desc, np.zeros((pad, 256))]).astype(np.int8),
        "lm_normal": np.concatenate([d / dist[:, None], np.zeros((pad, 3))]).astype(np.float32),
        "lm_dmin": np.concatenate([dmax / 1.2**7, np.zeros(pad)]).astype(np.float32),
        "lm_dmax": np.concatenate([dmax, np.zeros(pad)]).astype(np.float32),
        "lm_mask": np.arange(cap) < n,
    }


def jax_step(il, ir, R, t, lm):
    """The tracker's chain: _stereo_front, host depth / right-u,
    _visible_landmarks, search_by_projection, _pose_opt_from_obs."""
    cfg = jext.ExtractorConfig(*CFG)
    cam = jcam.Camera.pinhole(FX, FY, CX, CY)
    scales = jnp.asarray(cfg.scale_factor ** np.arange(cfg.n_levels), dtype=jnp.float32)
    kp, _, _, ur_ref, ok = jtr._stereo_front(
        jnp.asarray(il), jnp.asarray(ir), cfg, BF, max(2.0 * BF / FX, 0.1), scales, jnp.asarray(jext.slot_scales(cfg))
    )
    ok, ur, kxy = jax.device_get((ok, ur_ref, kp.xy))
    disp = np.maximum(kxy[:, 0] - ur, 0.01)
    depth = np.where(ok & (disp >= 0.5), BF / disp, -1.0)
    ru = np.where(depth > 0, ur, -1.0)
    uv, pred, vis = jtr._visible_landmarks(
        cam, jnp.asarray(R), jnp.asarray(t), jnp.asarray(lm["lm_pos"]), jnp.asarray(lm["lm_mask"]),
        jnp.asarray(lm["lm_normal"]), jnp.asarray(lm["lm_dmin"]), jnp.asarray(lm["lm_dmax"]),
        jnp.asarray([W, H], jnp.float32), log_sf=float(np.log(1.2)), n_lvl=8,
    )
    idx, accept = jtr._search_by_projection(kp, uv, vis, jnp.asarray(lm["lm_desc"]), pred, scales, radius=3.0)
    acc = np.asarray(accept)
    n = kp.xy.shape[0]
    obs_lm = np.full(n, -1, np.int64)
    obs_lm[np.asarray(idx)[acc]] = np.nonzero(acc)[0]
    slots = np.nonzero(obs_lm >= 0)[0]
    xw = np.zeros((n, 3), np.float32)
    uvr = np.full((n, 3), -1.0, np.float32)
    inv_s2 = np.ones(n, np.float32)
    valid = np.zeros(n, bool)
    stereo = np.zeros(n, bool)
    xw[slots] = lm["lm_pos"][obs_lm[slots]]
    uvr[slots, :2] = kxy[slots]
    inv_s2[slots] = 1.0 / jext.level_sigma2(cfg)[np.asarray(kp.level)[slots]]
    valid[slots] = True
    has_ru = ru[slots] > 0
    uvr[slots, 2] = np.where(has_ru, ru[slots], -1.0)
    stereo[slots] = has_ru
    obs = jpo.PoseObs(jnp.asarray(xw), jnp.asarray(uvr), jnp.asarray(inv_s2), jnp.asarray(stereo), jnp.asarray(valid))
    T, inlier, n_inl = jpo.pose_optimization(cam, jnp.float32(BF), jlie.SE3(jnp.asarray(R), jnp.asarray(t)), obs)
    return jlie.normalize_rotation_np(np.asarray(T.R)), np.asarray(T.t), int(valid.sum()), int(n_inl)


def test_step_matches_jax_chain():
    """Frame 3 of a sideways pan, predicted pose 0.6 px off the truth.

    Level-0 keypoints agree exactly; coarser levels are resampled by two
    libraries (~1e-4 apart) and a few of their corners and matches differ.
    So: match and inlier counts within 5% of each other, and the two poses
    within 2 mm (a tenth of a pixel at the plane's 2.75 m), both within 1 cm
    of the truth."""
    rng = np.random.default_rng(7)
    cv = canvas(rng, W + 64)
    lm = local_map(cv, frames=(0, 6))
    il, ir = crop(cv, 3)
    t_true = np.array([-3 * SHIFT * Z / FX, 0.0, 0.0], np.float32)
    R0 = np.eye(3, dtype=np.float32)
    t0 = t_true + np.array([0.6 * Z / FX, 0.0, 0.0], np.float32)

    R_j, t_j, m_j, n_j = jax_step(il, ir, R0, t0, lm)

    step = ttr.StereoTrackingStep(tcam.Camera.pinhole(FX, FY, CX, CY), BF, (W, H), text.ExtractorConfig(*CFG),
                                  device="cpu")
    res = step(
        torch.as_tensor(il), torch.as_tensor(ir), convert.se3_to_torch(R0, t0, "cpu"),
        convert.local_map_to_torch(**lm, device="cpu"),
    )
    m_t, n_t = int(res.n_matches), int(res.n_inliers)
    assert m_j >= 60 and n_j >= 30
    assert abs(m_t - m_j) <= 0.05 * m_j and abs(n_t - n_j) <= 0.05 * n_j
    np.testing.assert_allclose(res.T.t.numpy(), t_j, atol=2e-3)
    np.testing.assert_allclose(res.T.R.numpy(), R_j, atol=1e-3)
    assert np.abs(res.T.t.numpy() - t_true).max() < 0.01
    assert np.abs(t_j - t_true).max() < 0.01
    # the returned rotation is on SO(3)
    R = res.T.R.numpy().astype(np.float64)
    assert np.abs(R @ R.T - np.eye(3)).max() < 1e-6


def test_visible_landmarks_matches_jax(rng):
    """Kernel L's plain version (the wrapper on CPU tensors) against the JAX
    ``_visible_landmarks`` on a distorted pin-hole camera: uv within 1e-3
    px or 1e-5 relative (float32 in another operation order; points near
    z = 0 project far out), levels and flags equal."""
    M = 512
    params = (300.0, 310.0, 160.0, 120.0, 0.05, -0.01, 1e-3, -1e-3, 0.002)
    pos = np.stack([rng.uniform(-3, 3, M), rng.uniform(-2, 2, M), rng.uniform(-1, 8, M)], -1).astype(np.float32)
    normal = pos + rng.uniform(-0.5, 0.5, (M, 3))
    normal = (normal / np.linalg.norm(normal, axis=1, keepdims=True)).astype(np.float32)
    dmax = (np.linalg.norm(pos, axis=1) * rng.uniform(0.6, 1.8, M)).astype(np.float32)
    dmin = (dmax / 1.2**7).astype(np.float32)
    mask = rng.uniform(size=M) > 0.1
    T = jlie.se3_exp(jnp.asarray([0.05, -0.02, 0.1, 0.02, -0.03, 0.01], jnp.float32))
    R, t = np.array(T.R), np.array(T.t)
    got = ttr.visible_landmarks(
        tcam.Camera.pinhole(*params[:4], params[4:]), torch.as_tensor(R), torch.as_tensor(t), torch.as_tensor(pos),
        torch.as_tensor(mask), torch.as_tensor(normal), torch.as_tensor(dmin), torch.as_tensor(dmax), (320, 240),
    )
    want = jtr._visible_landmarks(
        jcam.Camera.pinhole(*params[:4], params[4:]), T.R, T.t, jnp.asarray(pos), jnp.asarray(mask),
        jnp.asarray(normal), jnp.asarray(dmin), jnp.asarray(dmax), jnp.asarray([320, 240], jnp.float32),
    )
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=1e-5, atol=1e-3)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    assert 50 < int(got[2].sum()) < M
