"""The kernel wrappers (A-AD, no K or O; the KB8 instances): CPU tensors take the plain version, other
devices launch the kernel or raise (no fallback); on a CUDA card each
kernel agrees with its plain version (``cuda`` marker; these skip without a
card and run there, where JAX is absent, with
``python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_kernels.py``)."""
import numpy as np
import pytest
import torch

from orb_slam3_fast_tpu_torch import _kernels
from orb_slam3_fast_tpu_torch.cameras import models as cm
from orb_slam3_fast_tpu_torch.frontend import tracker as trk
from orb_slam3_fast_tpu_torch.ops import extractor as ext
from orb_slam3_fast_tpu_torch.ops import fast
from orb_slam3_fast_tpu_torch.ops import hamming as ham
from orb_slam3_fast_tpu_torch.ops import image
from orb_slam3_fast_tpu_torch.ops import matching as mat
from orb_slam3_fast_tpu_torch.ops import twoview
from orb_slam3_fast_tpu_torch.optim import ba, ba_cg, pnp, pose_opt, sim3
from orb_slam3_fast_tpu_torch.optim import pose_graph as pg
from orb_slam3_fast_tpu_torch.utils import lie
from orb_slam3_fast_tpu_torch.vocab import vocabulary as voc_mod

torch.set_num_threads(1)

WRAPPERS = (fast.fast_nms, ext.orb_describe, ham.hamming_best2, pose_opt.pose_optimization,
            ba.build_normal_blocks, ba.schur_solve, twoview.triangulate_dlt, image.pyramid_blur,
            ext.select_subpixel, mat.stereo_subpixel_refine, trk.visible_landmarks, twoview.reconstruct,
            voc_mod.transform, pnp.pnp_ransac, ba.lm_update, ba.classify)
FRONT_CFG = ext.ExtractorConfig(n_features=256)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def scene(rng, h=240, w=320):
    img = rng.uniform(0, 50, (h, w)).astype(np.float32)
    for _ in range(60):
        cy, cx = rng.integers(4, h - 24), rng.integers(4, w - 24)
        img[cy : cy + rng.integers(8, 24), cx : cx + rng.integers(8, 24)] += rng.uniform(80, 170)
    return torch.as_tensor(np.clip(img, 0, 255))


def kernel_inputs(rng, device):
    """Inputs of all four kernels at a small size, on ``device``."""
    img = scene(rng).to(device)
    levels = image.build_pyramid(img, 4, 1.2)
    blurs = [image.gaussian_blur(l) for l in levels]
    n = 64
    lvl = torch.as_tensor(rng.integers(0, 4, n), device=device)
    hs = torch.as_tensor([l.shape[0] for l in levels], device=device)[lvl]
    ws = torch.as_tensor([l.shape[1] for l in levels], device=device)[lvl]
    u = torch.as_tensor(rng.uniform(size=(n, 2)), dtype=torch.float32, device=device)
    xy = torch.stack([16 + (u[:, 0] * (ws - 33).float()).long(), 16 + (u[:, 1] * (hs - 33).float()).long()], 1)
    desc_a = ham.pack_desc(torch.as_tensor(rng.integers(0, 2, (n, 256)), device=device))
    desc_b = ham.pack_desc(torch.as_tensor(rng.integers(0, 2, (80, 256)), device=device))
    f = lambda *s: torch.as_tensor(rng.uniform(size=s), dtype=torch.float32, device=device)  # noqa: E731
    stereo = ham.StereoGate(
        f(n) * 300, (f(n) * 6).round() * 20, (f(n) * 3).round(), (f(n) > 0.1).float(),
        f(80) * 300, (f(80) * 6).round() * 20 + f(80), 2.0 * 1.2 ** (f(80) * 3).round(), (f(80) * 3).round(),
        (f(80) > 0.1).float(), 40.0,
    )
    window = ham.WindowGate(
        f(n) * 300, f(n) * 200, 3.0 + 20 * f(n), (f(n) * 3).round(), (f(n) > 0.1).float(),
        f(80) * 300, f(80) * 200, (f(80) * 3).round(), (f(80) > 0.1).float(),
    )
    xw = torch.stack([f(n) * 4 - 2, f(n) * 3 - 1.5, 3 + 8 * f(n)], 1)
    T_gt = lie.se3_exp(torch.tensor([0.1, -0.05, 0.1, 0.02, -0.01, 0.03], device=device))
    cam = cm.Camera.pinhole(300.0, 300.0, 160.0, 120.0)
    uvr = cm.stereo_project(cam, T_gt.apply(xw), 30.0) + 0.3 * (f(n, 3) - 0.5)
    is_st = f(n) > 0.5
    obs = pose_opt.PoseObs(xw, uvr, torch.ones(n, device=device), is_st, f(n) > 0.05)
    return img, levels, blurs, xy, lvl, desc_a, desc_b, stereo, window, cam, obs


def system_inputs(rng, device):
    """Inputs of kernels E, F, G and kernel C's epipolar and mutual modes at
    a small size, on ``device``: a BA problem of 4 pose slots (pose 0 and
    the padding slot fixed), 64 landmarks and 256 observation slots."""
    cam = cm.Camera.pinhole(300.0, 300.0, 160.0, 120.0)
    K, M, O, n = 4, 64, 256, 200
    R = np.tile(np.eye(3, dtype=np.float32), (K, 1, 1))
    t = np.zeros((K, 3), np.float32)
    t[:3, 0] = [0.0, -0.4, -0.8]
    X = np.stack([rng.uniform(-2, 2, M), rng.uniform(-1.5, 1.5, M), rng.uniform(3, 8, M)], -1).astype(np.float32)
    kf = rng.integers(0, 3, n).astype(np.int32)
    lm = rng.integers(0, M, n).astype(np.int32)
    xc = np.einsum("oij,oj->oi", R[kf], X[lm]) + t[kf]
    uv = np.stack([300 * xc[:, 0] / xc[:, 2] + 160, 300 * xc[:, 1] / xc[:, 2] + 120, 0 * xc[:, 0]], -1)
    uv[:, 2] = uv[:, 0] - 30.0 / xc[:, 2]
    uv += rng.normal(0, 0.7, uv.shape)
    stereo = rng.uniform(size=n) < 0.6
    uv[~stereo, 2] = -1.0
    pad = lambda a, f: np.concatenate([a, np.full((O - n, *a.shape[1:]), f, a.dtype)])  # noqa: E731
    t0 = t + np.concatenate([np.zeros((1, 3)), rng.normal(0, 0.02, (K - 1, 3))]).astype(np.float32)
    prob = ba.make_problem(
        R, t0, np.array([True, False, False, True]), X + rng.normal(0, 0.03, X.shape).astype(np.float32),
        np.ones(M, bool), pad(kf, 0), pad(lm, 0), pad(uv.astype(np.float32), -1.0), np.ones(O, np.float32),
        pad(stereo, False), pad(np.ones(n, bool), False), device=device,
    )
    f = lambda *s: torch.as_tensor(rng.uniform(size=s), dtype=torch.float32, device=device)  # noqa: E731
    P0 = torch.tensor([[1.0, 0, 0, 0], [0, 1, 0, 0], [0, 0, 1, 0]], device=device)
    P1 = torch.tensor([[1.0, 0, 0, -0.3], [0, 1, 0, 0], [0, 0, 1, 0]], device=device)
    Xs = torch.stack([f(96) * 4 - 2, f(96) * 2 - 1, 2 + 8 * f(96)], 1)
    x0, x1 = Xs[:, :2] / Xs[:, 2:], (Xs[:, :2] + torch.tensor([-0.3, 0.0], device=device)) / Xs[:, 2:]
    epi = ham.EpipolarGate(
        f(64) - 0.5, f(64) - 0.5, (f(64) - 0.5) * 100, None, (f(64) > 0.1).float(), f(80) * 300, f(80) * 200,
        50 * f(80), (f(80) > 0.1).float(),
    )
    epi = epi._replace(den=epi.a ** 2 + epi.b ** 2)
    mutual = ham.MutualGate((f(64) > 0.2).float(), (f(80) > 0.2).float())
    return cam, prob, (P0, P1, x0, x1), epi, mutual


def front_inputs(rng, device, h=240, w=320):
    """Inputs of kernels H, I, J and L at a small size, on ``device``: an
    image, kernel A's flat maps of its pyramid (from the plain pyramid), a
    tie-heavy map of small integers, stereo matches and a landmark block."""
    img = scene(rng, h, w).to(device)
    shapes, offs = image.pyramid_layout(h, w, FRONT_CFG.n_levels, FRONT_CFG.scale_factor)
    levels, _ = image.pyramid_blur_plain(img, FRONT_CFG.n_levels, FRONT_CFG.scale_factor)
    raw, nms = torch.empty_like(levels), torch.empty_like(levels)
    for lv, r, m in zip(*(image.level_views(x, shapes, offs) for x in (levels, raw, nms))):
        fast.fast_nms_plain(lv, 20.0, 7.0, ext.EDGE_BORDER, out=(r, m))
    ties = torch.as_tensor(rng.integers(0, 4, levels.shape[0]) * (rng.uniform(size=levels.shape[0]) < 0.2),
                           dtype=torch.float32, device=device)
    n = 64
    f = lambda *s: torch.as_tensor(rng.uniform(size=s), dtype=torch.float32, device=device)  # noqa: E731
    img_r = torch.roll(img, -6, 1) + f(h, w)
    xy_l = torch.stack([20 + f(n) * (w - 40), 8 + f(n) * (h - 16)], 1)
    right_u = torch.where(f(n) < 0.1, torch.full_like(xy_l[:, 0], -1.0), xy_l[:, 0] - 6 + 3 * (f(n) - 0.5))
    valid = right_u > 0
    M = 256
    cam = cm.Camera.pinhole(300.0, 300.0, 160.0, 120.0, (0.05, -0.01, 1e-3, -1e-3, 0.0))
    pos = torch.stack([f(M) * 6 - 3, f(M) * 4 - 2, f(M) * 8 - 1], 1)
    normal = torch.nn.functional.normalize(pos + f(M, 3) - 0.5, dim=1)
    dist = pos.norm(dim=1)
    dmax = dist * (0.6 + 1.2 * f(M))
    lm = (pos, f(M) > 0.1, normal, dmax / 1.2 ** 7, dmax)
    T = lie.se3_exp(torch.tensor([0.05, -0.02, 0.1, 0.02, -0.03, 0.01], device=device))
    return img, (nms, raw, shapes, offs), ties, (img, img_r, xy_l, right_u, valid), cam, T, lm


def test_cpu_tensors_take_the_plain_version():
    rng = np.random.default_rng(0)
    img, levels, blurs, xy, lvl, da, db, stereo, window, cam, obs = kernel_inputs(rng, "cpu")
    before = [w.launches.total() for w in WRAPPERS]
    raw, nms = fast.fast_nms(levels[0], 20.0, 7.0, ext.EDGE_BORDER)
    torch.testing.assert_close((raw, nms), fast.fast_nms_plain(levels[0], 20.0, 7.0, ext.EDGE_BORDER))
    desc_in = ext.describe_inputs(levels, blurs, lvl)
    torch.testing.assert_close(ext.orb_describe(*desc_in, xy), ext.orb_describe_plain(*desc_in, xy))
    torch.testing.assert_close(ham.hamming_best2(da, db, stereo), ham.hamming_best2_plain(da, db, stereo))
    torch.testing.assert_close(ham.hamming_best2(da, db, window), ham.hamming_best2_plain(da, db, window))
    T0 = lie.SE3.identity("cpu")
    torch.testing.assert_close(
        pose_opt.pose_optimization(cam, 30.0, T0, obs), pose_opt.pose_optimization_plain(cam, 30.0, T0, obs)
    )
    cam, prob, dlt, epi, mutual = system_inputs(rng, "cpu")
    inl = torch.ones_like(prob.obs_valid)
    blocks = ba.build_normal_blocks(cam, 30.0, prob.R, prob.t, prob.xw, prob, inl)
    torch.testing.assert_close(blocks, ba.build_normal_blocks_plain(cam, 30.0, prob.R, prob.t, prob.xw, prob, inl))
    lam = torch.tensor(1e-3)
    dp, dl, ok = ba.schur_solve(*blocks[:6], prob, lam)
    torch.testing.assert_close((dp, dl), ba.schur_solve_plain(*blocks[:6], prob.pose_fixed, prob.lm_valid, lam))
    assert bool(ok)
    lm_args = (cam, 30.0, prob, prob.R, prob.t, prob.xw, dp, dl, inl, blocks[6], ok, lam)
    torch.testing.assert_close(ba.lm_update(*lm_args), ba.lm_update_plain(*lm_args))
    torch.testing.assert_close(ba.classify(cam, 30.0, prob, prob.R, prob.t, prob.xw),
                               ba.classify_plain(cam, 30.0, prob, prob.R, prob.t, prob.xw))
    torch.testing.assert_close(twoview.triangulate_dlt(*dlt), twoview.triangulate_dlt_plain(*dlt))
    for gate in (epi, mutual):
        torch.testing.assert_close(ham.hamming_best2(da, db, gate), ham.hamming_best2_plain(da, db, gate))
    img, maps, ties, sad_in, cam, T, lm = front_inputs(rng, "cpu")
    torch.testing.assert_close(image.pyramid_blur(img, 8, 1.2), image.pyramid_blur_plain(img, 8, 1.2))
    for nms in (maps[0], ties):
        torch.testing.assert_close(ext.select_subpixel(nms, *maps[1:], FRONT_CFG),
                                   ext.select_subpixel_plain(nms, *maps[1:], FRONT_CFG))
    torch.testing.assert_close(mat.stereo_subpixel_refine(*sad_in), mat.stereo_subpixel_refine_plain(*sad_in))
    torch.testing.assert_close(trk.visible_landmarks(cam, T.R, T.t, *lm, (320, 240)),
                               trk.visible_landmarks_plain(cam, T.R, T.t, *lm, (320, 240)))
    cam, tv, samples, voc, desc, valid, pnp_in, subsets = mono_inputs(rng, "cpu")
    for case in tv:
        torch.testing.assert_close(twoview.reconstruct(cam, *case, 0, samples=samples),
                                   twoview.reconstruct_plain(cam, *case, samples))
    torch.testing.assert_close(voc_mod.transform(voc, desc, valid), voc_mod.transform_plain(voc, desc, valid))
    torch.testing.assert_close(pnp.pnp_ransac(cam, *pnp_in, 0, subsets=subsets),
                               pnp.pnp_ransac_plain(cam, *pnp_in, subsets))
    assert [w.launches.total() for w in WRAPPERS] == before


def test_other_devices_raise_without_fallback():
    """A tensor that is neither on the CPU nor on CUDA gets no plain path."""
    rng = np.random.default_rng(0)
    img, levels, blurs, xy, lvl, da, db, stereo, window, cam, obs = kernel_inputs(rng, "cpu")
    meta = lambda t: t.to("meta")  # noqa: E731
    with pytest.raises(ValueError, match="CUDA"):
        fast.fast_nms(meta(levels[0]), 20.0, 7.0, ext.EDGE_BORDER)
    with pytest.raises(ValueError, match="CUDA"):
        ext.orb_describe(*[meta(x) for x in ext.describe_inputs(levels, blurs, lvl)], meta(xy))
    with pytest.raises(ValueError, match="CUDA"):
        ham.hamming_best2(meta(da), meta(db), ham.StereoGate(*[meta(x) for x in stereo[:-1]], stereo.max_disp))
    with pytest.raises(ValueError, match="CUDA"):
        pose_opt.pose_optimization(cam, 30.0, lie.SE3.identity("meta"), pose_opt.PoseObs(*[meta(x) for x in obs]))
    cam, prob, dlt, epi, mutual = system_inputs(rng, "cpu")
    mprob = ba.BAProblem(*[meta(x) for x in prob])
    with pytest.raises(ValueError, match="CUDA"):
        ba.build_normal_blocks(cam, 30.0, mprob.R, mprob.t, mprob.xw, mprob, meta(prob.obs_valid))
    blocks = ba.build_normal_blocks_plain(cam, 30.0, prob.R, prob.t, prob.xw, prob, torch.ones_like(prob.obs_valid))
    with pytest.raises(ValueError, match="CUDA"):
        ba.schur_solve(*[meta(x) for x in blocks[:6]], mprob, meta(torch.tensor(1e-3)))
    step = [meta(torch.zeros(4, 6)), meta(torch.zeros_like(prob.xw)), meta(prob.obs_valid), meta(blocks[6])]
    for ok in (None, meta(torch.tensor(True))):
        with pytest.raises(ValueError, match="CUDA"):
            ba.lm_update(cam, 30.0, mprob, mprob.R, mprob.t, mprob.xw, *step, ok, meta(torch.tensor(1e-3)))
    with pytest.raises(ValueError, match="CUDA"):
        ba.classify(cam, 30.0, mprob, mprob.R, mprob.t, mprob.xw)
    with pytest.raises(ValueError, match="CUDA"):
        twoview.triangulate_dlt(*[meta(x) for x in dlt])
    for gate in (epi, mutual):
        with pytest.raises(ValueError, match="CUDA"):
            ham.hamming_best2(meta(da), meta(db), type(gate)(*[meta(x) for x in gate]))
    img, (nms, raw, shapes, offs), ties, sad_in, cam, T, lm = front_inputs(rng, "cpu")
    with pytest.raises(ValueError, match="CUDA"):
        image.pyramid_blur(meta(img), 8, 1.2)
    with pytest.raises(ValueError, match="CUDA"):
        ext.select_subpixel(meta(nms), meta(raw), shapes, offs, FRONT_CFG)
    with pytest.raises(ValueError, match="CUDA"):
        mat.stereo_subpixel_refine(*[meta(x) for x in sad_in])
    with pytest.raises(ValueError, match="CUDA"):
        trk.visible_landmarks(cam, meta(T.R), meta(T.t), *[meta(x) for x in lm], (320, 240))
    with pytest.raises(ValueError, match="CUDA"):
        trk.visible_landmarks(cm.Camera.kb8(300.0, 300.0, 160.0, 120.0, 0, 0, 0, 0), meta(T.R), meta(T.t),
                              *[meta(x) for x in lm], (320, 240))
    cam, tv, samples, voc, desc, valid, pnp_in, subsets = mono_inputs(rng, "cpu")
    with pytest.raises(ValueError, match="CUDA"):
        twoview.reconstruct(cam, *[meta(x) for x in tv[0]], 0, samples=meta(samples))
    with pytest.raises(ValueError, match="CUDA"):
        voc_mod.transform(voc, meta(desc), meta(valid))
    with pytest.raises(ValueError, match="CUDA"):
        pnp.pnp_ransac(cam, *[meta(x) for x in pnp_in], 0, subsets=meta(subsets))
    kb8 = cm.Camera.kb8(300.0, 300.0, 160.0, 120.0, 0, 0, 0, 0)
    radtan = cm.Camera.pinhole(400.0, 400.0, 320.0, 240.0, (-0.28, 0.07, 2e-4, 2e-5))
    for c in (kb8, radtan):  # kernel M takes every camera kind, and a non-CUDA tensor no plain path
        with pytest.raises(ValueError, match="CUDA"):
            twoview.reconstruct(c, *[meta(x) for x in tv[0]], 0, samples=meta(samples))
        with pytest.raises(ValueError, match="CUDA"):
            twoview.unproject_pair(c, meta(tv[0][0]), meta(tv[0][1]))
    with pytest.raises(ValueError, match="CUDA"):
        pnp.pnp_ransac(kb8, *[meta(x) for x in pnp_in], 0, subsets=meta(subsets))


def mono_inputs(rng, device):
    """Inputs of M, N and P at a small size, on ``device``: a planar and a
    3-D two-view case over 256 slots with their 200 samples, the default
    vocabulary with 128 random descriptors, and a 256-slot PnP problem with
    64 subsets."""
    import chip_smoke

    cam = cm.Camera.pinhole(400.0, 400.0, 320.0, 240.0)
    plane = chip_smoke.planar_matches(rng, n=256, n_valid=150)
    X = np.stack([rng.uniform(-3, 3, 256), rng.uniform(-2, 2, 256), rng.uniform(3, 9, 256)], -1)
    T = lie.se3_exp(torch.tensor([0.3, 0.05, 0.1, 0.02, -0.05, 0.01], dtype=torch.float64)).inverse()
    X1 = X @ T.R.numpy().T + T.t.numpy()
    uv = [400.0 * Y[:, :2] / Y[:, 2:] + [320.0, 240.0] + rng.normal(0, 0.5, (256, 2)) for Y in (X, X1)]
    space = (uv[0].astype(np.float32), uv[1].astype(np.float32), np.arange(256) < 180)
    tv = [tuple(torch.as_tensor(a).to(device) for a in case) for case in (plane, space)]
    samples = twoview._sample_hypotheses(1, tv[1][2])
    voc = voc_mod.default_vocabulary().to(device)
    desc = ham.pack_desc(torch.as_tensor(rng.integers(0, 2, (128, 256)))).to(device)
    valid = torch.as_tensor(rng.uniform(size=128) > 0.2).to(device)
    pnp_in = tuple(torch.as_tensor(a).to(device) for a in chip_smoke.pnp_problem(rng, 256, 200, 0.2)[:4])
    return cam, tv, samples, voc, desc, valid, pnp_in, pnp._sample_subsets(2, pnp_in[3], 64)


def test_build_flags_and_sources():
    srcs = sorted(p.name for p in _kernels.SRC_DIR.glob("*.cu"))
    assert srcs == ["ba_blocks.cu", "ba_lm.cu", "ba_pcg.cu", "ba_schur.cu", "ba_shard.cu", "common.cu", "fast_nms.cu",
                    "fisheye_stereo.cu",
                    "hamming_best2.cu",
                    "imu_init.cu", "imu_preint.cu", "kfdb_score.cu", "match_epilogue.cu", "orb_describe.cu",
                    "pnp_ransac.cu", "pose_graph4.cu",
                    "pose_inertial.cu", "pose_inertial_kb8.cu", "pose_inertial_radtan.cu", "pose_lm.cu",
                    "pyramid_blur.cu", "sad_refine.cu", "select_subpixel.cu",
                    "sim3_graph.cu", "sim3_pcg.cu", "sim3_ransac.cu", "sim3_refine.cu", "triangulate_dlt.cu",
                    "twoview_ransac.cu", "vi_ba.cu", "vi_pcg.cu", "visible_landmarks.cu", "vocab_transform.cu"]
    # the one Jacobi eigen-solver, shared by G, M, P, Q, R, S, T, V and Z; the Sim3 maps and dual numbers, shared by
    # R, S, U and Z and (through inertial.cuh) W, X, Y and AA; the distorted pin-hole and the KB8 camera, shared by D,
    # E, L, M, P, Q, R, W, Y, AA and AB; the inertial factors, shared by V, W, X, Y and AA; kernel W's code, shared by
    # its three camera kinds' translation units; a BA observation's residual and robust cost, shared by E and AC;
    # E's, AC's and T's device code, shared with AF
    assert sorted(p.name for p in _kernels.SRC_DIR.glob("*.cuh")) == [
        "ba_blocks.cuh", "ba_lm.cuh", "ba_obs.cuh", "ba_pcg.cuh", "camera.cuh", "inertial.cuh", "jacobi.cuh",
        "pose_inertial.cuh", "sim3.cuh"]
    for name in ("ba_blocks.cuh", "ba_lm.cuh"):
        assert '#include "ba_obs.cuh"' in (_kernels.SRC_DIR / name).read_text()
    for name, headers in (("ba_blocks.cu", ("ba_blocks",)), ("ba_lm.cu", ("ba_lm",)), ("ba_pcg.cu", ("ba_pcg",)),
                          ("ba_shard.cu", ("ba_blocks", "ba_lm", "ba_pcg"))):
        assert all(f'#include "{h}.cuh"' in (_kernels.SRC_DIR / name).read_text() for h in headers)
    for name in ("imu_preint.cu", "pose_inertial.cuh", "imu_init.cu", "vi_ba.cu", "vi_pcg.cu"):
        assert '#include "inertial.cuh"' in (_kernels.SRC_DIR / name).read_text()
    for name in ("pose_inertial.cuh", "vi_ba.cu", "vi_pcg.cu"):
        assert '#include "camera.cuh"' in (_kernels.SRC_DIR / name).read_text()
    for name in ("pose_inertial.cu", "pose_inertial_radtan.cu", "pose_inertial_kb8.cu"):
        assert '#include "pose_inertial.cuh"' in (_kernels.SRC_DIR / name).read_text()
    for name in ("triangulate_dlt.cu", "twoview_ransac.cu", "pnp_ransac.cu", "sim3_ransac.cu", "ba_pcg.cuh",
                 "pose_graph4.cu", "fisheye_stereo.cu"):
        assert '#include "jacobi.cuh"' in (_kernels.SRC_DIR / name).read_text()
    for name in ("sim3_refine.cu", "sim3_graph.cu", "sim3_pcg.cu", "pose_graph4.cu"):
        assert '#include "sim3.cuh"' in (_kernels.SRC_DIR / name).read_text()
    for name in ("pose_lm.cu", "ba_blocks.cuh", "ba_lm.cuh", "sim3_ransac.cu", "sim3_refine.cu", "visible_landmarks.cu",
                 "pnp_ransac.cu", "fisheye_stereo.cu", "twoview_ransac.cu"):
        assert '#include "camera.cuh"' in (_kernels.SRC_DIR / name).read_text()
    assert set(_kernels.SIGNATURES) == {
        "fast_nms_launch", "orb_describe_launch", "hamming_best2_launch", "pose_lm_launch", "ba_blocks_launch",
        "ba_schur_launch", "triangulate_dlt_launch", "pyramid_blur_launch", "select_subpixel_launch",
        "sad_refine_launch", "visible_landmarks_launch", "twoview_ransac_launch", "vocab_transform_launch",
        "pnp_ransac_launch", "sim3_ransac_launch", "sim3_refine_launch", "sim3_graph_launch", "sim3_pcg_launch",
        "ba_pcg_launch", "imu_preint_launch", "imu_compose_launch", "pose_inertial_launch", "imu_init_launch",
        "vi_ba_launch", "pose_graph4_launch", "vi_pcg_launch", "fisheye_stereo_launch", "ba_lm_update_launch",
        "ba_classify_launch", "match_epilogue_launch", "twoview_unproject_launch", "twoview_verdict_launch",
        "kfdb_score_launch", "ba_shard_blocks_launch", "ba_shard_round_launch", "ba_shard_cost_launch",
        "ba_shard_commit_launch", "ba_shard_cg_setup_launch", "ba_shard_cg_start_launch", "ba_shard_cg_lm_launch",
        "ba_shard_cg_pose_launch", "ba_shard_cg_update_launch", "ba_shard_cg_backsub_launch",
    }
    assert "arch=compute_90a,code=sm_90a" in _kernels.NVCC_FLAGS
    assert _kernels.LIB_PATH.parent.name == "_build"


@pytest.mark.cuda
def test_kernels_match_plain_on_card(cuda):
    rng = np.random.default_rng(0)
    img, levels, blurs, xy, lvl, da, db, stereo, window, cam, obs = kernel_inputs(rng, cuda)
    for lv in levels:
        torch.testing.assert_close(
            fast.fast_nms(lv, 20.0, 7.0, ext.EDGE_BORDER), fast.fast_nms_plain(lv, 20.0, 7.0, ext.EDGE_BORDER),
            rtol=0, atol=0,
        )
    desc_in = ext.describe_inputs(levels, blurs, lvl)
    a_k, d_k = ext.orb_describe(*desc_in, xy)
    a_p, d_p = ext.orb_describe_plain(*desc_in, xy)
    torch.testing.assert_close(a_k, a_p, rtol=0, atol=1e-4)
    assert (ham.unpack_desc(d_k) != ham.unpack_desc(d_p)).float().mean() <= 1e-3
    for gate in (stereo, window):
        (bk, ck), (bp, cp) = ham.hamming_best2(da, db, gate), ham.hamming_best2_plain(da, db, gate)
        for x, y in zip(bk, bp):
            torch.testing.assert_close(x, y, rtol=0, atol=0)
        if ck is not None:
            torch.testing.assert_close(ck, cp, rtol=0, atol=0)
    T0 = lie.SE3.identity(cuda)
    Tk, ik, nk = pose_opt.pose_optimization(cam, 30.0, T0, obs)
    Tp, ip, np_ = pose_opt.pose_optimization_plain(cam, 30.0, T0, obs)
    torch.testing.assert_close(Tk.R, Tp.R, rtol=0, atol=1e-4)
    torch.testing.assert_close(Tk.t, Tp.t, rtol=0, atol=1e-3)
    assert abs(int(nk) - int(np_)) <= 2


@pytest.mark.cuda
@pytest.mark.parametrize("ties", [False, True], ids=["seeded", "tie-heavy"])
def test_match_epilogue_matches_plain_on_card(cuda, ties):
    """Kernel AD against match_epilogue_plain on the card at every search's
    stage set, on chip_smoke's seeded and tie-heavy inputs at 96 and 1024
    rows, and past 48 KB of shared memory (the dedup over 7000 columns, the
    sort of 16384 stereo rows): masks, right u and depth bit for bit."""
    import chip_smoke

    rng = np.random.default_rng(1)
    shapes = [(kind, n, m) for kind in chip_smoke.EPILOGUES for n, m in ((96, 96), (1024, 1024))]
    shapes += [("projection", 1024, 7000), ("stereo", 16384, 16384)]
    for kind, n, m in shapes:
        b, th, kw = chip_smoke.epilogue_inputs(chip_smoke.epilogue_case(rng, kind, n, m, ties), kind, cuda)
        k, p = ham.match_epilogue(b, th, **kw), ham.match_epilogue_plain(b, th, **kw)
        assert chip_smoke.epilogues_equal(k, p), (kind, n, m)


@pytest.mark.cuda
def test_system_kernels_match_plain_on_card(cuda):
    """E, F, G and kernel C's epipolar and mutual modes against their plain
    versions on the card: C exact; E's blocks within 1e-4 of each block's
    max (float atomics sum in another order), its W scattered into Z
    likewise; F's dp / dl within 1e-3 of their max (float64 Cholesky
    against a float32 LU); G within 1e-4 relative; a whole BA within 1e-3 m
    with at most 0.5% of the inlier flags differing."""
    rng = np.random.default_rng(0)
    da = ham.pack_desc(torch.as_tensor(rng.integers(0, 2, (64, 256)), device=cuda))
    db = ham.pack_desc(torch.as_tensor(rng.integers(0, 2, (80, 256)), device=cuda))
    cam, prob, dlt, epi, mutual = system_inputs(rng, cuda)
    for gate in (epi, mutual):
        (bk, ck), (bp, cp) = ham.hamming_best2(da, db, gate), ham.hamming_best2_plain(da, db, gate)
        for x, y in zip(bk, bp):
            torch.testing.assert_close(x, y, rtol=0, atol=0)
        torch.testing.assert_close(ck, cp, rtol=0, atol=0)
    inl = torch.ones_like(prob.obs_valid)
    bk = ba.build_normal_blocks(cam, 30.0, prob.R, prob.t, prob.xw, prob, inl)
    bp = ba.build_normal_blocks_plain(cam, 30.0, prob.R, prob.t, prob.xw, prob, inl)
    for x, y in zip((*bk[:4], ba.coupling_to_dense(bk[4], prob), *bk[5:]), bp):
        assert float((x - y).abs().max()) <= 1e-4 * max(float(y.abs().max()), 1e-12)
    lam = torch.tensor(1e-3, device=cuda)
    dk, lk, ok = ba.schur_solve(*bk[:6], prob, lam)
    assert bool(ok)
    dpp, lpp = ba.schur_solve_plain(*bp[:6], prob.pose_fixed, prob.lm_valid, lam)
    assert float((dk - dpp).abs().max()) <= 1e-3 * float(dpp.abs().max())
    assert float((lk - lpp).abs().max()) <= 1e-3 * float(lpp.abs().max())
    Xk, Xp = twoview.triangulate_dlt(*dlt), twoview.triangulate_dlt_plain(*dlt)
    assert float(((Xk - Xp).norm(dim=1) / Xp.norm(dim=1)).max()) < 1e-4
    Rk, tk, xk, ik = ba.bundle_adjust(cam, 30.0, prob)
    Rp, tp, xp, ip = ba.bundle_adjust_plain(cam, 30.0, prob)
    assert float((tk - tp).abs().max()) < 1e-3 and float((Rk - Rp).abs().max()) < 1e-3
    assert float((ik != ip).float().mean()) <= 0.005


@pytest.mark.cuda
def test_schur_failure_rejects_the_step_on_card(cuda):
    """Kernel F on a reduced system that is not positive definite: a free
    pose's block given a negative eigenvalue of 1e-3 of its largest one
    (a margin that float32 storage of the block cannot close).  The flag
    comes back as ``ok`` False with dp and dl zero, and a BA whose every
    solve fails leaves the problem as it was."""
    rng = np.random.default_rng(1)
    cam, prob, _, _, _ = system_inputs(rng, cuda)
    inl = torch.ones_like(prob.obs_valid)
    bk = list(ba.build_normal_blocks(cam, 30.0, prob.R, prob.t, prob.xw, prob, inl))
    lam = torch.tensor(1e-4, device=cuda)
    dp, dl, ok = ba.schur_solve(*bk[:6], prob, lam)
    assert bool(ok) and float(dl.abs().max()) > 0
    H1 = bk[0][1].double()
    ev = torch.linalg.eigvalsh(H1)
    shift = float(ev[0] + 1e-3 * ev[-1])
    bk[0] = bk[0].clone()
    bk[0][1] = (H1 - shift * torch.eye(6, dtype=torch.float64, device=cuda)).float()
    dp, dl, ok = ba.schur_solve(*bk[:6], prob, lam)
    assert not bool(ok)
    assert float(dp.abs().max()) == 0.0 and float(dl.abs().max()) == 0.0

    def indefinite(*args):
        blocks = list(ba.build_normal_blocks(*args))
        trace = blocks[0].diagonal(dim1=1, dim2=2).sum(-1)
        blocks[0] = blocks[0] - 2.0 * trace[:, None, None] * torch.eye(6, device=cuda)
        return blocks

    R, t, xw, _ = ba._bundle_adjust(cam, 30.0, prob, 2, 1, indefinite, ba.schur_solve)
    assert torch.equal(R, prob.R) and torch.equal(t, prob.t) and torch.equal(xw, prob.xw)


@pytest.mark.cuda
def test_lm_kernel_matches_plain_on_card(cuda, monkeypatch):
    """Kernel AC against its plain versions on the card: the update from E's
    cost and F's step within 1e-5 with the same accept and damping, twice
    bit for bit; a zero step rejected with AC's cost equal to E's bit for
    bit; the gate's mask equal but for chi2 within 1e-4 of its bound.  Then
    both BA forms on CUDA tensors with every plain LM function made to
    raise: they run, and AC launches once per E launch."""
    rng = np.random.default_rng(0)
    cam, prob, _, _, _ = system_inputs(rng, cuda)
    inl = torch.ones_like(prob.obs_valid)
    blocks = ba.build_normal_blocks(cam, 30.0, prob.R, prob.t, prob.xw, prob, inl)
    lam = torch.tensor(1e-3, device=cuda)
    dp, dl, ok = ba.schur_solve(*blocks[:6], prob, lam)
    args = (cam, 30.0, prob, prob.R, prob.t, prob.xw, dp, dl, inl, blocks[6], ok, lam)
    k, k2, p = ba.lm_update(*args), ba.lm_update(*args), ba.lm_update_plain(*args)
    assert all(torch.equal(a, b) for a, b in zip(k, k2))
    for a, b in zip(k[:3], p[:3]):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5)
    assert bool(k[4]) == bool(p[4]) and float(k[3]) == float(p[3])
    zero = ba.lm_update(cam, 30.0, prob, prob.R, prob.t, prob.xw, torch.zeros_like(dp), torch.zeros_like(dl), inl,
                        blocks[6], ok, lam)
    assert not bool(zero[4]) and float(zero[5]) == float(blocks[6])
    xw = prob.xw + 0.03 * torch.sin(torch.arange(prob.xw.numel(), device=cuda, dtype=torch.float32)).view(-1, 3)
    ck, cp = ba.classify(cam, 30.0, prob, prob.R, prob.t, xw), ba.classify_plain(cam, 30.0, prob, prob.R, prob.t, xw)
    r, _, _ = ba._obs_residuals(cam, 30.0, prob.R, prob.t, xw, prob)
    edge = near((r * r).sum(-1) * prob.obs_inv_sigma2 / ba._delta2(prob), 1.0, 1e-4)
    assert torch.equal(ck[~edge], cp[~edge])

    def refuse(*a, **kw):
        raise AssertionError("a plain LM function was called")

    for name in ("lm_update_plain", "classify_plain", "apply_update", "_obs_residuals", "_robust_cost"):
        monkeypatch.setattr(ba, name, refuse)
    for w in (ba.build_normal_blocks, ba.lm_update, ba.classify):
        w.launches.reset()
    ba.bundle_adjust(cam, 30.0, prob)
    ba_cg.bundle_adjust_cg(cam, 30.0, prob, iters1=2, iters2=3)
    assert ba.lm_update.launches.total() == ba.build_normal_blocks.launches.total() == 15 + 5
    assert ba.classify.launches.total() == 4


def near(x: torch.Tensor, threshold: float, tol: float = 1e-5) -> torch.Tensor:
    """Where a float quantity lies within ``tol`` (relative) of a threshold."""
    return (x - threshold).abs() <= tol * max(abs(threshold), 1.0)


@pytest.mark.cuda
def test_front_kernels_match_plain_on_card(cuda):
    """H, I, J and L against their plain versions on the same CUDA tensors.
    H: levels within 1e-4 grey levels of F.interpolate's chain, and each
    blur bit-equal to ``gaussian_blur`` of the kernel's own level.  I:
    exact, on kernel A's maps and on a tie-heavy map.  J: refined u within
    1e-3 px, ``ok`` equal except where two SADs lie within 1e-5 (relative).
    L: uv within 1e-3 px; level and visible equal except where a tested
    quantity lies within 1e-5 of its threshold."""
    rng = np.random.default_rng(0)
    img, maps, ties, sad_in, cam, T, lm = front_inputs(rng, cuda)
    shapes, offs = image.pyramid_layout(*img.shape, 8, 1.2)
    lk, bk = image.pyramid_blur(img, 8, 1.2)
    lp, _ = image.pyramid_blur_plain(img, 8, 1.2)
    assert float((lk - lp).abs().max()) <= 1e-4
    for lv, bl in zip(image.level_views(lk, shapes, offs), image.level_views(bk, shapes, offs)):
        assert torch.equal(bl, image.gaussian_blur(lv))
    for nms in (maps[0], ties):
        for x, y in zip(ext.select_subpixel(nms, *maps[1:], FRONT_CFG),
                        ext.select_subpixel_plain(nms, *maps[1:], FRONT_CFG)):
            assert torch.equal(x, y)
    (uk, ok_k), (up, ok_p) = mat.stereo_subpixel_refine(*sad_in), mat.stereo_subpixel_refine_plain(*sad_in)
    sad, _ = mat.sad_table(*sad_in[:4])
    two = torch.sort(sad, dim=1).values[:, :2]
    tie = (two[:, 1] - two[:, 0]) <= 1e-5 * two[:, 0].abs().clamp(min=1.0)
    assert torch.equal(ok_k[~tie], ok_p[~tie])
    both = ok_k & ok_p & ~tie
    assert float((uk - up)[both].abs().max()) <= 1e-3
    (uvk, lvk, vk), (uvp, lvp, vp) = (trk.visible_landmarks(cam, T.R, T.t, *lm, (320, 240)),
                                      trk.visible_landmarks_plain(cam, T.R, T.t, *lm, (320, 240)))
    # points near z = 0 project far out: there uv agrees to 1e-5 relative
    assert bool(((uvk - uvp).abs() <= 1e-3 + 1e-5 * uvp.abs()).all())
    pos, mask, normal, dmin, dmax = lm
    xc = pos @ T.R.T + T.t
    po = pos + T.R.T @ T.t
    dist = po.norm(dim=1)
    q = torch.log(dmax / dist) / float(np.log(1.2))  # unclamped: ratio < 1 is level 0 on both
    border = ((q - q.round()).abs().le(1e-5) | near(xc[:, 2], 0.05) | near(uvp[:, 0], 0.0)
              | near(uvp[:, 0], 320.0) | near(uvp[:, 1], 0.0) | near(uvp[:, 1], 240.0) | near(dist, 0.0)
              | near(dist / (dmin * 0.8), 1.0) | near(dist / (dmax * 1.2), 1.0)
              | near((po * normal).sum(1) / dist, 0.5))
    assert torch.equal(lvk[~border], lvp[~border]) and torch.equal(vk[~border], vp[~border])


@pytest.mark.cuda
def test_mono_kernels_match_plain_on_card(cuda):
    """M, N and P against their plain versions on the same CUDA tensors.  M,
    on a planar (H) and a 3-D (F) case: success and used_h equal, R within
    1e-3 rad, t's direction within 1e-3, good equal on >= 99%, X within
    1e-3 relative where both good.  N: words and nodes exact, the BoW within
    1e-5 relative on the same words.  P: the count and ok equal, the pose
    within 1e-3 rad and 1e-3 of the scene scale."""
    from chip_smoke import rot_angle as _angle

    rng = np.random.default_rng(0)
    cam, tv, samples, voc, desc, valid, pnp_in, subsets = mono_inputs(rng, cuda)
    used_h = set()
    for case in tv:
        rk = twoview.reconstruct(cam, *case, 0, samples=samples)
        rp = twoview.reconstruct_plain(cam, *case, samples)
        assert bool(rk.success) == bool(rp.success) and bool(rk.used_h) == bool(rp.used_h)
        used_h.add(bool(rp.used_h))
        assert _angle(rk.R, rp.R) <= 1e-3 and 1.0 - abs(float(torch.dot(rk.t, rp.t))) <= 1e-3
        assert float((rk.good == rp.good).float().mean()) >= 0.99
        both = rk.good & rp.good
        if bool(both.any()):
            assert float(((rk.X - rp.X).norm(dim=1) / rp.X.norm(dim=1))[both].max()) <= 1e-3
    assert used_h == {False, True}
    (wk, nk, bk), (wp, np_, bp) = voc_mod.transform(voc, desc, valid), voc_mod.transform_plain(voc, desc, valid)
    assert torch.equal(wk, wp) and torch.equal(nk, np_) and torch.equal(bk != 0, bp != 0)
    assert float(((bk - bp).abs() / bp.abs().clamp(min=1e-30))[bp != 0].max()) <= 1e-5
    rk, rp = pnp.pnp_ransac(cam, *pnp_in, 0, subsets=subsets), pnp.pnp_ransac_plain(cam, *pnp_in, subsets)
    assert int(rk.n_inliers) == int(rp.n_inliers) and bool(rk.ok) == bool(rp.ok) and bool(rp.ok)
    scale = float(pnp_in[0][pnp_in[3]].norm(dim=1).median())
    assert _angle(rk.R, rp.R) <= 1e-3 and float((rk.t - rp.t).norm()) <= 1e-3 * scale


# kernel M's three camera instances: the synthetic pin-hole camera, EuRoC cam0's distortion on it, TUM-VI's cam0
TWOVIEW_CAMERAS = {"pinhole": ((400.0, 400.0, 320.0, 240.0), (640, 480)),
                   "radtan": ((400.0, 400.0, 320.0, 240.0, (-0.28340811, 0.07395907, 0.00019359, 1.76187114e-05)),
                              (640, 480)),
                   "kb8": ((190.97847715128717, 190.9733070521226, 254.93170605935475, 256.8974428996504,
                            0.0034823894022493434, 0.0007150348452162257, -0.0020532361418706202,
                            0.00020293673591811182), (512, 512))}


def twoview_camera(kind):
    p, wh = TWOVIEW_CAMERAS[kind]
    return (cm.Camera.kb8(*p) if kind == "kb8" else cm.Camera.pinhole(*p)), wh


@pytest.mark.cuda
@pytest.mark.parametrize("kind", sorted(TWOVIEW_CAMERAS))
def test_twoview_unprojection_bit_for_bit_on_card(cuda, kind):
    """Kernel M's first stage bit for bit ``_camera_plane`` on the card (the
    camera on the host, as the tracker holds it): both views over the whole
    image, corners and principal point included, and sigma^2."""
    import chip_smoke

    cam, wh = twoview_camera(kind)
    rng = np.random.default_rng(2)
    uv0, uv1 = (chip_smoke.image_pixels(rng, cam, wh, 700).to(cuda) for _ in range(2))
    xk0, xk1, s2k = twoview.unproject_pair(cam, uv0, uv1)
    xp0, xp1, s2p = twoview._camera_plane(cam, uv0, uv1)
    assert torch.equal(xk0, xp0) and torch.equal(xk1, xp1) and s2k == float(np.float32(s2p))


@pytest.mark.cuda
def test_twoview_verdict_matches_plain_on_card(cuda):
    """Kernel M's last stage bit for bit ``_verdict`` on the card, on
    chip_smoke's crafted motions (H preferred and failing, both failing,
    quality ties, dominance by count, quality and parallax, the parallax
    gate), each reaching the verdict it was built for."""
    import chip_smoke

    for label, (args, (success, used_h, best)) in chip_smoke.verdict_cases(cuda).items():
        rk = twoview.verdict(*args, chip_smoke.VERDICT_MIN_TRI, 1.0)
        assert chip_smoke.verdicts_equal(rk, twoview._verdict(*args, chip_smoke.VERDICT_MIN_TRI, 1.0)), label
        assert (bool(rk.success), bool(rk.used_h)) == (success, used_h) and torch.equal(rk.R, args[0][best]), label


@pytest.mark.cuda
@pytest.mark.parametrize("planar", [False, True])
def test_twoview_kb8_matches_plain_on_card(cuda, planar):
    """reconstruct on the card (kernel M in its KB8 instance) against
    reconstruct_plain on the card, on a 3-D (F) and a planar (H) pair seen
    through TUM-VI's cam0, each hypothesis of 8 distinct matches
    (``chip_smoke.distinct_hypotheses``: with a repeated match the 8-point
    system's null space is a plane, and the kernel and the plain version
    each return a vector of it): success and used_h equal, R within 1e-3
    rad, t's direction within 1e-3, good equal on >= 99%, X within 1e-3
    relative where both good; its verdict bit for bit the plain verdict on
    the plain motions; the launch counted in the KB8 instance."""
    import chip_smoke

    cam, _ = twoview_camera("kb8")
    uv0, uv1, valid = (a.to(cuda) for a in chip_smoke.two_view_scene(np.random.default_rng(5), cam, planar))
    samples = chip_smoke.distinct_hypotheses(3, valid)
    before = twoview.reconstruct.launches.total(camera="kb8")
    rk = twoview.reconstruct(cam, uv0, uv1, valid, 0, samples=samples)
    assert twoview.reconstruct.launches.total(camera="kb8") == before + 1
    motions = twoview.motions_plain(cam, uv0, uv1, valid, samples)
    rp = twoview._verdict(*motions, 50, 1.0)
    assert bool(rp.success) and bool(rp.used_h) == planar
    assert bool(rk.success) == bool(rp.success) and bool(rk.used_h) == bool(rp.used_h)
    assert chip_smoke.rot_angle(rk.R, rp.R) <= 1e-3 and 1.0 - abs(float(torch.dot(rk.t, rp.t))) <= 1e-3
    assert float((rk.good == rp.good).float().mean()) >= 0.99
    both = rk.good & rp.good
    assert float(((rk.X - rp.X).norm(dim=1) / rp.X.norm(dim=1))[both].max()) <= 1e-3
    assert chip_smoke.verdicts_equal(twoview.verdict(*motions, 50, 1.0), rp)


LOOP_WRAPPERS = (sim3.sim3_ransac, sim3.optimize_sim3, pg.optimize_sim3_graph, ba_cg.implicit_schur_solve)


def loop_inputs(rng, device):
    """Inputs of Q, R, S and T at a small size, on ``device``: 256 pair
    slots (150 valid) with 64 subsets, a 12-keyframe essential graph, and
    the BA problem of ``system_inputs`` with its per-observation blocks."""
    import chip_smoke

    cam = cm.Camera.pinhole(400.0, 400.0, 320.0, 240.0)
    arrays, _ = chip_smoke.sim3_pairs(rng, n=256, n_valid=150)
    pairs = [torch.as_tensor(a).to(device) for a in arrays]
    subsets = sim3._sample_subsets(3, pairs[-1], 64)
    g_np, _ = chip_smoke.sim3_graph_problem(rng, K=12)
    graph = pg.Sim3Graph(**{k: torch.as_tensor(v).to(device) for k, v in g_np.items()})
    _, prob, *_ = system_inputs(rng, "cpu")
    blocks = ba.build_normal_blocks_plain(cam, 30.0, prob.R, prob.t, prob.xw, prob, torch.ones_like(prob.obs_valid),
                                          per_obs=True)
    move = lambda x: x.to(device)  # noqa: E731
    return cam, pairs, subsets, graph, ba.BAProblem(*map(move, prob)), [move(b) for b in blocks]


def test_loop_wrappers_cpu_plain_and_other_devices_raise():
    """Q, R, S and T: CPU tensors take the plain version (no launch); a
    tensor on another device (meta) gets no plain path; a KB8 camera goes
    to Q's and R's KB8 instance, so on a meta tensor it meets the same
    CUDA check; a KB8 camera beside a pin-hole one is refused."""
    rng = np.random.default_rng(5)
    cam, pairs, subsets, graph, prob, blocks = loop_inputs(rng, "cpu")
    before = [w.launches.total() for w in LOOP_WRAPPERS]
    torch.testing.assert_close(sim3.sim3_ransac(cam, cam, *pairs, 0, subsets=subsets),
                               sim3.sim3_ransac_plain(cam, cam, *pairs, subsets))
    S0 = sim3.sim3_ransac_plain(cam, cam, *pairs, subsets).S12
    torch.testing.assert_close(sim3.optimize_sim3(cam, cam, S0, *pairs), sim3.optimize_sim3_plain(cam, cam, S0, *pairs))
    torch.testing.assert_close(pg.optimize_sim3_graph(graph, iters=2)[:3], pg.optimize_sim3_graph_plain(graph, iters=2))
    lam = torch.tensor(1e-3)
    torch.testing.assert_close(
        ba_cg.implicit_schur_solve(*blocks[:5], prob, blocks[5], lam, cg_iters=8),
        ba_cg.implicit_schur_solve_plain(*blocks[:5], prob.obs_kf, prob.obs_lm, blocks[5], prob.pose_fixed,
                                         prob.lm_valid, lam, 8))
    assert [w.launches.total() for w in LOOP_WRAPPERS] == before
    meta = lambda t: t.to("meta")  # noqa: E731
    mpairs = [meta(x) for x in pairs]
    with pytest.raises(ValueError, match="CUDA"):
        sim3.sim3_ransac(cam, cam, *mpairs, 0, subsets=meta(subsets))
    with pytest.raises(ValueError, match="CUDA"):
        sim3.optimize_sim3(cam, cam, lie.Sim3(*map(meta, S0)), *mpairs)
    with pytest.raises(ValueError, match="CUDA"):
        pg.optimize_sim3_graph(pg.Sim3Graph(*map(meta, graph)))
    with pytest.raises(ValueError, match="CUDA"):
        ba_cg.implicit_schur_solve(*map(meta, blocks[:5]), ba.BAProblem(*map(meta, prob)), meta(blocks[5]), meta(lam))
    kb8 = cm.Camera.kb8(400.0, 400.0, 320.0, 240.0, 0.0, 0.0, 0.0, 0.0)
    with pytest.raises(ValueError, match="CUDA"):
        sim3.sim3_ransac(kb8, kb8, *mpairs, 0, subsets=meta(subsets))
    with pytest.raises(ValueError, match="CUDA"):
        sim3.optimize_sim3(kb8, kb8, lie.Sim3(*map(meta, S0)), *mpairs)
    with pytest.raises(ValueError, match="pin-hole or two KB8"):
        sim3.sim3_ransac(kb8, cam, *mpairs, 0, subsets=meta(subsets))


@pytest.mark.cuda
def test_loop_kernels_match_plain_on_card(cuda):
    """Q, R, S and T against their plain versions on the same CUDA tensors:
    Q's count within 1 and ok equal, its Sim3 within 1e-4; R's count within
    1, its Sim3 within 2e-4; S within 1e-3 with no Cholesky failure; T's dp
    and dl within 1e-4 of their largest entries; two runs of each kernel
    equal bit for bit."""
    from chip_smoke import sim3_rel_err

    rng = np.random.default_rng(5)
    cam, pairs, subsets, graph, prob, blocks = loop_inputs(rng, cuda)
    rk, rp = sim3.sim3_ransac(cam, cam, *pairs, 0, subsets=subsets), sim3.sim3_ransac_plain(cam, cam, *pairs, subsets)
    assert abs(int(rk.n_inliers) - int(rp.n_inliers)) <= 1 and bool(rk.ok) == bool(rp.ok) and bool(rp.ok)
    assert sim3_rel_err(rk.S12, rp.S12) <= 1e-4
    Sk, _, nk = sim3.optimize_sim3(cam, cam, rp.S12, *pairs)
    Sp, _, np_ = sim3.optimize_sim3_plain(cam, cam, rp.S12, *pairs)
    assert abs(int(nk) - int(np_)) <= 1 and sim3_rel_err(Sk, Sp) <= 2e-4
    assert torch.equal(sim3.optimize_sim3(cam, cam, rp.S12, *pairs)[0].t, Sk.t)
    gk, gp = pg.optimize_sim3_graph(graph), pg.optimize_sim3_graph_plain(graph)
    assert bool(gk.ok)
    assert max(float((a - b).abs().max()) for a, b in zip(gk[:3], gp)) <= 1e-3
    assert all(torch.equal(a, b) for a, b in zip(pg.optimize_sim3_graph(graph)[:3], gk[:3]))
    lam = torch.tensor(1e-3, device=cuda)
    dk, lk = ba_cg.implicit_schur_solve(*blocks[:5], prob, blocks[5], lam)
    dp, lp = ba_cg.implicit_schur_solve_plain(*blocks[:5], prob.obs_kf, prob.obs_lm, blocks[5], prob.pose_fixed,
                                              prob.lm_valid, lam)
    assert float((dk - dp).abs().max()) <= 1e-4 * float(dp.abs().max())
    assert float((lk - lp).abs().max()) <= 1e-4 * float(lp.abs().max())
    d2, l2 = ba_cg.implicit_schur_solve(*blocks[:5], prob, blocks[5], lam)
    assert torch.equal(d2, dk) and torch.equal(l2, lk)


@pytest.mark.cuda
def test_pcg_kernel_matches_plain_on_card(cuda):
    """Kernel U (the Sim3 graph's PCG branch) against its plain version on
    the card: tests/test_pose_graph.py's drift graph of 200 vertices (4
    steps) and, under ``_FORCE_CG``, the 12-vertex graph of ``loop_inputs``;
    the vertices within 1e-3, no failed solve, at most ``cg_iterations`` CG
    iterations a step, and two runs equal bit for bit; S is not launched."""
    import chip_smoke

    g_np, _ = chip_smoke.drift_graph(200, seed=3)
    graph = pg.Sim3Graph(**{k: torch.as_tensor(v).to(cuda) for k, v in g_np.items()})
    before_s = pg.optimize_sim3_graph.launches.total(mode="dense")
    res = pg.optimize_sim3_graph(graph, iters=4)
    plain = pg.optimize_sim3_graph_plain(graph, iters=4)
    assert bool(res.ok) and res.cg_run.shape == (4,) and int(res.cg_run.max()) <= pg.cg_iterations(200)
    assert max(float((a - b).abs().max()) for a, b in zip(res[:3], plain)) <= 1e-3
    assert all(torch.equal(a, b) for a, b in zip(pg.optimize_sim3_graph(graph, iters=4)[:3], res[:3]))
    _, _, _, small, _, _ = loop_inputs(np.random.default_rng(5), cuda)
    pg._FORCE_CG = True
    try:
        forced = pg.optimize_sim3_graph(small, iters=6)
        plain = pg.optimize_sim3_graph_plain(small, iters=6)
    finally:
        pg._FORCE_CG = False
    assert bool(forced.ok) and max(float((a - b).abs().max()) for a, b in zip(forced[:3], plain)) <= 1e-3
    assert pg.optimize_sim3_graph.launches.total(mode="dense") == before_s


@pytest.mark.cuda
def test_distorted_camera_kernels_match_plain_on_card(cuda):
    """D, E, Q and R with a pin-hole camera carrying EuRoC cam0's
    distortion, against their plain versions on the same CUDA tensors,
    with the undistorted cases' tolerances (D: pose 1e-4 / 1e-3, inliers
    within 2; E: every block within 1e-4 of its max; Q: count within 1,
    Sim3 1e-4; R: count within 1, Sim3 2e-4); each counted as a launch of
    its distorted instance."""
    import chip_smoke
    from chip_smoke import sim3_rel_err

    rng = np.random.default_rng(0)
    cam_d = cm.Camera.pinhole(300.0, 300.0, 160.0, 120.0, chip_smoke.EUROC_DIST)
    *_, obs = kernel_inputs(rng, cuda)
    T_gt = lie.se3_exp(torch.tensor([0.1, -0.05, 0.1, 0.02, -0.01, 0.03], device=cuda))
    uvr = cm.stereo_project(cam_d, T_gt.apply(obs.xw), 30.0) + 0.3 * (torch.rand(obs.xw.shape[0], 3, device=cuda) - 0.5)
    obs = obs._replace(uv=uvr.contiguous())
    counts = [w.launches.total(camera="radtan") for w in (pose_opt.pose_optimization, ba.build_normal_blocks,
                                                          sim3.sim3_ransac, sim3.optimize_sim3)]
    T0 = lie.SE3.identity(cuda)
    Tk, _, nk = pose_opt.pose_optimization(cam_d, 30.0, T0, obs)
    Tp, _, np_ = pose_opt.pose_optimization_plain(cam_d, 30.0, T0, obs)
    torch.testing.assert_close(Tk.R, Tp.R, rtol=0, atol=1e-4)
    torch.testing.assert_close(Tk.t, Tp.t, rtol=0, atol=1e-3)
    assert abs(int(nk) - int(np_)) <= 2
    _, prob, *_ = system_inputs(rng, cuda)
    inl = torch.ones_like(prob.obs_valid)
    bk = ba.build_normal_blocks(cam_d, 30.0, prob.R, prob.t, prob.xw, prob, inl)
    bp = ba.build_normal_blocks_plain(cam_d, 30.0, prob.R, prob.t, prob.xw, prob, inl)
    for x, y in zip((*bk[:4], ba.coupling_to_dense(bk[4], prob), *bk[5:]), bp):
        assert float((x - y).abs().max()) <= 1e-4 * max(float(y.abs().max()), 1e-12)
    cam_q = cm.Camera.pinhole(400.0, 400.0, 320.0, 240.0, chip_smoke.EUROC_DIST)
    arrays, _ = chip_smoke.sim3_pairs(rng, n=256, n_valid=150, cam=cam_q)
    pairs = [torch.as_tensor(a).to(cuda) for a in arrays]
    subsets = sim3._sample_subsets(3, pairs[-1], 64)
    rk, rp = (sim3.sim3_ransac(cam_q, cam_q, *pairs, 0, subsets=subsets),
              sim3.sim3_ransac_plain(cam_q, cam_q, *pairs, subsets))
    assert abs(int(rk.n_inliers) - int(rp.n_inliers)) <= 1 and bool(rk.ok) == bool(rp.ok) and bool(rp.ok)
    assert sim3_rel_err(rk.S12, rp.S12) <= 1e-4
    Sk, _, nk = sim3.optimize_sim3(cam_q, cam_q, rp.S12, *pairs)
    Sp, _, np_ = sim3.optimize_sim3_plain(cam_q, cam_q, rp.S12, *pairs)
    assert abs(int(nk) - int(np_)) <= 1 and sim3_rel_err(Sk, Sp) <= 2e-4
    after = [w.launches.total(camera="radtan") for w in (pose_opt.pose_optimization, ba.build_normal_blocks,
                                                         sim3.sim3_ransac, sim3.optimize_sim3)]
    assert all(a == b + 1 for a, b in zip(after, counts))


def vi_inputs(device):
    """The inertial kernels' inputs at small shapes (chip_smoke.py's
    phase 3 problems): a 40-sample window, a frame of 256 slots, a chain of
    8 keyframes, a window of 8 states, 256 landmarks and 1024 observations."""
    import chip_smoke

    rng = np.random.default_rng(8)
    acc = torch.as_tensor((rng.normal(size=(40, 3)) + [0, 0, 9.81]).astype(np.float32)).to(device)
    gyro = torch.as_tensor((rng.normal(size=(40, 3)) * 0.3).astype(np.float32)).to(device)
    window = (acc, gyro, torch.full((40,), 0.005, device=device), torch.arange(40, device=device) < 30)
    w = chip_smoke.w_problem(rng, device, 256)
    x = chip_smoke.x_problem(rng, device, 8)
    y = chip_smoke.y_problem(rng, device, K=16, M=256, per_lm=4)
    return window, w, x, y


def _vi_noise():
    from orb_slam3_fast_tpu_torch.imu import preintegration as pre

    return pre.ImuNoise.from_continuous(1.7e-4, 2e-3, 1.9e-5, 3e-3, 200.0)


def test_vi_wrappers_cpu_plain_and_other_devices_raise():
    """V, W, X and Y: CPU tensors take the plain version (no launch); a
    tensor on another device (meta) gets no plain path, a KB8 camera's
    either (W and Y have KB8 instances)."""
    from orb_slam3_fast_tpu_torch.imu import preintegration as pre
    from orb_slam3_fast_tpu_torch.optim import imu_init, inertial, vi_ba

    wrappers = (pre.preintegrate, inertial.pose_inertial_optimization, imu_init.inertial_only_optimization,
                vi_ba.vi_bundle_adjust)
    before = [w.launches.total() for w in wrappers]
    (acc, gyro, dts, valid), (cam, T_cb, preint, s_prev, s0, obs, prior), (R, p, v, pis), (cam_y, prob) = \
        vi_inputs("cpu")
    noise = _vi_noise()
    torch.testing.assert_close(pre.preintegrate(acc, gyro, dts, torch.zeros(6), noise, valid),
                               pre.preintegrate_plain(acc, gyro, dts, torch.zeros(6), noise, valid))
    a = inertial.pose_inertial_optimization(cam, 48.0, T_cb, s_prev, preint, s0, obs, n_rounds=1, iters=2)
    b = inertial.pose_inertial_optimization_plain(cam, 48.0, T_cb, s_prev, preint, s0, obs, n_rounds=1, iters=2)
    torch.testing.assert_close(a, b)
    torch.testing.assert_close(imu_init.inertial_only_optimization(R, p, pis, iters=3),
                               imu_init.inertial_only_optimization_plain(R, p, pis, iters=3))
    T_id = lie.SE3.identity("cpu")
    torch.testing.assert_close(vi_ba.vi_bundle_adjust(cam_y, 0.0, T_id, prob, 1, 1),
                               vi_ba.vi_bundle_adjust_plain(cam_y, 0.0, T_id, prob, 1, 1))
    assert [w.launches.total() for w in wrappers] == before
    meta = lambda t: t.to("meta")  # noqa: E731
    with pytest.raises(ValueError, match="CUDA"):
        pre.preintegrate(meta(acc), meta(gyro), meta(dts), meta(torch.zeros(6)), noise, meta(valid))
    mobs = inertial.VIObs(*map(meta, obs))
    with pytest.raises(ValueError, match="CUDA"):
        inertial.pose_inertial_optimization(cam, 48.0, T_cb, s_prev, preint, s0, mobs)
    with pytest.raises(ValueError, match="CUDA"):
        imu_init.inertial_only_optimization(meta(R), meta(p), pis)
    mprob = vi_ba.VIBAProblem(*[x if f == "preint" else meta(x) for f, x in zip(prob._fields, prob)])
    with pytest.raises(ValueError, match="CUDA"):
        vi_ba.vi_bundle_adjust(cam_y, 0.0, T_id, mprob)
    kb8 = cm.Camera.kb8(400.0, 400.0, 320.0, 240.0, 0.0, 0.0, 0.0, 0.0)
    with pytest.raises(ValueError, match="CUDA"):
        inertial.pose_inertial_optimization(kb8, 48.0, T_cb, s_prev, preint, s0, mobs)
    with pytest.raises(ValueError, match="CUDA"):
        vi_ba.vi_bundle_adjust(kb8, 0.0, T_id, mprob)


@pytest.mark.cuda
def test_vi_kernels_match_plain_on_card(cuda):
    """V, W (its three forms), X (both entries) and Y against their plain
    versions on the same CUDA tensors: V's deltas within 1e-4 and its
    covariance within 1e-3 of its largest entry; W's state within 5e-3,
    H within 5e-3 of its largest entry, at most 2 edges classified
    otherwise; X's scale within 5e-3 (relative), gravity, biases and
    velocities within 5e-3; Y's positions within 2e-3 m, rotation entries
    2e-4, landmarks 1e-2 m; every kernel launched, two runs of W and Y
    equal bit for bit."""
    from orb_slam3_fast_tpu_torch.imu import preintegration as pre
    from orb_slam3_fast_tpu_torch.optim import imu_init, inertial, vi_ba

    (acc, gyro, dts, valid), (cam, T_cb, preint, s_prev, s0, obs, prior), (R, p, v, pis), (cam_y, prob) = \
        vi_inputs(cuda)
    noise = _vi_noise()
    bias = torch.full((6,), 0.01, device=cuda)
    k, q = pre.preintegrate(acc, gyro, dts, bias, noise, valid), pre.preintegrate_plain(acc, gyro, dts, bias, noise,
                                                                                        valid)
    for f in pre.Preintegrated._fields:
        tol = 1e-3 * float(q.C.abs().max()) if f == "C" else 1e-4
        assert float((getattr(k, f) - getattr(q, f)).abs().max()) <= tol, f
    assert float((pre.compose(k, k).dP - pre.compose_plain(q, q).dP).abs().max()) <= 1e-4
    for form in ("none", "prior", "last"):
        if form == "last":
            run = lambda: inertial.pose_inertial_optimization_last_frame(cam, 48.0, T_cb, s_prev, prior, preint, s0, obs)
            ref = inertial.pose_inertial_optimization_last_frame_plain(cam, 48.0, T_cb, s_prev, prior, preint, s0, obs)
        else:
            pr = prior if form == "prior" else None
            run = lambda: inertial.pose_inertial_optimization(cam, 48.0, T_cb, s_prev, preint, s0, obs, pr)
            ref = inertial.pose_inertial_optimization_plain(cam, 48.0, T_cb, s_prev, preint, s0, obs, pr)
        out = run()
        assert max(float((a - b).abs().max()) for a, b in zip(out[0], ref[0])) <= 5e-3, form
        assert float((out[3] - ref[3]).abs().max()) <= 5e-3 * float(ref[3].abs().max()), form
        assert int((out[1] != ref[1]).sum()) <= 2, form
        again = run()
        assert all(torch.equal(a, b) for a, b in zip(again[0], out[0])) and torch.equal(again[3], out[3])
    ik, ip = imu_init.inertial_only_optimization(R, p, pis), imu_init.inertial_only_optimization_plain(R, p, pis)
    assert abs(float(ik.scale) / float(ip.scale) - 1) <= 5e-3
    assert max(float((a - b).abs().max()) for a, b in zip((ik.Rwg, ik.bias), (ip.Rwg, ip.bias))) <= 5e-3
    Rk, sk = imu_init.scale_gravity_refinement(R, p, v, torch.zeros(6, device=cuda), pis)
    Rq, sq = imu_init.scale_gravity_refinement_plain(R, p, v, torch.zeros(6, device=cuda), pis)
    assert abs(float(sk) - float(sq)) <= 5e-3 and float((Rk - Rq).abs().max()) <= 5e-3
    T_id = lie.SE3.identity(cuda)
    yk, yp = vi_ba.vi_bundle_adjust(cam_y, 0.0, T_id, prob), vi_ba.vi_bundle_adjust_plain(cam_y, 0.0, T_id, prob)
    for name, tol, a, b in zip(("R", "p", "v", "bias", "xw"), (2e-4, 2e-3, 1e-2, 1e-3, 1e-2), yk[:5], yp[:5]):
        assert float((a - b).abs().max()) <= tol, name
    again = vi_ba.vi_bundle_adjust(cam_y, 0.0, T_id, prob)
    assert all(torch.equal(a, b) for a, b in zip(again, yk))


@pytest.mark.cuda
def test_vi_kernels_at_long_chains_on_card(cuda):
    """X's two entries on a chain of 120 keyframes (its P = 369 system in
    global memory) and Y at K = 128 (100 real states) against their plain
    versions on the same CUDA tensors, at test_vi_kernels_match_plain_on_card's
    tolerances; X launched twice, Y once."""
    import chip_smoke
    from orb_slam3_fast_tpu_torch.optim import imu_init, vi_ba

    R, p, v, pis = chip_smoke.x_problem(np.random.default_rng(12), cuda, 120)
    before = imu_init.inertial_only_optimization.launches.total()
    ik, ip = imu_init.inertial_only_optimization(R, p, pis), imu_init.inertial_only_optimization_plain(R, p, pis)
    assert abs(float(ik.scale) / float(ip.scale) - 1) <= 5e-3
    assert max(float((a - b).abs().max()) for a, b in zip((ik.Rwg, ik.bias), (ip.Rwg, ip.bias))) <= 5e-3
    assert float((ik.vel - ip.vel).abs().max()) <= 5e-3 * float(ip.vel.abs().max())
    zero = torch.zeros(6, device=cuda)
    Rk, sk = imu_init.scale_gravity_refinement(R, p * 0.95, v * 0.95, zero, pis)
    Rq, sq = imu_init.scale_gravity_refinement_plain(R, p * 0.95, v * 0.95, zero, pis)
    assert abs(float(sk) - float(sq)) <= 1e-3 and float((Rk - Rq).abs().max()) <= 1e-3
    assert imu_init.inertial_only_optimization.launches.total() == before + 2
    cam, prob = chip_smoke.y_problem(np.random.default_rng(13), cuda, K=128, n_real=100)
    T_id = lie.SE3.identity(cuda)
    yk, yp = vi_ba.vi_bundle_adjust(cam, 0.0, T_id, prob), vi_ba.vi_bundle_adjust_plain(cam, 0.0, T_id, prob)
    for name, tol, a, b in zip(("R", "p", "v", "bias", "xw"), (2e-4, 2e-3, 1e-2, 1e-3, 1e-2), yk[:5], yp[:5]):
        assert float((a - b).abs().max()) <= tol, name
    assert float((yk[5] != yp[5]).float().mean()) <= 0.01


@pytest.mark.cuda
def test_inertial_loop_kernels_match_plain_on_card(cuda):
    """Kernel Z on chip_smoke.py's yaw-drifted circles (K = 30, the dense
    branch; K = 200, the PCG branch) and kernel AA (a 2-step segment and
    the classification) on its build_vi_problem-sized problem, against
    their plain versions on the same CUDA tensors: Z within 1e-3 in
    rotation entries and camera centres, AA's states within 1e-3 and the
    same inlier flags; each launch counted in its mode."""
    import chip_smoke
    from orb_slam3_fast_tpu_torch.optim import vi_ba_cg

    for K, mode in ((30, "dense"), (200, "pcg")):
        arrays, _ = chip_smoke.drift_graph(K, 1, rot_noise=0.015, s_drift=1.0, yaw_only=True, pad_e=4)
        g = pg.SE3Graph(**{k: torch.as_tensor(arrays[k]).to(cuda) for k in pg.SE3Graph._fields})
        before = pg.optimize_4dof_graph.launches.total(mode=mode)
        rk, rp = pg.optimize_4dof_graph(g), pg.optimize_4dof_graph_plain(g)
        assert bool(rk.ok) and chip_smoke.graph4_dist(rk, rp) <= 1e-3
        assert pg.optimize_4dof_graph.launches.total(mode=mode) == before + 1
    prob, _ = chip_smoke.vi_cg_problem(np.random.default_rng(12), cuda)
    cam, T_id = cm.Camera.pinhole(400.0, 400.0, 320.0, 240.0), lie.SE3.identity(cuda)
    inl = torch.ones(prob.obs_uv.shape[0], dtype=torch.bool, device=cuda)
    lam = torch.tensor(1e-4, device=cuda)
    args = (cam, 0.0, T_id, prob, prob.R_wb, prob.p_wb, prob.v_w, prob.bias, prob.xw, inl, lam, 2, 40)
    before = vi_ba_cg.lm_segment_vi.launches.total(mode="segment")
    sk, sp = vi_ba_cg.lm_segment_vi(*args), vi_ba_cg.lm_segment_vi_plain(*args)
    assert max(float((a - b).abs().max()) for a, b in zip(sk[:4], sp[:4])) <= 1e-3
    assert vi_ba_cg.lm_segment_vi.launches.total(mode="segment") == before + 1
    ck = vi_ba_cg.classify_vi(cam, 0.0, T_id, prob, sk[0], sk[1], sk[4])
    cp = vi_ba_cg.classify_vi_plain(cam, 0.0, T_id, prob, sk[0], sk[1], sk[4])
    assert torch.equal(ck, cp) and vi_ba_cg.classify_vi.launches.total(mode="classify") >= 1


@pytest.fixture(scope="module")
def fisheye_checks():
    """chip_smoke.py phase 3's fisheye comparisons on the card, run once for
    the module: kernel AB on phase 13's frame 1 and the KB8 instances of D,
    E, L, P, W, Y, Q, R and AA at their paths' shapes, each held against its plain
    version there (chip_smoke.compare_fisheye_kernels raises on a kernel
    beyond its tolerance); and the KB8 launches they counted."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import chip_smoke

    chip_smoke.reset_counts()
    ab, kb8 = chip_smoke.compare_fisheye_kernels(torch.device("cuda"))
    return {"fisheye_stereo": ab[0], **kb8}, chip_smoke.read_counts()


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["fisheye_stereo", "pose_lm", "ba_blocks", "visible_landmarks", "pnp_ransac",
                                  "pose_inertial", "vi_ba", "sim3_ransac", "sim3_refine", "vi_pcg"])
def test_fisheye_kernels_match_plain_on_card(fisheye_checks, name):
    """Kernel AB, and the KB8 instance of D, E, L, P, W, Y, Q, R and AA,
    against its plain version on the same CUDA tensors at chip_smoke.py's
    tolerances (AB: points within 1e-3 m, 1% of the slots flipped; D 1e-3;
    E 1e-4 of each block's largest; L 1e-3 px; P 1e-3 and the same count;
    W 5e-3; Y p 2e-3 m, xw 1e-2 m; Q 1e-4 and R 2e-4 of the Sim3; AA 1e-3
    of the states), timed, and counted: AB as a launch, the others as
    launches of their KB8 instance."""
    entries, counts = fisheye_checks
    e = entries[name]
    assert e["ms"] > 0 and e["plain_ms"] > 0 and e["bound_ms"] > 0
    assert e["max_abs_err"] <= {"visible_landmarks": 1e-3, "pose_inertial": 5e-3, "vi_ba": 1e-2,
                                "ba_blocks": 1e-4, "sim3_ransac": 1e-4, "sim3_refine": 2e-4}.get(name, 1e-3)
    assert counts[name if name == "fisheye_stereo" else f"{name}[kb8]"] >= 1


def test_dist_wrappers_cpu_plain_and_other_devices_raise():
    """AE and AF (parallel/dist_kfdb.py, parallel/dist_ba.py): CPU tensors
    take the plain version (no launch); a tensor on another device (meta)
    gets no plain path."""
    import chip_smoke
    from orb_slam3_fast_tpu_torch.parallel import dist_ba, dist_kfdb, multihost

    ids, w, q = chip_smoke.kfdb_case(np.random.default_rng(0), 2000, n_rows=16, row_words=64)
    lut = torch.from_numpy(np.concatenate([q, np.zeros(1, np.float32)]))
    before = dist_kfdb.score_rows.launches.total(), dist_ba.LAUNCHES.total()
    c, s = dist_kfdb.score_rows(torch.from_numpy(ids), torch.from_numpy(w), lut)
    assert torch.equal(c, dist_kfdb.score_rows_plain(torch.from_numpy(ids), torch.from_numpy(w), lut)[0])
    cam = cm.Camera.pinhole(400.0, 400.0, 320.0, 240.0)
    prob = chip_smoke.ba_problem(np.random.default_rng(3), "cpu")
    mesh = multihost.global_mesh("cpu")
    inl = torch.ones_like(prob.obs_valid)
    acc, W = dist_ba.blocks_partial(cam, 48.0, prob.R, prob.t, prob.xw, prob, inl)
    p_acc, p_W = dist_ba.blocks_partial_plain(cam, 48.0, prob.R, prob.t, prob.xw, prob, inl)
    assert torch.equal(acc, p_acc) and torch.equal(W, p_W)
    assert (dist_kfdb.score_rows.launches.total(), dist_ba.LAUNCHES.total()) == before
    meta = lambda t: t.to("meta")  # noqa: E731
    with pytest.raises(ValueError, match="CUDA"):
        dist_kfdb.score_rows(meta(torch.from_numpy(ids)), meta(torch.from_numpy(w)), meta(lut))
    mprob = ba.BAProblem(*map(meta, prob))
    with pytest.raises(ValueError, match="CUDA"):
        dist_ba.blocks_partial(cam, 48.0, mprob.R, mprob.t, mprob.xw, mprob, meta(inl))
    with pytest.raises(ValueError, match="CUDA"):
        dist_ba.round_blocks(meta(acc), 32, 4096)
    with pytest.raises(ValueError, match="CUDA"):
        dist_ba.cg_solve(mesh, *map(meta, (prob.R.new_zeros(32, 6, 6), prob.xw.new_zeros(4096, 3, 3),
                                           prob.R.new_zeros(32, 6), prob.xw.new_zeros(4096, 3), W)), mprob,
                         meta(prob.xw.new_zeros(4096)), meta(torch.tensor(1e-4)), 4)


@pytest.mark.cuda
def test_dist_kernels_match_plain_on_card(cuda):
    """AE bit for bit its plain version on the card; AF in a world of one
    (no process group): one iteration's stages of the dense run (local-BA
    caps) and of the CG run against their plain versions (state within
    1e-5, the accepts equal: chip_smoke.af_stage_check), and each whole run
    within 5e-4 / 5e-3 of the single-device BA (E -> F -> AC, E -> T ->
    AC)."""
    import chip_smoke
    from orb_slam3_fast_tpu_torch.parallel import dist_kfdb, multihost

    ids, w, q = chip_smoke.kfdb_case(np.random.default_rng(1), 10_000, n_rows=256)
    lut = torch.from_numpy(np.concatenate([q, np.zeros(1, np.float32)])).to(cuda)
    args = (torch.from_numpy(ids).to(cuda), torch.from_numpy(w).to(cuda), lut)
    n0 = dist_kfdb.score_rows.launches.total()
    ck, sk = dist_kfdb.score_rows(*args)
    cp, sp = dist_kfdb.score_rows_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(ck, cp) and torch.equal(sk, sp) and dist_kfdb.score_rows.launches.total() == n0 + 1
    mesh = multihost.global_mesh(cuda)
    cam = cm.Camera.pinhole(400.0, 400.0, 320.0, 240.0)
    for form, (prob, bf) in chip_smoke.af_problems(cuda).items():
        run, shard = chip_smoke.af_run(mesh, cam, form, prob, bf)
        checks = chip_smoke.af_stage_check(mesh, cam, bf, shard, form)
        assert checks["state"] <= 1e-5, (form, checks)
        err = chip_smoke.af_errors(run(shard), chip_smoke.single_run(cam, bf, prob, form))
        assert err[0] <= 5e-4 and err[1] <= 5e-3, (form, err)
