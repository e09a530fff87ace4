"""The four kernel wrappers: CPU tensors take the plain version, other
devices launch the kernel or raise (no fallback); on a CUDA card each
kernel agrees with its plain version (``cuda`` marker; these skip without a
card and run there, where JAX is absent, with
``python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_kernels.py``)."""
import numpy as np
import pytest
import torch

from orb_slam3_fast_tpu_torch import _kernels
from orb_slam3_fast_tpu_torch.cameras import models as cm
from orb_slam3_fast_tpu_torch.ops import extractor as ext
from orb_slam3_fast_tpu_torch.ops import fast
from orb_slam3_fast_tpu_torch.ops import hamming as ham
from orb_slam3_fast_tpu_torch.ops import image
from orb_slam3_fast_tpu_torch.optim import pose_opt
from orb_slam3_fast_tpu_torch.utils import lie

torch.set_num_threads(1)

WRAPPERS = (fast.fast_nms, ext.orb_describe, ham.hamming_best2, pose_opt.pose_optimization)


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


def test_cpu_tensors_take_the_plain_version():
    rng = np.random.default_rng(0)
    img, levels, blurs, xy, lvl, da, db, stereo, window, cam, obs = kernel_inputs(rng, "cpu")
    before = [w.launches for w in WRAPPERS]
    raw, nms = fast.fast_nms(levels[0], 20.0, 7.0, ext.EDGE_BORDER)
    torch.testing.assert_close((raw, nms), fast.fast_nms_plain(levels[0], 20.0, 7.0, ext.EDGE_BORDER))
    torch.testing.assert_close(ext.orb_describe(levels, blurs, xy, lvl), ext.orb_describe_plain(levels, blurs, xy, lvl))
    torch.testing.assert_close(ham.hamming_best2(da, db, stereo), ham.hamming_best2_plain(da, db, stereo))
    torch.testing.assert_close(ham.hamming_best2(da, db, window), ham.hamming_best2_plain(da, db, window))
    T0 = lie.SE3.identity("cpu")
    torch.testing.assert_close(
        pose_opt.pose_optimization(cam, 30.0, T0, obs), pose_opt.pose_optimization_plain(cam, 30.0, T0, obs)
    )
    assert [w.launches for w in WRAPPERS] == before


def test_other_devices_raise_without_fallback():
    """A tensor that is neither on the CPU nor on CUDA gets no plain path."""
    rng = np.random.default_rng(0)
    img, levels, blurs, xy, lvl, da, db, stereo, window, cam, obs = kernel_inputs(rng, "cpu")
    meta = lambda t: t.to("meta")  # noqa: E731
    with pytest.raises(ValueError, match="CUDA"):
        fast.fast_nms(meta(levels[0]), 20.0, 7.0, ext.EDGE_BORDER)
    with pytest.raises(ValueError, match="CUDA"):
        ext.orb_describe([meta(l) for l in levels], [meta(b) for b in blurs], meta(xy), meta(lvl))
    with pytest.raises(ValueError, match="CUDA"):
        ham.hamming_best2(meta(da), meta(db), ham.StereoGate(*[meta(x) for x in stereo[:-1]], stereo.max_disp))
    with pytest.raises(ValueError, match="CUDA"):
        pose_opt.pose_optimization(cam, 30.0, lie.SE3.identity("meta"), pose_opt.PoseObs(*[meta(x) for x in obs]))


def test_build_flags_and_sources():
    srcs = sorted(p.name for p in _kernels.SRC_DIR.glob("*.cu"))
    assert srcs == ["common.cu", "fast_nms.cu", "hamming_best2.cu", "orb_describe.cu", "pose_lm.cu"]
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
    a_k, d_k = ext.orb_describe(levels, blurs, xy, lvl)
    a_p, d_p = ext.orb_describe_plain(levels, blurs, xy, lvl)
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
