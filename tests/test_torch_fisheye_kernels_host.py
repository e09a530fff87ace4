"""The fisheye slice's device code compiled for the host, each CTA emulated
with one std::thread per CUDA thread (the harness of
tests/test_torch_loop_kernels_host.py: a launch of several CTAs runs them
one after another, each at its full width; a one-CTA launch runs at most 64
threads, its loops striding by the block's width), and held against the
plain versions on the same inputs: csrc/camera.cuh's KB8 projection,
closed-form Jacobian and Newton unprojection; kernel AB
(csrc/fisheye_stereo.cu) through its wrapper's marshalling; and the KB8
instances of kernels D, E, L, P, W and Y.  The card runs the same sources
(tests/test_torch_kernels.py's cuda cases, chip_smoke.py phase 3)."""
import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from orb_slam3_fast_tpu_torch import _kernels
from orb_slam3_fast_tpu_torch.cameras import models as cm
from orb_slam3_fast_tpu_torch.frontend import tracker as ttrk
from orb_slam3_fast_tpu_torch.ops import extractor as text
from orb_slam3_fast_tpu_torch.ops import hamming as tham
from orb_slam3_fast_tpu_torch.ops import matching as tmat
from orb_slam3_fast_tpu_torch.optim import ba as tba
from orb_slam3_fast_tpu_torch.optim import inertial as tinr
from orb_slam3_fast_tpu_torch.optim import pnp as tpnp
from orb_slam3_fast_tpu_torch.optim import pose_opt as tpo
from orb_slam3_fast_tpu_torch.optim import vi_ba as tvb
from orb_slam3_fast_tpu_torch.utils import convert
from orb_slam3_fast_tpu_torch.utils import lie as tlie
from tests.test_torch_loop_kernels_host import _GRID_STUB, _host_source
from tests.test_torch_vi_kernels_host import EMULATED_THREADS

torch.set_num_threads(1)

SOURCES = ("fisheye_stereo.cu", "pose_lm.cu", "ba_blocks.cu", "visible_landmarks.cu", "pnp_ransac.cu",
           "pose_inertial.cu", "vi_ba.cu")
# TUM-VI's cam0 (configs/TUMVI_fisheye_stereo_inertial.yaml)
KB8 = cm.Camera.kb8(190.97847715128717, 190.9733070521226, 254.93170605935475, 256.8974428996504,
                    0.0034823894022493434, 0.0007150348452162257, -0.0020532361418706202, 0.00020293673591811182)

_FISHEYE_STUB = _GRID_STUB + r"""
#include <mutex>
inline float atan2f(float y, float x) { return std::atan2(y, x); }
inline float tanf(float x) { return std::tan(x); }
inline float fminf(float a, float b) { return std::fmin(a, b); }
inline float logf(float x) { return std::log(x); }
inline float ceilf(float x) { return std::ceil(x); }
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fdiv_rn(float a, float b) { return a / b; }
inline std::mutex g_atomic;
inline double atomicAdd(double* p, double v) {
  std::lock_guard<std::mutex> lock(g_atomic);
  const double old = *p;
  *p += v;
  return old;
}
"""

# camera.cuh's three KB8 functions over arrays, for the host library
_CAMERA_PROBE = r"""
#include "cuda_runtime.h"
#include "camera.cuh"
extern "C" void kb8_probe(const float* p8, const float* xc, int n, float* uv, float* J, const float* pix, float* ray) {
  const cam::KB8 c = {p8[0], p8[1], p8[2], p8[3], p8[4], p8[5], p8[6], p8[7]};
  for (int i = 0; i < n; ++i) {
    cam::kb8_project(c, xc[3 * i], xc[3 * i + 1], xc[3 * i + 2], uv[2 * i], uv[2 * i + 1]);
    float Ji[2][3];
    cam::kb8_jac(c, xc[3 * i], xc[3 * i + 1], xc[3 * i + 2], Ji);
    for (int k = 0; k < 6; ++k) J[6 * i + k] = Ji[k / 3][k % 3];
    cam::kb8_unproject(c, pix[2 * i], pix[2 * i + 1], ray[2 * i], ray[2 * i + 1]);
  }
}
"""


@pytest.fixture(scope="module")
def host_kernels(tmp_path_factory):
    """The sources and the camera probe built into one host library, and
    _kernels.launch / require_cuda pointed at it for the module."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to compile the kernels' device code for the host")
    d = tmp_path_factory.mktemp("fisheye_kernels")
    (d / "cuda_runtime.h").write_text(_FISHEYE_STUB)
    units = {name[:-3]: _host_source((_kernels.SRC_DIR / name).read_text()) for name in SOURCES}
    # kernel D strides its edges by its full width (512), so its one CTA runs at that width
    units["pose_lm"] = units["pose_lm"].replace(f"{EMULATED_THREADS}u", "512u")
    units["camera_probe"] = _CAMERA_PROBE
    objs, procs = [], []
    for stem, text_ in units.items():
        cpp = d / (stem + ".cpp")
        cpp.write_text(text_)
        obj = d / (stem + ".o")
        procs.append(subprocess.Popen(["g++", "-std=c++20", "-O1", "-fPIC", "-pthread", f"-I{d}",
                                       f"-I{_kernels.SRC_DIR}", "-c", str(cpp), "-o", str(obj)],
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        objs.append(str(obj))
    for p in procs:
        out = p.communicate(timeout=600)[0]
        assert p.returncode == 0, out
    so = d / "libfisheye_host.so"
    subprocess.run(["g++", "-shared", "-pthread", "-o", str(so), *objs], check=True, capture_output=True, timeout=120)
    lib = ctypes.CDLL(str(so))
    for name, argtypes in _kernels.SIGNATURES.items():
        fn = getattr(lib, name, None)
        if fn is not None:
            fn.argtypes, fn.restype = argtypes, ctypes.c_int
    lib.kb8_probe.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 4

    def launch(name, device, *args):
        err = getattr(lib, name)(*args, None)
        assert err == 0, f"{name}: {err}"

    saved = _kernels.launch, _kernels.require_cuda
    _kernels.launch, _kernels.require_cuda = launch, lambda *a, **k: None
    yield lib
    _kernels.launch, _kernels.require_cuda = saved


def probe_points() -> np.ndarray:
    """Camera points on and near the optical axis, across the field of view
    and near its edge (theta up to ~100 deg, z < 0 included)."""
    rng = np.random.default_rng(0)
    theta = np.concatenate([[0.0, 1e-7, 1e-5, 1e-3], rng.uniform(0.0, 1.3, 60), rng.uniform(1.3, 1.75, 16)])
    phi = rng.uniform(-np.pi, np.pi, len(theta))
    depth = rng.uniform(0.5, 8.0, len(theta))
    xc = np.stack([np.sin(theta) * np.cos(phi), np.sin(theta) * np.sin(phi), np.cos(theta)], -1) * depth[:, None]
    return xc.astype(np.float32)


def test_camera_kb8_functions_match_plain(host_kernels):
    """camera.cuh's KB8 projection, closed-form Jacobian and Newton
    unprojection against models.project, the torch.func.jacfwd Jacobian and
    models.unproject, on and near the optical axis and out to ~100 deg:
    pixels within 1e-3 px, every Jacobian entry within 1e-4 of the largest
    of its row (the expression is the plain version's, EPS included, so the
    axis, where its r / r terms cancel, agrees too), the rays within 1e-5
    relative (theta < 90 deg, where tan is finite)."""
    xc = probe_points()
    n = len(xc)
    p8 = KB8.params.numpy().copy()
    uv_p = cm.project(KB8, torch.as_tensor(xc)).numpy()
    J_p = cm.project_jac(KB8, torch.as_tensor(xc)).numpy()
    pix = uv_p[xc[:, 2] > 0.05]
    ray_p = cm.unproject(KB8, torch.as_tensor(pix)).numpy()
    uv, J, ray = np.zeros((n, 2), np.float32), np.zeros((n, 2, 3), np.float32), np.zeros((n, 2), np.float32)
    pix_all = np.zeros((n, 2), np.float32)
    pix_all[: len(pix)] = pix
    host_kernels.kb8_probe(p8.ctypes.data, xc.ctypes.data, n, uv.ctypes.data, J.ctypes.data, pix_all.ctypes.data,
                           ray.ctypes.data)
    np.testing.assert_allclose(uv, uv_p, atol=1e-3)
    scale = np.abs(J_p).max(axis=-1, keepdims=True)
    assert np.all(np.abs(J - J_p) <= 1e-4 * scale), float((np.abs(J - J_p) / scale).max())
    np.testing.assert_allclose(ray[: len(pix)], ray_p[:, :2], rtol=1e-5, atol=1e-6)


def fisheye_keypoints():
    """The left and right keypoints (768 features) of frame 1 of
    tests/test_fisheye.py's corridor through the TUM-VI rig
    (chip_smoke.fisheye_frames), the port's extraction, and the rig's
    R_rl, t_rl."""
    import chip_smoke

    frames, _, _ = chip_smoke.fisheye_frames(2)
    s = chip_smoke.fisheye_settings("stereo")
    cfg = text.ExtractorConfig(n_features=768)
    kp_l, kp_r = (text.extract(torch.as_tensor(im), cfg) for im in frames[1])
    T = np.asarray(s.T_c1_c2, np.float64)
    R_rl = torch.as_tensor(T[:3, :3].T, dtype=torch.float32)
    t_rl = torch.as_tensor(-T[:3, :3].T @ T[:3, 3], dtype=torch.float32)
    return s, kp_l, kp_r, R_rl, t_rl, torch.as_tensor(text.level_sigma2(cfg), dtype=torch.float32)


def test_kernel_ab_matches_plain(host_kernels):
    """Kernel AB through its wrapper against fisheye_stereo_gate_plain on
    the same best-2: the float64 Jacobi DLT against the float32 SVD one, so
    at most 1% of the slots flip valid, each within 1e-3 relative of a cut
    it decides; where both accept, idx equal, depth and the point within
    1e-3 m; more than 100 slots accepted."""
    s, kp_l, kp_r, R_rl, t_rl, sigma2 = fisheye_keypoints()
    gate = tham.MutualGate(kp_l.valid.float(), kp_r.valid.float())
    b, col = tham.hamming_best2_plain(kp_l.desc, kp_r.desc, gate)
    tmat.fisheye_stereo_gate.launches.reset()
    k = tmat._fisheye_kernel(s.cam, s.cam2, kp_l, kp_r, b, col, R_rl, t_rl, sigma2, 0.7, tham.TH_HIGH, 0.9998)
    p = tmat.fisheye_stereo_gate_plain(s.cam, s.cam2, kp_l, kp_r, b, col, R_rl, t_rl, sigma2)
    assert tmat.fisheye_stereo_gate.launches.total() == 1
    assert int(p.valid.sum()) > 100
    both = k.valid & p.valid
    assert torch.equal(k.idx, p.idx)
    np.testing.assert_allclose(k.depth[both].numpy(), p.depth[both].numpy(), atol=1e-3)
    np.testing.assert_allclose(k.x3d[both].numpy(), p.x3d[both].numpy(), atol=1e-3)
    flipped = torch.nonzero(k.valid != p.valid).flatten()
    assert len(flipped) <= 0.01 * len(k.valid)
    margins = fisheye_margins(s, kp_l, kp_r, p, sigma2, R_rl, t_rl)
    assert all(float(margins[i]) < 1e-3 for i in flipped), margins[flipped]


def fisheye_margins(s, kp_l, kp_r, m, sigma2, R_rl, t_rl) -> torch.Tensor:
    """Per slot, the least relative distance of a float gate's value to its
    cut (parallax cosine, both depths, both chi2) at the plain version's
    point."""
    r1 = cm.unproject(s.cam, kp_l.xy)
    r2 = torch.einsum("ji,nj->ni", R_rl, cm.unproject(s.cam2, kp_r.xy)[m.idx])
    cos = (r1 * r2).sum(-1) / (r1.norm(dim=-1) * r2.norm(dim=-1))
    X = m.x3d
    xc2 = X @ R_rl.T + t_rl
    e1 = ((cm.project(s.cam, X) - kp_l.xy) ** 2).sum(-1) / (5.991 * sigma2[kp_l.level])
    e2 = ((cm.project(s.cam2, xc2) - kp_r.xy[m.idx]) ** 2).sum(-1) / (5.991 * sigma2[kp_r.level][m.idx])
    rel = [torch.abs(cos / 0.9998 - 1), torch.abs(X[:, 2] / 0.05 - 1), torch.abs(xc2[:, 2] / 0.05 - 1),
           torch.abs(e1 - 1), torch.abs(e2 - 1)]
    return torch.stack(rel).nan_to_num(nan=np.inf).min(0).values


def test_kernel_d_kb8_matches_plain(host_kernels):
    """Kernel D's KB8 instance against the plain version (jacfwd Jacobian)
    on 256 mono edges through the TUM-VI camera, 0.3 px noise, 10%
    outliers: rotation entries within 1e-4, translation within 1e-3, inlier
    counts within 2, counted as a KB8 launch."""
    rng = np.random.default_rng(3)
    n = 256
    T_gt = tlie.se3_exp(torch.tensor([0.1, -0.05, 0.1, 0.02, -0.01, 0.03]))
    xw = torch.as_tensor(np.stack([rng.uniform(-3, 3, n), rng.uniform(-2, 2, n), rng.uniform(1, 8, n)], -1),
                         dtype=torch.float32)
    uv = cm.project(KB8, T_gt.apply(xw)) + torch.as_tensor(rng.normal(0, 0.3, (n, 2)), dtype=torch.float32)
    uv[: n // 10] += 25.0
    obs = tpo.PoseObs(xw=xw, uv=torch.cat([uv, -torch.ones(n, 1)], 1).contiguous(),
                      inv_sigma2=torch.ones(n), is_stereo=torch.zeros(n, dtype=torch.bool),
                      valid=torch.ones(n, dtype=torch.bool))
    T0 = tlie.SE3.identity("cpu")
    tpo.pose_optimization.launches.reset()
    Tk, _, nk = tpo._kernel(KB8, 0.0, T0, obs, 4, 10)
    Tp, _, np_ = tpo.pose_optimization_plain(KB8, 0.0, T0, obs)
    assert tpo.pose_optimization.launches.total(camera="kb8") == 1
    np.testing.assert_allclose(Tk.R.numpy(), Tp.R.numpy(), atol=1e-4)
    np.testing.assert_allclose(Tk.t.numpy(), Tp.t.numpy(), atol=1e-3)
    assert abs(int(nk) - int(np_)) <= 2
    np.testing.assert_allclose(Tp.t.numpy(), T_gt.t.numpy(), atol=2e-2)


def test_kernel_e_kb8_matches_plain(host_kernels):
    """Kernel E's KB8 instance against the plain blocks on chip_smoke.py's
    local-BA problem with the TUM-VI camera's pixels (60% stereo rows):
    every block within 1e-4 of its largest entry (float64 sums of float32
    terms against float32 ones)."""
    import chip_smoke

    prob = chip_smoke.ba_problem(np.random.default_rng(5), "cpu", cam=KB8)
    inl = torch.ones_like(prob.obs_valid)
    tba.build_normal_blocks.launches.reset()
    bk = tba._blocks_kernel(KB8, 48.0, prob.R, prob.t, prob.xw, prob, inl)
    bp = tba.build_normal_blocks_plain(KB8, 48.0, prob.R, prob.t, prob.xw, prob, inl)
    assert tba.build_normal_blocks.launches.total(camera="kb8") == 1
    for x, y in zip((*bk[:4], tba.coupling_to_dense(bk[4], prob), *bk[5:]), bp):
        assert float((x - y).abs().max()) <= 1e-4 * max(float(y.abs().max()), 1e-12)


def test_kernel_l_kb8_matches_plain(host_kernels):
    """Kernel L's KB8 instance against the plain frustum test on 2048
    landmark slots around a 512x512 fisheye frame (some behind the camera
    and off the image): uv within 1e-3 px where z > 0.05, level and visible
    equal but for slots within 1e-4 px of the image border."""
    rng = np.random.default_rng(6)
    m = 2048
    pos = torch.as_tensor(np.stack([rng.uniform(-6, 6, m), rng.uniform(-6, 6, m), rng.uniform(-2, 10, m)], -1),
                          dtype=torch.float32)
    normal = torch.nn.functional.normalize(torch.as_tensor(rng.normal(size=(m, 3)), dtype=torch.float32) +
                                           torch.tensor([0.0, 0.0, 1.5]), dim=-1)
    dmin = torch.as_tensor(rng.uniform(0.2, 2.0, m), dtype=torch.float32)
    dmax = dmin * 8.0
    mask = torch.as_tensor(rng.uniform(size=m) < 0.9)
    T = tlie.se3_exp(torch.tensor([0.05, 0.02, -0.1, 0.01, 0.02, -0.01]))
    args = (KB8, T.R, T.t, pos, mask, normal, dmin, dmax, (512.0, 512.0))
    ttrk.visible_landmarks.launches.reset()
    uv_k, lvl_k, vis_k = ttrk._visible_kernel(*args, np.log(1.2), 8)
    uv_p, lvl_p, vis_p = ttrk.visible_landmarks_plain(*args)
    assert ttrk.visible_landmarks.launches.total(camera="kb8") == 1
    front = T.apply(pos)[:, 2] > 0.05
    np.testing.assert_allclose(uv_k[front].numpy(), uv_p[front].numpy(), atol=1e-3)
    border = ((uv_p.abs() < 1e-4) | ((uv_p - 512.0).abs() < 1e-4)).any(-1)
    assert torch.equal(vis_k[~border], vis_p[~border]) and int(vis_p.sum()) > 200
    assert torch.equal(lvl_k[front], lvl_p[front])


def test_kernel_p_kb8_matches_plain(host_kernels):
    """Kernel P's KB8 instance against the plain PnP RANSAC on
    chip_smoke.py's relocalisation problem seen through the TUM-VI camera
    (768 slots, 600 valid, 20% outliers), 64 subsets: the same inlier count
    and ok, the pose within 1e-3 of the plain one's, counted as a KB8
    launch."""
    import chip_smoke

    rng = np.random.default_rng(8)
    xw, uv, inv_s2, valid, R, t = chip_smoke.pnp_problem(rng)
    uv = torch.as_tensor(chip_smoke.kb8_pixels(KB8, uv))
    xw, inv_s2, valid = (torch.as_tensor(a) for a in (xw, inv_s2, valid))
    subsets = tpnp._sample_subsets(3, valid, 64)
    tpnp.pnp_ransac.launches.reset()
    k = tpnp._kernel(KB8, xw, uv, inv_s2, valid, subsets, 15)
    p = tpnp.pnp_ransac_plain(KB8, xw, uv, inv_s2, valid, subsets, 15)
    assert tpnp.pnp_ransac.launches.total(camera="kb8") == 1
    assert bool(k.ok) and bool(p.ok) and int(k.n_inliers) == int(p.n_inliers)
    np.testing.assert_allclose(k.R.numpy(), p.R.numpy(), atol=1e-3)
    np.testing.assert_allclose(k.t.numpy(), p.t.numpy(), atol=1e-3)
    np.testing.assert_allclose(p.t.numpy(), t, atol=5e-2)


@pytest.mark.parametrize("form", ["anchored", "last_frame"])
def test_kernel_w_kb8_matches_plain(host_kernels, form):
    """Kernel W's KB8 instance against its plain version on
    tests/test_torch_inertial.py's scenario seen through the TUM-VI camera
    (2 rounds of 4 iterations), at test_torch_vi_kernels_host.py's
    tolerances: rotation entries within 2e-4, positions within 2e-3 m,
    velocities within 5e-3 m/s, biases within 1e-3, at most 2 edges
    classified otherwise, H within 1e-3 of its largest entry."""
    import chip_smoke
    from tests.test_torch_vi_kernels_host import _w_problem

    _, T_cb, preint, s_prev, s0, obs = _w_problem(0 if form == "anchored" else 2)
    # the same rays through the TUM-VI camera, every edge monocular (a fisheye frame has no right-u)
    obs = obs._replace(uv=chip_smoke.kb8_mono(obs.uv, KB8), is_stereo=torch.zeros_like(obs.is_stereo))
    prior = None
    if form == "last_frame":
        prior = tinr.PriorState(state=s_prev._replace(p=s_prev.p + 0.01), H=torch.diag(torch.linspace(10.0, 1e3, 15)))
    last = form == "last_frame"
    tinr.pose_inertial_optimization.launches.reset()
    sk, ik, nk, Hk = tinr._launch(KB8, 0.0, T_cb, s_prev, prior, preint, s0, obs, last, 2, 4)
    assert tinr.pose_inertial_optimization.launches.total(camera="kb8") == 1
    if last:
        sp, ip, np_, Hp = tinr.pose_inertial_optimization_last_frame_plain(KB8, 0.0, T_cb, s_prev, prior, preint, s0,
                                                                            obs, 2, 4)
    else:
        sp, ip, np_, Hp = tinr.pose_inertial_optimization_plain(KB8, 0.0, T_cb, s_prev, preint, s0, obs, None, 2, 4)
    for a, b, tol in zip(sk, sp, (2e-4, 2e-3, 5e-3, 1e-3)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=tol)
    assert int((ik != ip).sum()) <= 2 and abs(int(nk) - int(np_)) <= 2
    np.testing.assert_allclose(Hk.numpy(), Hp.numpy(), atol=1e-3 * float(Hp.abs().max()))


def test_kernel_y_kb8_matches_plain(host_kernels):
    """Kernel Y's KB8 instance against the plain VI-BA (2 + 3 iterations)
    on tests/test_torch_vi_ba.py's tracker-shaped problem seen through the
    TUM-VI camera, every edge monocular: at
    test_torch_vi_kernels_host.py's tolerances (positions 2e-3 m, rotation
    entries 2e-4, velocities 1e-2 m/s, biases 1e-3, landmarks 1e-2 m, at
    most 1% of the observations classified otherwise)."""
    import chip_smoke
    from tests.test_torch_vi_ba import tracker_shaped

    prob, _ = tracker_shaped(np.random.default_rng(7))
    pt = convert.inertial_to_torch(prob)
    pt = pt._replace(obs_uv=chip_smoke.kb8_mono(pt.obs_uv, KB8), obs_is_stereo=torch.zeros_like(pt.obs_is_stereo))
    T_cb = tlie.SE3(tlie.so3_exp(torch.tensor([0.01, -0.02, 0.015])), torch.tensor([0.03, 0.0, -0.02]))
    tvb.vi_bundle_adjust.launches.reset()
    out_k = tvb._kernel(KB8, 0.0, T_cb, pt, 2, 3)
    out_p = tvb.vi_bundle_adjust_plain(KB8, 0.0, T_cb, pt, 2, 3)
    assert tvb.vi_bundle_adjust.launches.total(camera="kb8") == 1
    for name, tol, a, b in zip(("R", "p", "v", "bias", "xw"), (2e-4, 2e-3, 1e-2, 1e-3, 1e-2), out_k[:5], out_p[:5]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=tol, err_msg=name)
    assert float((out_k[5] != out_p[5]).float().mean()) <= 0.01
