"""Kernel M (csrc/twoview_ransac.cu) in every camera kind, its device code
compiled for the host with the harness of tests/test_torch_loop_kernels_host.py
(each CTA emulated with one std::thread per CUDA thread; a one-CTA launch at
most 64 threads, its loops striding by the block's width), against the plain
versions on the same inputs: its first stage (the unprojection of both views
and sigma^2) against ``_camera_plane`` in the pin-hole, radial-tangential and
KB8 instances; its last stage (the 12-motion verdict) bit for bit against
``_verdict`` on chip_smoke's crafted cases, which reach every branch, and on
the motions of a KB8 pair; and the whole kernel against ``reconstruct_plain``
on a 3-D and a planar pair seen through TUM-VI's cam0 and through EuRoC cam0's
distortion.  The card runs the same sources (tests/test_torch_kernels.py's
cuda cases, chip_smoke.py phase 3), where the first stage is bit for bit
the plain version's too: the host's own rounding of a division and of tan
differs from the card's by an ulp, so here it is held at 2e-6 (1 + |x|^2).
And the plain version (``reconstruct_plain``) on TUM-VI's cam0 against the
JAX package's ``reconstruct`` on its own samples: a 3-D pair (the F
branch), a planar pair (the H branch) and a pair under the parallax gate."""
import ctypes
import shutil
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from orb_slam3_fast_tpu.cameras import models as jcam
from orb_slam3_fast_tpu.ops import extractor as jext
from orb_slam3_fast_tpu.ops import matching as jmat
from orb_slam3_fast_tpu.ops import twoview as jtv
from orb_slam3_fast_tpu.slam.settings import Settings as JSettings
from orb_slam3_fast_tpu_torch import _kernels
from orb_slam3_fast_tpu_torch.cameras import models as cm
from orb_slam3_fast_tpu_torch.ops import twoview
from tests.test_torch_fisheye_kernels_host import _FISHEYE_STUB, KB8
from tests.test_torch_loop_kernels_host import _host_source
from tests.test_torch_twoview import jax_samples

torch.set_num_threads(1)

PINHOLE = cm.Camera.pinhole(400.0, 400.0, 320.0, 240.0)
RADTAN = cm.Camera.pinhole(400.0, 400.0, 320.0, 240.0, chip_smoke.EUROC_DIST)
CAMERAS = {"pinhole": (PINHOLE, (640, 480)), "radtan": (RADTAN, (640, 480)), "kb8": (KB8, (512, 512))}
INSTANCE = {"pinhole": "", "radtan": "radtan", "kb8": "kb8"}  # the launch counters' camera instances
N_HYP = 48  # hypotheses of the whole-kernel cases: every one of them is a CTA of 256 emulated threads

_STUB = _FISHEYE_STUB + r"""
inline float __fsqrt_rn(float x) { return std::sqrt(x); }
struct float2 { float x, y; };
inline float2 make_float2(float x, float y) { return {x, y}; }
"""


@pytest.fixture(scope="module")
def host_kernel(tmp_path_factory):
    """csrc/twoview_ransac.cu built for the host, and _kernels.launch /
    require_cuda pointed at it for the module."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to compile the kernels' device code for the host")
    d = tmp_path_factory.mktemp("twoview_kernel")
    (d / "cuda_runtime.h").write_text(_STUB)
    cpp = d / "twoview_ransac.cpp"
    cpp.write_text(_host_source((_kernels.SRC_DIR / "twoview_ransac.cu").read_text()))
    so = d / "libtwoview_host.so"
    out = subprocess.run(["g++", "-std=c++20", "-O1", "-fPIC", "-shared", "-pthread", f"-I{d}",
                          f"-I{_kernels.SRC_DIR}", str(cpp), "-o", str(so)], capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stdout + out.stderr
    lib = ctypes.CDLL(str(so))
    for name in ("twoview_ransac_launch", "twoview_unproject_launch", "twoview_verdict_launch"):
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = _kernels.SIGNATURES[name], ctypes.c_int

    def launch(name, device, *args):
        err = getattr(lib, name)(*args, None)
        assert err == 0, f"{name}: {err}"

    saved = _kernels.launch, _kernels.require_cuda
    _kernels.launch, _kernels.require_cuda = launch, lambda *a, **k: None
    yield lib
    _kernels.launch, _kernels.require_cuda = saved


@pytest.mark.parametrize("kind", sorted(CAMERAS))
def test_unprojection_matches_plain(host_kernel, kind):
    """The first stage in each camera kind against ``_camera_plane``: both
    views within 2e-6 (1 + |x|^2) of the plain points x (the derivative of
    tan at the ray's angle: near the KB8 image's corners the ray lies ~89
    degrees off the axis, |x| ~ 58, where an ulp of the angle moves x by
    3e3 ulps), sigma^2 the plain one rounded to float32; the launch counted
    in its camera instance."""
    cam, wh = CAMERAS[kind]
    rng = np.random.default_rng(1)
    uv0, uv1 = chip_smoke.image_pixels(rng, cam, wh, 300), chip_smoke.image_pixels(rng, cam, wh, 300)
    before = twoview.unproject_pair.launches.total(camera=INSTANCE[kind])
    x0, x1, s2 = twoview._unproject_kernel(cam, uv0, uv1)
    p0, p1, ps2 = twoview._camera_plane(cam, uv0, uv1)
    for k, p in ((x0, p0), (x1, p1)):
        assert bool(((k - p).abs() <= 2e-6 * (1.0 + p.square().sum(1, keepdim=True))).all())
    assert float(s2) == float(np.float32(ps2))
    assert twoview.unproject_pair.launches.total(camera=INSTANCE[kind]) == before + 1


@pytest.mark.parametrize("label", sorted(chip_smoke.VERDICT_CASES))
def test_verdict_matches_plain_on_crafted_cases(host_kernel, label):
    """The last stage against ``_verdict`` bit for bit on each crafted case
    (success, used_h, the chosen motion's R, t, points and flags), and the
    verdict the case was built to reach."""
    args, (success, used_h, best) = chip_smoke.verdict_cases("cpu")[label]
    rk = twoview._verdict_kernel(*args, chip_smoke.VERDICT_MIN_TRI, 1.0)
    rp = twoview._verdict(*args, chip_smoke.VERDICT_MIN_TRI, 1.0)
    assert chip_smoke.verdicts_equal(rk, rp)
    assert (bool(rk.success), bool(rk.used_h)) == (success, used_h) and torch.equal(rk.R, args[0][best])


@pytest.mark.parametrize("kind, planar", [("kb8", False), ("kb8", True), ("radtan", False)])
def test_kernel_matches_plain(host_kernel, kind, planar):
    """The whole kernel against ``reconstruct_plain`` on the same samples
    (phase 3's tolerances: success and used_h equal, R within 1e-3 rad, t's
    direction within 1e-3, good equal on >= 99%, X within 1e-3 relative
    where both good), its verdict bit for bit ``_verdict`` on the plain
    motions, and the launch counted in its camera instance.  Each
    hypothesis draws 8 distinct matches (``chip_smoke.distinct_hypotheses``:
    a repeated match leaves the 8-point system a plane of null vectors)."""
    cam, _ = CAMERAS[kind]
    uv0, uv1, valid = chip_smoke.two_view_scene(np.random.default_rng(5), cam, planar)
    samples = chip_smoke.distinct_hypotheses(3, valid, N_HYP)
    before = twoview.reconstruct.launches.total(camera=INSTANCE[kind])
    rk = twoview._kernel(cam, uv0, uv1, valid, samples, 50, 1.0)
    assert twoview.reconstruct.launches.total(camera=INSTANCE[kind]) == before + 1
    motions = twoview.motions_plain(cam, uv0, uv1, valid, samples)
    rp = twoview._verdict(*motions, 50, 1.0)
    assert bool(rp.success) and bool(rp.used_h) == planar
    assert bool(rk.success) == bool(rp.success) and bool(rk.used_h) == bool(rp.used_h)
    assert chip_smoke.rot_angle(rk.R, rp.R) <= 1e-3 and 1.0 - abs(float(torch.dot(rk.t, rp.t))) <= 1e-3
    assert float((rk.good == rp.good).float().mean()) >= 0.99
    both = rk.good & rp.good
    assert float(((rk.X - rp.X).norm(dim=1) / rp.X.norm(dim=1))[both].max()) <= 1e-3
    assert chip_smoke.verdicts_equal(twoview._verdict_kernel(*motions, 50, 1.0), rp)


# --- the plain version on TUM-VI's cam0 against the JAX package ---------------------------------------------------


def kb8_two_view_case(name):
    """(uv0, uv1, valid) numpy through TUM-VI's cam0: phase 15 (a)'s corridor
    frames 0 and 1 (the pair the mono System initialises on) extracted and
    matched by the JAX package's search_for_initialization, a 3-D scene
    (the F branch); chip_smoke's planar pair seen through cam0 (the H
    branch); or a pair 20-40 m ahead 2 cm apart, whose parallax stays under
    the 1 degree gate (no model succeeds)."""
    if name == "corridor":
        pairs, _, _ = chip_smoke.fisheye_frames(2)
        s = JSettings.from_yaml(chip_smoke.FISHEYE_CONFIG, "monocular")
        cfg = jext.ExtractorConfig(n_features=s.n_features, n_levels=s.n_levels, scale_factor=s.scale_factor,
                                   ini_th_fast=s.ini_th_fast, min_th_fast=s.min_th_fast)
        kp0, kp1 = (jext.extract(jnp.asarray(pairs[i][0], jnp.float32), cfg) for i in (0, 1))
        idx, acc = jmat.search_for_initialization(kp0, kp1, 100.0)
        return np.asarray(kp0.xy), np.asarray(kp1.xy)[np.asarray(idx)], np.asarray(acc)
    if name == "plane":
        uv0, uv1, valid = chip_smoke.planar_matches(np.random.default_rng(7), n=512, n_valid=300)
        return (chip_smoke.kb8_pixels(KB8, uv0).astype(np.float32), chip_smoke.kb8_pixels(KB8, uv1).astype(np.float32),
                valid)
    rng = np.random.default_rng(11)
    X = np.stack([rng.uniform(-8, 8, 400), rng.uniform(-6, 6, 400), rng.uniform(20, 40, 400)], -1)
    X1 = X + [0.02, 0.0, 0.005]
    uv = [cm.project(KB8, torch.as_tensor(Y, dtype=torch.float32)).numpy() + rng.normal(0, 0.3, (400, 2))
          for Y in (X, X1)]
    return uv[0].astype(np.float32), uv[1].astype(np.float32), np.arange(400) < 300


@pytest.mark.parametrize("name, success, used_h", [("corridor", True, False), ("plane", True, True),
                                                   ("low parallax", False, None)])
def test_reconstruct_plain_on_kb8_matches_jax(name, success, used_h):
    """reconstruct_plain on TUM-VI's cam0 and the JAX package's samples
    against the JAX package's reconstruct: success, used_h and good equal
    (the JAX verdict's branch: F, H, or no model over the parallax gate),
    and where it succeeds R within 1e-3 rad, t's direction within 1e-3, X
    within 1e-3 relative where good."""
    uv0, uv1, valid = kb8_two_view_case(name)
    key = jax.random.PRNGKey(250)
    jcam_kb8 = jcam.Camera.kb8(*KB8.params.tolist())
    rj = jtv.reconstruct(jcam_kb8, jnp.asarray(uv0), jnp.asarray(uv1), jnp.asarray(valid), key)
    rt = twoview.reconstruct_plain(KB8, torch.as_tensor(uv0), torch.as_tensor(uv1), torch.as_tensor(valid),
                                   jax_samples(key, valid))
    assert bool(rt.success) == bool(rj.success) == success
    assert bool(rt.used_h) == bool(rj.used_h) and (used_h is None or bool(rj.used_h) == used_h)
    np.testing.assert_array_equal(rt.good.numpy(), np.asarray(rj.good))
    if success:
        assert chip_smoke.rot_angle(rt.R.numpy(), rj.R) <= 1e-3
        assert 1.0 - abs(float(np.dot(rt.t.numpy(), np.asarray(rj.t)))) <= 1e-3
        good, X_j = np.asarray(rj.good), np.asarray(rj.X)
        assert good.sum() >= 50
        assert (np.linalg.norm(rt.X.numpy() - X_j, axis=1) / np.linalg.norm(X_j, axis=1))[good].max() <= 1e-3
