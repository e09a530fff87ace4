"""Parity of the port's geometry with the JAX package: Lie group, camera
models, the closed-form projection Jacobian, the state converters, and the
port's independence from JAX."""
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam3_fast_tpu.cameras import models as jcam
from orb_slam3_fast_tpu.utils import lie as jlie
from orb_slam3_fast_tpu_torch.cameras import models as tcam
from orb_slam3_fast_tpu_torch.frontend.tracker import LocalMap
from orb_slam3_fast_tpu_torch.ops import hamming as tham
from orb_slam3_fast_tpu_torch.utils import convert
from orb_slam3_fast_tpu_torch.utils import lie as tlie

torch.set_num_threads(1)

# float32 elementwise math in two libraries: a few ulp at unit scale
F32_TOL = 2e-6

PINHOLE = (458.654, 457.296, 367.215, 248.375, (-0.28340811, 0.07395907, 0.00019359, 1.76187114e-05, 0.0))
KB8 = (190.978477, 190.973307, 254.931706, 256.897442, 0.003482389402, 0.000715034845, -0.002053236141, 0.000202936736)


def _cams(kind):
    if kind == "pinhole":
        return jcam.Camera.pinhole(*PINHOLE[:4], dist=PINHOLE[4]), tcam.Camera.pinhole(*PINHOLE[:4], dist=PINHOLE[4])
    if kind == "pinhole0":
        return jcam.Camera.pinhole(*PINHOLE[:4]), tcam.Camera.pinhole(*PINHOLE[:4])
    return jcam.Camera.kb8(*KB8), tcam.Camera.kb8(*KB8)


def _points(rng, n=64):
    z = rng.uniform(0.5, 10.0, n)
    return np.stack([rng.uniform(-0.6, 0.6, n) * z, rng.uniform(-0.6, 0.6, n) * z, z], -1).astype(np.float32)


@pytest.mark.parametrize("scale", [1e-5, 0.3, 2.5])
def test_so3_se3_exp_match(rng, scale):
    xi = (rng.normal(size=(32, 6)) * scale).astype(np.float32)
    R_j = np.asarray(jlie.so3_exp(jnp.asarray(xi[:, 3:])))
    R_t = tlie.so3_exp(torch.as_tensor(xi[:, 3:])).numpy()
    np.testing.assert_allclose(R_t, R_j, atol=F32_TOL)
    T_j = jlie.se3_exp(jnp.asarray(xi))
    T_t = tlie.se3_exp(torch.as_tensor(xi))
    np.testing.assert_allclose(T_t.R.numpy(), np.asarray(T_j.R), atol=F32_TOL)
    np.testing.assert_allclose(T_t.t.numpy(), np.asarray(T_j.t), atol=F32_TOL * max(scale, 1.0) * 4)


def test_se3_compose_inverse_apply(rng):
    xi = (rng.normal(size=(2, 6)) * 0.5).astype(np.float32)
    x = rng.normal(size=(16, 3)).astype(np.float32)
    A_j, B_j = jlie.se3_exp(jnp.asarray(xi[0])), jlie.se3_exp(jnp.asarray(xi[1]))
    A_t, B_t = tlie.se3_exp(torch.as_tensor(xi[0])), tlie.se3_exp(torch.as_tensor(xi[1]))
    C_j, C_t = A_j.compose(B_j.inverse()), A_t.compose(B_t.inverse())
    np.testing.assert_allclose(C_t.R.numpy(), np.asarray(C_j.R), atol=1e-5)
    np.testing.assert_allclose(C_t.t.numpy(), np.asarray(C_j.t), atol=1e-5)
    np.testing.assert_allclose(
        C_t.apply(torch.as_tensor(x)).numpy(), np.asarray(C_j.apply(jnp.asarray(x))), atol=1e-5
    )
    I_t = tlie.SE3.identity("cpu")
    np.testing.assert_array_equal(I_t.R.numpy(), np.eye(3, dtype=np.float32))
    # the host SO(3) projection is the same numpy code
    R = np.asarray(C_j.R) + 1e-3 * rng.normal(size=(3, 3)).astype(np.float32)
    np.testing.assert_array_equal(tlie.normalize_rotation_np(R), jlie.normalize_rotation_np(R))


@pytest.mark.parametrize("kind", ["pinhole", "pinhole0", "kb8"])
def test_project_and_stereo_project(rng, kind):
    jc, tc = _cams(kind)
    x = _points(rng)
    uv_j = np.asarray(jcam.project(jc, jnp.asarray(x)))
    uv_t = tcam.project(tc, torch.as_tensor(x)).numpy()
    # pixel coordinates of a few hundred: relative float32 precision
    np.testing.assert_allclose(uv_t, uv_j, rtol=1e-5, atol=1e-3)
    s_j = np.asarray(jcam.stereo_project(jc, jnp.asarray(x), 40.0))
    s_t = tcam.stereo_project(tc, torch.as_tensor(x), 40.0).numpy()
    np.testing.assert_allclose(s_t, s_j, rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("kind", ["pinhole", "pinhole0", "kb8"])
def test_project_jac_closed_form_matches_ad(rng, kind):
    """Closed-form pin-hole Jacobian against torch.func.jacfwd and the JAX
    package's jax.jacfwd; same tolerance (relative float32, Jacobian entries
    up to ~1e3)."""
    jc, tc = _cams(kind)
    x = _points(rng)
    J_t = tcam.project_jac(tc, torch.as_tensor(x)).numpy()
    J_ad = torch.func.vmap(torch.func.jacfwd(lambda v: tcam.project(tc, v)))(torch.as_tensor(x)).numpy()
    J_j = np.asarray(jcam.project_jac(jc, jnp.asarray(x)))
    np.testing.assert_allclose(J_t, J_ad, rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(J_t, J_j, rtol=1e-4, atol=1e-3)
    Js_t = tcam.stereo_project_jac(tc, torch.as_tensor(x), 40.0).numpy()
    Js_j = np.asarray(
        jax.vmap(jax.jacfwd(lambda v: jcam.stereo_project(jc, v, jnp.float32(40.0))))(jnp.asarray(x))
    )
    np.testing.assert_allclose(Js_t, Js_j, rtol=1e-4, atol=1e-3)


def test_pack_unpack_desc_round_trip(rng):
    bits = rng.integers(0, 2, (37, 256)).astype(np.int8)
    bits[0] = 1  # every sign bit set
    words = tham.pack_desc(torch.as_tensor(bits))
    assert words.dtype == torch.int32 and words.shape == (37, 8)
    np.testing.assert_array_equal(tham.unpack_desc(words).numpy(), bits)
    # bit k lives in word k // 32 at bit k % 32
    k = 77
    one = np.zeros((1, 256), np.int8)
    one[0, k] = 1
    w = tham.pack_desc(torch.as_tensor(one)).numpy()[0]
    assert w[k // 32] == 1 << (k % 32) and np.count_nonzero(w) == 1


def test_convert_round_trips(rng):
    kind, params = "pinhole", np.asarray(jcam.Camera.pinhole(*PINHOLE[:4], dist=PINHOLE[4]).params)
    cam = convert.camera_to_torch(kind, params)
    k2, p2 = convert.camera_to_numpy(cam)
    assert k2 == kind
    np.testing.assert_array_equal(p2, params)

    n = 20
    kp_np = {
        "xy": rng.uniform(0, 600, (n, 2)).astype(np.float32),
        "level": rng.integers(0, 8, n).astype(np.int32),
        "angle": rng.uniform(-3, 3, n).astype(np.float32),
        "response": rng.uniform(0, 100, n).astype(np.float32),
        "desc": rng.integers(0, 2, (n, 256)).astype(np.int8),
        "valid": rng.uniform(size=n) > 0.3,
    }
    kp = convert.keypoints_to_torch(**kp_np, device="cpu")
    assert kp.desc.shape == (n, 8)
    back = convert.keypoints_to_numpy(kp)
    for key, val in kp_np.items():
        np.testing.assert_array_equal(back[key], val)

    m = 16
    lm_np = {
        "lm_pos": rng.normal(size=(m, 3)).astype(np.float32),
        "lm_desc": rng.integers(0, 2, (m, 256)).astype(np.int8),
        "lm_normal": rng.normal(size=(m, 3)).astype(np.float32),
        "lm_dmin": rng.uniform(1, 2, m).astype(np.float32),
        "lm_dmax": rng.uniform(3, 9, m).astype(np.float32),
        "lm_mask": rng.uniform(size=m) > 0.5,
    }
    lm = convert.local_map_to_torch(**lm_np, device="cpu")
    assert isinstance(lm, LocalMap)
    back = convert.local_map_to_numpy(lm)
    for key, val in lm_np.items():
        np.testing.assert_array_equal(back[key], val)

    R = np.asarray(jlie.so3_exp(jnp.asarray([0.1, -0.2, 0.3], jnp.float32)))
    t = np.array([1.0, 2.0, 3.0], np.float32)
    R2, t2 = convert.se3_to_numpy(convert.se3_to_torch(R, t, "cpu"))
    np.testing.assert_array_equal(R2, R)
    np.testing.assert_array_equal(t2, t)


def test_port_never_imports_jax():
    """Every module of the port imports, and a config loads, without jax,
    the JAX package or pyyaml."""
    code = (
        "import importlib, pkgutil, sys, orb_slam3_fast_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, 'orb_slam3_fast_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "from orb_slam3_fast_tpu_torch.slam.settings import Settings\n"
        "Settings.from_yaml('configs/synthetic_stereo.yaml', 'stereo')\n"
        "import torch\n"
        "assert 'orb_slam3_fast_tpu_torch.slam.system' in sys.modules\n"
        "assert 'jax' not in sys.modules, 'jax imported'\n"
        "assert 'yaml' not in sys.modules, 'yaml imported'\n"
        "assert 'orb_slam3_fast_tpu' not in sys.modules\n"
        "assert torch.backends.cuda.matmul.allow_tf32 is False\n"
        "assert torch.backends.cudnn.allow_tf32 is False\n"
    )
    repo = Path(__file__).resolve().parents[1]
    res = subprocess.run([sys.executable, "-c", code], cwd=repo, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_unproject_K_and_quaternions_match_jax():
    """cameras.unproject (pin-hole with and without rad-tan, KB8), Camera.K,
    lie.rotation_to_quaternion and lie.so3_log against the JAX package."""
    rng = np.random.default_rng(5)
    uv = np.stack([rng.uniform(0, 640, 200), rng.uniform(0, 480, 200)], -1).astype(np.float32)
    cams = [
        ((400.0, 410.0, 320.0, 240.0), (0.0,) * 5, "pinhole"),
        ((458.654, 457.296, 367.215, 248.375), (-0.2834, 0.07396, 1.9e-4, 1.8e-5, 0.0), "pinhole"),
        ((190.98, 190.97, 254.93, 256.90), (0.00348, 0.000715, -0.00205, 0.000203), "kb8"),
    ]
    for (fx, fy, cx, cy), d, kind in cams:
        jc = jcam.Camera.pinhole(fx, fy, cx, cy, d) if kind == "pinhole" else jcam.Camera.kb8(fx, fy, cx, cy, *d)
        tc = tcam.Camera.pinhole(fx, fy, cx, cy, d) if kind == "pinhole" else tcam.Camera.kb8(fx, fy, cx, cy, *d)
        np.testing.assert_allclose(
            tcam.unproject(tc, torch.as_tensor(uv)).numpy(), np.asarray(jcam.unproject(jc, jnp.asarray(uv))),
            rtol=1e-5, atol=1e-6,
        )
        np.testing.assert_array_equal(tc.K().numpy(), np.asarray(jc.K()))
    w = rng.normal(0, 1.0, (300, 3)).astype(np.float32)
    w[:20] *= 1e-7  # near identity
    w[20:40] *= 3.1 / np.linalg.norm(w[20:40], axis=1, keepdims=True)  # near pi
    R = np.array(jlie.so3_exp(jnp.asarray(w)))
    np.testing.assert_allclose(
        tlie.rotation_to_quaternion(torch.as_tensor(R)).numpy(), np.asarray(jlie.rotation_to_quaternion(jnp.asarray(R))),
        atol=2e-6,
    )
    np.testing.assert_allclose(tlie.so3_log(torch.as_tensor(R)).numpy(), np.asarray(jlie.so3_log(jnp.asarray(R))),
                               atol=1e-5)
