"""Kernel AC (csrc/ba_lm.cu) and kernel E (csrc/ba_blocks.cu) compiled for
the host through the emulated-CTA harness of
tests/test_torch_fisheye_kernels_host.py (one std::thread per CUDA thread;
a launch of several CTAs runs them one after another), every CTA here at
the kernels' full width of 256 threads, since E and AC's cost launch map
one thread to one observation.  Through their wrappers' marshalling, at a
small size (K 4, M 64, O 256) in the pin-hole, radial-tangential and KB8
instances, both of AC's entries are held against their plain versions:
the state within 1e-5, the accept and the damping equal, the inlier masks
equal; and a zero step's cost equals emulated E's cost bit for bit.  The
LM loops of both BA forms run on the emulated E and AC with every plain
LM function made to raise.  The card runs the same sources
(tests/test_torch_kernels.py's cuda cases, chip_smoke.py phase 3)."""
import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

import chip_smoke
from orb_slam3_fast_tpu_torch import _kernels
from orb_slam3_fast_tpu_torch.cameras import models as cm
from orb_slam3_fast_tpu_torch.optim import ba as tba
from orb_slam3_fast_tpu_torch.optim import ba_cg as tcg
from tests.test_torch_fisheye_kernels_host import _FISHEYE_STUB, KB8
from tests.test_torch_loop_kernels_host import _host_source
from tests.test_torch_vi_kernels_host import EMULATED_THREADS

torch.set_num_threads(1)

SOURCES = ("ba_blocks.cu", "ba_lm.cu")
K, M, OBS_PER_LM, BF = 4, 64, 4, 48.0
CAMERAS = {"pinhole": cm.Camera.pinhole(400.0, 400.0, 320.0, 240.0),
           "radtan": cm.Camera.pinhole(400.0, 400.0, 320.0, 240.0, chip_smoke.EUROC_DIST), "kb8": KB8}


@pytest.fixture(scope="module")
def host_kernels(tmp_path_factory):
    """Both sources built into one host library, and _kernels.launch /
    require_cuda pointed at it for the module."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to compile the kernels' device code for the host")
    d = tmp_path_factory.mktemp("ba_lm_kernels")
    (d / "cuda_runtime.h").write_text(_FISHEYE_STUB)
    objs, procs = [], []
    for name in SOURCES:
        cpp = d / (name[:-3] + ".cpp")
        cpp.write_text(_host_source((_kernels.SRC_DIR / name).read_text()).replace(f"{EMULATED_THREADS}u", "256u"))
        obj = d / (name[:-3] + ".o")
        procs.append(subprocess.Popen(["g++", "-std=c++20", "-O1", "-fPIC", "-pthread", f"-I{d}",
                                       f"-I{_kernels.SRC_DIR}", "-c", str(cpp), "-o", str(obj)],
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        objs.append(str(obj))
    for p in procs:
        out = p.communicate(timeout=600)[0]
        assert p.returncode == 0, out
    so = d / "libba_lm_host.so"
    subprocess.run(["g++", "-shared", "-pthread", "-o", str(so), *objs], check=True, capture_output=True, timeout=120)
    lib = ctypes.CDLL(str(so))
    for name, argtypes in _kernels.SIGNATURES.items():
        fn = getattr(lib, name, None)
        if fn is not None:
            fn.argtypes, fn.restype = argtypes, ctypes.c_int

    def launch(name, device, *args):
        err = getattr(lib, name)(*args, None)
        assert err == 0, f"{name}: {err}"

    saved = _kernels.launch, _kernels.require_cuda
    _kernels.launch, _kernels.require_cuda = launch, lambda *a, **k: None
    yield lib
    _kernels.launch, _kernels.require_cuda = saved


def small_problem(cam, seed=0):
    """chip_smoke.ba_problem's scene at K 4 (poses 1 and 2 free, 0 fixed, 3
    padding), M 64, O 256: every landmark seen from 4 random real poses,
    the pixels through ``cam``, 60% stereo rows, 10% outliers, 0.5 px of
    noise, the free poses and the landmarks perturbed."""
    from orb_slam3_fast_tpu_torch.utils import lie

    rng = np.random.default_rng(seed)
    R = np.tile(np.eye(3, dtype=np.float32), (K, 1, 1))
    t = np.zeros((K, 3), np.float32)
    for k in range(3):
        T = lie.se3_exp(torch.tensor([0.1 * k, 0.0, 0.2 * k, 0.0, 0.01 * k, 0.0])).inverse()
        R[k], t[k] = T.R.numpy(), T.t.numpy()
    X = np.stack([rng.uniform(-3, 3, M), rng.uniform(-2, 2, M), rng.uniform(4, 12, M)], -1).astype(np.float32)
    lm = np.repeat(np.arange(M), OBS_PER_LM).astype(np.int32)
    kf = rng.integers(0, 3, len(lm)).astype(np.int32)
    xc = np.einsum("oij,oj->oi", R[kf], X[lm]) + t[kf]
    uv = cm.stereo_project(cam, torch.as_tensor(xc.astype(np.float32)), BF).numpy().astype(np.float64)
    uv += rng.normal(0, 0.5, uv.shape)
    out = rng.uniform(size=len(lm)) < 0.1
    uv[out, :2] += rng.uniform(15, 40, (out.sum(), 2)) * rng.choice([-1, 1], (out.sum(), 2))
    stereo = rng.uniform(size=len(lm)) < 0.6
    uv[~stereo, 2] = -1.0
    pose_fixed = np.array([True, False, False, True])
    t0 = t.copy()
    t0[1:3] += rng.normal(0, 0.02, (2, 3)).astype(np.float32)
    return tba.make_problem(R, t0, pose_fixed, X + rng.normal(0, 0.05, X.shape).astype(np.float32),
                            np.arange(M) != 5, kf, lm, uv.astype(np.float32),
                            (1.0 / 1.44 ** rng.integers(0, 4, len(lm))).astype(np.float32), stereo,
                            np.arange(len(lm)) < len(lm) - 7, device="cpu")


def step_of(cam, prob, inl, lam):
    """Emulated kernel E's blocks at the problem's state, and the plain
    Schur step from them at damping ``lam``."""
    blocks = tba._blocks_kernel(cam, BF, prob.R, prob.t, prob.xw, prob, inl)
    Z = tba.coupling_to_dense(blocks[4], prob)
    dp, dl, _ = tba._solve_plain(*blocks[:4], Z, blocks[5], prob, lam)
    return blocks, dp, dl


@pytest.mark.parametrize("camera", list(CAMERAS))
def test_lm_update_matches_plain(host_kernels, camera):
    """Entry 1 against lm_update_plain from the same state, cost and step:
    the Schur step (accepted), three times it (rejected), it with F's flag
    cleared (rejected), and in the global BA's form with no flag; the state
    within 1e-5, a rejected step's state the input bit for bit, accept and
    damping equal, the cost within 1e-5 relative; and a zero step rejected
    with AC's cost equal to emulated E's bit for bit.  Counted as launches
    of the camera's instance."""
    cam = CAMERAS[camera]
    prob = small_problem(cam)
    inl = torch.ones_like(prob.obs_valid)
    inl[::13] = False
    lam = torch.tensor(1e-2)  # at 1e-4 the first full step of this small scene raises the cost
    blocks, dp, dl = step_of(cam, prob, inl, lam)
    cost_old = blocks[6]
    state = (prob.R, prob.t, prob.xw)
    yes, no = torch.tensor(True), torch.tensor(False)
    name = "" if camera == "pinhole" else camera  # the launch counter's camera instance
    n0 = tba.lm_update.launches.total(camera=name)
    cases = [("step", dp, dl, yes, True), ("3 steps", 3 * dp, 3 * dl, yes, False), ("failed", dp, dl, no, False),
             ("no flag", dp, dl, None, True)]
    for label, dp_, dl_, ok, accepted in cases:
        k = tba._lm_update_kernel(cam, BF, prob, *state, dp_, dl_, inl, cost_old, ok, lam)
        p = tba.lm_update_plain(cam, BF, prob, *state, dp_, dl_, inl, cost_old, ok, lam)
        for a, b in zip(k[:3], p[:3]):
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5, err_msg=label)
        assert bool(k[4]) == bool(p[4]) == accepted, label
        assert float(k[3]) == float(p[3]), label
        assert float(k[5]) == pytest.approx(float(p[5]), rel=1e-5), label
        if not accepted:
            assert all(torch.equal(a, b) for a, b in zip(k[:3], state)), label
    zero = tba._lm_update_kernel(cam, BF, prob, *state, torch.zeros_like(dp), torch.zeros_like(dl), inl, cost_old, yes,
                                 lam)
    assert not bool(zero[4]) and float(zero[5]) == float(cost_old)
    assert float(zero[3]) == float(np.float32(1e-2) * np.float32(5.0))
    assert tba.lm_update.launches.total(camera=name) == n0 + len(cases) + 1


@pytest.mark.parametrize("camera", list(CAMERAS))
def test_classify_matches_plain(host_kernels, camera):
    """Entry 2 against classify_plain at a perturbed state: the masks equal
    (no chi2 within 1e-4 of its bound), some observations out."""
    cam = CAMERAS[camera]
    prob = small_problem(cam, seed=1)
    xw = prob.xw + 0.02 * torch.sin(torch.arange(prob.xw.numel(), dtype=torch.float32)).view(-1, 3)
    k = tba._classify_kernel(cam, BF, prob, prob.R, prob.t, xw)
    p = tba.classify_plain(cam, BF, prob, prob.R, prob.t, xw)
    r, _, _ = tba._obs_residuals(cam, BF, prob.R, prob.t, xw, prob)
    ratio = (r * r).sum(-1) * prob.obs_inv_sigma2 / tba._delta2(prob)
    assert not bool(((ratio - 1).abs() < 1e-4).any())
    assert 0 < int(p.sum()) < int(prob.obs_valid.sum())
    assert torch.equal(k, p)


def test_lm_loops_run_on_the_kernels(host_kernels, monkeypatch):
    """Both BA forms' loops (2 + 2 iterations) on emulated E and AC, their
    steps from the plain solvers, with every plain function of the LM
    iteration and the gate made to raise: they run, launch AC once an
    iteration and twice for the gate, and land where bundle_adjust_plain
    and bundle_adjust_cg_plain land: poses within 1e-4, at most one inlier
    flag of 256 otherwise."""
    cam = CAMERAS["pinhole"]
    prob = small_problem(cam, seed=2)

    def dense(Hpp, Hll, bp, bl, W, w_lm, prob_, lam):
        return tba._solve_plain(Hpp, Hll, bp, bl, tba.coupling_to_dense(W, prob_), w_lm, prob_, lam)

    def refuse(*args, **kwargs):
        raise AssertionError("a plain LM function was called")

    n0, c0 = tba.lm_update.launches.total(), tba.classify.launches.total()
    with monkeypatch.context() as m:
        for name in ("lm_update_plain", "classify_plain", "apply_update", "_obs_residuals", "_robust_cost"):
            m.setattr(tba, name, refuse)
        local = tba._bundle_adjust(cam, BF, prob, 2, 2, tba._blocks_kernel, dense, tba._lm_update_kernel,
                                   tba._classify_kernel)
        glob = tcg._bundle_adjust_cg(cam, BF, prob, 2, 2, 16, 5, None, tba._blocks_kernel, tcg._solve_plain,
                                     tba._lm_update_kernel, tba._classify_kernel)
    assert tba.lm_update.launches.total() == n0 + 8 and tba.classify.launches.total() == c0 + 4
    p_local = tba.bundle_adjust_plain(cam, BF, prob, 2, 2)
    p_glob = tcg.bundle_adjust_cg_plain(cam, BF, prob, 2, 2, 16)
    for k, p in ((local, p_local), (glob[:4], p_glob[:4])):
        np.testing.assert_allclose(k[0].numpy(), p[0].numpy(), atol=1e-4)
        np.testing.assert_allclose(k[1].numpy(), p[1].numpy(), atol=1e-4)
        assert int((k[3] != p[3]).sum()) <= 1
