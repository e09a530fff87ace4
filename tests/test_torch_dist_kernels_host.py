"""Kernels AE (csrc/kfdb_score.cu), AF (csrc/ba_shard.cu) and AG
(csrc/vi_shard.cu) compiled for the host with g++ through the emulated-CTA
harness of tests/test_torch_ba_lm_host.py and
tests/test_torch_loop_kernels_host.py (one std::thread per CUDA thread; a
launch of several CTAs runs them one after another; every CTA of AE, AF
and their neighbours at its full width, up to AF's one-CTA launches of
1024 threads, since those kernels stride by their launch constants; AA's
and AG's, which stride by the block's width, at most 64 threads), beside
E, T and AC (ba_blocks.cu, ba_pcg.cu, ba_lm.cu) and through the wrappers'
marshalling, at a world of one (no process group): AE bit for bit its
plain version; AF's stages bit for bit E's, T's and AC's on the same
inputs (a world of one runs their arithmetic in their order), and its
whole dense and CG runs those of E -> F -> AC (F's plain version on both
sides) and E -> T -> AC; AG's whole two-phase run kernel AA's (vi_pcg.cu)
bit for bit, both at the same width.  The card runs the same sources
(tests/test_torch_kernels.py's cuda cases, chip_smoke.py phase 16)."""
import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from orb_slam3_fast_tpu_torch import _kernels
from orb_slam3_fast_tpu_torch.cameras import models as cm
from orb_slam3_fast_tpu_torch.optim import ba as tba
from orb_slam3_fast_tpu_torch.optim import ba_cg as tcg
from orb_slam3_fast_tpu_torch.parallel import dist_ba, dist_kfdb, multihost
from orb_slam3_fast_tpu_torch.utils import lie as tlie
from tests.test_torch_ba_lm_host import BF, small_problem
from tests.test_torch_fisheye_kernels_host import _FISHEYE_STUB
from tests.test_torch_loop_kernels_host import _host_source
from tests.test_torch_vi_kernels_host import EMULATED_THREADS

torch.set_num_threads(1)

VI_SOURCES = ("vi_pcg.cu", "vi_shard.cu")  # kernels AA and AG: their one-CTA launches emulated at EMULATED_THREADS
SOURCES = ("kfdb_score.cu", "ba_shard.cu", "ba_blocks.cu", "ba_lm.cu", "ba_pcg.cu", *VI_SOURCES)
CAM = cm.Camera.pinhole(400.0, 400.0, 320.0, 240.0)
CG_ITERS = 2
ITERS = (1, 1)  # LM iterations of the whole runs, the chi2 gate between and after

VI_ITERS, VI_CG = (3, 2), 6  # AG's and AA's whole runs: LM steps of the two phases, CG iterations a step
AG_KERNEL = dist_ba.VIStages(dist_ba._segment_kernel, dist_ba._classify_kernel)  # AG's stages on the host

# AF at a world of one, launching its kernels on the host
KERNEL = dist_ba.Stages(dist_ba._blocks_partial_kernel, dist_ba._round_blocks_kernel, dist_ba._update_partial_kernel,
                        dist_ba._commit_kernel, tba._classify_kernel, dist_ba._cg_solve_kernel,
                        dist_ba.dense_solve_plain)


@pytest.fixture(scope="module")
def host_kernels(tmp_path_factory):
    """The sources built into one host library, and _kernels.launch /
    require_cuda pointed at it for the module."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to compile the kernels' device code for the host")
    d = tmp_path_factory.mktemp("dist_kernels")
    (d / "cuda_runtime.h").write_text(_FISHEYE_STUB)
    objs, procs = [], []
    for name in SOURCES:
        cpp = d / (name[:-3] + ".cpp")
        src = _host_source((_kernels.SRC_DIR / name).read_text())
        cpp.write_text(src if name in VI_SOURCES else src.replace(f"{EMULATED_THREADS}u", "1024u"))
        obj = d / (name[:-3] + ".o")
        procs.append(subprocess.Popen(["g++", "-std=c++20", "-O1", "-fPIC", "-pthread", f"-I{d}",
                                       f"-I{_kernels.SRC_DIR}", "-c", str(cpp), "-o", str(obj)],
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        objs.append(str(obj))
    for p in procs:
        out = p.communicate(timeout=600)[0]
        assert p.returncode == 0, out
    so = d / "libdist_host.so"
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


@pytest.mark.parametrize("K,T", [(20, 1024), (9, 45)])
def test_kfdb_score_matches_plain(host_kernels, K, T):
    """AE on K rows of T slots (a partial CTA of rows; a width not a
    multiple of 32; -1 slots; words absent from the query): the counts and
    scores bit for bit score_rows_plain's, the counts the host database's
    and the scores within 1e-5 of them; counted as launches."""
    from orb_slam3_fast_tpu_torch.vocab.database import KeyFrameDatabase

    rng = np.random.default_rng(K)
    n_words = 2000
    ids = np.full((K, T), -1, np.int32)
    w = np.zeros((K, T), np.float32)
    for k in range(K):
        n = int(rng.integers(T // 3, T + 1))
        ids[k, :n] = np.sort(rng.choice(n_words, n, replace=False))
        w[k, :n] = rng.dirichlet(np.ones(n))
    q = rng.uniform(0, 1, n_words).astype(np.float32) * (rng.uniform(size=n_words) < 0.4)
    lut = torch.from_numpy(np.concatenate([q, [0.0]]).astype(np.float32))
    n0 = dist_kfdb.score_rows.launches.total()
    ck, sk = dist_kfdb._score_rows_kernel(torch.from_numpy(ids), torch.from_numpy(w), lut)
    cp, sp = dist_kfdb.score_rows_plain(torch.from_numpy(ids), torch.from_numpy(w), lut)
    assert torch.equal(ck, cp) and torch.equal(sk, sp)
    db = KeyFrameDatabase(n_words, max_kf=K, row_words=T)
    db.ids, db.w = ids, w
    db.valid[:] = True
    ch, sh, _ = db._scores(q, np.zeros(0, np.int64))
    np.testing.assert_array_equal(ck.numpy(), ch)
    np.testing.assert_allclose(sk.numpy(), sh, atol=1e-5)
    assert int(ch.sum()) > 0 and dist_kfdb.score_rows.launches.total() == n0 + 1


def test_af_stages_match_e_t_ac(host_kernels):
    """One LM iteration at a world of one, from the same state: AF's blocks
    and round entries E's outputs (W bit for bit, the sums within a float32
    rounding: the emulated atomics land in any order); its CG entries T's
    dp and dl bit for bit from the same blocks; its cost and commit
    entries AC's update bit for bit (state, damping, accept, cost), from
    the step and from its negative."""
    mesh = multihost.global_mesh("cpu")
    prob = small_problem(CAM)
    inl = torch.ones_like(prob.obs_valid)
    inl[::11] = False
    K, M = prob.R.shape[0], prob.xw.shape[0]
    state = (prob.R, prob.t, prob.xw)
    acc, W = dist_ba._blocks_partial_kernel(CAM, BF, *state, prob, inl)
    blocks = dist_ba._round_blocks_kernel(acc, K, M)
    e = tba._blocks_kernel(CAM, BF, *state, prob, inl)
    assert torch.equal(W, e[4])
    for a, b in zip(blocks, (*e[:4], *e[5:])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6, atol=1e-6)
    Hpp, Hll, bp, bl, w_lm, cost = (*e[:4], *e[5:])
    lam = torch.tensor(1e-2)
    dp, dl = dist_ba._cg_solve_kernel(mesh, Hpp, Hll, bp, bl, W, prob, w_lm, lam, CG_ITERS)
    dt, lt = tcg.implicit_schur_solve(Hpp, Hll, bp, bl, W, prob, w_lm, lam, CG_ITERS)
    assert torch.equal(dp, dt) and torch.equal(dl, lt) and float(dp.abs().max()) > 0
    for sign in (1.0, -1.0):
        step = (sign * dp, sign * dl)
        R_c, t_c, x_c, a = dist_ba._update_partial_kernel(CAM, BF, prob, *state, *step, inl)
        k = dist_ba._commit_kernel(*state, R_c, t_c, x_c, a, cost, None, lam)
        p = tba._lm_update_kernel(CAM, BF, prob, *state, *step, inl, cost, None, lam)
        assert all(torch.equal(x, y) for x, y in zip(k, p)), sign


@pytest.mark.parametrize("form", ["dense", "cg"])
def test_af_runs_match_single_device(host_kernels, form):
    """The whole run (1 + 1 LM iterations) at a world of one on AF's
    kernels against the single-device BA on E, T (or F's plain version on
    both sides) and AC: poses, landmarks and the inlier mask bit for bit;
    AF's entries counted as launches and E's wrapper's not."""
    mesh = multihost.global_mesh("cpu")
    prob = small_problem(CAM, seed=2)
    if form == "dense":
        def dense(Hpp, Hll, bp, bl, W, w_lm, prob_, lam):
            return tba._solve_plain(Hpp, Hll, bp, bl, tba.coupling_to_dense(W, prob_), w_lm, prob_, lam)

        shard = dist_ba.shard_problem(prob, mesh, whole=True)

        def solve(Hpp, Hll, bp, bl, W, w_lm, lam):
            return KERNEL.dense(Hpp, Hll, bp, bl, mesh.all_gather(W), shard.whole, w_lm, lam)

        ref = tba._bundle_adjust(CAM, BF, prob, *ITERS, tba._blocks_kernel, dense, tba._lm_update_kernel,
                                 tba._classify_kernel)
    else:
        shard = dist_ba.shard_problem(prob, mesh)

        def solve(Hpp, Hll, bp, bl, W, w_lm, lam):
            return (*KERNEL.cg(mesh, Hpp, Hll, bp, bl, W, shard.local, w_lm, lam, CG_ITERS), None)

        ref = tcg._bundle_adjust_cg(CAM, BF, prob, *ITERS, CG_ITERS, 5, None, tba._blocks_kernel,
                                    tcg.implicit_schur_solve, tba._lm_update_kernel, tba._classify_kernel)[:4]
    n_af = dist_ba.LAUNCHES.total()
    n_e = tba.build_normal_blocks.launches.total()
    out = dist_ba._run(mesh, KERNEL, CAM, BF, shard, *ITERS, solve)
    assert all(torch.equal(a, b) for a, b in zip(out[:4], ref)), form
    per_iter = 4 if form == "dense" else 4 + 2 + 3 * CG_ITERS + 2
    assert dist_ba.LAUNCHES.total() - n_af == sum(ITERS) * per_iter
    assert tba.build_normal_blocks.launches.total() == n_e  # AF launched no E of its wrapper


def _vi_case(case: str):
    """(camera, bf, T_cb, problem): AA's host test's tracker-shaped problem
    (pin-hole, stereo edges, outliers, padded fixed states, invalid
    landmarks, padded observations; a camera offset from the body) or
    chip_smoke.vi_cg_problem's flight seen through TUM-VI's cam0 (KB8,
    monocular)."""
    import chip_smoke
    from tests.test_torch_loop_kernels_host import _aa_problem
    from tests.test_torch_vi_ba import T_CAM

    if case == "pinhole":
        prob, T_cb = _aa_problem()
        return T_CAM, 40.0, T_cb, prob
    cam = chip_smoke.fisheye_settings("stereo").cam
    prob, _ = chip_smoke.vi_cg_problem(np.random.default_rng(12), "cpu", n_kf=5, n_lm=120)
    prob = prob._replace(obs_uv=chip_smoke.kb8_mono(prob.obs_uv, cam), obs_is_stereo=torch.zeros_like(
        prob.obs_is_stereo))
    return cam, 0.0, tlie.SE3.identity("cpu"), prob


@pytest.mark.parametrize("case", ["pinhole", "kb8"])
def test_ag_run_is_aa_bit_for_bit(host_kernels, case):
    """AG's whole two-phase run at a world of one (3 + 2 LM steps, 6 CG
    iterations a step, segments of 2: the damping crosses them in float32)
    against kernel AA's full_inertial_ba_cg schedule on the same problem:
    states, landmarks and the inlier mask bit for bit, the state moved;
    every stage launched in its count (6 + 3 x 6 a step, 2 a segment, 2
    classifications), counted in the camera's instance."""
    import chip_smoke

    cam, bf, T_cb, prob = _vi_case(case)
    mesh = multihost.global_mesh("cpu")
    dist_ba.VI_LAUNCHES.reset()
    ag = dist_ba._run_vi(mesh, AG_KERNEL, cam, bf, T_cb, dist_ba.shard_vi_problem(prob, mesh), *VI_ITERS, VI_CG)
    aa, _ = chip_smoke.aa_two_phase(cam, prob, VI_ITERS, VI_CG, bf=bf, T_cb=T_cb)
    for name, a, b in zip(("R", "p", "v", "bias", "xw", "inlier"), ag, aa):
        assert torch.equal(a, b), name
    assert float((ag[1] - prob.p_wb).abs().max()) > 1e-4
    steps, segments = sum(VI_ITERS), 2 + 1
    camera = "kb8" if case == "kb8" else ""
    assert dist_ba.VI_LAUNCHES.total(camera=camera) == steps * (6 + 3 * VI_CG) + 2 * segments + 2
    assert dist_ba.VI_LAUNCHES.total(mode="cg_update") == steps * VI_CG
    assert dist_ba.VI_LAUNCHES.total(mode="classify") == 2
