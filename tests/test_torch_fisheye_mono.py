"""The monocular Kannala-Brandt slice of the port against the JAX package on
the CPU: ``System(configs/TUMVI_fisheye_stereo_inertial.yaml, "monocular" |
"monocular-inertial")`` (TUM-VI's cam0 alone, a 512x512 KB8 camera, 1000
features) beside the JAX package's System built from the same file, on the
first frames of tests/test_fisheye.py's corridor (chip_smoke.fisheye_frames,
phase 15's scenes), both drawing the same two-view hypotheses (the port's
sampler patched to the JAX package's draw); the settings of both sensors
field for field; the System's wiring; and the slice's imports."""
import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
from orb_slam3_fast_tpu.slam.settings import Settings as JSettings
from orb_slam3_fast_tpu.slam.system import System as JSystem
from orb_slam3_fast_tpu_torch.cameras import models as tcam
from orb_slam3_fast_tpu_torch.ops import twoview as ttv
from orb_slam3_fast_tpu_torch.slam import system as tsys
from orb_slam3_fast_tpu_torch.slam.settings import Settings as TSettings
from tests.test_torch_mono import jax_hypotheses

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
CONFIG = str(REPO / "configs" / "TUMVI_fisheye_stereo_inertial.yaml")
SYNC = dict(enable_loop_closing=False, multi_map=False, async_backend=False)
N_MONO = 12  # the JAX System takes ~90 s for these on the CPU, most of it compiling
N_VI = 12  # before the IMU initialisation (frame 22 in both packages, phase 15 (b))
N_VI_SLOW = 45  # the whole of phase 15 (b)
VI_WINDOW = dict(init_min_kfs=8, init_min_time=1.0)  # phase 11's, as phase 15 (b) sets it


def run_both(sensor: str, n: int):
    """Both Systems on the first ``n`` frames of phase 15 (a)'s corridor (or
    (b)'s arc with the body's IMU stream for the inertial sensor), the port's
    two-view sampler patched to the JAX package's draw.  Returns per frame
    (port state, JAX state, port pose, JAX pose, port keyframes, JAX
    keyframes, port IMU initialised, JAX IMU initialised), both Systems,
    and the launches kernel M's wrapper counted over the run."""
    inertial = sensor == "monocular-inertial"
    pairs, _, imu = chip_smoke.fisheye_frames(chip_smoke.FISHEYE_VI_FRAMES if inertial else chip_smoke.FISHEYE_FRAMES,
                                              imu=inertial)
    samples = chip_smoke.imu_slices(imu, n) if inertial else [()] * n
    port = tsys.System(CONFIG, sensor, device="cpu", **SYNC)
    jsys = JSystem(CONFIG, sensor, **SYNC)
    if inertial:
        port.tracker.icfg = port.tracker.icfg._replace(**VI_WINDOW)
        jsys.tracker.icfg = jsys.tracker.icfg._replace(**VI_WINDOW)
    mp = pytest.MonkeyPatch()
    mp.setattr(ttv, "_sample_hypotheses", jax_hypotheses)
    rows, launches = [], ttv.reconstruct.launches.total()
    try:
        for i, ((img, _), smp) in enumerate(zip(pairs[:n], samples)):
            st_j, pose_j = jsys.track_monocular(img, i * 0.05, imu=smp)
            st_t, pose_t = port.track_monocular(img, i * 0.05, imu=smp)
            rows.append((st_t, st_j, pose_t, pose_j, port.world.n_kf, jsys.world.n_kf,
                         bool(port.world.imu_initialized), bool(jsys.world.imu_initialized)))
    finally:
        mp.undo()
    return rows, port, jsys, ttv.reconstruct.launches.total() - launches


@pytest.fixture(scope="module")
def mono_runs():
    return run_both("monocular", N_MONO)


@pytest.fixture(scope="module")
def mono_inertial_runs():
    return run_both("monocular-inertial", N_VI)


def test_mono_states_and_keyframes_match_jax(mono_runs):
    """Per frame the same state and the same keyframe count; the map
    initialised at the same frame (frame 1, against frame 0, as the JAX
    package's own 40-frame run does)."""
    rows = mono_runs[0]
    assert [r[0] for r in rows] == [r[1] for r in rows]
    assert [r[4] for r in rows] == [r[5] for r in rows]
    assert [r[0] for r in rows].index("OK") == 1 and rows[-1][0] == "OK" and rows[-1][4] >= 5


def test_mono_poses_match_jax(mono_runs):
    """Per frame tracked the camera pose within 2e-3 in t and 1e-3 in the
    rotation entries (the scale is the initialisation's median depth, the
    same in both on the same hypotheses)."""
    rows = mono_runs[0]
    for i, (st, _, pose_t, pose_j, *_) in enumerate(rows):
        assert (pose_t is None) == (pose_j is None), i
        if st == "OK":
            np.testing.assert_allclose(pose_t[1], np.asarray(pose_j[1]), atol=2e-3, err_msg=f"frame {i}")
            np.testing.assert_allclose(pose_t[0], np.asarray(pose_j[0]), atol=1e-3, err_msg=f"frame {i}")


def test_mono_map_matches_jax(mono_runs):
    """At the end: live landmarks within 3%, local BAs ran in both, and the
    keyframe database indexed every keyframe; on the CPU the wrappers
    launched no kernel (kernel M's plain version took the two views)."""
    _, port, jsys, m_launches = mono_runs
    n_t, n_j = int(port.world.lm_valid.sum()), int(jsys.world.lm_valid.sum())
    assert n_j > 200 and abs(n_t - n_j) <= 0.03 * n_j
    assert port.mapper.n_local_ba >= 1
    assert int(port.kfdb.valid.sum()) == port.world.n_kf
    assert m_launches == 0


def test_mono_inertial_matches_jax_before_imu_init(mono_inertial_runs):
    """The monocular-inertial System on the arc with the body's IMU stream,
    over its frames before the IMU initialisation: per frame the same
    state and keyframes, neither initialised the IMU, poses within 2e-3 /
    1e-3; the scale free (the IMU sets it at the initialisation)."""
    rows, port = mono_inertial_runs[:2]
    assert [r[0] for r in rows] == [r[1] for r in rows] and [r[4] for r in rows] == [r[5] for r in rows]
    assert not any(r[6] or r[7] for r in rows)
    for i, (st, _, pose_t, pose_j, *_) in enumerate(rows):
        if st == "OK":
            np.testing.assert_allclose(pose_t[1], np.asarray(pose_j[1]), atol=2e-3, err_msg=f"frame {i}")
            np.testing.assert_allclose(pose_t[0], np.asarray(pose_j[0]), atol=1e-3, err_msg=f"frame {i}")
    assert port.tracker.icfg.fix_scale is False and rows[-1][0] == "OK"


@pytest.mark.slow
def test_mono_inertial_whole_run_matches_jax():
    """The whole of phase 15 (b) in both packages (45 frames, ~5 min):
    per frame the same state, keyframes and IMU-initialisation frame
    (frame 22), poses within phase 15 (b)'s card-against-host bound
    (``VI_BOUNDS["monocular"]``) over the frames before the first loss."""
    rows = run_both("monocular-inertial", N_VI_SLOW)[0]
    assert [r[0] for r in rows] == [r[1] for r in rows] and [r[4] for r in rows] == [r[5] for r in rows]
    init_t, init_j = ([r[k] for r in rows].index(True) for k in (6, 7))
    assert init_t == init_j == 22
    dt, dr = chip_smoke.VI_BOUNDS["monocular"]
    first_loss = next(i for i, r in enumerate(rows) if r[0] == "RECENTLY_LOST")
    for i, (st, _, pose_t, pose_j, *_) in enumerate(rows[:first_loss]):
        if st == "OK":
            np.testing.assert_allclose(pose_t[1], np.asarray(pose_j[1]), atol=dt, err_msg=f"frame {i}")
            np.testing.assert_allclose(pose_t[0], np.asarray(pose_j[0]), atol=dr, err_msg=f"frame {i}")


@pytest.mark.parametrize("sensor", ["monocular", "monocular-inertial"])
def test_settings_match_jax(sensor):
    """The TUM-VI configuration loaded for a monocular sensor: every field
    of the port's Settings the JAX package's, bf and the second camera
    included (the JAX System routes it whatever the sensor)."""
    t, j = TSettings.from_yaml(CONFIG, sensor), JSettings.from_yaml(CONFIG, sensor)
    for f in dataclasses.fields(TSettings):
        a, b = getattr(t, f.name), getattr(j, f.name)
        if f.name in ("cam", "cam2"):
            assert a.kind == b.kind == tcam.KB8, f.name
            np.testing.assert_array_equal(a.params.numpy(), np.asarray(b.params), err_msg=f.name)
        elif isinstance(b, np.ndarray):
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        elif f.name != "raw":
            assert a == b, f.name
    assert t.bf == j.bf and t.camera_type == "KannalaBrandt8"


@pytest.mark.parametrize("sensor", ["monocular", "monocular-inertial"])
def test_system_wires_the_monocular_kb8_camera(sensor):
    """``System(TUM-VI config, sensor)`` constructs on the CPU: the tracker
    gets the first KB8 camera, and the second with Stereo.T_c1_c2 as the
    JAX System routes them (``process_mono`` reads neither); with loop
    closing its loop closer on the first camera with the scale free for
    ``"monocular"`` (fixed by the IMU otherwise, as the JAX package's
    ``fix_scale=(sensor != MONOCULAR)``)."""
    slam = tsys.System(CONFIG, sensor, device="cpu", **dict(SYNC, enable_loop_closing=True, multi_map=True))
    jsys = JSystem(CONFIG, sensor, **dict(SYNC, enable_loop_closing=True, multi_map=True))
    assert slam.tracker.cam is slam.settings.cam and slam.tracker.cam.kind == tcam.KB8
    assert (slam.tracker.cam2 is None) == (jsys.tracker.cam2 is None)
    np.testing.assert_allclose(slam.tracker.T_rl[0].numpy(), np.asarray(jsys.tracker.T_rl[0]), atol=1e-7)
    assert slam.loopcloser.cam is slam.settings.cam
    assert slam.loopcloser.cfg.fix_scale is jsys.loopcloser.cfg.fix_scale is (sensor != "monocular")
    assert slam.inertial == (sensor == "monocular-inertial")


def test_slice_never_imports_jax():
    """The monocular KB8 System constructs and tracks two frames on the CPU
    without jax or the JAX package."""
    code = (
        "import sys, numpy as np\n"
        "from orb_slam3_fast_tpu_torch.slam.system import System\n"
        f"for sensor in ('monocular', 'monocular-inertial'):\n"
        f"    slam = System('{CONFIG}', sensor, device='cpu', enable_loop_closing=False, async_backend=False)\n"
        "    for i in range(2):\n"
        "        slam.track_monocular(np.full((512, 512), 30.0, np.float32), i * 0.05)\n"
        "assert 'jax' not in sys.modules, 'jax imported'\n"
        "assert 'orb_slam3_fast_tpu' not in sys.modules\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
