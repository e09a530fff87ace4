"""The port's visual-inertial tracker beside the JAX package's InertialTracker
(tests/test_vi_tracker.py's stack: the tracker and a Mapper, no vocabulary)
on that test's mono-inertial scenario (corridor seed 0, the IMU arc with its
biases and noise, init_min_kfs 8, init_min_time 1.0, min_init_matches 60),
both fed the same frames and samples and the port's two-view sampler
patched to the JAX package's draws: the same state every frame, the same
keyframes, the IMU initialised at the same frame, then the inertial pose
optimisation in both its forms and the IMU prediction while lost
(tests/test_torch_vi_sensors.py has the short stereo- and RGB-D-inertial
runs).

``python -m tests.test_torch_vi_system`` prints the JAX package's own
reading of the 45-frame scenario (test_vi_tracker.py's gates), which
chip_smoke.py's phase 11 (a) cites."""
import jax
import numpy as np
import pytest
import torch

import chip_smoke
from orb_slam3_fast_tpu.backend.mapper import Mapper as JMapper
from orb_slam3_fast_tpu.cameras import models as jcam
from orb_slam3_fast_tpu.frontend import tracker as jtrk
from orb_slam3_fast_tpu.frontend import vi_tracker as jvi
from orb_slam3_fast_tpu.imu import preintegration as jpre
from orb_slam3_fast_tpu.map.worldmap import WorldMap as JMap
from orb_slam3_fast_tpu.ops import extractor as jext
from orb_slam3_fast_tpu_torch.backend.mapper import Mapper as TMapper
from orb_slam3_fast_tpu_torch.cameras import models as tcam
from orb_slam3_fast_tpu_torch.frontend import tracker as ttrk
from orb_slam3_fast_tpu_torch.frontend import vi_tracker as tvi
from orb_slam3_fast_tpu_torch.imu import preintegration as tpre
from orb_slam3_fast_tpu_torch.map.worldmap import WorldMap as TMap
from orb_slam3_fast_tpu_torch.ops import extractor as text
from orb_slam3_fast_tpu_torch.ops import twoview as ttv
from tests.test_torch_mono import jax_hypotheses

torch.set_num_threads(1)

N_MONO = 35  # IMU init at frame 29, the first inertial frames, a lost frame, both forms of the pose optimisation


def _pair(sensor: str, icfg_kw: dict):
    """The JAX InertialTracker and the port's on the same settings."""
    bf = {"monocular": 0.0, "stereo": 48.0, "rgbd": chip_smoke.RGBD_BF}[sensor]
    kw = dict(init_min_kfs=8, init_min_time=1.0, **icfg_kw)
    jcfg = jtrk.TrackerConfig(extractor=jext.ExtractorConfig(n_features=768), min_init_matches=60)
    jc = jcam.Camera.pinhole(400.0, 400.0, 320.0, 240.0)
    jn = jpre.ImuNoise.from_continuous(1.7e-4, 2.0e-3, 1.9e-5, 3.0e-3, 200.0)
    jt = jvi.InertialTracker(jc, jcfg, bf=bf, world=JMap(kp_cap=jext.total_capacity(jcfg.extractor)),
                             mapper=JMapper(jc, bf=bf, sigma2=jext.level_sigma2(jcfg.extractor)), noise=jn,
                             icfg=jvi.InertialConfig(**kw))
    tcfg = ttrk.TrackerConfig(extractor=text.ExtractorConfig(n_features=768), min_init_matches=60)
    tc = tcam.Camera.pinhole(400.0, 400.0, 320.0, 240.0)
    tn = tpre.ImuNoise.from_continuous(1.7e-4, 2.0e-3, 1.9e-5, 3.0e-3, 200.0)
    tt = tvi.InertialTracker(tc, tcfg, bf=bf, world=TMap(kp_cap=text.total_capacity(tcfg.extractor)),
                             mapper=TMapper(tc, bf=bf, sigma2=text.level_sigma2(tcfg.extractor), device="cpu"),
                             noise=tn, icfg=tvi.InertialConfig(**kw), device="cpu")
    return jt, tt


def _feed(tracker, sensor, frame, ts):
    if sensor == "monocular":
        return tracker.process_mono(frame[0], ts)
    if sensor == "stereo":
        return tracker.process_stereo(*frame, ts)
    return tracker.process_rgbd(*frame, ts)


def _run_both(sensor: str, n: int, icfg_kw: dict):
    """Both trackers on the same n frames and samples.  Returns per frame
    (state_j, state_t, pose_j, pose_t, imu_initialized_j, imu_initialized_t),
    and the two trackers."""
    frames, _, imu = chip_smoke.vi_frames(sensor, n)
    jt, tt = _pair(sensor, icfg_kw)
    rows = []
    for i, (f, samples) in enumerate(zip(frames, chip_smoke.imu_slices(imu, n))):
        jt.grab_imu(samples)
        tt.grab_imu(samples)
        sj, pj = _feed(jt, sensor, f, i * 0.05)
        st, pt = _feed(tt, sensor, f, i * 0.05)
        rows.append((sj, st, pj, pt, jt.world.imu_initialized, tt.world.imu_initialized))
    return rows, jt, tt


@pytest.fixture(scope="module")
def mono_run():
    """Both trackers on the first N_MONO frames of the scenario, run once for
    the module's parity checks."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ttv, "_sample_hypotheses", jax_hypotheses)
        return _run_both("monocular", N_MONO, {})


def test_mono_inertial_states_and_init_frame_match_jax(mono_run):
    """Per frame the same state, the same IMU-initialised flag and a pose
    on the same frames; the IMU initialised at frame 29; the IMU
    prediction bridged a lost frame and tracking resumed."""
    rows, _, _ = mono_run
    init = [i for i, r in enumerate(rows) if r[5]]
    assert init and init[0] == 29
    for i, (sj, st, pj, pt, ij, it) in enumerate(rows):
        assert (st, it) == (sj, ij), (i, st, sj, it, ij)
        assert (pt is None) == (pj is None), i
    states = [r[1] for r in rows]
    assert "RECENTLY_LOST" in states[30:] and states[-1] == "OK"


def test_mono_inertial_path_matches_jax(mono_run):
    """Poses before the initialisation within the sync paths' 2e-3
    (rotation entries 1e-3); after it, in the rotated and rescaled world,
    within 1e-2 (rotation entries 5e-3; measured 3.3e-5 before, 3.7e-3
    after): float32 LM solves in two frameworks start the IMU
    initialisation from maps a few 1e-5 apart, and its gravity and scale
    carry that into every later pose."""
    rows, _, _ = mono_run
    dev_before, dev_after = [0.0], [0.0]
    for i, (sj, st, pj, pt, ij, it) in enumerate(rows):
        if pt is None or pj is None:
            continue
        (dt_b, dr_b), out = ((2e-3, 1e-3), dev_before) if not it else ((1e-2, 5e-3), dev_after)
        out.append(float(np.abs(pt[1] - pj[1]).max()))
        np.testing.assert_allclose(pt[1], pj[1], atol=dt_b, err_msg=f"frame {i}")
        np.testing.assert_allclose(pt[0], pj[0], atol=dr_b, err_msg=f"frame {i}")
    print(f"mono-inertial path: max |dt| against the JAX package {max(dev_before):.3g} before the IMU "
          f"initialisation, {max(dev_after):.3g} after it")


def test_mono_inertial_keyframes_match_jax(mono_run):
    """The same keyframes, at the same timestamps, each with its
    preintegrated window."""
    _, jt, tt = mono_run
    assert tt.world.n_kf == jt.world.n_kf and sorted(tt.world.kf_preint) == sorted(jt.world.kf_preint)
    np.testing.assert_allclose(tt.world.kf_ts[: tt.world.n_kf], jt.world.kf_ts[: jt.world.n_kf])


def test_mono_inertial_velocity_bias_and_prior_match_jax(mono_run):
    """The tracker's velocity (5e-2 m/s) and biases (2e-3) agree after the
    inertial frames, and the last frame carried its marginal: the
    last-frame form of the pose optimisation ran."""
    _, jt, tt = mono_run
    np.testing.assert_allclose(tt.cur_bias.numpy(), np.asarray(jt.cur_bias), atol=2e-3)
    np.testing.assert_allclose(tt.cur_vel.numpy(), np.asarray(jt.cur_vel), atol=5e-2)
    assert tt._prior is not None


def jax_reference(n_frames: int = chip_smoke.VI_FRAMES) -> dict:
    """The JAX package's InertialTracker on test_vi_tracker.py's scenario,
    read as that test reads it (the fit after the init frame)."""
    from orb_slam3_fast_tpu.eval import ate
    from tests import test_vi_tracker as tv

    t, gt, est, ts, init_n = tv._run_vi(n_frames=n_frames)
    out = dict(state=t.state, imu_initialized=t.world.imu_initialized, init_index=init_n, n_est=len(est),
               n_kf=t.world.n_kf, bg=np.asarray(t.cur_bias)[:3].round(5).tolist())
    if init_n is not None and len(est) - init_n >= 3:
        rmse, _, s_fit = ate.ate_rmse(ts[init_n:], est[init_n:], ts[init_n:], gt[init_n:], with_scale=True)
        out.update(ate_m=float(rmse), scale=float(s_fit), after_init=len(est) - init_n)
    return out


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    print(jax_reference())
