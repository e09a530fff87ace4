"""The monocular System of the port beside the JAX package's Tracker +
Mapper + vocabulary + KeyFrameDatabase (the stack of tests/test_reloc.py) on
the mono corridor of tests/test_slam_e2e.py (seed 0, 900 splats, 640x480,
768 features, min_init_matches 60): initialisation, tracking with keyframes,
a blackout, and relocalisation on a revisit, with both packages drawing the
same RANSAC hypotheses (the port's samplers patched to the JAX package's
draws).  And the System's vocabulary: the default one, its checksum, and the
atlas guard."""
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from orb_slam3_fast_tpu.backend.mapper import Mapper as JMapper
from orb_slam3_fast_tpu.cameras import models as jcam
from orb_slam3_fast_tpu.frontend import tracker as jtrk
from orb_slam3_fast_tpu.map.worldmap import WorldMap as JMap
from orb_slam3_fast_tpu.ops import extractor as jext
from orb_slam3_fast_tpu.optim import pnp as jpnp
from orb_slam3_fast_tpu.vocab import database as jdb
from orb_slam3_fast_tpu.vocab import vocabulary as jvoc
from orb_slam3_fast_tpu_torch.ops import twoview as ttv
from orb_slam3_fast_tpu_torch.optim import pnp as tpnp
from orb_slam3_fast_tpu_torch.slam import system as tsys

torch.set_num_threads(1)

CONFIG = str(Path(__file__).resolve().parents[1] / "configs" / "synthetic_mono.yaml")
OPTS = dict(enable_loop_closing=False, multi_map=False, async_backend=False, device="cpu")
N_FRAMES, N_BLANK, REVISIT = 10, 2, 7


def jax_hypotheses(seed, valid, n_iters=200):
    """The JAX package's two-view draw (twoview.py:329-331) for this seed."""
    p = jnp.asarray(valid.cpu().numpy(), jnp.float32)
    p = p / jnp.maximum(jnp.sum(p), 1.0)
    return torch.as_tensor(np.asarray(jax.random.choice(jax.random.PRNGKey(seed), p.shape[0], (n_iters, 8), p=p)))


def jax_subsets(seed, valid, n_hyp=256):
    """The JAX package's PnP draw (pnp.py:100-106) for this seed."""
    return torch.as_tensor(np.asarray(jpnp._sample_subsets(jax.random.PRNGKey(seed),
                                                           jnp.asarray(valid.cpu().numpy()), n_hyp)))


def _record(monkeypatch, module, log):
    fn = module.pnp_ransac

    def recorded(*args, **kw):
        res = fn(*args, **kw)
        log.append((int(res.n_inliers), np.asarray(res.R), np.asarray(res.t)))
        return res

    monkeypatch.setattr(module, "pnp_ransac", recorded)


def _record_candidates(monkeypatch, db, log):
    fn = db.detect_reloc_candidates

    def recorded(*args, **kw):
        out = fn(*args, **kw)
        log.append(np.asarray(out))
        return out

    monkeypatch.setattr(db, "detect_reloc_candidates", recorded)


def test_mono_path_matches_jax(monkeypatch):
    """Per frame: the same state, the pose within 2e-3 (rotation entries
    1e-3), inliers within 2%; initialisation at the same frame; at the end
    the same keyframe count, live landmarks within 3% and the same indexed
    keyframes; at the relocalisation the same candidates, the same PnP
    inlier counts and the relocalised pose within 2e-3."""
    monkeypatch.setattr(ttv, "_sample_hypotheses", jax_hypotheses)
    monkeypatch.setattr(tpnp, "_sample_subsets", jax_subsets)
    imgs, _ = chip_smoke.mono_frames(N_FRAMES)
    port = tsys.System(CONFIG, "monocular", tracker_overrides=dict(min_init_matches=60), max_keyframes=256, **OPTS)
    cam = jcam.Camera.pinhole(400.0, 400.0, 320.0, 240.0)
    cfg = jtrk.TrackerConfig(extractor=jext.ExtractorConfig(n_features=768), min_init_matches=60)
    voc = jvoc.default_vocabulary()
    kfdb = jdb.KeyFrameDatabase(voc.n_words, max_kf=256)
    jt = jtrk.Tracker(cam, cfg, world=JMap(kp_cap=jext.total_capacity(cfg.extractor)),
                      mapper=JMapper(cam, sigma2=jext.level_sigma2(cfg.extractor)), voc=voc, kfdb=kfdb)
    pnp_j, pnp_t, cand_j, cand_t = [], [], [], []
    _record(monkeypatch, jpnp, pnp_j)
    _record(monkeypatch, tpnp, pnp_t)
    _record_candidates(monkeypatch, kfdb, cand_j)
    _record_candidates(monkeypatch, port.kfdb, cand_t)
    blank = np.full((480, 640), 25.0, np.float32)
    seq = list(imgs) + [blank] * N_BLANK + [imgs[REVISIT]]
    states = []
    for i, img in enumerate(seq):
        st_j, pose_j = jt.process_mono(img, i * 0.05)
        st_t, pose_t = port.track_monocular(img, i * 0.05)
        assert st_t == st_j, (i, st_t, st_j)
        states.append(st_t)
        assert (pose_t is None) == (pose_j is None), i
        if pose_t is not None:
            np.testing.assert_allclose(pose_t[1], pose_j[1], atol=2e-3, err_msg=f"frame {i}")
            np.testing.assert_allclose(pose_t[0], pose_j[0], atol=1e-3, err_msg=f"frame {i}")
        if i == N_FRAMES - 1:
            n_kf = port.world.n_kf
            assert n_kf == jt.world.n_kf and n_kf >= 3
            n_t, n_j = int(port.world.lm_valid.sum()), int(jt.world.lm_valid.sum())
            assert abs(n_t - n_j) <= 0.03 * n_j
            np.testing.assert_array_equal(port.kfdb.valid, kfdb.valid)
            assert int(port.kfdb.valid.sum()) == n_kf
    assert states.index("OK") == 5  # initialisation at frame 5, against frame 0
    assert states[N_FRAMES:] == ["RECENTLY_LOST"] * N_BLANK + ["OK"]
    inl_t, inl_j = np.asarray(port.tracker.stats["inliers"]), np.asarray(jt.stats["inliers"])
    assert len(inl_t) == len(inl_j) and np.all(np.abs(inl_t - inl_j) <= 0.02 * inl_j)
    assert len(cand_t) == len(cand_j) >= 1
    for a, b in zip(cand_t, cand_j):
        np.testing.assert_array_equal(a, b)
    assert [n for n, _, _ in pnp_t] == [n for n, _, _ in pnp_j] and pnp_t[-1][0] >= 15
    np.testing.assert_allclose(pnp_t[-1][2], pnp_j[-1][2], atol=2e-3)
    assert port.tracker.ref_kf == jt.ref_kf


def test_system_vocabulary_and_atlas_guard(tmp_path):
    """The System loads the default vocabulary (the JAX package's checksum),
    builds a database over its words, and writes the checksum beside a saved
    map; a map whose checksum differs is refused; IMU samples given to the
    visual System are ignored."""
    port = tsys.System(CONFIG, "monocular", **OPTS)
    assert port.settings.bf == 0.0 and port.mapper.bf == 0.0
    assert port.voc.checksum() == jvoc.default_vocabulary().checksum()
    assert port.kfdb.n_words == port.voc.n_words == 10**4 and port.tracker.kfdb is port.kfdb
    path = str(tmp_path / "map.npz")
    port.save_atlas(path)
    assert Path(path + ".md5").read_text() == port.voc.checksum()
    port.load_atlas(path)
    Path(path + ".md5").write_text("0" * 32)
    with pytest.raises(ValueError, match="checksum"):
        port.load_atlas(path)
    # IMU samples given to a visual System are ignored, as the JAX System ignores them
    state, _ = port.track_monocular(np.zeros((480, 640), np.float32), 0.0, imu=[(0.0,) * 7])
    assert state == "NOT_INITIALIZED" and not hasattr(port.tracker, "imu_queue")
