"""The port's asynchronous backend (backend/pipeline.py) against what the
JAX package's tests assert of its own: the GBA thread's supersede-and-abort
record (tests/test_gba.py:148-178), and the default stereo System, whose
local mapping and loop closing run on the worker thread, on
tests/test_pipeline.py's scenario with that test's gates; the kernel
wrappers' launch counters under threads; and a loop correction while the
tracker inserts a keyframe, and the worker dropping a keyframe of a retired map."""
import sys
import threading
import time
from pathlib import Path

import numpy as np
import torch

import chip_smoke
from orb_slam3_fast_tpu_torch import _kernels
from orb_slam3_fast_tpu_torch.backend.mapper import Mapper
from orb_slam3_fast_tpu_torch.backend.pipeline import AsyncBackend
from orb_slam3_fast_tpu_torch.cameras import models as cm
from orb_slam3_fast_tpu_torch.eval import ate
from orb_slam3_fast_tpu_torch.slam import system as tsys

torch.set_num_threads(1)

CONFIG = str(Path(__file__).resolve().parents[1] / "configs" / "synthetic_stereo.yaml")


def test_gba_thread_supersede_and_abort():
    """A newer request aborts the solve in flight; only the newest runs to
    its end (LoopClosing.cc:1072-1086): the JAX test's record."""
    backend = AsyncBackend(Mapper(cm.Camera.pinhole(400.0, 400.0, 320.0, 240.0), bf=0.0, device="cpu"))
    started = threading.Event()
    record = []

    def slow_thunk(abort_flag=None, map_lock=None):
        started.set()
        for _ in range(200):
            if abort_flag.is_set():
                record.append("aborted")
                return False
            time.sleep(0.01)
        record.append("slow_done")
        return True

    def fast_thunk(abort_flag=None, map_lock=None):
        record.append("fast_done")
        return True

    backend.request_gba(slow_thunk)
    assert started.wait(timeout=5)
    backend.request_gba(fast_thunk)  # supersedes the slow one, which aborts
    assert backend.wait_idle(timeout=10)
    backend.shutdown()
    assert record == ["aborted", "fast_done"]
    assert backend.gba_completed == 1
    assert backend.gba_aborted >= 1
    assert not backend.errors
    assert not backend._thread.is_alive() and not backend._gba_thread.is_alive()


def test_default_stereo_system_runs_async():
    """``System(CONFIG, "stereo", device="cpu")`` with every other argument
    at its default (the async backend, loop closing, the Atlas) on
    tests/test_pipeline.py's 30 frames (corridor seed 1, 0.12 m baseline),
    fed as fast as they are tracked, and that test's gates: the backend
    drains within 120 s, no worker error, final state OK, >= 3 frames
    tracked while the worker was busy, > 25 tracked, unscaled ATE < 0.25 m;
    ``shutdown`` stops both threads."""
    frames, poses = chip_smoke.corridor_frames(30)
    slam = tsys.System(CONFIG, "stereo", device="cpu")
    b = slam.backend
    assert b is not None and slam.tracker.backend is b and slam.loopcloser.gba_hook == b.request_gba
    est, gt, ts, overlapped = [], [], [], 0
    for i, ((img_l, img_r), (R, t)) in enumerate(zip(frames, poses)):
        state, pose = slam.track_stereo(img_l, img_r, i * 0.05)
        overlapped += b.queue_len() > 0
        if state == "OK" and pose is not None:
            est.append(-pose[0].T @ pose[1])
            gt.append(-R.T @ t)
            ts.append(i * 0.05)
    assert b.wait_idle(timeout=120), "the backend never drained"
    assert not b.errors, f"the backend thread failed:\n{b.errors[0]}"
    slam.shutdown()
    assert not b._thread.is_alive() and not b._gba_thread.is_alive()
    assert slam.get_tracking_state() == "OK"
    assert overlapped >= 3, "tracking never overlapped keyframe processing"
    assert len(est) > 25
    rmse, _, _ = ate.ate_rmse(np.asarray(ts), np.asarray(est), np.asarray(ts), np.asarray(gt), with_scale=False)
    assert rmse < 0.25, f"async stereo ATE {rmse:.3f} m"
    assert slam.mapper.n_local_ba + slam.mapper.n_ba_skipped == slam.world.n_kf - 1  # every queued keyframe mapped
    assert slam.map_changed() and not slam.map_changed()


def test_launch_counters_lose_no_count_under_threads():
    """Eight threads bump one counter 2000 times each, with the interpreter
    switching threads every microsecond: no count is lost, and the counts
    per thread name and per mode add up; every kernel wrapper counts in
    such a counter."""
    counter = _kernels.LaunchCounter()
    n_threads, per = 8, 2000

    def bump():
        for i in range(per):
            counter.add("radtan" if i % 2 else "")

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=bump, name=f"worker-{k}") for k in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(th.is_alive() for th in threads)
    assert counter.total() == n_threads * per
    assert counter.by_thread() == {f"worker-{k}": per for k in range(n_threads)}
    assert counter.total(mode="radtan") == n_threads * per // 2
    assert counter.total(thread="worker-3", mode="") == per // 2
    counter.reset()
    assert counter.total() == 0 and counter.by_thread() == {}
    assert all(isinstance(w.launches, _kernels.LaunchCounter) for w in chip_smoke.wrappers().values())


def test_loop_correction_keeps_its_keyframe_count_while_the_tracker_inserts():
    """On the async backend the tracker may add a keyframe while the worker
    corrects a loop.  The synthetic loop map of tests/test_torch_loop.py
    closes its loop at keyframe 23; a keyframe added in the middle of the
    correction (during the loop fusion) makes the JAX package's loop closer
    index past its arrays (its worker's IndexError, tests/
    async_loop_reference.py); the port's corrects the keyframes it started
    with, closes the loop, and leaves the new one where it was put."""
    from orb_slam3_fast_tpu_torch.backend import loopcloser as tlc
    from orb_slam3_fast_tpu_torch.map.worldmap import WorldMap
    from orb_slam3_fast_tpu_torch.vocab import database as tdb
    from orb_slam3_fast_tpu_torch.vocab import vocabulary as tvoc
    from tests.test_torch_loop import CFG, KP_CAP, LOOP_START, N_KF, SIGMA2, _index, add_keyframe, loop_keyframes

    cam = cm.Camera.pinhole(400.0, 400.0, 320.0, 240.0)
    kfs, _ = loop_keyframes()
    world = WorldMap(kp_cap=KP_CAP, max_kf=32, max_lm=4096)
    voc = tvoc.default_vocabulary()
    kfdb = tdb.KeyFrameDatabase(voc.n_words, max_kf=32)
    point_lm: dict = {}
    lc = tlc.LoopCloser(cam, voc, kfdb, Mapper(cam, bf=0.0, sigma2=SIGMA2, device="cpu"),
                        cfg=tlc.LoopCloserConfig(**CFG), sigma2=SIGMA2)
    fuse = lc._fuse_loop
    inserted = []

    def fuse_while_the_tracker_inserts(w, k, c):
        if not inserted:  # keyframe N_KF arrives in the middle of the correction
            add_keyframe(w, kfs[N_KF - 1], N_KF, point_lm, packed=True)
            inserted.append((w.kf_R[N_KF].copy(), w.kf_t[N_KF].copy()))
        return fuse(w, k, c)

    lc._fuse_loop = fuse_while_the_tracker_inserts
    for k in range(N_KF):
        add_keyframe(world, kfs[k], k, point_lm, packed=True)
        _index(tvoc, voc, kfdb, world, k, True)
        if k >= LOOP_START:
            lc.process_keyframe(world, k)
    assert lc.n_loops_closed == 1 and len(inserted) == 1 and world.n_kf == N_KF + 1
    np.testing.assert_array_equal(world.kf_R[N_KF], inserted[0][0])
    np.testing.assert_array_equal(world.kf_t[N_KF], inserted[0][1])
    assert np.isfinite(world.kf_R[: N_KF + 1]).all() and np.isfinite(world.kf_t[: N_KF + 1]).all()


def test_worker_drops_keyframes_of_a_retired_map():
    """A keyframe queued for a map that the Atlas retired before the worker
    reached it (merged into another by the loop closer of an earlier
    keyframe, or reset by the tracker) is dropped and counted, with no
    worker error; a keyframe of the live map is mapped and handed to the
    loop closer.  (The JAX package's worker maps such a keyframe and its
    loop closer then fails in ``Atlas.merge_into`` on the retired map.)"""
    from orb_slam3_fast_tpu_torch.map.atlas import Atlas
    from orb_slam3_fast_tpu_torch.map.worldmap import WorldMap

    seen = []
    mapper = Mapper(cm.Camera.pinhole(400.0, 400.0, 320.0, 240.0), bf=0.0, device="cpu")
    mapper.process_new_keyframe = lambda world, k, **kw: seen.append(("map", k))
    closer = type("Closer", (), {"process_keyframe": lambda self, world, k, map_id=0, atlas=None, map_lock=None:
                                 seen.append(("close", k)) and False})()
    backend = AsyncBackend(mapper, closer)
    atlas = Atlas(lambda: WorldMap(kp_cap=8, max_kf=8))
    retired = atlas.current
    atlas.maps[atlas.current_id] = None  # merged away before the worker reached its keyframe
    live = atlas.create_new_map()
    backend.insert_keyframe(retired, 3, map_id=0, atlas=atlas)
    backend.insert_keyframe(live, 0, map_id=atlas.current_id, atlas=atlas)
    assert backend.wait_idle(timeout=10)
    backend.shutdown()
    assert seen == [("map", 0), ("close", 0)]
    assert backend.n_retired_skipped == 1 and not backend.errors
