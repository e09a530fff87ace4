"""The loop closer's map changes under the async backend's map lock.

On the async backend the loop closer runs on the worker thread while the
tracker inserts keyframes under the map lock.  ``process_keyframe`` takes
the lock (``map_lock``) across the whole loop correction (the Sim3
propagation, the fusion, the essential graph) and the whole merge, as the
reference holds mMutexMapUpdate there; detection and verification run
outside it.  Here the interleaving is forced on the CPU on the synthetic
loop map of tests/test_torch_loop.py (the loop closes at keyframe 23): the
correction is paused on a worker thread after its propagation, and a
tracker-side keyframe insertion waits until the correction has ended.  A
synchronous run moves by no bit with the lock passed."""
import threading

import numpy as np
import torch

from orb_slam3_fast_tpu_torch.backend import loopcloser as tlc
from orb_slam3_fast_tpu_torch.backend.mapper import Mapper
from orb_slam3_fast_tpu_torch.backend.pipeline import AsyncBackend
from orb_slam3_fast_tpu_torch.cameras import models as cm
from orb_slam3_fast_tpu_torch.map.worldmap import WorldMap
from orb_slam3_fast_tpu_torch.utils import lie
from orb_slam3_fast_tpu_torch.vocab import database as tdb
from orb_slam3_fast_tpu_torch.vocab import vocabulary as tvoc
from tests.test_torch_loop import CFG, KP_CAP, LOOP_START, N_KF, SIGMA2, _index, add_keyframe, loop_keyframes

torch.set_num_threads(1)

CAM = cm.Camera.pinhole(400.0, 400.0, 320.0, 240.0)
WAIT = 30.0  # seconds any thread may wait for another before the test fails


def loop_map():
    """The loop map's first LOOP_START keyframes, indexed, and a loop
    closer over it."""
    kfs, _ = loop_keyframes()
    world = WorldMap(kp_cap=KP_CAP, max_kf=32, max_lm=4096)
    voc = tvoc.default_vocabulary()
    kfdb = tdb.KeyFrameDatabase(voc.n_words, max_kf=32)
    lc = tlc.LoopCloser(CAM, voc, kfdb, Mapper(CAM, bf=0.0, sigma2=SIGMA2, device="cpu"),
                        cfg=tlc.LoopCloserConfig(**CFG), sigma2=SIGMA2)
    point_lm: dict = {}
    for k in range(LOOP_START):
        add_keyframe(world, kfs[k], k, point_lm, packed=True)
        _index(tvoc, voc, kfdb, world, k, True)
    return kfs, world, voc, kfdb, lc, point_lm


def add(kfs, world, voc, kfdb, point_lm, k):
    add_keyframe(world, kfs[k], k, point_lm, packed=True)
    _index(tvoc, voc, kfdb, world, k, True)


def held(lock) -> bool:
    """True if some thread holds ``lock`` (probed from a new thread: the
    caller's own hold counts too)."""
    got = []

    def probe():
        ok = lock.acquire(timeout=0.05)
        got.append(ok)
        if ok:
            lock.release()

    t = threading.Thread(target=probe)
    t.start()
    t.join()
    return not got[0]


def test_sync_run_moves_no_bit_with_the_lock():
    """Keyframes 21-23 through process_keyframe with no lock and with a
    re-entrant lock passed (the global BA inline, as on the synchronous
    path): the loop closes at 23 in both, and every pose and landmark is
    equal bit for bit."""
    runs = []
    for lock in (None, threading.RLock()):
        kfs, world, voc, kfdb, lc, point_lm = loop_map()
        outs = []
        for k in range(LOOP_START, N_KF):
            add(kfs, world, voc, kfdb, point_lm, k)
            outs.append(lc.process_keyframe(world, k) if lock is None else lc.process_keyframe(world, k, map_lock=lock))
        assert outs == [False, False, ("loop", None)] and lc.n_loops_closed == 1
        runs.append((world.kf_R[:N_KF].copy(), world.kf_t[:N_KF].copy(), world.lm_pos[: world.n_lm].copy()))
    for a, b in zip(*runs):
        np.testing.assert_array_equal(a, b)


def test_tracker_insert_waits_for_the_loop_correction():
    """Keyframe 23's correction on a worker thread, paused after the Sim3
    propagation (at the fusion) while it holds the lock: a keyframe insert
    under the lock on a third thread, as the tracker's, does not land while
    it is paused, and lands after the correction has ended; the keyframe
    count the correction read (24) is the map's at the start and at the end
    of the essential graph; the global BA is handed to the hook (the GBA
    thread on the async backend) and gathers nothing under the correction's
    lock."""
    kfs, world, voc, kfdb, lc, point_lm = loop_map()
    lock = threading.RLock()
    for k in range(LOOP_START, N_KF - 1):
        add(kfs, world, voc, kfdb, point_lm, k)
        assert lc.process_keyframe(world, k, map_lock=lock) is False
    add(kfs, world, voc, kfdb, point_lm, N_KF - 1)
    paused, resume, inserted = threading.Event(), threading.Event(), threading.Event()
    events, graph_counts, queued = [], [], []
    fuse, graph, correct = lc._fuse_loop, lc._essential_graph, lc._correct

    def fuse_paused(w, k, c):
        events.append(("fuse", held(lock)))
        paused.set()
        assert resume.wait(WAIT)
        return fuse(w, k, c)

    def graph_counted(w, k, c, K, *args):
        graph_counts.append((K, w.n_kf))
        out = graph(w, k, c, K, *args)
        graph_counts.append((K, w.n_kf))
        return out

    def correct_logged(*args):
        out = correct(*args)
        events.append(("corrected", world.n_kf))
        return out

    lc._fuse_loop, lc._essential_graph, lc._correct = fuse_paused, graph_counted, correct_logged
    lc.gba_hook = queued.append
    result = []
    worker = threading.Thread(target=lambda: result.append(lc.process_keyframe(world, N_KF - 1, map_lock=lock)))
    worker.start()
    assert paused.wait(WAIT)

    def tracker_insert():
        with lock:
            events.append(("insert", world.n_kf))
            add_keyframe(world, kfs[N_KF - 1], N_KF, point_lm, packed=True)
        inserted.set()

    tracker = threading.Thread(target=tracker_insert)
    tracker.start()
    assert not inserted.wait(0.3)  # blocked while the correction holds the lock
    assert world.n_kf == N_KF
    resume.set()
    worker.join(WAIT)
    tracker.join(WAIT)
    assert not worker.is_alive() and not tracker.is_alive() and inserted.is_set()
    assert result == [("loop", None)] and lc.n_loops_closed == 1
    assert events == [("fuse", True), ("corrected", N_KF), ("insert", N_KF)]
    assert graph_counts == [(N_KF, N_KF), (N_KF, N_KF)]
    assert len(queued) == 1 and world.n_kf == N_KF + 1


def test_merge_runs_under_the_lock():
    """The merge branch of process_keyframe (a stored map's candidate,
    verified): the merge runs while the caller's lock is held, the
    verification before it does not."""
    from orb_slam3_fast_tpu_torch.map.atlas import Atlas

    kfs, world, voc, kfdb, lc, point_lm = loop_map()
    atlas = Atlas(lambda: WorldMap(kp_cap=KP_CAP, max_kf=32, max_lm=4096))
    atlas.maps[atlas.current_id] = world
    for k in range(LOOP_START):
        atlas.register_kf(atlas.current_id, k)
    stored = atlas.current_id
    w_active = atlas.create_new_map()
    active = atlas.current_id
    lock = threading.RLock()
    seen = []
    S = lie.Sim3(torch.eye(3), torch.zeros(3), torch.tensor(1.0))
    lc.kfdb.detect_n_best_candidates = lambda *a, **kw: (np.zeros(0, np.int64), np.asarray([0]))
    atlas.resolve_row = lambda row: (stored, 0)

    def verify(*args):
        seen.append(("verify", held(lock)))
        return S, 30

    def merge(*args):
        seen.append(("merge", held(lock)))
        return {}

    lc._verify, lc._merge = verify, merge
    add_keyframe(w_active, kfs[0], 0, {}, packed=True)
    lc.cfg.temporal_gap = -2  # process the one-keyframe map
    out = []
    worker = threading.Thread(target=lambda: out.append(
        lc.process_keyframe(w_active, 0, map_id=active, atlas=atlas, map_lock=lock)))
    worker.start()
    worker.join(WAIT)
    assert out == [("merge", {})] and seen == [("verify", False), ("merge", True)]


def test_async_worker_passes_its_lock():
    """AsyncBackend's worker hands the loop closer its own map lock."""
    got = []
    mapper = Mapper(CAM, bf=0.0, device="cpu")
    mapper.process_new_keyframe = lambda world, k, **kw: None

    class Closer:
        def process_keyframe(self, world, k, map_id=0, atlas=None, map_lock=None):
            got.append(map_lock)
            return False

    backend = AsyncBackend(mapper, Closer())
    backend.insert_keyframe(WorldMap(kp_cap=8, max_kf=8), 0)
    assert backend.wait_idle(timeout=10)
    backend.shutdown()
    assert got == [backend.lock] and not backend.errors
