"""Asynchronous backend: local mapping and loop closing on a worker thread,
global bundle adjustment on a second one.

Counterpart of ``orb_slam3_fast_tpu/backend/pipeline.py`` (the reference's
thread pipeline, System.cc:221,241: LocalMapping and LoopClosing on their
own threads; LocalMapping.cc:906 skips the local BA when a new keyframe
waits; Tracking.cc:1884-1891 rebases the tracked pose through the
reference keyframe when the map changed under it):

* the worker thread ``slam-backend`` runs ``Mapper.process_new_keyframe``
  and then ``LoopCloser.process_keyframe`` per queued keyframe, and hands
  the loop closer's ("loop", None) / ("merge", info) events to ``results``
  for the tracker;
* the persistent thread ``slam-gba`` runs the global BA requests of the
  loop closer (``gba_hook``), only the newest one: a newer request aborts
  the one in flight between its LM segments;
* a queued keyframe whose map the Atlas has retired meanwhile (merged
  into another map by the loop closer of an earlier keyframe, or reset by
  the tracker) is dropped: mapping it would write into a map no one reads,
  and its loop closer would try to merge a map that is gone (the JAX
  package's worker fails there, ``Atlas.merge_into`` reading a retired
  map);
* one re-entrant map lock bounds the sections that touch the shared host
  map (the tracker's keyframe insertion, the workers' problem gathers and
  write-backs, the loop closer's whole correction and merge);
  ``map_version`` counts the workers' map updates, which the
  tracker compares with what it saw last;
* a worker's BA whose map the tracker turned and scaled between its
  gather and its write-back (the IMU initialisation, the scale
  refinement: ``WorldMap.frame_epoch``) is discarded and counted
  (``Mapper.n_ba_discarded``, ``InertialTracker.n_ba_discarded``).

Device work: each thread launches its kernels on a CUDA stream of its own,
entered for the thread's whole life, so that the tracker's frames, the
local BA and the global BA overlap on the card.  No device tensor crosses
threads: the map is host numpy, and each thread builds its device inputs
from it and reads its results back itself.  On the CPU the threads run the
plain versions.
"""
from __future__ import annotations

import contextlib
import threading
import time
import traceback
from collections import deque

import torch


def _own_stream(device: torch.device):
    """A new CUDA stream entered as the current one of the calling thread
    (on the CPU: nothing)."""
    if device.type != "cuda":
        return contextlib.nullcontext()
    return torch.cuda.stream(torch.cuda.Stream(device=device))


class AsyncBackend:
    def __init__(self, mapper, loopcloser=None, kfdb=None):
        self.mapper = mapper
        self.loopcloser = loopcloser
        self.kfdb = kfdb
        self.lock = threading.RLock()  # mMutexMapUpdate
        self.abort_ba = threading.Event()  # mbAbortBA (LocalMapping.cc:906)
        self.gba_abort = threading.Event()  # mbStopGBA (LoopClosing.cc:1072)
        self._queue: deque = deque()
        self._cv = threading.Condition()
        self._gba_queue: deque = deque()
        self._gba_cv = threading.Condition()
        self._stop = False
        self._busy = False
        self._gba_busy = False
        self.map_version = 0  # the map's change index (Map.cc:306-324)
        self.results: deque = deque()  # ("loop" | "merge", info) events for the tracker
        self.errors: list = []
        self.gba_completed = 0
        self.gba_aborted = 0
        self.n_retired_skipped = 0  # queued keyframes dropped because their map was retired meanwhile
        self._thread = threading.Thread(target=self._run, daemon=True, name="slam-backend")
        self._gba_thread = threading.Thread(target=self._run_gba_loop, daemon=True, name="slam-gba")
        self._thread.start()
        self._gba_thread.start()
        if loopcloser is not None:
            # the loop closer hands its global BA to the GBA thread instead of
            # blocking mapping and loop detection for the solve's duration
            loopcloser.gba_hook = self.request_gba

    # ------------------------------------------------------------------
    def insert_keyframe(self, world, k: int, map_id: int = 0, atlas=None):
        """LocalMapping::InsertKeyFrame (LocalMapping.cc:327): queue the
        keyframe and ask a local BA in flight to stop."""
        self.abort_ba.set()
        with self._cv:
            self._queue.append((world, k, map_id, atlas))
            self._cv.notify()

    def request_gba(self, thunk):
        """RunGlobalBundleAdjustment's dispatch (LoopClosing.cc:1327-1334):
        queue ``thunk(abort_flag=..., map_lock=...) -> bool`` for the GBA
        thread; a solve in flight is aborted first (:1072-1086, the newest
        loop correction supersedes it)."""
        with self._gba_cv:
            if self._gba_busy or self._gba_queue:
                self.gba_abort.set()
            self._gba_queue.append(thunk)
            self._gba_cv.notify()

    def gba_running(self) -> bool:
        with self._gba_cv:
            return self._gba_busy or bool(self._gba_queue)

    def queue_len(self) -> int:
        with self._cv:
            return len(self._queue) + (1 if self._busy else 0)

    def wait_idle(self, timeout: float | None = None) -> bool:
        """Block until the mapping and the GBA queues drain; False if
        ``timeout`` seconds passed first."""
        t0 = time.time()
        while True:
            with self._cv:
                main_idle = not self._queue and not self._busy
            if main_idle and not self.gba_running():
                return True
            if timeout is not None and time.time() - t0 > timeout:
                return False
            time.sleep(0.002)

    def shutdown(self):
        """Stop both threads once their queues are empty; an in-flight
        global BA stops at its next segment."""
        with self._cv:
            self._stop = True
            self._cv.notify()
        self.gba_abort.set()
        with self._gba_cv:
            self._gba_cv.notify()
        self._thread.join(timeout=30)
        self._gba_thread.join(timeout=30)

    # ------------------------------------------------------------------
    def _run(self):
        with _own_stream(self.mapper.device):
            while True:
                with self._cv:
                    while not self._queue and not self._stop:
                        self._cv.wait(timeout=0.05)
                    if self._stop and not self._queue:
                        return
                    world, k, map_id, atlas = self._queue.popleft()
                    self._busy = True
                self.abort_ba.clear()
                try:
                    with self.lock:
                        retired = atlas is not None and atlas.maps[map_id] is not world
                    if retired:  # its map was merged into another or reset after the keyframe was queued
                        self.n_retired_skipped += 1
                        continue
                    self.mapper.process_new_keyframe(world, k, kfdb=self.kfdb, map_lock=self.lock,
                                                     abort_flag=self.abort_ba)
                    if self.loopcloser is not None:
                        out = self.loopcloser.process_keyframe(world, k, map_id=map_id, atlas=atlas,
                                                               map_lock=self.lock)
                        if out:
                            self.results.append(out)
                    with self.lock:
                        self.map_version += 1
                except Exception:  # noqa: BLE001 -- a worker crash is reported to the caller
                    self.errors.append(traceback.format_exc())
                finally:
                    with self._cv:
                        self._busy = False

    def _run_gba_loop(self):
        """The GBA thread (the reference's per-loop GBA thread,
        LoopClosing.cc:1331; persistent here): only the newest request is
        served, a superseded one was aborted by ``request_gba``."""
        with _own_stream(self.mapper.device):
            while True:
                with self._gba_cv:
                    while not self._gba_queue and not self._stop:
                        self._gba_cv.wait(timeout=0.05)
                    if self._stop and not self._gba_queue:
                        return
                    while len(self._gba_queue) > 1:
                        self._gba_queue.popleft()
                        self.gba_aborted += 1
                    thunk = self._gba_queue.popleft()
                    self._gba_busy = True
                    # clear the abort inside the critical section, and only when
                    # no newer request came in: a request_gba() between the pop
                    # and the clear means to stop this very solve
                    if not self._gba_queue:
                        self.gba_abort.clear()
                try:
                    if thunk(abort_flag=self.gba_abort, map_lock=self.lock):
                        self.gba_completed += 1
                        with self.lock:
                            self.map_version += 1
                    else:
                        self.gba_aborted += 1
                except Exception:  # noqa: BLE001
                    self.errors.append(traceback.format_exc())
                finally:
                    with self._gba_cv:
                        self._gba_busy = False
