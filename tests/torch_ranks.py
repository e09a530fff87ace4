"""Ranks for the port's multi-rank tests on the CPU: ``world`` spawned
processes, each in one gloo process group (a FileStore under the test's
temporary directory, the loopback interface), one torch thread each, which
run the functions a test sends them and return their results.  A test
module spawns one group for all its cases (a module-scoped fixture); a
spawn costs a few seconds.  The functions run in the ranks must live in a
module that does not import jax (``tests/torch_dist_cases.py``)."""
from __future__ import annotations

import importlib
import multiprocessing as mp
import os
import traceback

TIMEOUT_S = 120  # a rank's answer to one job; the group's own timeout is shorter


def _serve(rank: int, world: int, store: str, inbox, outbox) -> None:
    os.environ["GLOO_SOCKET_IFNAME"] = "lo"
    import datetime

    import torch

    torch.set_num_threads(1)
    from orb_slam3_fast_tpu_torch.parallel import multihost

    multihost.initialize(f"file://{store}", world, rank, device="cpu", timeout=datetime.timedelta(seconds=60))
    while (job := inbox.get()) is not None:
        module, name, args = job
        try:
            outbox.put((True, getattr(importlib.import_module(module), name)(*args)))
        except BaseException:  # noqa: BLE001 -- the test reports the rank's traceback
            outbox.put((False, traceback.format_exc()))
    torch.distributed.destroy_process_group()


class Ranks:
    """``world`` ranks; ``run(fn, *args)`` runs ``fn(*args)`` on every rank
    at once and returns their results in rank order."""

    def __init__(self, world: int, tmp_dir):
        ctx = mp.get_context("spawn")
        store = os.path.join(str(tmp_dir), "store")
        self.inboxes = [ctx.Queue() for _ in range(world)]
        self.outboxes = [ctx.Queue() for _ in range(world)]
        self.procs = [ctx.Process(target=_serve, args=(r, world, store, self.inboxes[r], self.outboxes[r]), daemon=True)
                      for r in range(world)]
        for p in self.procs:
            p.start()

    def run(self, fn, *args) -> list:
        for q in self.inboxes:
            q.put((fn.__module__, fn.__name__, args))
        out = [q.get(timeout=TIMEOUT_S) for q in self.outboxes]
        failed = [f"rank {r}:\n{res}" for r, (ok, res) in enumerate(out) if not ok]
        if failed:
            raise AssertionError("\n".join(failed))
        return [res for _, res in out]

    def close(self) -> None:
        for q in self.inboxes:
            q.put(None)
        for p in self.procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
