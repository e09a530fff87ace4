"""Multi-process runtime: the ``torch.distributed`` process group and the
rank's mesh.

Counterpart of ``orb_slam3_fast_tpu/parallel/multihost.py`` (``initialize``
:30, ``global_mesh`` :83, ``process_info`` :93).  The JAX package scales
by SPMD over a device mesh; here every rank is one process running the same
program, holding its shard of the observations (``parallel/dist_ba.py``) or
of the keyframe database's rows (``parallel/dist_kfdb.py``), and reducing
with collectives.

Usage, one process per rank (``torchrun --nproc-per-node N script.py``, or
explicit arguments):

    from orb_slam3_fast_tpu_torch.parallel import multihost
    multihost.initialize()              # False and nothing done in a lone process
    mesh = multihost.global_mesh()      # this rank, the world, its card, the group

Backend: ``nccl`` where each rank of the host has its own card; ``gloo`` for
CPU tensors and for ranks that share one card (NCCL refuses two ranks on one
device).  The choice follows from the counts and is logged; it is never made
by catching a failure.  Divergence from the JAX package: where its
``initialize`` prints a message and goes on with a per-host mesh after a
failed bring-up (``multihost.py:60-78``), this one raises, and a partial
torchrun environment raises too.  Every collective has the process group's
timeout, so ranks that diverge fail instead of hanging.
"""
from __future__ import annotations

import datetime
import os
import time
from dataclasses import dataclass, field

import torch
import torch.distributed as dist

from orb_slam3_fast_tpu_torch.utils import verbose

TIMEOUT = datetime.timedelta(seconds=300)
_TORCHRUN = ("RANK", "WORLD_SIZE", "MASTER_ADDR")


def choose_backend(cpu: bool, local_world: int) -> str:
    """``gloo`` for CPU tensors or where the host's ranks outnumber its
    cards, else ``nccl``."""
    if cpu or not torch.cuda.is_available() or local_world > torch.cuda.device_count():
        return "gloo"
    return "nccl"


def initialize(init_method: str | None = None, world_size: int | None = None, rank: int | None = None,
               device: torch.device | str | None = None, timeout: datetime.timedelta = TIMEOUT) -> bool:
    """Bring up the process group.  A lone process (no torchrun variables
    ``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR`` and no ``init_method``), or
    one whose group is already up, is a no-op returning False.  Explicit:
    ``init_method`` ("tcp://localhost:PORT", "file://PATH"), ``world_size``
    and ``rank``.  ``device`` "cpu" asks for CPU tensors (gloo).  Raises
    where the bring-up fails."""
    if dist.is_initialized():
        return False
    present = [v for v in _TORCHRUN if os.environ.get(v)]
    if init_method is None:
        if not present:
            return False
        if len(present) < len(_TORCHRUN):
            raise ValueError(f"multihost: a partial torchrun environment ({present} of {list(_TORCHRUN)})")
        init_method, world_size, rank = "env://", int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
    if world_size is None or rank is None:
        raise ValueError("multihost: an explicit init_method needs world_size and rank")
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world_size))
    cpu = device is not None and torch.device(device).type == "cpu"
    backend = choose_backend(cpu, local_world)
    if not cpu and torch.cuda.is_available():
        torch.cuda.set_device(local_rank % torch.cuda.device_count())
    verbose.print_mess(f"multihost: rank {rank} of {world_size}, backend {backend} ({local_world} ranks on this host, "
                       f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} cards, cpu {cpu})")
    dist.init_process_group(backend, init_method=init_method, world_size=world_size, rank=rank, timeout=timeout)
    return True


def backend() -> str | None:
    """The process group's backend, or None in a lone process."""
    return dist.get_backend() if dist.is_initialized() else None


def process_info() -> tuple[int, int]:
    """(rank, world size); (0, 1) in a lone process."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


@dataclass
class CollectiveLog:
    """The collectives a mesh ran: their count, and with ``timed`` a CUDA
    event pair around each on the current stream and the host's seconds
    inside them, so that their time can be read apart from the kernels'."""
    timed: bool = False
    calls: int = 0
    events: list = field(default_factory=list)
    host_s: float = 0.0

    def ms(self) -> float:
        """Milliseconds inside the timed collectives (the stream must have
        reached them: synchronise first)."""
        return sum(a.elapsed_time(b) for a, b in self.events)

    def reset(self) -> None:
        self.calls, self.events, self.host_s = 0, [], 0.0


@dataclass
class Mesh:
    """One rank's view of the job: its rank, the world size, its device and
    the process group (None in a lone process, where the collectives are the
    identity, as the JAX package's ``_noreduce`` is, ``optim/ba_cg.py:43``)."""
    rank: int
    world: int
    device: torch.device
    group: object | None
    log: CollectiveLog = field(default_factory=CollectiveLog)

    def _run(self, t: torch.Tensor, fn):
        self.log.calls += 1
        if self.log.timed and t.is_cuda:
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            h = time.perf_counter()
            out = fn()
            self.log.host_s += time.perf_counter() - h
            b.record()
            self.log.events.append((a, b))
            return out
        return fn()

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` over the ranks in place; every rank gets the same bits."""
        if self.group is None:
            return t
        return self._run(t, lambda: (dist.all_reduce(t, group=self.group), t)[1])

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's ``t`` concatenated along dim 0 in rank order (bool
        tensors travel as bytes)."""
        if self.group is None:
            return t
        x = t.to(torch.uint8) if t.dtype == torch.bool else t.contiguous()

        def gather():
            parts = [torch.empty_like(x) for _ in range(self.world)]
            dist.all_gather(parts, x, group=self.group)
            return torch.cat(parts)

        out = self._run(x, gather)
        return out.bool() if t.dtype == torch.bool else out


def _rank_device(device: torch.device | str | None) -> torch.device:
    """The rank's device: the CPU where asked for, else the given card or
    ``cuda:LOCAL_RANK % device_count()``."""
    dev = torch.device(device if device is not None else "cuda")
    if dev.type == "cpu":
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError("multihost: PyTorch sees no CUDA card; pass device='cpu' to run on the CPU")
    if dev.index is not None:
        return dev
    local_rank = int(os.environ.get("LOCAL_RANK", process_info()[0]))
    return torch.device("cuda", local_rank % torch.cuda.device_count())


def global_mesh(device: torch.device | str | None = None) -> Mesh:
    """This rank's mesh over the whole job (a world of one in a lone
    process)."""
    rank, world = process_info()
    return Mesh(rank, world, _rank_device(device), dist.group.WORLD if dist.is_initialized() else None)
