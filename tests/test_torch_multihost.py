"""The port's multi-process runtime (orb_slam3_fast_tpu_torch/parallel/
multihost.py) against the JAX package's (tests/test_multihost.py): the
lone-process no-op, ``process_info``, the mesh of a world of one (its
collectives the identity), the backend rule, and, in one pair of gloo
ranks spawned for the module, the group's view, its collectives and what
a world above one refuses (an async System, FullInertialBA).

Divergence from the JAX package, named: where its ``initialize`` prints a
message and goes on with a per-host mesh after a failed bring-up
(orb_slam3_fast_tpu/parallel/multihost.py:60-78), the port raises, and a
partial torchrun environment raises too (``test_failed_bringup_raises``).
The JAX side of that case is not run: it would look for a coordinator."""
import datetime
import socket

import jax
import numpy as np
import pytest
import torch

from orb_slam3_fast_tpu.parallel import multihost as jmh
from orb_slam3_fast_tpu_torch.parallel import multihost
from tests import torch_dist_cases as cases
from tests.torch_ranks import Ranks

torch.set_num_threads(1)

TORCHRUN = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT", "LOCAL_RANK", "LOCAL_WORLD_SIZE")


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    r = Ranks(2, tmp_path_factory.mktemp("multihost_ranks"))
    yield r
    r.close()


@pytest.fixture
def lone(monkeypatch):
    for v in TORCHRUN:
        monkeypatch.delenv(v, raising=False)


def test_initialize_lone_process_noop(lone):
    """No torchrun variables, no arguments: False and nothing brought up,
    (0, 1), as the JAX package's single-host no-op."""
    assert jmh.initialize() is False and jmh.process_info() == (0, 1)
    assert multihost.initialize() is False
    assert multihost.process_info() == (0, 1) and multihost.backend() is None
    assert not torch.distributed.is_initialized()


def test_world_of_one_mesh_reduces_by_identity(lone):
    """A lone process's mesh: rank 0 of 1 on the device asked for, no group,
    its collectives the identity (the JAX package's _noreduce); the JAX
    package's global mesh spans its 8 virtual devices on one axis."""
    mesh = multihost.global_mesh("cpu")
    assert (mesh.rank, mesh.world, mesh.device.type, mesh.group) == (0, 1, "cpu", None)
    x = torch.arange(4.0)
    assert mesh.all_reduce(x) is x and mesh.all_gather(x) is x and mesh.log.calls == 0
    jmesh = jmh.global_mesh()
    assert jmesh.devices.size == len(jax.devices()) and jmesh.axis_names == ("obs",)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        multihost.global_mesh()  # the card by default, which this machine lacks


def test_backend_rule(monkeypatch):
    """gloo for CPU tensors and where the host's ranks outnumber its cards,
    nccl where each rank has its own card; decided from the counts."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert [multihost.choose_backend(False, n) for n in (1, 4, 8)] == ["nccl", "nccl", "gloo"]
    assert multihost.choose_backend(True, 1) == "gloo"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert multihost.choose_backend(False, 1) == "gloo"


def test_failed_bringup_raises(lone, monkeypatch):
    """A partial torchrun environment raises at once; a full one whose
    master never answers raises at the group's timeout, where the JAX
    package would print and return False."""
    monkeypatch.setenv("RANK", "1")
    with pytest.raises(ValueError, match="partial torchrun environment"):
        multihost.initialize()
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("MASTER_ADDR", "localhost")
    monkeypatch.setenv("MASTER_PORT", str(port))
    with pytest.raises(Exception, match="timed out|Timed out|timeout"):
        multihost.initialize(device="cpu", timeout=datetime.timedelta(seconds=1))
    assert not torch.distributed.is_initialized()


def test_two_ranks_group_and_collectives(ranks):
    """Each rank: its (rank, 2), gloo, a float64 all_reduce summing the
    ranks' tensors and all_gather concatenating them in rank order (bool
    too), the same on both ranks."""
    out = ranks.run(cases.collectives)
    for r, o in enumerate(out):
        assert o["info"] == (r, 2) and o["backend"] == "gloo" and o["world"] == 2
        np.testing.assert_array_equal(o["summed"], [10.0, 12.0, 14.0])
        np.testing.assert_array_equal(o["gathered"], [0.0, 1.0, 2.0, 10.0, 11.0, 12.0])
        np.testing.assert_array_equal(o["flags"], [True, True, False, True])


def test_two_ranks_refuse_async_system_and_full_inertial_ba(ranks):
    """On a world of two an async-backend System raises ValueError at
    construction (its worker threads would schedule differently on each
    rank), and FullInertialBA raises NotImplementedError naming ROADMAP
    item 12's remainder."""
    for msgs in ranks.run(cases.refusals):
        assert len(msgs) == 2
        assert "async_backend=False" in msgs[0] and "collectives would not match" in msgs[0]
        assert "ROADMAP §A item 12" in msgs[1]
