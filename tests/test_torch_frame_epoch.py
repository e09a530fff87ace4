"""A bundle adjustment that straddles a change of the map's frame.

On the async backend the worker gathers a local or global BA under the map
lock, solves it outside the lock and writes it back under the lock; the
tracker's IMU initialisation (and scale refinement) turns and scales the
whole map under the same lock (``WorldMap.apply_scaled_rotation``).  A
solve gathered before such a change is in the old frame: the mapper
discards it and counts the discard, and the map keeps the transformed
state.  Here the interleaving is forced on the CPU: the solve itself turns
the map first, as the tracker would while the worker solves."""
import threading
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from orb_slam3_fast_tpu_torch.backend import mapper as mapper_mod
from orb_slam3_fast_tpu_torch.cameras import models as cm
from orb_slam3_fast_tpu_torch.map.worldmap import WorldMap
from orb_slam3_fast_tpu_torch.utils import lie

torch.set_num_threads(1)

N_KP, N_LM, FX = 128, 96, 400.0
CAM = cm.Camera.pinhole(FX, FX, 320.0, 240.0)


def small_world():
    """Three keyframes 0.3 m apart along x, 96 landmarks seen by all three
    at their pixels (0.5 px noise), the landmarks and the last two poses
    perturbed, so that a BA moves them."""
    rng = np.random.default_rng(0)
    X = np.stack([rng.uniform(-2, 2, N_LM), rng.uniform(-1.5, 1.5, N_LM), rng.uniform(4, 9, N_LM)], -1)
    world = WorldMap(kp_cap=N_KP)
    slots = np.arange(N_LM)
    for k in range(3):
        t = np.array([-0.3 * k, 0.0, 0.0])
        uv = FX * (X[:, :2] + t[:2]) / X[:, 2:] + [320.0, 240.0] + rng.normal(0, 0.5, (N_LM, 2))
        xy = np.zeros((N_KP, 2), np.float32)
        xy[:N_LM] = uv
        kp = SimpleNamespace(xy=xy, level=np.zeros(N_KP, np.int32), angle=np.zeros(N_KP, np.float32),
                             desc=np.zeros((N_KP, 8), np.int32), valid=np.arange(N_KP) < N_LM)
        t0 = t + (rng.normal(0, 0.02, 3) if k else 0.0)
        world.add_keyframe(kp, np.eye(3, dtype=np.float32), t0.astype(np.float32), 0.1 * k)
    pos = (X + rng.normal(0, 0.05, X.shape)).astype(np.float32)
    ids = world.add_landmarks(pos, np.zeros((N_LM, 8), np.int32), 0, slots, np.zeros(N_LM, np.int32))
    for k in (1, 2):
        world.add_observations(k, slots, ids)
    return world


def state(world):
    return world.kf_R[: world.n_kf].copy(), world.kf_t[: world.n_kf].copy(), world.lm_pos[: world.n_lm].copy()


def run(world, mapper, which, lock):
    ids = np.arange(world.n_kf)
    if which == "local":
        mapper._run_ba(world, ids, fixed=np.asarray([0]), iters=(2, 2), map_lock=lock)
        return None
    return mapper._run_gba(world, ids, fixed=np.asarray([0]), iters=(2, 2), map_lock=lock, cg_iters=8)


@pytest.mark.parametrize("which", ["local", "global"])
def test_solve_across_a_frame_change_is_discarded(monkeypatch, which):
    """The gather, then the map turned and scaled under the lock, then the
    write-back: nothing is written, the map keeps the transformed poses
    and landmarks bit for bit, the discard is counted and the BA is not
    counted as done (the global BA reports False).  Without the turn the
    same BA writes its poses and landmarks back."""
    lock = threading.RLock()
    module, name = (mapper_mod.ba, "bundle_adjust") if which == "local" else (mapper_mod.ba_cg, "bundle_adjust_cg")
    solve = getattr(module, name)

    world = small_world()
    mapper = mapper_mod.Mapper(CAM, 0.0, device="cpu")
    before = state(world)
    done = run(world, mapper, which, lock)
    assert mapper.n_ba_discarded == 0 and (done or which == "local")
    assert mapper.n_local_ba == (1 if which == "local" else 0)
    assert not np.array_equal(state(world)[1], before[1]) and not np.array_equal(state(world)[2], before[2])

    world = small_world()
    mapper = mapper_mod.Mapper(CAM, 0.0, device="cpu")
    R_turn = lie.so3_exp(torch.tensor([0.1, -0.2, 0.3])).numpy()
    turned = {}

    def solve_across_a_turn(*args, **kwargs):
        with lock:  # the tracker's IMU initialisation, while the worker solves
            world.apply_scaled_rotation(R_turn, 1.7)
            turned["state"] = state(world)
        return solve(*args, **kwargs)

    monkeypatch.setattr(module, name, solve_across_a_turn)
    epoch = world.frame_epoch
    done = run(world, mapper, which, lock)
    assert world.frame_epoch == epoch + 1
    assert mapper.n_ba_discarded == 1 and mapper.n_local_ba == 0 and not done
    for got, want in zip(state(world), turned["state"]):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(world.lm_pos[: world.n_lm], 1.7 * before[2] @ R_turn.T, rtol=1e-5, atol=1e-5)
