"""The port's WorldMap (packed descriptors, host C++ through its own build
of native/map_ops.cpp) against the JAX package's WorldMap under one
scripted sequence of keyframe / landmark / observation edits, and .npz maps
crossing between the two packages."""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from orb_slam3_fast_tpu.map.worldmap import WorldMap as JMap
from orb_slam3_fast_tpu_torch import native as tnative
from orb_slam3_fast_tpu_torch.map import worldmap as twm

torch.set_num_threads(1)

N = 64  # keypoint slots


def _kp(rng):
    bits = rng.integers(0, 2, (N, 256)).astype(np.int8)
    common = dict(
        xy=rng.uniform(0, 300, (N, 2)).astype(np.float32), level=rng.integers(0, 8, N).astype(np.int32),
        angle=rng.uniform(-3, 3, N).astype(np.float32), valid=rng.uniform(size=N) > 0.1,
    )
    return SimpleNamespace(desc=bits, **common), SimpleNamespace(desc=twm.pack_bits(bits), **common)


def scripted(rng):
    """The same edits on a JAX map and a port map; small capacities so both
    grow.  Returns (jax map, port map)."""
    maps = JMap(kp_cap=N, max_kf=2, max_lm=16), twm.WorldMap(kp_cap=N, max_kf=2, max_lm=16)
    for k in range(5):
        R = np.eye(3, dtype=np.float32)
        t = np.array([0.3 * k, 0.0, 0.1 * k], np.float32)
        jk, tk = _kp(rng)
        depth = rng.uniform(1, 9, N).astype(np.float32)
        for m, kp in zip(maps, (jk, tk)):
            assert m.add_keyframe(kp, R, t, 0.1 * k, depth=depth, right_u=depth - 3) == k
    for k, (lo, n) in enumerate([(0, 20), (5, 15), (10, 12)]):
        pos = rng.uniform(-2, 2, (n, 3)).astype(np.float32) + np.array([0, 0, 6], np.float32)
        slots = rng.choice(N, n, replace=False)
        bits = rng.integers(0, 2, (n, 256)).astype(np.int8)
        lvl = rng.integers(0, 8, n).astype(np.int32)
        ids_j = maps[0].add_landmarks(pos, bits, k, slots, lvl)
        ids_t = maps[1].add_landmarks(pos, twm.pack_bits(bits), k, slots, lvl)
        np.testing.assert_array_equal(ids_j, ids_t)
    for k in range(1, 5):  # observations of older landmarks, some slots taken twice
        slots = rng.choice(N, 25, replace=False)
        lm = rng.integers(0, 47, 25).astype(np.int32)
        for m in maps:
            m.add_observations(k, slots, lm)
    pairs = [(3, 7), (7, 12), (20, 21), (30, 2)]
    for m in maps:
        m.replace_landmarks(pairs)
        m.remove_landmarks(np.array([4, 33], np.int32))
        m.update_landmark_stats(np.arange(47))
        m.remove_keyframe(2)
        m.lm_visible[:40] += 3
        m.lm_found[:40] += 1
    return maps


def _same_tables(jm, tm):
    assert (jm.n_kf, jm.n_lm, jm.max_kf, jm.max_lm) == (tm.n_kf, tm.n_lm, tm.max_kf, tm.max_lm)
    for name in ("kf_valid", "kf_R", "kf_t", "kf_xy", "kf_level", "kf_obs", "kf_kp_valid", "kf_depth",
                 "lm_valid", "lm_pos", "lm_first_kf", "lm_n_obs", "lm_found", "lm_visible"):
        np.testing.assert_array_equal(getattr(tm, name), getattr(jm, name), err_msg=name)
    for name in ("lm_normal", "lm_dmin", "lm_dmax"):
        np.testing.assert_allclose(getattr(tm, name), getattr(jm, name), rtol=1e-6, atol=1e-7, err_msg=name)
    np.testing.assert_array_equal(twm.unpack_bits(tm.kf_desc), jm.kf_desc)
    np.testing.assert_array_equal(twm.unpack_bits(tm.lm_desc), jm.lm_desc)


def test_scripted_sequence_matches_jax():
    jm, tm = scripted(np.random.default_rng(0))
    _same_tables(jm, tm)
    for k in range(jm.n_kf):
        np.testing.assert_array_equal(tm.covisibility_counts(k), jm.covisibility_counts(k))
        np.testing.assert_array_equal(tm.best_covisible(k, 3, min_shared=2), jm.best_covisible(k, 3, min_shared=2))
    kfs = np.array([0, 1, 3, 4])
    np.testing.assert_array_equal(tm.local_landmarks(kfs), jm.local_landmarks(kfs))
    lm = jm.local_landmarks(kfs)
    for x, y in zip(tm.observations_of(lm, kfs), jm.observations_of(lm, kfs)):
        np.testing.assert_array_equal(x, y)
    assert jm.lm_valid.sum() > 30 and (jm.kf_obs >= 0).sum() > 100


def test_numpy_fallback_matches_native(monkeypatch):
    """Without a toolchain the port takes the JAX package's numpy fallback."""
    assert tnative.get_lib() is not None  # g++ is on this machine
    native_map = scripted(np.random.default_rng(1))[1]
    monkeypatch.setattr(tnative, "_lib", False)
    numpy_map = scripted(np.random.default_rng(1))[1]
    for name in ("kf_obs", "lm_n_obs", "lm_valid"):
        np.testing.assert_array_equal(getattr(numpy_map, name), getattr(native_map, name))
    for name in ("lm_normal", "lm_dmin", "lm_dmax"):
        np.testing.assert_allclose(getattr(numpy_map, name), getattr(native_map, name), rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(numpy_map.covisibility_counts(0), native_map.covisibility_counts(0))


def test_pack_roundtrip_matches_torch_layout():
    bits = np.random.default_rng(2).integers(0, 2, (10, 256)).astype(np.int8)
    from orb_slam3_fast_tpu_torch.ops.hamming import pack_desc

    np.testing.assert_array_equal(twm.pack_bits(bits), pack_desc(torch.as_tensor(bits)).numpy())
    np.testing.assert_array_equal(twm.unpack_bits(twm.pack_bits(bits)), bits)
    x = twm.pack_bits(bits)
    np.testing.assert_array_equal(twm.popcount_words(x[:, None] ^ x[None]), (bits[:, None] != bits[None]).sum(-1))


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_saved_maps_cross_packages(tmp_path, direction):
    jm, tm = scripted(np.random.default_rng(3))
    path = str(tmp_path / "map.npz")
    if direction == "port_to_jax":
        tm.save(path)
        _same_tables(JMap.load(path), tm)
    else:
        jm.save(path)
        loaded = twm.WorldMap.load(path)
        _same_tables(jm, loaded)
        assert loaded.kf_desc.dtype == np.int32 and loaded.kf_desc.shape[-1] == 8


def _inertial_state(rng, jm, tm):
    """The same inertial state on both maps: velocities, biases, two stored
    windows (JAX Preintegrated on one, the port's on the other) and the
    initialised flag."""
    import jax.numpy as jnp

    from orb_slam3_fast_tpu.imu import preintegration as jpre
    from orb_slam3_fast_tpu_torch.utils import convert

    noise = jpre.ImuNoise.from_continuous(1.7e-4, 2e-3, 1.9e-5, 3e-3, 200.0)
    for m in (jm, tm):
        m.kf_vel[: m.n_kf] = np.arange(3 * m.n_kf, dtype=np.float32).reshape(-1, 3) * 0.1
        m.kf_bias[: m.n_kf] = 0.01
        m.imu_initialized = True
    for k in (1, 2):
        p = jpre.preintegrate(jnp.asarray(rng.normal(size=(8, 3)), jnp.float32),
                              jnp.asarray(rng.normal(size=(8, 3)) * 0.1, jnp.float32), jnp.full((8,), 0.005),
                              jnp.zeros(6), noise)
        jm.kf_preint[k] = p
        tm.kf_preint[k] = convert.inertial_to_torch(p)


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_inertial_maps_cross_packages(tmp_path, direction):
    """A map with stored preintegration windows, velocities, biases and the
    initialised flag, saved by one package and loaded by the other: every
    field of every window equal, the state equal."""
    jm, tm = scripted(np.random.default_rng(3))
    _inertial_state(np.random.default_rng(4), jm, tm)
    path = str(tmp_path / "map.npz")
    src, load = (tm, JMap.load) if direction == "port_to_jax" else (jm, twm.WorldMap.load)
    src.save(path)
    loaded = load(path)
    _same_tables(*((loaded, src) if direction == "port_to_jax" else (src, loaded)))
    assert loaded.imu_initialized and sorted(loaded.kf_preint) == [1, 2]
    for k in (1, 2):
        for f, a, b in zip(loaded.kf_preint[k]._fields, loaded.kf_preint[k], src.kf_preint[k]):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=f)
    np.testing.assert_array_equal(loaded.kf_vel, src.kf_vel)
    np.testing.assert_array_equal(loaded.kf_bias, src.kf_bias)


def test_apply_scaled_rotation_and_removal_match_jax():
    """The gauge transform after IMU initialisation, and a removed keyframe
    dropping its window, as the JAX map does them."""
    jm, tm = scripted(np.random.default_rng(5))
    _inertial_state(np.random.default_rng(6), jm, tm)
    R = np.asarray([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]], np.float32)
    jm.apply_scaled_rotation(R, 1.7)
    tm.apply_scaled_rotation(R, 1.7)
    _same_tables(jm, tm)
    np.testing.assert_array_equal(tm.kf_vel, jm.kf_vel)
    assert tm.change_index == jm.change_index
    jm.remove_keyframe(2)
    tm.remove_keyframe(2)
    assert sorted(tm.kf_preint) == sorted(jm.kf_preint) == [1]


def test_map_ops_source_is_the_jax_packages():
    """The port compiles its own copy of the map's host C++, byte for byte
    the JAX package's: a later edit to either shows here."""
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    port_src = root / "orb_slam3_fast_tpu_torch" / "native" / "map_ops.cpp"
    assert tnative._SRC == port_src.resolve()
    assert port_src.read_bytes() == (root / "orb_slam3_fast_tpu" / "native" / "map_ops.cpp").read_bytes()
