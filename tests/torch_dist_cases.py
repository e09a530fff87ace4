"""The functions the port's multi-rank tests run on every rank
(``tests/torch_ranks.py``), and at a world of one in the test's own
process.  Only the port and numpy here: the ranks do not import jax."""
from __future__ import annotations

import numpy as np
import torch

from orb_slam3_fast_tpu_torch.cameras import models as cm
from orb_slam3_fast_tpu_torch.optim import ba
from orb_slam3_fast_tpu_torch.parallel import dist_ba, multihost


def mesh():
    return multihost.global_mesh("cpu")


def problem(arrays: dict) -> ba.BAProblem:
    """A port BAProblem on the CPU from the JAX package's arrays (numpy)."""
    return ba.make_problem(*(np.array(arrays[f]) for f in dist_ba.STATE + dist_ba.OBS), device="cpu")


def ba_run(arrays: dict, cam_args: tuple, bf: float, form: str, kwargs: dict) -> tuple:
    """The dense ("dense") or CG ("cg") distributed BA of this rank's shard
    of ``arrays``, built fresh: (R, t, xw, inlier, cost) as numpy."""
    m = mesh()
    cam = cm.Camera.pinhole(*cam_args)
    prob = problem(arrays)
    if form == "dense":
        run, shard = dist_ba.make_distributed_ba(m, cam, bf, **kwargs), dist_ba.shard_problem(prob, m, whole=True)
    else:
        run, shard = dist_ba.make_distributed_ba_cg(m, cam, bf, **kwargs), dist_ba.shard_problem(prob, m)
    R, t, xw, inlier, cost = run(shard)
    return R.numpy(), t.numpy(), xw.numpy(), inlier.numpy(), float(cost)


def collectives() -> dict:
    """This rank's view of the group and one all_reduce and all_gather."""
    m = mesh()
    x = torch.arange(3, dtype=torch.float64) + 10 * m.rank
    return dict(info=multihost.process_info(), backend=multihost.backend(), world=m.world,
                summed=m.all_reduce(x.clone()).numpy(), gathered=m.all_gather(x).numpy(),
                flags=m.all_gather(torch.tensor([m.rank == 0, True])).numpy())


def refusals() -> list:
    """The messages of what a world above one refuses: an async System."""
    from orb_slam3_fast_tpu_torch.slam.system import System

    out = []
    try:
        System("configs/synthetic_mono.yaml", "monocular", device="cpu")
    except ValueError as e:
        out.append(str(e))
    return out


def small_full_inertial_ba() -> tuple:
    """FullInertialBA through the inertial tracker's hook on chip_smoke's
    inertial world cut to 8 keyframes (keyframe 0 fixed, 2 + 2 LM steps, 8
    CG iterations) at this rank's world: (completed, the keyframe poses
    and velocities after it, their distance from the truth before and
    after)."""
    import chip_smoke

    w, _, p_gt, _ = chip_smoke.inertial_world(np.random.default_rng(5), n_kf=8, n_lm=80, obs_per_kf=32)
    before = float(np.abs(chip_smoke.body_positions(w, 8) - p_gt).max())
    done = chip_smoke.inertial_tracker(w, "cpu")._full_inertial_ba(w, np.asarray([0]), iters=(2, 2), cg_iters=8)
    after = float(np.abs(chip_smoke.body_positions(w, 8) - p_gt).max())
    return done, w.kf_R[:8].copy(), w.kf_t[:8].copy(), w.kf_vel[:8].copy(), before, after


def vi_problem(arrays: dict):
    """A port VIBAProblem on the CPU from ``convert.inertial_to_numpy``'s
    arrays."""
    from orb_slam3_fast_tpu_torch.imu.preintegration import Preintegrated
    from orb_slam3_fast_tpu_torch.optim.vi_ba import VIBAProblem

    def t(a):
        return torch.as_tensor(np.array(a))

    return VIBAProblem(**{f: t(arrays[f]) for f in VIBAProblem._fields if f != "preint"},
                       preint=Preintegrated(**{k: t(v) for k, v in arrays["preint"].items()}))


def identity_T_cb():
    from orb_slam3_fast_tpu_torch.utils import lie

    return lie.SE3.identity("cpu")


def vi_run(arrays: dict, cam_args: tuple, bf: float, kwargs: dict) -> tuple:
    """FullInertialBA over this rank's shard of ``arrays`` (camera = body),
    built fresh: (R, p, v, bias, xw, inlier) as numpy."""
    m = mesh()
    run = dist_ba.make_distributed_vi_ba_cg(m, cm.Camera.pinhole(*cam_args), bf, identity_T_cb(), **kwargs)
    return tuple(x.numpy() for x in run(dist_ba.shard_vi_problem(vi_problem(arrays), m)))


def vi_step(arrays: dict, cam_args: tuple, bf: float, cg_iters: int) -> tuple:
    """One plain LM step of FullInertialBA on this rank's shard, its hooks
    the mesh's all_reduce: (R, p, v, bias, xw, lam, cost) as numpy."""
    m = mesh()
    shard = dist_ba.shard_vi_problem(vi_problem(arrays), m)
    loc = shard.local
    inl = torch.ones(loc.obs_kf.shape[0], dtype=torch.bool)
    out = dist_ba.lm_segment_vi_shard(cm.Camera.pinhole(*cam_args), bf, identity_T_cb(), loc, loc.R_wb, loc.p_wb,
                                      loc.v_w, loc.bias, loc.xw, inl, torch.tensor(1e-4), 1, cg_iters, mesh=m,
                                      csr=shard.csr)
    return tuple(x.numpy() for x in out)


def vi_solve(arrays: dict, blocks: dict, cg_iters: int) -> tuple:
    """``_implicit_vi_solve`` on whole blocks (``blocks``: Hpp, Hll, bp, bl,
    Hii, Hjj, Hij, g, w_lm) and this rank's rows of the per-observation W,
    its hooks the mesh's all_reduce: (dx, dl) as numpy."""
    from orb_slam3_fast_tpu_torch.optim import vi_ba_cg

    m = mesh()
    loc = dist_ba.shard_vi_problem(vi_problem(arrays), m).local
    W = torch.as_tensor(np.array(blocks["W"]))
    W = torch.cat([W, W.new_zeros((-W.shape[0] % m.world, 6, 3))])
    n = W.shape[0]
    W = W[m.rank * n // m.world:(m.rank + 1) * n // m.world]
    b = {k: torch.as_tensor(np.array(v)) for k, v in blocks.items() if k != "W"}
    dx, dl = vi_ba_cg._implicit_vi_solve(b["Hpp"], b["Hll"], b["bp"], b["bl"], W, b["Hii"], b["Hjj"], b["Hij"], b["g"],
                                         loc.obs_kf, loc.obs_lm, loc.edge_i, loc.edge_j, b["w_lm"], loc.state_fixed,
                                         loc.lm_valid, torch.tensor(1e-4), cg_iters, reduce_k=m.all_reduce,
                                         reduce_m=m.all_reduce)
    return dx.numpy(), dl.numpy()


def vi_tracker_full_ba(map_path: str, cam_args: tuple, noise_args: tuple, fixed: list) -> tuple:
    """``InertialTracker._full_inertial_ba`` over every keyframe of the saved
    inertial map (camera = body, a mapper) at this rank's world:
    (completed, kf_R, kf_t, kf_vel, kf_bias, lm_pos, kf_obs after it)."""
    from orb_slam3_fast_tpu_torch.backend.mapper import Mapper
    from orb_slam3_fast_tpu_torch.frontend.vi_tracker import InertialTracker
    from orb_slam3_fast_tpu_torch.imu import preintegration as pre
    from orb_slam3_fast_tpu_torch.map.worldmap import WorldMap

    w = WorldMap.load(map_path)
    cam = cm.Camera.pinhole(*cam_args)
    tracker = InertialTracker(cam, world=w, noise=pre.ImuNoise.from_continuous(*noise_args),
                              mapper=Mapper(cam, bf=0.0, device="cpu"), device="cpu")
    done = tracker._full_inertial_ba(w, fixed_ids=np.asarray(fixed))
    K, M = w.n_kf, w.n_lm
    return (done, w.kf_R[:K].copy(), w.kf_t[:K].copy(), w.kf_vel[:K].copy(), w.kf_bias[:K].copy(),
            w.lm_pos[:M].copy(), w.kf_obs[:K].copy())


def kfdb_rows(n_words: int, n_rows: int, seed: int):
    """``n_rows`` random L1-normalised BoW vectors, a fifth of the words
    each, drawn as tests/test_dist_kfdb.py's ``_mk_db`` draws them."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_rows):
        bow = rng.uniform(0, 1, n_words).astype(np.float32)
        bow[rng.uniform(0, 1, n_words) < 0.8] = 0.0
        bow /= max(bow.sum(), 1e-9)
        out.append(bow)
    return out


def make_db(n_words: int, max_kf: int, bows: list, attach: bool):
    """A port KeyFrameDatabase with ``bows`` added (rows 0, 1, ...), mirrored
    onto this rank's mesh first where ``attach``."""
    from orb_slam3_fast_tpu_torch.vocab import database as tdb

    db = tdb.KeyFrameDatabase(n_words, max_kf=max_kf)
    if attach:
        db.attach_mesh(mesh())
    for k, bow in enumerate(bows):
        db.add(k, bow, map_id=0)
    return db


def kfdb_scores(n_words: int, max_kf: int, bows: list, query: np.ndarray, exclude: list) -> tuple:
    """The sharded database's (common, score, eligible) for ``query``, and
    the rows this rank holds, [lo, hi)."""
    db = make_db(n_words, max_kf, bows, attach=True)
    c, s, e = db._scores(query, np.asarray(exclude))
    return c, s, e, db.sharded.lo, db.sharded.hi


def kfdb_candidates(n_words: int, max_kf: int, bows: list, query_row: int) -> tuple:
    """test_dist_kfdb.py's candidate case on the sharded database."""
    db = make_db(n_words, max_kf, bows, attach=True)
    q = db.bow[query_row].copy()
    db.erase(query_row)
    return db.detect_n_best_candidates(q, np.asarray([query_row - 1, query_row + 1]), 3, query_map=0)


def kfdb_growth(n_words: int, bows: list) -> tuple:
    """test_dist_kfdb.py's growth case: 8 rows of capacity grown past 16 to
    32, the mirror re-sharded; (max_kf, mirror's max_kf, common, score of
    the last row, the dense table)."""
    db = make_db(n_words, 8, bows, attach=True)
    c, s = db.sharded.scores(db.bow[len(bows) - 1])
    return db.max_kf, db.sharded.max_kf, c, s, db.bow


def mapper_run(map_path: str, cam_args: tuple, sigma2: np.ndarray, form: str, iters: tuple, fixed: list) -> tuple:
    """``Mapper._run_gba(distributed=True)`` ("gba") or ``Mapper._run_ba(
    distributed=True)`` ("local") over every keyframe of the saved map, at
    this rank's world: (completed, the keyframe poses and the landmarks
    after it)."""
    from orb_slam3_fast_tpu_torch.backend.mapper import Mapper
    from orb_slam3_fast_tpu_torch.map.worldmap import WorldMap

    world = WorldMap.load(map_path)
    mapper = Mapper(cm.Camera.pinhole(*cam_args), bf=0.0, sigma2=sigma2, device="cpu")
    kf_ids = np.nonzero(world.kf_valid[: world.n_kf])[0]
    if form == "gba":
        done = mapper._run_gba(world, kf_ids, fixed=np.asarray(fixed), iters=iters, distributed=True)
    else:
        mapper._run_ba(world, kf_ids, fixed=np.asarray(fixed), iters=iters, distributed=True)
        done = mapper.n_local_ba == 1
    K, M = world.n_kf, world.n_lm
    return done, world.kf_R[:K].copy(), world.kf_t[:K].copy(), world.lm_pos[:M].copy()
