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
    """The messages of what a world above one refuses: an async System and
    FullInertialBA."""
    from orb_slam3_fast_tpu_torch.frontend.vi_tracker import InertialTracker
    from orb_slam3_fast_tpu_torch.slam.system import System

    out = []
    try:
        System("configs/synthetic_mono.yaml", "monocular", device="cpu")
    except ValueError as e:
        out.append(str(e))
    try:
        InertialTracker._full_inertial_ba(None, None, np.zeros(1, np.int64))
    except NotImplementedError as e:
        out.append(str(e))
    return out


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
