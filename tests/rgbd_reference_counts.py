"""The JAX package's RGB-D run of tests/test_slam_e2e.py::test_rgbd_e2e
(seed 2, 900 splats, 25 frames, bf 32), with the counts the port's RGB-D
gate in chip_smoke.py takes from it: the frames that made a keyframe, the
local BAs, the live landmarks and the ATE.

Run from the repository root on the CPU (about 2.5 minutes):
``python -m tests.rgbd_reference_counts``.
"""
import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from orb_slam3_fast_tpu.backend.mapper import Mapper  # noqa: E402
from orb_slam3_fast_tpu.cameras import models as cm  # noqa: E402
from orb_slam3_fast_tpu.eval import ate  # noqa: E402
from orb_slam3_fast_tpu.frontend import tracker as trk  # noqa: E402
from orb_slam3_fast_tpu.map.worldmap import WorldMap  # noqa: E402
from orb_slam3_fast_tpu.ops import extractor as ext  # noqa: E402
from orb_slam3_fast_tpu.optim import ba  # noqa: E402
from tests import synthetic as syn  # noqa: E402

CAM = cm.Camera.pinhole(400.0, 400.0, 320.0, 240.0)
CFG = trk.TrackerConfig(extractor=ext.ExtractorConfig(n_features=768), min_init_matches=60)


def main():
    n_ba = [0]
    bundle_adjust = ba.bundle_adjust

    def counted(*args, **kwargs):
        n_ba[0] += 1
        return bundle_adjust(*args, **kwargs)

    ba.bundle_adjust = counted
    world = syn.make_corridor_world(np.random.default_rng(2), n=900)
    bf = 0.08 * 400.0
    t = trk.Tracker(CAM, CFG, bf=bf, world=WorldMap(kp_cap=ext.total_capacity(CFG.extractor)),
                    mapper=Mapper(CAM, bf=bf, sigma2=ext.level_sigma2(CFG.extractor)))
    est, gt, ts, kf_frames = [], [], [], []
    for i, T in enumerate(syn.arc_trajectory(25, step=0.06, lateral=0.05)):
        img = syn.render(world, CAM, T)
        # the test's depth map: each splat's footprint at its centre's depth
        Xc = np.asarray(T.apply(jnp.asarray(world["centers"])))
        uv = np.asarray(cm.project(CAM, jnp.asarray(Xc)))
        depth = np.zeros((480, 640), np.float32)
        for j in np.argsort(-Xc[:, 2]):
            z = Xc[j, 2]
            if z < 0.5:
                continue
            u, v = uv[j]
            s = world["sizes"][j] * 400.0 / z
            if s < 2:
                continue
            u0, v0, u1, v1 = int(u - s / 2), int(v - s / 2), int(u + s / 2), int(v + s / 2)
            depth[max(v0, 0) : max(v1, 0), max(u0, 0) : max(u1, 0)] = z
        n_kf = t.world.n_kf
        state, pose = t.process_rgbd(img, depth, i * 0.05)
        if t.world.n_kf > n_kf:
            kf_frames.append(i)
        if state == trk.OK and pose is not None:
            est.append(-pose[0].T @ pose[1])
            gt.append(np.asarray(T.inverse().t))
            ts.append(i * 0.05)
    rmse, _, _ = ate.ate_rmse(np.asarray(ts), np.asarray(est), np.asarray(ts), np.asarray(gt), with_scale=False)
    print(f"state {t.state}, tracked {len(est)}, keyframes {t.world.n_kf} at frames {kf_frames}, local BAs "
          f"{n_ba[0]}, landmarks {int(t.world.lm_valid.sum())}, unscaled ATE {rmse:.6f} m")


if __name__ == "__main__":
    main()
