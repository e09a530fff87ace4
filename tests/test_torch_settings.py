"""The port's cv::FileStorage reader (slam/settings.py, no pyyaml) against
the JAX package's pyyaml loader on every configs/*.yaml, and the Settings
built from them."""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from orb_slam3_fast_tpu.slam import settings as jset
from orb_slam3_fast_tpu_torch.slam import settings as tset

torch.set_num_threads(1)

CONFIGS = sorted(str(p) for p in (Path(__file__).resolve().parents[1] / "configs").glob("*.yaml"))


def _equal(a, b):
    if isinstance(a, np.ndarray):
        return isinstance(b, np.ndarray) and a.dtype == b.dtype and np.array_equal(a, b)
    return type(a) is type(b) and a == b


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: Path(p).name)
def test_loader_matches_pyyaml(path, monkeypatch):
    want = jset.load_opencv_yaml(path)
    monkeypatch.setitem(sys.modules, "yaml", None)  # the port must not reach for pyyaml
    got = tset.load_opencv_yaml(path)
    assert got.keys() == want.keys()
    for k in want:
        assert _equal(got[k], want[k]), (k, got[k], want[k])


@pytest.mark.parametrize("path,sensor", [(CONFIGS[-1], "stereo"), (CONFIGS[0], "stereo-inertial"),
                                         (CONFIGS[-1], "rgbd")],
                         ids=["synthetic_stereo", "euroc_rectified", "synthetic_rgbd"])
def test_settings_match(path, sensor):
    """Rectified stereo, pin-hole stereo with extrinsics (rectification
    maps computed by the copied ops/rectify.py), and the synthetic
    configuration loaded for RGB-D: ``th_depth`` from ``Stereo.ThDepth`` and
    ``depth_map_factor`` as the JAX loader reads them."""
    j, t = jset.Settings.from_yaml(path, sensor), tset.Settings.from_yaml(path, sensor)
    assert t.camera_type == j.camera_type and t.cam.kind == j.cam.kind
    np.testing.assert_allclose(t.cam.params.numpy(), np.asarray(j.cam.params), rtol=1e-6)
    for name in ("sensor", "width", "height", "fps", "rgb", "bf", "th_depth", "depth_map_factor", "n_features",
                 "scale_factor", "n_levels", "ini_th_fast", "min_th_fast", "imu_frequency"):
        assert getattr(t, name) == getattr(j, name), name
    if j.rect_map_left is not None:
        for a, b in zip(t.rect_map_left + t.rect_map_right, j.rect_map_left + j.rect_map_right):
            np.testing.assert_array_equal(a, b)


def test_configs_are_the_four():
    assert [Path(p).name for p in CONFIGS] == [
        "EuRoC_stereo_inertial.yaml", "TUMVI_fisheye_stereo_inertial.yaml", "synthetic_mono.yaml",
        "synthetic_stereo.yaml",
    ]
