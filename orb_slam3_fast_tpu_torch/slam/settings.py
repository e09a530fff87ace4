"""Typed settings loader for ORB-SLAM3's YAML schema.

Counterpart of ``orb_slam3_fast_tpu/slam/settings.py`` (Settings.cc,
Settings.h): the same ``Settings`` fields, camera dispatch (PinHole,
Rectified, KannalaBrandt8), stereo rectification precompute and ORB
parameters.  The JAX package parses with pyyaml; the port reads the
cv::FileStorage subset itself, so that it needs nothing beyond numpy:
  * the ``%YAML:1.0`` directive and ``---``;
  * ``key: value`` block mappings by indentation, ``#`` comments;
  * plain scalars resolved as pyyaml's YAML 1.1 resolver resolves them
    (null, bool, int, float, else str) and quoted strings;
  * flow sequences ``[a, b, ...]``, over several lines;
  * ``!!opencv-matrix`` mappings, returned as float64 (rows, cols) arrays.
On the repo's ``configs/*.yaml`` it gives the JAX loader's dict.
"""
from __future__ import annotations

import re
from dataclasses import dataclass, field

import numpy as np

from orb_slam3_fast_tpu_torch.cameras import models as cam_models

_NULL = {"", "~", "null", "Null", "NULL"}
_TRUE = {"yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON"}
_FALSE = {"no", "No", "NO", "false", "False", "FALSE", "off", "Off", "OFF"}
_INT = re.compile(r"^[-+]?(0|[1-9][0-9_]*)$")
_FLOAT = re.compile(
    r"^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
    r"|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?"
    r"|[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN))$"
)


def _scalar(tok: str):
    """A plain or quoted scalar, resolved as pyyaml does (YAML 1.1)."""
    tok = tok.strip()
    if len(tok) >= 2 and tok[0] == tok[-1] and tok[0] in "\"'":
        return tok[1:-1]
    if tok in _NULL:
        return None
    if tok in _TRUE:
        return True
    if tok in _FALSE:
        return False
    if _INT.match(tok):
        return int(tok.replace("_", ""))
    if _FLOAT.match(tok):
        t = tok.replace("_", "").lower()
        if t.endswith("inf"):
            return float("-inf") if t.startswith("-") else float("inf")
        if t.endswith("nan"):
            return float("nan")
        return float(t)
    return tok


def _strip_comment(line: str) -> str:
    """Drop a ``#`` comment that starts a line or follows whitespace,
    outside quotes."""
    quote = None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "\"'":
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
    return line


def _split_flow(body: str) -> list:
    """Items of a flow sequence body (no nesting in this subset)."""
    body = body.strip()
    return [] if not body else [_scalar(x) for x in body.split(",")]


def _parse_block(lines: list, i: int, indent: int):
    """Parse a block mapping whose keys sit at ``indent``; returns (dict,
    next line index)."""
    out = {}
    while i < len(lines):
        ind, text = lines[i]
        if ind < indent:
            break
        if ind > indent:
            raise ValueError(f"unexpected indentation: {text!r}")
        key, sep, rest = text.partition(":")
        if not sep:
            raise ValueError(f"expected 'key: value', got {text!r}")
        key, rest = key.strip(), rest.strip()
        i += 1
        tag = None
        if rest.startswith("!!"):
            tag, _, rest = rest.partition(" ")
            rest = rest.strip()
        if rest.startswith("["):
            body = rest[1:]
            while "]" not in body:  # a flow sequence over several lines
                body += " " + lines[i][1]
                i += 1
            value = _split_flow(body[: body.index("]")])
        elif rest == "" and i < len(lines) and lines[i][0] > indent:
            value, i = _parse_block(lines, i, lines[i][0])
        else:
            value = _scalar(rest)
        if tag == "!!opencv-matrix":
            value = np.asarray(value["data"], dtype=np.float64).reshape(value["rows"], value["cols"])
        elif tag is not None:
            raise ValueError(f"unsupported tag {tag}")
        out[key] = value
    return out, i


def load_opencv_yaml(path: str) -> dict:
    """Parse a cv::FileStorage YAML file into a dict (top-level keys
    flat, as the file writes them)."""
    with open(path) as f:
        text = f.read()
    lines = []
    for raw in text.splitlines():
        if raw.startswith("%YAML") or raw.strip() == "---":
            continue
        line = _strip_comment(raw).rstrip()
        if line.strip():
            lines.append((len(line) - len(line.lstrip(" ")), line.strip()))
    if not lines:
        return {}
    data, _ = _parse_block(lines, 0, lines[0][0])
    return data


@dataclass
class Settings:
    """Resolved configuration (the Settings.h:133-242 surface)."""

    sensor: str = "monocular"  # monocular|stereo|rgbd (+ "-inertial")
    camera_type: str = "PinHole"  # PinHole|Rectified|KannalaBrandt8
    cam: object = None  # cameras.models.Camera (left / main), on the host
    cam2: object = None  # right camera (fisheye stereo)
    width: int = 640
    height: int = 480
    new_width: int = 0  # Camera.newWidth resize target (0 = off)
    new_height: int = 0
    fps: float = 30.0
    rgb: bool = True
    bf: float = 0.0  # baseline * fx
    th_depth: float = 35.0  # Stereo.ThDepth / RGBD.ThDepth
    depth_map_factor: float = 1.0  # RGBD.DepthMapFactor
    T_c1_c2: np.ndarray | None = None  # stereo extrinsics (4,4)
    T_b_c1: np.ndarray | None = None  # IMU body-from-camera (4,4)
    imu_noise_gyro: float = 1.7e-4
    imu_noise_acc: float = 2.0e-3
    imu_gyro_walk: float = 1.9e-5
    imu_acc_walk: float = 3.0e-3
    imu_frequency: float = 200.0
    insert_kfs_when_lost: bool = True
    n_features: int = 1000
    scale_factor: float = 1.2
    n_levels: int = 8
    ini_th_fast: float = 20.0
    min_th_fast: float = 7.0
    rect_map_left: tuple | None = None  # rectification grids (precompute_rectification)
    rect_map_right: tuple | None = None
    load_atlas: str | None = None
    save_atlas: str | None = None
    raw: dict = field(default_factory=dict)

    @staticmethod
    def from_yaml(path: str, sensor: str = "monocular") -> "Settings":
        d = load_opencv_yaml(path)
        s = Settings(sensor=sensor, raw=d)
        get = d.get
        s.camera_type = get("Camera.type", "PinHole")
        pfx = "Camera1." if "Camera1.fx" in d else "Camera."
        fx, fy, cx, cy = get(pfx + "fx"), get(pfx + "fy"), get(pfx + "cx"), get(pfx + "cy")
        if s.camera_type in ("PinHole", "Rectified"):
            dist = [get(pfx + k, 0.0) or 0.0 for k in ("k1", "k2", "p1", "p2", "k3")]
            if s.camera_type == "Rectified":
                dist = [0.0] * 5
            s.cam = cam_models.Camera.pinhole(fx, fy, cx, cy, dist)
        elif s.camera_type == "KannalaBrandt8":
            s.cam = cam_models.Camera.kb8(fx, fy, cx, cy, *[get(pfx + k, 0.0) or 0.0 for k in ("k1", "k2", "k3", "k4")])
        else:
            raise ValueError(f"unknown Camera.type {s.camera_type}")
        if "Camera2.fx" in d:
            c2 = [get("Camera2." + k) for k in ("fx", "fy", "cx", "cy")]
            if s.camera_type == "KannalaBrandt8":
                s.cam2 = cam_models.Camera.kb8(*c2, *[get("Camera2." + k, 0.0) or 0.0 for k in ("k1", "k2", "k3", "k4")])
            else:
                dist2 = [get("Camera2." + k, 0.0) or 0.0 for k in ("k1", "k2", "p1", "p2", "k3")]
                s.cam2 = cam_models.Camera.pinhole(*c2, dist2)
        s.width = int(get("Camera.width", 640))
        s.height = int(get("Camera.height", 480))
        s.new_width = int(get("Camera.newWidth", 0) or 0)
        s.new_height = int(get("Camera.newHeight", 0) or 0)
        s.fps = float(get("Camera.fps", 30.0))
        s.rgb = bool(get("Camera.RGB", 1))
        s.bf = float(get("Camera.bf", 0.0) or 0.0)
        s.th_depth = float(get("Stereo.ThDepth", get("ThDepth", 35.0)) or 35.0)
        s.depth_map_factor = float(get("RGBD.DepthMapFactor", get("DepthMapFactor", 1.0)) or 1.0)
        if get("Stereo.T_c1_c2") is not None:
            s.T_c1_c2 = np.asarray(get("Stereo.T_c1_c2"), dtype=np.float64)
        if get("IMU.T_b_c1") is not None:
            s.T_b_c1 = np.asarray(get("IMU.T_b_c1"), dtype=np.float64)
        elif get("Tbc") is not None:  # legacy key
            s.T_b_c1 = np.asarray(get("Tbc"), dtype=np.float64)
        s.imu_noise_gyro = float(get("IMU.NoiseGyro", s.imu_noise_gyro))
        s.imu_noise_acc = float(get("IMU.NoiseAcc", s.imu_noise_acc))
        s.imu_gyro_walk = float(get("IMU.GyroWalk", s.imu_gyro_walk))
        s.imu_acc_walk = float(get("IMU.AccWalk", s.imu_acc_walk))
        s.imu_frequency = float(get("IMU.Frequency", s.imu_frequency))
        s.n_features = int(get("ORBextractor.nFeatures", 1000))
        s.scale_factor = float(get("ORBextractor.scaleFactor", 1.2))
        s.n_levels = int(get("ORBextractor.nLevels", 8))
        s.ini_th_fast = float(get("ORBextractor.iniThFAST", 20))
        s.min_th_fast = float(get("ORBextractor.minThFAST", 7))
        s.load_atlas = get("System.LoadAtlasFromFile")
        s.save_atlas = get("System.SaveAtlasToFile")
        if "stereo" in sensor and s.camera_type == "PinHole" and s.T_c1_c2 is not None and s.cam2 is not None:
            s.precompute_rectification()  # Settings.cc:525-570
        elif "stereo" in sensor and s.camera_type == "Rectified" and s.bf == 0.0:
            s.bf = float(get("Stereo.b", 0.0) or 0.0) * float(s.cam.params[0])
        return s

    def precompute_rectification(self):
        """stereoRectify + initUndistortRectifyMap (``ops/rectify.py``):
        remap grids per camera, and the rectified pin-hole as the camera."""
        from orb_slam3_fast_tpu_torch.ops import rectify as rect

        p1 = self.cam.params.numpy().astype(np.float64)
        p2 = self.cam2.params.numpy().astype(np.float64)
        K1 = np.array([[p1[0], 0, p1[2]], [0, p1[1], p1[3]], [0, 0, 1]])
        K2 = np.array([[p2[0], 0, p2[2]], [0, p2[1], p2[3]], [0, 0, 1]])
        R12, t12 = self.T_c1_c2[:3, :3], self.T_c1_c2[:3, 3]
        wh = (self.width, self.height)
        R1, R2, K_new, _, bf = rect.stereo_rectify(K1, p1[4:9], K2, p2[4:9], wh, R12.T, -R12.T @ t12)
        self.rect_map_left = rect.undistort_rectify_map(K1, p1[4:9], R1, K_new, wh)
        self.rect_map_right = rect.undistort_rectify_map(K2, p2[4:9], R2, K_new, wh)
        self.cam = cam_models.Camera.pinhole(K_new[0, 0], K_new[1, 1], K_new[0, 2], K_new[1, 2])
        self.bf = float(bf)
        self.camera_type = "Rectified"

    def rectify(self, img_l: np.ndarray, img_r: np.ndarray):
        from orb_slam3_fast_tpu_torch.ops import rectify as rect

        return rect.remap_bilinear(img_l, *self.rect_map_left), rect.remap_bilinear(img_r, *self.rect_map_right)
