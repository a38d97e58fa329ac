"""Dataset readers: TUM RGB-D sequences + a synthetic multi-camera rig
(numpy copy of the JAX package's ``pipeline/datasets.py``, on the port's
``core.camera`` and ``core.transforms``; it renders the same arrays).

These replace the reference's ROS topic inputs (RealSense depth images +
Livox point clouds) for offline/benchmark runs:

- :class:`TumRgbdDataset` — the standard TUM RGB-D layout (``depth.txt``
  index of 16-bit PNGs in 1/5000 m units, ``groundtruth.txt`` trajectory,
  timestamp association). Used for the ATE benchmark configs.
- :class:`SyntheticRigDataset` — ray-traced depth of a simple analytic
  scene (ground plane, walls, boxes, spheres) for N cameras with exact
  poses: ground-truth everything, no files needed.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from ros_gpu_depthmap_fusion_tpu_torch.core.camera import PinholeIntrinsics
from ros_gpu_depthmap_fusion_tpu_torch.core import transforms
from ros_gpu_depthmap_fusion_tpu_torch.utils.png import read_png_gray

TUM_DEPTH_SCALE = 1.0 / 5000.0  # meters per depth unit
# TUM freiburg1/2 default pinhole intrinsics (camera.tum.de calibration)
TUM_INTRINSICS = {
    "fr1": PinholeIntrinsics(517.3, 516.5, 318.6, 255.3, 640, 480),
    "fr2": PinholeIntrinsics(520.9, 521.0, 325.1, 249.7, 640, 480),
    "fr3": PinholeIntrinsics(535.4, 539.2, 320.1, 247.6, 640, 480),
}


def quat_to_rot(qx: float, qy: float, qz: float, qw: float) -> np.ndarray:
    """Unit quaternion -> 3x3 rotation (TUM groundtruth convention)."""
    n = np.sqrt(qx * qx + qy * qy + qz * qz + qw * qw)
    qx, qy, qz, qw = qx / n, qy / n, qz / n, qw / n
    return np.array([
        [1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - qz * qw),
         2 * (qx * qz + qy * qw)],
        [2 * (qx * qy + qz * qw), 1 - 2 * (qx * qx + qz * qz),
         2 * (qy * qz - qx * qw)],
        [2 * (qx * qz - qy * qw), 2 * (qy * qz + qx * qw),
         1 - 2 * (qx * qx + qy * qy)],
    ], dtype=np.float32)


def rot_to_quat(r: np.ndarray) -> Tuple[float, float, float, float]:
    """3x3 rotation -> (qx, qy, qz, qw)."""
    t = np.trace(r)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        qw = 0.25 * s
        qx = (r[2, 1] - r[1, 2]) / s
        qy = (r[0, 2] - r[2, 0]) / s
        qz = (r[1, 0] - r[0, 1]) / s
    else:
        i = int(np.argmax(np.diag(r)))
        j, k = (i + 1) % 3, (i + 2) % 3
        s = np.sqrt(r[i, i] - r[j, j] - r[k, k] + 1.0) * 2
        q = [0.0, 0.0, 0.0, 0.0]
        q[i] = 0.25 * s
        q[3] = (r[k, j] - r[j, k]) / s
        q[j] = (r[j, i] + r[i, j]) / s
        q[k] = (r[k, i] + r[i, k]) / s
        qx, qy, qz, qw = q
    return float(qx), float(qy), float(qz), float(qw)


@dataclasses.dataclass
class DepthFrame:
    stamp: float
    depth_u16: np.ndarray
    intrinsics: PinholeIntrinsics
    tf_world_cam: Optional[np.ndarray]  # None when no groundtruth near stamp
    depth_scale: float
    intensity: Optional[np.ndarray] = None  # grayscale image, if available


class TumRgbdDataset:
    """TUM RGB-D sequence directory (depth.txt + depth/ + groundtruth.txt,
    optional rgb.txt with grayscale PNGs associated by timestamp)."""

    def __init__(self, root: str, max_assoc_dt: float = 0.02,
                 intrinsics: Optional[PinholeIntrinsics] = None):
        self.root = root
        name = os.path.basename(os.path.normpath(root))
        fr = "fr1"
        for key in TUM_INTRINSICS:
            if f"freiburg{key[-1]}" in name or name.startswith(key):
                fr = key
        # an explicit per-sequence calibration file (one line: fx fy cx cy
        # width height — written by the synthetic sequence writers) beats
        # the freiburg-name heuristic
        calib = os.path.join(root, "intrinsics.txt")
        if intrinsics is None and os.path.exists(calib):
            with open(calib) as f:
                for line in f:
                    line = line.strip()
                    if line and not line.startswith("#"):
                        fx, fy, cx, cy, w, h = line.split()[:6]
                        intrinsics = PinholeIntrinsics(
                            float(fx), float(fy), float(cx), float(cy),
                            int(w), int(h))
                        break
        self.intrinsics = intrinsics or TUM_INTRINSICS[fr]
        self.depth_index = self._read_index(os.path.join(root, "depth.txt"))
        rgb_path = os.path.join(root, "rgb.txt")
        self.rgb_index = (self._read_index(rgb_path)
                          if os.path.exists(rgb_path) else [])
        self.groundtruth = self._read_groundtruth(
            os.path.join(root, "groundtruth.txt"))
        self.max_assoc_dt = max_assoc_dt

    @staticmethod
    def _read_index(path: str) -> List[Tuple[float, str]]:
        out = []
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                stamp, rel = line.split()[:2]
                out.append((float(stamp), rel))
        return out

    @staticmethod
    def _read_groundtruth(path: str) -> np.ndarray:
        """[N, 8] rows: stamp tx ty tz qx qy qz qw."""
        rows = []
        if not os.path.exists(path):
            return np.zeros((0, 8), np.float64)
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                vals = [float(v) for v in line.split()]
                if len(vals) >= 8:
                    rows.append(vals[:8])
        return np.asarray(rows, np.float64)

    def pose_at(self, stamp: float) -> Optional[np.ndarray]:
        """Nearest-groundtruth world<-camera pose, or None outside the
        association window."""
        gt = self.groundtruth
        if len(gt) == 0:
            return None
        i = int(np.argmin(np.abs(gt[:, 0] - stamp)))
        if abs(gt[i, 0] - stamp) > self.max_assoc_dt:
            return None
        tx, ty, tz, qx, qy, qz, qw = gt[i, 1:8]
        return transforms.make_se3(quat_to_rot(qx, qy, qz, qw),
                                   np.array([tx, ty, tz], np.float32))

    def __len__(self) -> int:
        return len(self.depth_index)

    def _intensity_at(self, stamp: float) -> Optional[np.ndarray]:
        if not self.rgb_index:
            return None
        stamps = np.array([s for s, _ in self.rgb_index])
        i = int(np.argmin(np.abs(stamps - stamp)))
        if abs(stamps[i] - stamp) > self.max_assoc_dt:
            return None
        img = read_png_gray(os.path.join(self.root, self.rgb_index[i][1]))
        return img.astype(np.float32)

    def __iter__(self) -> Iterator[DepthFrame]:
        for stamp, rel in self.depth_index:
            depth = read_png_gray(os.path.join(self.root, rel))
            yield DepthFrame(stamp=stamp, depth_u16=depth,
                             intrinsics=self.intrinsics,
                             tf_world_cam=self.pose_at(stamp),
                             depth_scale=TUM_DEPTH_SCALE,
                             intensity=self._intensity_at(stamp))


# ---------------------------------------------------------------------------
# Synthetic rig
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Sphere:
    center: np.ndarray
    radius: float


@dataclasses.dataclass
class Box:
    lower: np.ndarray
    upper: np.ndarray


class SyntheticRigDataset:
    """Analytic depth render: ground plane z=0 + axis-aligned boxes +
    spheres, ray-cast per pixel (vectorized numpy)."""

    def __init__(self, intrinsics: PinholeIntrinsics,
                 spheres: Sequence[Sphere] = (),
                 boxes: Sequence[Box] = (),
                 ground_z: Optional[float] = 0.0,
                 max_depth: float = 20.0,
                 depth_scale: float = 0.001,
                 noise_std: float = 0.0,
                 noise_quad: float = 0.0,
                 dropout: float = 0.0,
                 dropout_per_m: float = 0.0,
                 seed: int = 0):
        """``noise_std``/``noise_quad``: depth noise sigma(z) = std +
        quad * z^2 meters (the quadratic term models stereo/structured-
        light depth cameras, e.g. RealSense ~0.001-0.003 * z^2).
        ``dropout``/``dropout_per_m``: hole probability p(z) = dropout +
        dropout_per_m * z (invalid returns grow with range)."""
        self.intr = intrinsics
        self.spheres = list(spheres)
        self.boxes = list(boxes)
        self.ground_z = ground_z
        self.max_depth = max_depth
        self.depth_scale = depth_scale
        self.noise_std = noise_std
        self.noise_quad = noise_quad
        self.dropout = dropout
        self.dropout_per_m = dropout_per_m
        self._rng = np.random.default_rng(seed)
        # camera-frame ray directions (z forward, pinhole)
        h, w = intrinsics.height, intrinsics.width
        u, v = np.meshgrid(np.arange(w, dtype=np.float64),
                           np.arange(h, dtype=np.float64))
        self._rays = np.stack([(u - intrinsics.cx) / intrinsics.fx,
                               (v - intrinsics.cy) / intrinsics.fy,
                               np.ones_like(u)], axis=-1)

    def render(self, tf_world_cam: np.ndarray):
        """(depth_u16 [H, W], intensity [H, W] float32): depth plus a
        checkerboard world-texture intensity image (corners on surfaces,
        not depth edges — good features for the SLAM frontend).

        The intensity is rendered from the NOISE-FREE geometry: an RGB
        camera sees clean texture even when the (stereo) depth channel is
        noisy — baking depth noise into the texture would make it flicker
        frame-to-frame, which no real sensor does."""
        depth = self.render_depth(tf_world_cam)
        clean = self.render_depth(tf_world_cam, with_noise=False) \
            if (self.noise_std or self.noise_quad or self.dropout
                or self.dropout_per_m) else depth
        z = clean.astype(np.float64) * self.depth_scale
        r = tf_world_cam[:3, :3].astype(np.float64)
        t = tf_world_cam[:3, 3].astype(np.float64)
        pts_cam = self._rays * z[..., None]
        pts_world = pts_cam @ r.T + t
        checker = (np.floor(pts_world[..., 0] * 2.5)
                   + np.floor(pts_world[..., 1] * 2.5)
                   + np.floor(pts_world[..., 2] * 2.5)) % 2
        fine = (np.floor(pts_world[..., 0] * 7 + pts_world[..., 1] * 3) % 2)
        intensity = np.where(clean > 0,
                             60 + 120 * checker + 40 * fine, 0.0)
        return depth, intensity.astype(np.float32)

    def render_depth(self, tf_world_cam: np.ndarray,
                     with_noise: bool = True) -> np.ndarray:
        """[H, W] uint16 depth (z-depth, like a depth camera) for a camera
        at the given world<-camera pose."""
        r = tf_world_cam[:3, :3].astype(np.float64)
        t = tf_world_cam[:3, 3].astype(np.float64)
        dirs = self._rays @ r.T                      # world-frame directions
        origin = t
        tmin = np.full(self._rays.shape[:2], np.inf)

        if self.ground_z is not None:
            dz = dirs[..., 2]
            with np.errstate(divide="ignore", invalid="ignore"):
                th = (self.ground_z - origin[2]) / dz
            hit = (np.abs(dz) > 1e-12) & (th > 1e-6)
            tmin = np.where(hit, np.minimum(tmin, np.where(hit, th, np.inf)),
                            tmin)
        for s in self.spheres:
            oc = origin - s.center
            b = np.sum(dirs * oc, axis=-1)
            c = np.dot(oc, oc) - s.radius ** 2
            a = np.sum(dirs * dirs, axis=-1)
            disc = b * b - a * c
            with np.errstate(invalid="ignore"):
                th = (-b - np.sqrt(np.maximum(disc, 0.0))) / a
            hit = (disc > 0) & (th > 1e-6)
            tmin = np.where(hit & (th < tmin), th, tmin)
        for bx in self.boxes:
            with np.errstate(divide="ignore", invalid="ignore"):
                t1 = (bx.lower - origin) / dirs
                t2 = (bx.upper - origin) / dirs
            tn = np.nanmax(np.minimum(t1, t2), axis=-1)
            tf_ = np.nanmin(np.maximum(t1, t2), axis=-1)
            hit = (tn <= tf_) & (tf_ > 1e-6)
            th = np.where(tn > 1e-6, tn, tf_)
            tmin = np.where(hit & (th < tmin), th, tmin)

        # convert ray distance to camera z-depth: z = t * (ray.z == 1 in cam)
        z = np.where(np.isfinite(tmin), tmin, 0.0)
        if with_noise and (self.noise_std > 0 or self.noise_quad > 0):
            sigma = self.noise_std + self.noise_quad * z * z
            z = np.where(z > 0,
                         z + self._rng.standard_normal(z.shape) * sigma, z)
        if with_noise and (self.dropout > 0 or self.dropout_per_m > 0):
            p = self.dropout + self.dropout_per_m * z
            z = np.where(self._rng.random(z.shape) < p, 0.0, z)
        z = np.where((z > 0) & (z < self.max_depth), z, 0.0)
        return np.clip(z / self.depth_scale, 0, 65535).astype(np.uint16)
