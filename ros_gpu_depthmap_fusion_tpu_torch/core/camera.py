"""Pinhole camera model (numpy copy of the JAX package's ``core/camera.py``).

Unprojection (``shader/convert_depthmap_to_points.glsl:64-73``)::

    z = depth * depth_scale
    x = (u - cx) / fx * z
    y = (v - cy) / fy * z
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class PinholeIntrinsics:
    fx: float
    fy: float
    cx: float
    cy: float
    width: int
    height: int

    def as_array(self) -> np.ndarray:
        """Pack to ``[4]`` float32 (fx, fy, cx, cy)."""
        return np.array([self.fx, self.fy, self.cx, self.cy],
                        dtype=np.float32)

    @staticmethod
    def from_k_matrix(k: np.ndarray, width: int, height: int
                      ) -> "PinholeIntrinsics":
        """From a 3x3 camera matrix (CameraInfo K layout)."""
        k = np.asarray(k).reshape(3, 3)
        return PinholeIntrinsics(fx=float(k[0, 0]), fy=float(k[1, 1]),
                                 cx=float(k[0, 2]), cy=float(k[1, 2]),
                                 width=width, height=height)

    @staticmethod
    def default_for(width: int, height: int, fov_deg: float = 60.0
                    ) -> "PinholeIntrinsics":
        """Synthetic-rig default: horizontal FOV, centered principal point."""
        fx = width / (2.0 * np.tan(np.deg2rad(fov_deg) / 2.0))
        return PinholeIntrinsics(fx=fx, fy=fx, cx=(width - 1) / 2.0,
                                 cy=(height - 1) / 2.0,
                                 width=width, height=height)


def stack_intrinsics(cams) -> np.ndarray:
    """``[C, 4]`` float32 (fx, fy, cx, cy) from a list of intrinsics."""
    return np.stack([c.as_array() for c in cams], axis=0)
