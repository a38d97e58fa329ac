"""Voxel-grid geometry (reference ``GridMeta``,
``include/gpu_depthmap_fusion/grid_meta.h:17-169``).

Bounds and cell size define a static integer grid, linear index
``x + y*W + z*W*H`` (x fastest). The conversions are torch functions on
tensors of any device.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch

from ros_gpu_depthmap_fusion_tpu_torch.core.devconst import const


@dataclasses.dataclass(frozen=True)
class VoxelGrid:
    """Static grid descriptor: ``grid_size[i] = max(1, ceil((upper -
    lower) / cell))`` per axis (grid_meta.h:153-154)."""

    lower: Tuple[float, float, float]
    upper: Tuple[float, float, float]
    cell_size: Tuple[float, float, float]

    def __post_init__(self):
        # normalize bounds so lower <= upper (grid_meta.h:142-148)
        lo = tuple(min(l, u) for l, u in zip(self.lower, self.upper))
        hi = tuple(max(l, u) for l, u in zip(self.lower, self.upper))
        object.__setattr__(self, "lower", lo)
        object.__setattr__(self, "upper", hi)

    @property
    def grid_size(self) -> Tuple[int, int, int]:
        return tuple(
            max(1, int(math.ceil((u - l) / c)))
            for l, u, c in zip(self.lower, self.upper, self.cell_size))

    @property
    def steps(self) -> Tuple[int, int, int]:
        """Linear-index strides per axis; steps[0] == 1."""
        gs = self.grid_size
        return (1, gs[0], gs[0] * gs[1])

    @property
    def num_cells(self) -> int:
        gs = self.grid_size
        return gs[0] * gs[1] * gs[2]

    @property
    def shape_zyx(self) -> Tuple[int, int, int]:
        """Shape of a dense grid laid out ``[z, y, x]`` (z = layers), the
        reference's layer-major occupancy download
        (gpu_depthmap_fusion.cpp:1829-1838)."""
        gs = self.grid_size
        return (gs[2], gs[1], gs[0])

    def cell_index_clamped(self, points_xyz: torch.Tensor) -> torch.Tensor:
        """World points ``[..., 3]`` -> int32 linear cell index, clamped to
        border cells (``shader/compute_voxel_coords.glsl:44-53``): the
        FLOAT scaled coordinate is clamped to [0, grid_size - 1] before the
        floor."""
        dev = points_xyz.device
        gs = const(self.grid_size, dev)
        lo = const(self.lower, dev)
        cs = const(self.cell_size, dev)
        f = torch.minimum(torch.clamp_min((points_xyz - lo) / cs, 0.0),
                          gs - 1.0)
        u = torch.floor(f).to(torch.int32)
        st = self.steps
        return u[..., 0] * st[0] + u[..., 1] * st[1] + u[..., 2] * st[2]

    def grid_coord_of_index(self, cell_index: torch.Tensor) -> torch.Tensor:
        """Linear index -> ``[..., 3]`` int32 grid coord
        (grid_meta.h:45-56)."""
        gs, st = self.grid_size, self.steps
        idx = cell_index.to(torch.int32)
        return torch.stack(
            [torch.remainder(torch.div(idx, st[i], rounding_mode="floor"),
                             gs[i]) for i in range(3)], dim=-1)

    def cell_index_of_coord(self, grid_coord: torch.Tensor) -> torch.Tensor:
        """``[..., 3]`` integer grid coord -> int32 linear index
        (grid_meta.h:79-87)."""
        st = self.steps
        gc = grid_coord.to(torch.int32)
        return gc[..., 0] * st[0] + gc[..., 1] * st[1] + gc[..., 2] * st[2]

    def world_coord_of_coord(self, grid_coord: torch.Tensor) -> torch.Tensor:
        """Grid coord -> float32 world coordinate of the cell's lower corner
        (grid_meta.h:94-100: ``grid * cell + lower``)."""
        cs = const(self.cell_size, grid_coord.device)
        lo = const(self.lower, grid_coord.device)
        return grid_coord.to(torch.float32) * cs + lo

    def world_coord_of_index(self, cell_index: torch.Tensor) -> torch.Tensor:
        return self.world_coord_of_coord(self.grid_coord_of_index(cell_index))

    @staticmethod
    def from_config(cfg) -> "VoxelGrid":
        return VoxelGrid(lower=tuple(cfg.voxel_min),
                         upper=tuple(cfg.voxel_max),
                         cell_size=tuple(cfg.voxel_size))
