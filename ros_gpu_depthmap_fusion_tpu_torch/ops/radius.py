"""Radius outlier filter.

The reference declares the radius filter's parameters but never calls it
(``_component.cpp:414-421``). This is the JAX package's density test
(``ops/radius.py``): a uniform grid with cell size = radius, and a point
survives when its own cell and its 26 neighbour cells hold at least
``min_neighbors`` points (itself included). The counts are integers, so
the result does not depend on the order of the scatter-add or the box
sum, on any device.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ros_gpu_depthmap_fusion_tpu_torch.core.devconst import const
from ros_gpu_depthmap_fusion_tpu_torch.core.grid import VoxelGrid


def _box1(a: torch.Tensor, axis: int) -> torch.Tensor:
    """``a`` plus its two neighbours along ``axis`` (zero past the ends)."""
    n = a.shape[axis]
    shape = [1, 1, 1]
    shape[axis] = n
    idx = torch.arange(n, device=a.device).reshape(shape)
    lo = torch.where(idx > 0, torch.roll(a, 1, dims=axis), 0)
    hi = torch.where(idx < n - 1, torch.roll(a, -1, dims=axis), 0)
    return a + lo + hi


def filter_radius_outliers(points: torch.Tensor,
                           mask: torch.Tensor,
                           lower: Tuple[float, float, float],
                           upper: Tuple[float, float, float],
                           radius: float,
                           min_neighbors: int = 2) -> torch.Tensor:
    """AND a density gate into the mask.

    Args:
        points: ``[N, 4]`` (or ``[N, 3]``) world points.
        mask: ``[N]`` bool.
        lower, upper, radius: the filter's box and neighbourhood radius
            (its grid's cell size).
        min_neighbors: least population of the 3x3x3 cell neighbourhood.
    """
    grid = VoxelGrid(lower=lower, upper=upper,
                     cell_size=(radius, radius, radius))
    dev = points.device
    gs = grid.grid_size
    # float32 device constants: the division is the float32 quotient the
    # JAX package computes, on every device
    f = (points[:, :3] - const(grid.lower, dev)) / const(float(radius), dev)
    # truncation toward zero, then the clip; the float is first held
    # within [-1, size] (a NaN at 0), which leaves every clipped index as
    # a saturating conversion gives it and keeps the conversion defined
    f = torch.minimum(torch.clamp_min(torch.nan_to_num(f, nan=0.0), -1.0),
                      const(tuple(float(g) for g in gs), dev))
    coord = torch.minimum(torch.clamp_min(f.to(torch.int32), 0),
                          const(tuple(g - 1 for g in gs), dev, torch.int32))
    num_cells = grid.num_cells
    cell = grid.cell_index_of_coord(coord)
    target = torch.where(mask, cell, num_cells).long()
    counts = torch.zeros((num_cells + 1,), dtype=torch.int32, device=dev)
    counts.index_add_(0, target, torch.ones_like(cell))
    gx, gy, gz = gs
    c3 = counts[:num_cells].reshape(gz, gy, gx)
    dens = _box1(_box1(_box1(c3, 0), 1), 2).reshape(-1)
    return mask & (dens[cell.long()] >= min_neighbors)
