"""Average-mode voxelization by two run-length reductions.

The reference downloads every point's cell id, radix-sorts and groups them
on the host and averages per cell (``voxelize.h:9-48``). Here it stays on
the device in four steps:

1. each point's coordinates are quantized relative to its cell's lower
   corner (10/10/12 bits for x/y/z: error at most cell/2048 in x and y and
   cell/8192 in z), so every value is a small exact integer;
2. level 1: the run-length reduction (kernel 1) over each raster domain in
   raster order collapses runs of neighbouring pixels that share a cell
   into (cell, partial-sum) rows, with runs broken every 128 positions so
   a partial fits two 32-bit words;
3. the partials of all domains, plus the raster-incoherent ``extra`` rows
   (the lidar selection) as single-point partials, are sorted by cell
   (a stable library sort, carrying the two packed words);
4. level 2: the same reduction over the sorted partials gives one row per
   occupied cell, which is dequantized to the cell's mean point.

All sums are exact integers below 2^24, so the result does not depend on
summation order: it is bit-equal to the JAX package's
``voxelize_average_rle_domains`` and ``voxelize_average_packed``.
"""

from __future__ import annotations

import torch

from ros_gpu_depthmap_fusion_tpu_torch.core.devconst import const
from ros_gpu_depthmap_fusion_tpu_torch.core.grid import VoxelGrid
from ros_gpu_depthmap_fusion_tpu_torch.ops.kernels.segreduce import (
    segreduce, segreduce_plain)

QUANT_BITS = (10, 10, 12)
LEVEL1_FORCE_BREAK = 128


def _pack_partials(ps: torch.Tensor):
    """Pack partial rows ``[N, 4]`` (qx, qy, qz, count — exact integers of
    a run of at most 128 points: qx, qy < 2^17, qz < 2^20, count <= 2^7)
    into two 32-bit words, carried in int64 (torch has no unsigned 32-bit
    shifts on every device)::

        w0 = qx | (qz & 0x7FFF) << 17
        w1 = qy | (qz >> 15) << 17 | count << 22
    """
    xi, yi, zi, ci = (ps[:, k].to(torch.int64) for k in range(4))
    w0 = xi | ((zi & 0x7FFF) << 17)
    w1 = yi | ((zi >> 15) << 17) | (ci << 22)
    return w0 & 0xFFFFFFFF, w1 & 0xFFFFFFFF


def _unpack_partials(w0: torch.Tensor, w1: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`_pack_partials` -> ``[N, 4]`` float32."""
    m17 = (1 << 17) - 1
    xi = w0 & m17
    yi = w1 & m17
    zi = (w0 >> 17) | (((w1 >> 17) & 0x1F) << 15)
    ci = w1 >> 22
    return torch.stack([xi, yi, zi, ci], dim=-1).to(torch.float32)


def _quantize_cell_relative(points: torch.Tensor, cell_indices: torch.Tensor,
                            grid: VoxelGrid) -> torch.Tensor:
    """Coordinates quantized relative to their cell corner, as exact
    small-integer float32 columns ``[N, 3]``."""
    corner = grid.world_coord_of_coord(grid.grid_coord_of_index(cell_indices))
    cs = const(grid.cell_size, points.device)
    qs = []
    for a, b in enumerate(QUANT_BITS):
        f = (points[:, a] - corner[:, a]) / cs[a]
        qs.append(torch.clamp(torch.floor(f * float(1 << b)),
                              0.0, float((1 << b) - 1)))
    return torch.stack(qs, dim=-1)


def _partial_rows(points, cell_indices, mask, sentinel, grid):
    """Keys and ``[N, 4]`` (qx, qy, qz, 1) values of single points."""
    key = torch.where(mask, cell_indices.to(torch.int32), sentinel)
    q = _quantize_cell_relative(points, cell_indices, grid)
    vals = torch.cat([torch.where(mask[:, None], q, 0.0),
                      mask.to(torch.float32)[:, None]], dim=-1)
    return key, vals


def voxelize_average_rle_domains(domains,
                                 grid: VoxelGrid,
                                 capacity: int,
                                 partials_capacity: int = 0,
                                 extra_points: torch.Tensor | None = None,
                                 extra_cell_indices=None,
                                 extra_mask=None,
                                 plain: bool = False):
    """Mean point per occupied cell over raster-coherent domains.

    The counterpart of the JAX package's ``voxelize_average_rle_domains(...,
    return_occupancy="cells", return_partials_count=True)``.

    Args:
        domains: sequence of ``(points [N_i, 4], cell_indices [N_i],
            mask [N_i])`` raster sections; each gets its own level-1
            reduction with a pixel-proportional share of
            ``partials_capacity``.
        grid: the voxel grid (fewer than 2^24 cells).
        capacity: static number of output cells.
        partials_capacity: level-1 rows (0 -> ``max(2^16, N // 4)``);
            partials past a domain's share are dropped.
        extra_*: rows without raster coherence, joined at the sort.
        plain: run the plain twin of the reduction kernel on any device
            (the on-card reference).

    Returns:
        (points ``[capacity, 4]`` float32 — cell means with w = 1, zero
        rows past the count; count int32 0-d; (cells ``[capacity]`` int32,
        0 past the count, live ``[capacity]`` bool); partials count int32
        0-d — the max over domains of the true level-1 run count scaled to
        the full capacity, so ``> partials_capacity`` means partials were
        dropped).
    """
    reduce = segreduce_plain if plain else segreduce
    num_cells = grid.num_cells
    if num_cells >= (1 << 24):
        raise ValueError("rle voxelize needs a grid of fewer than 2^24 "
                         f"cells, got {num_cells}")
    n_total = sum(int(m.shape[0]) for _, _, m in domains)
    if partials_capacity <= 0:
        partials_capacity = max(1 << 16, n_total // 4)
    partials_capacity = min(partials_capacity, n_total)
    sentinel = num_cells
    dev = domains[0][0].device

    pks, w0s, w1s = [], [], []
    l1_true = torch.zeros((), dtype=torch.int64, device=dev)
    for points, cell_indices, mask in domains:
        n = int(mask.shape[0])
        cap_d = (partials_capacity if len(domains) == 1
                 else min(max(1 << 12, partials_capacity * n // n_total), n))
        key, vals = _partial_rows(points, cell_indices, mask, sentinel, grid)
        pk, ps, _, l1t = reduce(key, vals, cap_d, sentinel,
                                force_break=LEVEL1_FORCE_BREAK)
        w0, w1 = _pack_partials(ps)
        pks.append(pk)
        w0s.append(w0)
        w1s.append(w1)
        # this domain's true count scaled to the full capacity, in
        # integers: > partials_capacity  <=>  l1t > cap_d
        scaled = torch.div(l1t.to(torch.int64) * partials_capacity
                           + cap_d - 1, cap_d, rounding_mode="floor")
        l1_true = torch.maximum(l1_true, scaled)
    if extra_points is not None:
        ekey, evals = _partial_rows(extra_points, extra_cell_indices,
                                    extra_mask, sentinel, grid)
        w0, w1 = _pack_partials(evals)
        pks.append(ekey)
        w0s.append(w0)
        w1s.append(w1)
    pk, w0, w1 = torch.cat(pks), torch.cat(w0s), torch.cat(w1s)
    # group the partials by cell: a stable sort of the keys carrying the
    # two packed words (level-2 sums are order-independent anyway)
    sk, order = torch.sort(pk, stable=True)
    cells, sums, count, _ = reduce(
        sk.contiguous(), _unpack_partials(w0[order], w1[order]), capacity,
        sentinel)

    live = torch.arange(capacity, dtype=torch.int32, device=dev) < count
    safe_cells = torch.where(live, cells, 0)
    mean_q = sums[:, :3] / torch.clamp_min(sums[:, 3:4], 1.0)
    corner = grid.world_coord_of_coord(grid.grid_coord_of_index(safe_cells))
    inv_scale = const(grid.cell_size, dev) / const(
        tuple(float(1 << b) for b in QUANT_BITS), dev)
    w_col = live.to(torch.float32)
    out_means = (corner + (mean_q + 0.5) * inv_scale) * w_col[:, None]
    out_points = torch.cat([out_means, w_col[:, None]], dim=-1)
    return (out_points, count, (safe_cells, live),
            l1_true.to(torch.int32))
