"""Average- and occupied-mode voxelization, and sort/group helpers.

The reference downloads every point's cell id, radix-sorts and groups them
on the host and averages per cell (``voxelize.h:9-48``). Here every mode
stays on the device. The averaging modes of the JAX package's
``ops/voxelize.py``, by ``FusionConfig.voxel_mean_mode``:

- ``"rle"`` (:func:`voxelize_average_rle_domains`, four steps):
  1. each point's coordinates are quantized relative to its cell's lower
     corner (10/10/12 bits for x/y/z: error at most cell/2048 in x and y
     and cell/8192 in z), so every value is a small exact integer;
  2. level 1: the run-length reduction (kernel 1) over each raster domain
     in raster order collapses runs of neighbouring pixels that share a
     cell into (cell, partial-sum) rows, with runs broken every 128
     positions so a partial fits two 32-bit words;
  3. the partials of all domains, plus the raster-incoherent ``extra``
     rows (the lidar selection) as single-point partials, are sorted by
     cell (a stable library sort, carrying the two packed words);
  4. level 2: the same reduction over the sorted partials gives one row
     per occupied cell, which is dequantized to the cell's mean point.
- ``"packed"`` (:func:`voxelize_average_packed`): the same quantization,
  a stable sort of every point by cell and one reduction (kernel 1) over
  the sorted stream.
- ``"exact"`` (:func:`voxelize_average`): float32 means of the
  coordinates themselves, summed by the JAX package's log-doubling over
  the stably sorted rows, pass for pass (its bits depend on that order),
  and the run ends compacted (kernel 3).

The quantized sums are exact integers while a cell's sum stays below 2^24
(about 4,096 points a cell at 12 bits), so "rle" and "packed" do not
depend on summation order there: each is bit-equal to the JAX package's
"rle" and "packed", and they equal each other.
"""

from __future__ import annotations

import torch

from ros_gpu_depthmap_fusion_tpu_torch.core.devconst import const
from ros_gpu_depthmap_fusion_tpu_torch.core.grid import VoxelGrid
from ros_gpu_depthmap_fusion_tpu_torch.ops.kernels.segreduce import (
    segreduce, segreduce_plain)
from ros_gpu_depthmap_fusion_tpu_torch.ops.mask_ops import compact_multi
from ros_gpu_depthmap_fusion_tpu_torch.ops.voxel import scatter_occupancy

QUANT_BITS = (10, 10, 12)
LEVEL1_FORCE_BREAK = 128
#: "rle" needs a grid of fewer cells (the JAX package's kernel carries cell
#: ids as exact float32)
RLE_MAX_CELLS = 1 << 24


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


def _cell_means(cells, qsums, cnts, live, grid: VoxelGrid):
    """``[capacity, 4]`` points: each live row's mean of quantized sums
    dequantized in its cell (w = 1), zero rows elsewhere; and the cells
    with 0 at dead rows."""
    dev = cells.device
    safe = torch.where(live, cells, 0)
    mean_q = qsums / torch.clamp_min(cnts[:, None], 1.0)
    corner = grid.world_coord_of_coord(grid.grid_coord_of_index(safe))
    inv_scale = const(grid.cell_size, dev) / const(
        tuple(float(1 << b) for b in QUANT_BITS), dev)
    w_col = live.to(torch.float32)
    means = (corner + (mean_q + 0.5) * inv_scale) * w_col[:, None]
    return torch.cat([means, w_col[:, None]], dim=-1), safe


def resolve_partials_capacity(partials_capacity: int, n: int) -> int:
    """The level-1 rows an "rle" voxelize of ``n`` rows holds:
    ``partials_capacity``, or ``max(2^16, n // 4)`` when it is 0; at most
    ``n``."""
    if partials_capacity <= 0:
        partials_capacity = max(1 << 16, n // 4)
    return min(partials_capacity, n)


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
    if num_cells >= RLE_MAX_CELLS:
        raise ValueError("rle voxelize needs a grid of fewer than 2^24 "
                         f"cells, got {num_cells}")
    n_total = sum(int(m.shape[0]) for _, _, m in domains)
    partials_capacity = resolve_partials_capacity(partials_capacity, n_total)
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
    out_points, safe_cells = _cell_means(cells, sums[:, :3], sums[:, 3],
                                         live, grid)
    return (out_points, count, (safe_cells, live),
            l1_true.to(torch.int32))


def voxelize_average_rle(points: torch.Tensor,
                         cell_indices: torch.Tensor,
                         mask: torch.Tensor,
                         grid: VoxelGrid,
                         capacity: int,
                         return_occupancy=False,
                         partials_capacity: int = 0,
                         return_partials_count: bool = False,
                         extra_points: torch.Tensor | None = None,
                         extra_cell_indices=None,
                         extra_mask=None,
                         plain: bool = False):
    """:func:`voxelize_average_rle_domains` over one raster domain, in the
    JAX package's ``voxelize_average_rle`` form.

    Returns ``(points [capacity, 4], count)``, then with
    ``return_occupancy=True`` the dense ``[num_cells]`` int32 0/1
    occupancy, or with ``"cells"`` the ``(cells, live)`` pair; then with
    ``return_partials_count`` the partials count.
    """
    pts, count, (cells, live), partials = voxelize_average_rle_domains(
        [(points, cell_indices, mask)], grid, capacity,
        partials_capacity=partials_capacity, extra_points=extra_points,
        extra_cell_indices=extra_cell_indices, extra_mask=extra_mask,
        plain=plain)
    ret = (pts, count)
    if return_occupancy == "cells":
        ret += ((cells, live),)
    elif return_occupancy:
        ret += (scatter_occupancy(cells, live, grid.num_cells),)
    if return_partials_count:
        ret += (partials,)
    return ret


def _sorted_quantized(points, cell_indices, mask, grid):
    """Keys stably sorted, and the (qx, qy, qz, 1) rows in that order."""
    sentinel = grid.num_cells
    key = torch.where(mask, cell_indices.to(torch.int32), sentinel)
    q = _quantize_cell_relative(points, cell_indices, grid)
    vals = torch.cat([q, torch.ones_like(q[:, :1])], dim=-1)
    ks, order = torch.sort(key, stable=True)
    return ks.contiguous(), vals[order]


def voxelize_average_packed(points: torch.Tensor,
                            cell_indices: torch.Tensor,
                            mask: torch.Tensor,
                            grid: VoxelGrid,
                            capacity: int,
                            return_occupancy: bool = False,
                            plain: bool = False):
    """Mean point per occupied cell from quantized coordinates (the JAX
    package's ``voxelize_average_packed``).

    Each point is quantized in its cell (10/10/12 bits), the points are
    stably sorted by cell, and one run-length reduction (kernel 1, its
    twin with ``plain=True``) over the sorted stream gives each cell's
    integer sums and count; the means are dequantized in the cell. The
    JAX package sums by log-doubling instead: the sums are integers, so
    the two agree bit for bit while a cell's sums stay below 2^24.

    Returns ``(points [capacity, 4], count)`` — cells in ascending index
    order, zero rows past the count — and with ``return_occupancy`` the
    dense ``[num_cells]`` int32 0/1 occupancy.
    """
    cells, qsums, cnts, count = voxelize_partial_sums(
        points, cell_indices, mask, grid, capacity, plain=plain)
    live = torch.arange(capacity, dtype=torch.int32,
                        device=cells.device) < count
    out_points, safe = _cell_means(cells, qsums, cnts, live, grid)
    if return_occupancy:
        return out_points, count, scatter_occupancy(safe, live,
                                                    grid.num_cells)
    return out_points, count


def voxelize_partial_sums(points: torch.Tensor,
                          cell_indices: torch.Tensor,
                          mask: torch.Tensor,
                          grid: VoxelGrid,
                          capacity: int,
                          plain: bool = False):
    """Per-cell integer sums of :func:`voxelize_average_packed`, before
    the mean, so that shards can add them exactly.

    Returns (cells ``[capacity]`` int32, ``num_cells`` past the count;
    quantized sums ``[capacity, 3]`` float32; member counts ``[capacity]``
    float32; count int32 0-d).
    """
    reduce = segreduce_plain if plain else segreduce
    ks, vals = _sorted_quantized(points, cell_indices, mask, grid)
    cells, sums, count, _ = reduce(ks, vals, capacity, grid.num_cells)
    return cells, sums[:, :3], sums[:, 3], count


def dequantize_cell_means(cells: torch.Tensor, qsums: torch.Tensor,
                          cnts: torch.Tensor, grid: VoxelGrid) -> torch.Tensor:
    """World means ``[M, 4]`` (w = 1, zero rows where the count is 0) from
    per-cell quantized sums: the second half of
    :func:`voxelize_average_packed`."""
    return _cell_means(cells, qsums, cnts, cnts > 0, grid)[0]


def voxelize_average(points: torch.Tensor,
                     cell_indices: torch.Tensor,
                     mask: torch.Tensor,
                     grid: VoxelGrid,
                     capacity: int,
                     return_occupancy: bool = False,
                     plain: bool = False):
    """Exact float32 mean point per occupied cell (the JAX package's
    ``voxelize_average``, ``voxel_mean_mode="exact"``).

    The points are stably sorted by cell, then summed by the JAX package's
    log-doubling, pass for pass: at stride ``s = 1, 2, 4, ...`` every row
    adds the row ``s`` before it when both share a key, so each run's last
    row ends with the run's sums. The float sums depend on that order; a
    scan or an atomic scatter-add would not give the same bits. The run
    ends are compacted by kernel 3 (its twin with ``plain=True``).

    Returns ``(points [capacity, 4], count)`` — cells in ascending index
    order, zero rows past the count — and with ``return_occupancy`` the
    dense ``[num_cells]`` int32 0/1 occupancy.
    """
    num_cells = grid.num_cells
    n = mask.shape[0]
    dev = points.device
    key = torch.where(mask, cell_indices.to(torch.int32), num_cells)
    ks, order = torch.sort(key, stable=True)
    acc = torch.cat([points[order, :3],
                     (ks < num_cells).to(torch.float32)[:, None]], dim=-1)
    zeros = torch.zeros_like(acc)
    s = 1
    while s < n:
        shifted = torch.cat([zeros[:s], acc[:-s]])
        same = torch.cat([torch.zeros((s,), dtype=torch.bool, device=dev),
                          ks[s:] == ks[:-s]])
        acc = acc + torch.where(same[:, None], shifted, 0.0)
        s *= 2
    is_end = torch.cat([ks[1:] != ks[:-1],
                        torch.ones((1,), dtype=torch.bool, device=dev)]) \
        & (ks < num_cells)
    means3 = acc[:, :3] / torch.clamp_min(acc[:, 3:4], 1.0)
    (out_means, out_cells), count, _ = compact_multi(
        (means3, ks), is_end, capacity, plain=plain)
    live = torch.arange(capacity, dtype=torch.int32, device=dev) < count
    out_points = torch.cat([out_means, live.to(torch.float32)[:, None]],
                           dim=-1)
    if return_occupancy:
        return out_points, count, scatter_occupancy(out_cells, live,
                                                    num_cells)
    return out_points, count


def voxelize_occupied(occupancy: torch.Tensor,
                      grid: VoxelGrid,
                      capacity: int,
                      plain: bool = False):
    """World coordinates (cell lower corners, w = 1) of the occupied cells
    of a dense ``[num_cells]`` occupancy, in ascending cell order, zero
    rows past the count. Only the ids of occupied cells are compacted
    (kernel 3, its twin with ``plain=True``); the corners are computed for
    those alone."""
    dev = occupancy.device
    ids = torch.arange(grid.num_cells, dtype=torch.int32, device=dev)
    (out_ids,), count, _ = compact_multi((ids,), occupancy > 0, capacity,
                                         plain=plain)
    live = torch.arange(capacity, dtype=torch.int32, device=dev) < count
    xyz = grid.world_coord_of_index(out_ids)
    pts = torch.cat([xyz, torch.ones_like(xyz[:, :1])], dim=-1)
    return torch.where(live[:, None], pts, 0.0), count


# -- sort / group (the reference's RadixSorter, RadixGrouper, UIntGrouper) --

def sort_by_key(keys: torch.Tensor, *payloads):
    """Stable ascending sort of integer keys carrying payloads (reference
    ``RadixSorter::sort``, radix_sort.h:108-239); returns the sorted keys
    and payloads."""
    ks, order = torch.sort(keys, stable=True)
    return (ks,) + tuple(p[order] for p in payloads)


def group_by_key(keys: torch.Tensor, mask: torch.Tensor,
                 group_capacity: int, plain: bool = False):
    """Sort and run-length-group equal keys (reference
    ``RadixGrouper::group``, radix_grouper.h:35-64); masked entries sort
    to the end (key int32 max) and join no group.

    Returns a dict: ``sorted_indices`` and ``sorted_keys`` ``[N]``;
    ``group_starts``, ``group_sizes``, ``group_values``
    ``[group_capacity]``; ``num_groups`` int32 0-d.
    """
    n = keys.shape[0]
    dev = keys.device
    big = (1 << 31) - 1
    k = torch.where(mask, keys.to(torch.int32), big)
    idx = torch.arange(n, dtype=torch.int32, device=dev)
    ks, sorted_idx = sort_by_key(k, idx)
    valid = ks != big
    first = torch.ones((1,), dtype=torch.bool, device=dev)
    is_start = valid & torch.cat([first, ks[1:] != ks[:-1]])
    (group_starts, group_values), num_groups, _ = compact_multi(
        (idx, ks), is_start, group_capacity, plain=plain)
    valid_count = valid.sum(dtype=torch.int32)
    next_starts = torch.cat([group_starts[1:], group_starts.new_zeros(1)])
    gi = torch.arange(group_capacity, dtype=torch.int32, device=dev)
    ends = torch.where(gi == num_groups - 1, valid_count, next_starts)
    group_sizes = torch.where(gi < num_groups, ends - group_starts, 0)
    return {"sorted_indices": sorted_idx, "sorted_keys": ks,
            "group_starts": group_starts, "group_sizes": group_sizes,
            "group_values": group_values, "num_groups": num_groups}


def bincount_group(values: torch.Tensor, mask: torch.Tensor,
                   num_bins: int):
    """Counting-sort grouping by a small integer key (reference
    ``UIntGrouper::group``, uint_grouper.h:44-102).

    Returns (counts ``[num_bins]`` int32, starts ``[num_bins]`` int32,
    grouped_indices ``[N]`` int32: the original indices, stably ordered
    by bin, masked entries last).
    """
    n = values.shape[0]
    dev = values.device
    v = values.to(torch.int32)
    target = torch.where(mask, v, num_bins)
    binned = mask & (v >= 0) & (v < num_bins)
    counts = torch.zeros((num_bins + 1,), dtype=torch.int32, device=dev)
    counts.index_add_(0, torch.where(binned, v, num_bins).long(),
                      binned.to(torch.int32))
    counts = counts[:num_bins]
    starts = torch.cumsum(counts, 0, dtype=torch.int32) - counts
    idx = torch.arange(n, dtype=torch.int32, device=dev)
    return counts, starts, sort_by_key(target, idx)[1]
