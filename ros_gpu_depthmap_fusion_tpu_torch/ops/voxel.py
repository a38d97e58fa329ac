"""Voxel occupancy ops (``gpu_depthmap_fusion.cpp:1757-1823``).

- ``voxel_grid_occupancy_of_points`` -> :func:`scatter_occupancy` (a
  deterministic scatter of one value).
- ``decrement_uints`` + ``max_with_uints_times_scalar`` ->
  :func:`update_historic_occupancy`.
- ``uints_to_chars`` -> :func:`occupancy_to_u8`.
- the mapping consumer's payloads -> :func:`occupancy_bitmap` (8 cells a
  byte) and :func:`occupancy_bitmap_sparse` (nonzero 128-bit blocks).
"""

from __future__ import annotations

import torch

from ros_gpu_depthmap_fusion_tpu_torch.core.devconst import const
from ros_gpu_depthmap_fusion_tpu_torch.ops.mask_ops import compact_multi


def scatter_occupancy(cell_indices: torch.Tensor,
                      mask: torch.Tensor,
                      num_cells: int,
                      occupied_value: int = 1) -> torch.Tensor:
    """``[num_cells]`` int32 grid holding ``occupied_value`` at each valid
    point's cell and 0 elsewhere."""
    target = torch.where(mask, cell_indices.to(torch.int64), num_cells)
    occ = torch.zeros((num_cells + 1,), dtype=torch.int32,
                      device=cell_indices.device)
    occ[target] = occupied_value
    return occ[:num_cells]


def update_historic_occupancy(historic: torch.Tensor,
                              fresh: torch.Tensor,
                              lifetime: int,
                              decrement: int = 1,
                              min_value: int = 0) -> torch.Tensor:
    """One temporal-decay step: age by a saturating decrement, then take
    the max with ``fresh * lifetime`` (reference order,
    gpu_depthmap_fusion.cpp:1796-1812)."""
    aged = torch.clamp_min(historic - decrement, min_value)
    return torch.maximum(aged, fresh * lifetime)


def occupancy_to_u8(grid: torch.Tensor) -> torch.Tensor:
    """int32 occupancy -> uint8 (clamp-cast)."""
    return torch.clamp(grid, 0, 255).to(torch.uint8)


def occupancy_bitmap(grid: torch.Tensor) -> torch.Tensor:
    """Binarized occupancy packed 8 cells a byte, little-endian bit order
    (``np.unpackbits(..., bitorder="little")`` inverts it)."""
    n = grid.shape[0]
    m = -(-n // 8) * 8
    bits = torch.nn.functional.pad((grid > 0).to(torch.int32), (0, m - n))
    weights = const((1, 2, 4, 8, 16, 32, 64, 128), grid.device,
                    torch.int32)
    return (bits.reshape(-1, 8) * weights).sum(-1).to(torch.uint8)


def occupancy_bitmap_sparse(grid: torch.Tensor, capacity: int,
                            plain: bool = False):
    """The NONZERO 128-bit blocks (4 u32 words = 128 cells) of
    :func:`occupancy_bitmap` as (block index, 4 words) rows, compacted in
    block order by the compaction kernel (its plain twin when
    ``plain=True``).

    Returns ``(block_idx [capacity] int32, words [capacity, 4] int32 — u32
    bit patterns, count int32 clamped to capacity, true_count int32)``;
    ``true_count > capacity`` means blocks were dropped.
    """
    packed = occupancy_bitmap(grid)                        # [B] u8
    b = packed.shape[0]
    nb = -(-b // 16) * 16
    # little-endian: 4 consecutive bytes are one word, byte 0 lowest
    words = torch.nn.functional.pad(packed, (0, nb - b)).view(
        torch.int32).reshape(-1, 4)
    nz = torch.any(words != 0, dim=1)
    idx = torch.arange(words.shape[0], dtype=torch.int32,
                       device=grid.device)
    (oi, ow), cnt, true_cnt = compact_multi((idx, words), nz, capacity,
                                            plain=plain)
    return oi, ow, cnt, true_cnt
