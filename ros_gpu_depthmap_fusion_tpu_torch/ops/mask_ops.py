"""Mask predicates and stable stream compaction.

- :func:`crop_points` — ``shader/crop_points.glsl:47-66``: AABB test in the
  crop frame, ANDed into the validity mask.
- :func:`compact` / :func:`compact_multi` — stable compaction of the
  flagged rows into a static capacity (the reference's atomic-counter
  ``shader/apply_point_mask.glsl`` made deterministic). Rows move as raw
  32-bit words through :func:`ops.kernels.compact.compact_rows`, the
  hand-written CUDA kernel on the card and its plain twin on the CPU.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ros_gpu_depthmap_fusion_tpu_torch.core.devconst import const
from ros_gpu_depthmap_fusion_tpu_torch.ops.kernels.compact import (
    compact_plain, compact_rows)

_WORD_DTYPES = (torch.int32, torch.float32)


def crop_points(points: torch.Tensor,
                mask: torch.Tensor,
                lower: Tuple[float, float, float],
                upper: Tuple[float, float, float]) -> torch.Tensor:
    """AND an axis-aligned-box containment test into the mask.

    Args:
        points: ``[..., 4]`` points in the crop frame.
        mask:   ``[...]`` bool.
    """
    lo = const(lower, points.device)
    hi = const(upper, points.device)
    xyz = points[..., :3]
    inside = torch.all((xyz >= lo) & (xyz <= hi), dim=-1)
    return mask & inside


def compact_multi(arrays, mask: torch.Tensor, capacity: int,
                  plain: bool = False):
    """Compact several parallel ``[N, ...]`` int32/float32 arrays with one
    pass: rows ``[0, count)`` of each output hold the flagged rows in input
    order, the rest zero.

    ``plain=True`` runs the plain PyTorch twin on any device (the on-card
    reference).

    Returns (tuple of compacted arrays, count clamped to capacity, true
    count) — the counts are int32 0-d tensors on the input's device.
    """
    arrays = tuple(arrays)
    n = mask.shape[0]
    cols = []
    for a in arrays:
        if a.dtype not in _WORD_DTYPES:
            raise TypeError(f"compact_multi moves 32-bit words; got {a.dtype}")
        cols.append(a.reshape(n, -1).view(torch.int32))
    words = torch.cat(cols, dim=1)
    fn = compact_plain if plain else compact_rows
    out, count, true_count = fn(words.contiguous(), mask, capacity)
    outs, col = [], 0
    for a, c in zip(arrays, cols):
        k = c.shape[1]
        outs.append(out[:, col:col + k].contiguous().view(a.dtype)
                    .reshape((capacity,) + tuple(a.shape[1:])))
        col += k
    return tuple(outs), count, true_count


def compact(values: torch.Tensor, mask: torch.Tensor, capacity: int
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stable stream compaction of ``values`` rows where ``mask`` is set.

    Returns (out ``[capacity, ...]`` — rows ``[0, count)`` are the flagged
    rows in order, the rest zero — and count, int32, clamped to capacity).
    """
    (out,), count, _ = compact_multi((values,), mask, capacity)
    return out, count
