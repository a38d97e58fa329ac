"""Validity-mask stencil filters.

- :func:`filter_flying_pixels` — ``shader/filter_flying_pixels.glsl``, the
  2-D depth-image filter: the wrapper of kernel 2
  (:mod:`ops.kernels.flying_pixels`), whose plain twin is the whole-image
  torch stencil.
- :func:`filter_point_sequence` — ``shader/filter_point_sequence.glsl``:
  along a 1-D lidar scan, reject points whose neighbour direction is nearly
  parallel to the view ray. Plain torch: it runs on the few thousand
  staged points of a frame.
"""

from __future__ import annotations

import torch

from ros_gpu_depthmap_fusion_tpu_torch.core.devconst import scalar_f32
from ros_gpu_depthmap_fusion_tpu_torch.ops.kernels import flying_pixels

filter_flying_pixels = flying_pixels.filter_flying_pixels


def _norm3(x, y, z):
    return torch.sqrt((x * x + y * y) + z * z)


def filter_point_sequence(points: torch.Tensor,
                          mask: torch.Tensor,
                          valid_count,
                          filter_size: int,
                          threshold) -> torch.Tensor:
    """1-D scan-order flying-point filter (``filter_point_sequence.glsl:
    96-116``): for point i, test neighbour offsets
    ``{-1, .., filter_size-2} U {1, .., filter_size}`` (the self offset 0,
    a NaN-compare no-op in the reference, is skipped); reject the point
    when ``1 - |cos(dir_to_neighbour, view_ray)| < threshold`` for any
    in-range neighbour, or when ``|p| < 1e-3``.

    Args:
        points: ``[N, 4]`` points in the sensor frame.
        mask: ``[N]`` bool input validity.
        valid_count: int or 0-d tensor — live items; neighbours past it
            never count.
        filter_size: neighbour span.
        threshold: float or 0-d tensor, threshold on ``1 - |cos|``.

    Returns:
        ``[N]`` bool output mask.
    """
    n = points.shape[0]
    dev = points.device
    px, py, pz = points[:, 0], points[:, 1], points[:, 2]
    idx = torch.arange(n, dtype=torch.int32, device=dev)
    threshold = scalar_f32(threshold, dev)

    norm_p = _norm3(px, py, pz)
    out = mask & (idx < valid_count) & (norm_p >= 1e-3)
    den = torch.clamp_min(norm_p, 1e-30)
    vx, vy, vz = -px / den, -py / den, -pz / den

    offsets = sorted(set(range(-1, filter_size - 1))
                     | set(range(1, filter_size + 1)))
    for d in offsets:
        if d == 0:
            continue  # the reference's self-compare is a NaN no-op
        neigh_valid = (idx + d >= 0) & (idx + d < valid_count)
        dx = torch.roll(px, -d) - px
        dy = torch.roll(py, -d) - py
        dz = torch.roll(pz, -d) - pz
        dn = torch.clamp_min(_norm3(dx, dy, dz), 1e-30)
        cos_between = torch.abs(
            (dx / dn * vx + dy / dn * vy) + dz / dn * vz)
        out = out & ~(neigh_valid & (1.0 - cos_between < threshold))
    return out
