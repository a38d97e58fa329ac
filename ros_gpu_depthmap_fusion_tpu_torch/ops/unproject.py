"""Depth-map unprojection (``shader/convert_depthmap_to_points.glsl``).

Unprojects a ``[C, H, W]`` u16 depth batch through per-camera pinhole
intrinsics to camera-frame points, and produces world- and crop-frame
copies plus the validity mask (zero depth -> masked, zeroed points).
"""

from __future__ import annotations

import torch

from ros_gpu_depthmap_fusion_tpu_torch.core.devconst import const
from ros_gpu_depthmap_fusion_tpu_torch.core.transforms import (
    transform_points_batched)


def unproject_depthmaps(depth_u16: torch.Tensor,
                        intrinsics: torch.Tensor,
                        tf_world: torch.Tensor,
                        tf_crop: torch.Tensor,
                        depth_scale):
    """Unproject a batch of depth maps.

    Args:
        depth_u16:  ``[C, H, W]`` integer depth images (u16 values in any
            integer dtype).
        intrinsics: ``[C, 4]`` float32 (fx, fy, cx, cy) per camera.
        tf_world:   ``[C, 4, 4]`` world <- camera.
        tf_crop:    ``[C, 4, 4]`` crop <- camera.
        depth_scale: depth unit -> meters, a float shared by all streams or
            a ``[C]`` sequence.

    Returns:
        points_cam, points_world, points_crop: ``[C, H*W, 4]`` float32
        (zeros where invalid), and mask ``[C, H*W]`` bool.
    """
    c, h, w = depth_u16.shape
    dev = depth_u16.device
    depth = depth_u16.reshape(c, h * w).to(torch.float32)
    mask = depth > 0

    lin = torch.arange(h * w, dtype=torch.int32, device=dev)
    u = torch.remainder(lin, w).to(torch.float32)[None, :]
    v = torch.div(lin, w, rounding_mode="floor").to(torch.float32)[None, :]

    fx = intrinsics[:, 0:1]
    fy = intrinsics[:, 1:2]
    cx = intrinsics[:, 2:3]
    cy = intrinsics[:, 3:4]

    scale = const(depth_scale, dev)
    if scale.ndim == 1:
        scale = scale[:, None]          # per-camera [C, 1]
    z = depth * scale
    x = (u - cx) / fx * z
    y = (v - cy) / fy * z

    points_cam = torch.stack([x, y, z, torch.ones_like(z)], dim=-1)
    m4 = mask[..., None]
    points_cam = torch.where(m4, points_cam, 0.0)
    points_world = torch.where(
        m4, transform_points_batched(points_cam, tf_world), 0.0)
    points_crop = torch.where(
        m4, transform_points_batched(points_cam, tf_crop), 0.0)
    return points_cam, points_world, points_crop, mask
