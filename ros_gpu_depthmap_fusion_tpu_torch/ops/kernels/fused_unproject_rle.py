"""Kernel 4: the fused raster front (``csrc/fused_unproject_rle.cu``).

From masked metric depth, in one kernel: unprojection, the world and
crop transforms, the crop test, the clamped cell index, the cell-relative
10/10/12-bit quantization and the level-1 run-length reduction, giving
the raster's (cell, partial-sum) rows without materializing the point
clouds.

Counterpart of the JAX package's
``ops/pallas/fused_unproject_rle.py:128 unproject_voxelize_l1``, with the
same contract and return. The stream runs over rows padded to
``Wp = ceil(W / 128) * 128`` columns, so its runs break at every row start
and every 128th column; the row set therefore differs from the level 1 of
``ops.voxelize`` (breaks every 128 unpadded positions), and only level-2
totals per cell compare with that chain. The JAX engine does not call this
op, and neither does the port's engine: it is a tested alternative front.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ros_gpu_depthmap_fusion_tpu_torch.core.devconst import const
from ros_gpu_depthmap_fusion_tpu_torch.ops.kernels.segreduce import (
    segreduce_plain)

#: launches of the CUDA kernel by :func:`unproject_voxelize_l1` in this
#: process
launches = 0

_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p)
LANES = 128
# the kernel keeps [C, 32] parameters in shared memory beside a tile's keys
# and packed values (16 KB), within the 48 KB a kernel gets without opting in
MAX_CAMERAS = 128


def padded_width(width: int) -> int:
    return -(-width // LANES) * LANES


def camera_params(intr: torch.Tensor, tf_world: torch.Tensor,
                  tf_crop: torch.Tensor) -> torch.Tensor:
    """``[C, 32]`` float32 per-camera table, as the JAX kernel's: fx fy cx
    cy, rows 0-2 of the world transform, rows 0-2 of the crop transform,
    4 zeros."""
    c = intr.shape[0]
    return torch.cat([intr.to(torch.float32),
                      tf_world[:, :3, :].reshape(c, 12).to(torch.float32),
                      tf_crop[:, :3, :].reshape(c, 12).to(torch.float32),
                      intr.new_zeros((c, 4), dtype=torch.float32)],
                     dim=1).contiguous()


def grid_consts(grid, crop_min, crop_max, device) -> torch.Tensor:
    """``[32]`` float32 (cached per device): grid lower[3], cell size[3],
    grid size - 1[3], gs0, gs0 * gs1, crop min[3], crop max[3], zeros."""
    gs = grid.grid_size
    vals = (tuple(grid.lower) + tuple(grid.cell_size)
            + tuple(g - 1.0 for g in gs) + (gs[0], gs[0] * gs[1])
            + tuple(crop_min) + tuple(crop_max))
    vals = tuple(float(v) for v in vals) + (0.0,) * (32 - len(vals))
    return const(vals, device)


def _check_grid(grid):
    if grid.num_cells >= (1 << 24):
        raise ValueError("unproject_voxelize_l1 needs a grid of fewer than "
                         f"2^24 cells (exact float keys), got "
                         f"{grid.num_cells}")


def unproject_voxelize_l1_plain(depth_m, intr, tf_world, tf_crop, grid,
                                crop_min, crop_max, capacity: int,
                                force_break: int = 128):
    """Plain PyTorch twin of :func:`unproject_voxelize_l1` (the padded image
    through elementwise ops in the kernel's order, then
    :func:`segreduce_plain`); same contract, any device."""
    _check_grid(grid)
    c, h, w = depth_m.shape
    wp = padded_width(w)
    dev = depth_m.device
    g = grid_consts(grid, crop_min, crop_max, dev)
    p = camera_params(intr, tf_world, tf_crop).reshape(c, 32, 1, 1)
    d = F.pad(depth_m.to(torch.float32), (0, wp - w))        # [C, H, Wp]
    col = torch.arange(wp, dtype=torch.float32, device=dev).reshape(1, 1, wp)
    row = torch.arange(h, dtype=torch.float32, device=dev).reshape(1, h, 1)
    x = (col - p[:, 2]) / p[:, 0] * d
    y = (row - p[:, 3]) / p[:, 1] * d

    def transform(base):
        return [((p[:, base + 4 * r] * x + p[:, base + 4 * r + 1] * y)
                 + p[:, base + 4 * r + 2] * d) + p[:, base + 4 * r + 3]
                for r in range(3)]

    world = transform(4)
    crop = transform(16)
    m = d > 0.0
    for a in range(3):
        m = m & (crop[a] >= g[11 + a]) & (crop[a] <= g[14 + a])
    cells = [torch.floor(torch.minimum(
        torch.clamp_min((world[a] - g[a]) / g[3 + a], 0.0), g[6 + a]))
        for a in range(3)]
    cell = (cells[0] + cells[1] * g[9]) + cells[2] * g[10]
    mf = m.to(torch.float32)
    vals = []
    for a, bits in enumerate((10, 10, 12)):
        q = torch.floor((world[a] - (g[a] + cells[a] * g[3 + a])) / g[3 + a]
                        * float(1 << bits))
        vals.append(torch.clamp(q, 0.0, float((1 << bits) - 1)) * mf)
    sentinel = grid.num_cells
    key = torch.where(m, cell, float(sentinel)).to(torch.int32).reshape(-1)
    vals = torch.stack(vals + [mf], dim=-1).reshape(-1, 4)
    keys, sums, count, true_count = segreduce_plain(
        key, vals, capacity, sentinel, force_break)
    return keys, sums, count, true_count, m.sum(dtype=torch.int32)


def unproject_voxelize_l1(depth_m: torch.Tensor, intr: torch.Tensor,
                          tf_world: torch.Tensor, tf_crop: torch.Tensor,
                          grid, crop_min, crop_max, capacity: int,
                          force_break: int = 128):
    """Level-1 raster partials straight from masked metric depth.

    Args:
        depth_m: ``[C, H, W]`` float32 depth in metres, 0 for every invalid
            pixel (holes and flying-pixel-filtered).
        intr: ``[C, 4]`` (fx, fy, cx, cy).
        tf_world / tf_crop: ``[C, 4, 4]`` world <- camera / crop <- camera.
        grid: the :class:`~core.grid.VoxelGrid` (fewer than 2^24 cells).
        crop_min / crop_max: the crop box (crop frame).
        capacity: output rows; runs past it are dropped.
        force_break: ``k > 0`` starts a run at every padded stream position
            divisible by ``k``.

    Returns:
        (keys ``[capacity]`` int32, the sentinel ``grid.num_cells`` past the
        count; sums ``[capacity, 4]`` float32 (qx, qy, qz, count), zero
        past it; count clamped to capacity, true count and valid-point
        count, each int32 0-d).

    A CPU tensor runs :func:`unproject_voxelize_l1_plain`; a CUDA tensor
    launches the kernel (built on first use) or raises.
    """
    if depth_m.device.type == "cpu":
        return unproject_voxelize_l1_plain(depth_m, intr, tf_world, tf_crop,
                                           grid, crop_min, crop_max,
                                           capacity, force_break)
    if depth_m.device.type != "cuda":
        raise ValueError(f"unproject_voxelize_l1: unsupported device "
                         f"{depth_m.device}")
    _check_grid(grid)
    if depth_m.dtype != torch.float32 or depth_m.ndim != 3 \
            or not depth_m.is_contiguous():
        raise ValueError("unproject_voxelize_l1: depth_m must be a "
                         "contiguous [C, H, W] float32 tensor, got "
                         f"{depth_m.dtype} {tuple(depth_m.shape)}")
    c, h, w = depth_m.shape
    for name, t, shape in (("intr", intr, (c, 4)),
                           ("tf_world", tf_world, (c, 4, 4)),
                           ("tf_crop", tf_crop, (c, 4, 4))):
        if tuple(t.shape) != shape or t.device != depth_m.device:
            raise ValueError(f"unproject_voxelize_l1: {name} must be "
                             f"{shape} on {depth_m.device}, got "
                             f"{tuple(t.shape)} on {t.device}")
    wp = padded_width(w)
    if not 1 <= c <= MAX_CAMERAS or capacity < 1 or c * h * wp > 2 ** 30:
        raise ValueError(f"unproject_voxelize_l1: unsupported C={c}, "
                         f"capacity={capacity}, stream {c * h * wp}")
    from ros_gpu_depthmap_fusion_tpu_torch.ops.kernels import _build
    fn = _build.function("fusion_unproject_rle", _ARGTYPES)
    dev = depth_m.device
    sentinel = grid.num_cells
    params = camera_params(intr, tf_world, tf_crop)
    consts = grid_consts(grid, crop_min, crop_max, dev)
    # the kernel writes every row: runs below the count, the sentinel and
    # zeros past it; the counts are the first three words of its scratch,
    # zeroed with the look-back descriptors by the launch's one memset
    out_keys = torch.empty((capacity,), dtype=torch.int32, device=dev)
    out_sums = torch.empty((capacity, 4), dtype=torch.float32, device=dev)
    scratch = torch.empty(
        (_build.scratch_bytes("fusion_unproject_rle", c * h * wp),),
        dtype=torch.uint8, device=dev)
    p = _build.ptr
    status = fn(p(depth_m), p(params), p(consts), c, h, w, wp, sentinel,
                int(force_break), capacity, p(scratch), p(out_keys),
                p(out_sums), _build.stream_ptr(depth_m))
    _build.check(status, "unproject_voxelize_l1")
    global launches
    launches += 1
    counts = scratch[:12].view(torch.int32)
    return out_keys, out_sums, counts[0], counts[1], counts[2]
