"""Drive the PyTorch port's ops end to end on one depth camera: synthetic
640x480 depth -> unproject -> flying-pixel filter -> crop -> compact ->
voxel occupancy + decay -> occupied cell corners, with ms/frame and three
probes (zero depth, decay to extinction, compaction overflow).

Run: PYTHONPATH=.:$PYTHONPATH python examples_torch/run_minimal_slice.py \
    [--device cuda|cpu]
"""
import argparse
import time

import numpy as np
import torch

from ros_gpu_depthmap_fusion_tpu_torch.core import transforms
from ros_gpu_depthmap_fusion_tpu_torch.core.camera import PinholeIntrinsics
from ros_gpu_depthmap_fusion_tpu_torch.core.grid import VoxelGrid
from ros_gpu_depthmap_fusion_tpu_torch.ops.kernels.flying_pixels import (
    filter_flying_pixels)
from ros_gpu_depthmap_fusion_tpu_torch.ops.mask_ops import (
    compact, crop_points)
from ros_gpu_depthmap_fusion_tpu_torch.ops.unproject import (
    unproject_depthmaps)
from ros_gpu_depthmap_fusion_tpu_torch.ops.voxel import (
    occupancy_to_u8, scatter_occupancy, update_historic_occupancy)
from ros_gpu_depthmap_fusion_tpu_torch.ops.voxelize import voxelize_occupied
from ros_gpu_depthmap_fusion_tpu_torch.utils.profiling import hard_sync


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    dev = torch.device(args.device)
    print("device:", dev)
    H, W = 480, 640
    intr = PinholeIntrinsics.default_for(W, H)
    grid = VoxelGrid(lower=(-4, -4, 0), upper=(4, 4, 2.5),
                     cell_size=(0.1, 0.1, 0.1))
    print("grid:", grid.grid_size, grid.num_cells, "cells")

    # synthetic scene: floor plane + a box, camera looking down +z
    rng = np.random.default_rng(0)
    u, v = np.meshgrid(np.arange(W), np.arange(H))
    depth_m = np.full((H, W), 3.0)
    box = (np.abs(u - 320) < 60) & (np.abs(v - 240) < 80)
    depth_m[box] = 1.5
    depth_u16 = (depth_m / 0.001).astype(np.uint16)
    depth_u16[rng.random((H, W)) < 0.05] = 0  # dropouts

    tf = torch.from_numpy(transforms.make_se3(
        transforms.rot_x(-np.pi / 2), np.array([0, 0, 1.0])))[None].to(dev)
    intr_t = torch.from_numpy(intr.as_array()).float()[None].to(dev)

    def step(depth, hist):
        pc, pw, pcr, m = unproject_depthmaps(depth[None], intr_t, tf, tf,
                                             0.001)
        m = filter_flying_pixels(pc, m, H, W, 1, 0.5, True, 10.0)
        m = crop_points(pcr, m, (-4, -4, 0), (4, 4, 2.5))
        pts, count = compact(pw.reshape(-1, 4), m.reshape(-1), H * W)
        ids = grid.cell_index_clamped(pts[:, :3])
        valid = torch.arange(H * W, device=dev) < count
        occ = scatter_occupancy(ids, valid, grid.num_cells)
        hist = update_historic_occupancy(hist, occ, lifetime=10)
        centers, ncells = voxelize_occupied(hist, grid, 20000)
        return count, hist, occupancy_to_u8(hist), centers, ncells

    depth = torch.from_numpy(depth_u16.astype(np.int32)).to(dev)
    hist = torch.zeros((grid.num_cells,), dtype=torch.int32, device=dev)
    t0 = time.time()
    count, hist, occ8, centers, ncells = step(depth, hist)
    hard_sync(dev)
    print(f"first call (kernel build or load): {time.time() - t0:.1f}s")
    t0 = time.time()
    iters = 20
    for _ in range(iters):
        count, hist, occ8, centers, ncells = step(depth, hist)
    hard_sync(dev)
    dt = (time.time() - t0) / iters
    print(f"steady state: {dt * 1e3:.2f} ms/frame -> {1 / dt:.1f} fps "
          "(1 cam 640x480)")
    print("valid points after filters:", int(count), "/", H * W)
    print("occupied cells:", int(ncells))
    c = centers[:int(ncells)].cpu().numpy()
    print("center z range:", c[:, 2].min(), c[:, 2].max())
    assert int(count) > 100000, "filters rejected almost everything"
    assert 0 < int(ncells) < 20000
    print("sample centers:", c[:3])

    # probe 1: all-zero depth -> zero points, zero fresh occupancy, history
    # decays
    zero = torch.zeros((H, W), dtype=torch.int32, device=dev)
    count0, hist2, _, _, n2 = step(zero, hist)
    print("probe zero-depth: count =", int(count0), "cells:", int(n2))
    assert int(count0) == 0
    assert int(n2) == int(ncells)  # decayed by 1 but still > 0 (lifetime 10)

    # probe 2: decay to extinction after lifetime frames
    h = hist2
    for _ in range(12):
        _, h, _, _, nl = step(zero, h)
    print("probe decay: cells after 12 empty frames =", int(nl))
    assert int(nl) == 0

    # probe 3: compaction capacity overflow is explicit, not corruption
    pts_over, cnt_over = compact(torch.ones((100, 4), device=dev),
                                 torch.ones(100, dtype=torch.bool,
                                            device=dev), 10)
    assert int(cnt_over) == 10 and pts_over.shape == (10, 4)
    print("probe overflow: capped at", int(cnt_over))
    print("ALL CHECKS PASSED")


if __name__ == "__main__":
    main()
