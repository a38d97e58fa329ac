"""Drive the PyTorch port's FusionEngine end to end: a 4-camera rig around
a synthetic room plus a lidar stream, 30 frames, printing throughput, then
object segmentation and tracking on the final occupancy.

Run: PYTHONPATH=.:$PYTHONPATH python examples_torch/run_engine_demo.py \
    [--device cuda|cpu] [--frames 30]
"""
import argparse
import time

import numpy as np
import torch

from ros_gpu_depthmap_fusion_tpu_torch.core import transforms
from ros_gpu_depthmap_fusion_tpu_torch.core.camera import PinholeIntrinsics
from ros_gpu_depthmap_fusion_tpu_torch.core.config import FusionConfig
from ros_gpu_depthmap_fusion_tpu_torch.pipeline import FusionEngine
from ros_gpu_depthmap_fusion_tpu_torch.utils.profiling import hard_sync


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--frames", type=int, default=30)
    args = ap.parse_args()
    dev = torch.device(args.device)
    print("device:", dev)
    H, W, C = 480, 848, 4
    cfg = FusionConfig(
        num_depth_streams=C, depth_height=H, depth_width=W,
        num_point_sequences=1,
        crop_min=(-10, -10, 0), crop_max=(10, 10, 3),
        voxel_min=(-10, -10, 0), voxel_max=(10, 10, 3),
        voxel_size=(0.1, 0.1, 0.1),
        voxel_occupancy_lifetime=10,
        rollbuffer_point_capacity=131072,
        max_points_per_sequence=32768,
    )
    eng = FusionEngine(cfg, dev, enable_mapping=True)
    intr = PinholeIntrinsics.default_for(W, H)

    # 4 cameras at the corners of a square, 2 m up, looking inward+down
    cams = []
    for i in range(C):
        ang = i * np.pi / 2
        pos = np.array([4 * np.cos(ang), 4 * np.sin(ang), 2.0])
        cams.append(transforms.make_se3(
            transforms.rot_z(ang + np.pi) @ transforms.rot_x(-np.pi / 2 - 0.4),
            pos))

    rng = np.random.default_rng(0)
    u, v = np.meshgrid(np.arange(W), np.arange(H))
    base = (2500 + 200 * np.sin(u / 150.0) + 150 * np.cos(v / 120.0))

    t_lidar = np.linspace(0, np.pi, 2048)
    arc = np.stack([5 * np.cos(t_lidar), 5 * np.sin(t_lidar),
                    1.0 + 0 * t_lidar], axis=-1)

    frames = args.frames
    t_total = 0.0
    for f in range(frames):
        depth = (base + 1.0 * rng.standard_normal((H, W))).astype(np.uint16)
        depth[rng.random((H, W)) < 0.01] = 0
        for i in range(C):
            eng.add_depthmap(i, depth, intr, cams[i], cams[i])
        eng.add_point_sequence(arc, sec=10 + f // 30,
                               nsec=int((f % 30) * 33e6),
                               tf_move=np.eye(4, dtype=np.float32))
        t0 = time.time()
        out = eng.process(10.0 + f / 30.0)
        hard_sync(dev)
        dt = time.time() - t0
        if f == 0:
            print(f"first frame (kernel build or load): {dt:.1f}s")
        else:
            t_total += dt
    per = t_total / (frames - 1)
    print(f"steady state: {per * 1e3:.2f} ms/frame -> {1 / per:.1f} fps "
          f"({C} cams {W}x{H} + lidar, grid {eng.grid.grid_size})")
    print("raw points:", int(out.raw_count), "fused:", int(out.fused_count),
          "lidar selected:", int(out.seq_selected_count))
    occ = out.occupancy_u8.cpu().numpy()
    print("occupied cells:", int((occ > 0).sum()), "/", eng.grid.num_cells)
    assert int(out.raw_count) > 100000
    assert int(out.seq_selected_count) > 0
    assert (occ > 0).sum() > 100

    # object segmentation + tracking on the final occupancy grid
    t0 = time.time()
    res = eng.segment_and_track(out)
    print(f"segment+track: {time.time() - t0:.2f}s; "
          f"objects={res.num_merged - 1} tracks={len(res.tracks)} "
          f"new={res.stats.num_new_tracks}")
    t0 = time.time()
    res2 = eng.segment_and_track(out)
    print(f"second frame: {time.time() - t0:.2f}s "
          f"updated={res2.stats.num_updated_tracks}")
    assert res.num_merged >= 1
    eng.close()
    print("ENGINE DEMO OK")


if __name__ == "__main__":
    main()
