"""Drive the PyTorch port's SLAM frontend + windowed BA on a textured
synthetic scene: an orbiting camera, FAST/BRIEF features + RANSAC odometry
on the device, Schur-complement BA refinement, ATE report.

Run: PYTHONPATH=.:$PYTHONPATH python examples_torch/run_slam_demo.py \
    [--device cuda|cpu]
"""
import argparse
import time

import numpy as np
import torch

from ros_gpu_depthmap_fusion_tpu_torch.core.camera import PinholeIntrinsics
from ros_gpu_depthmap_fusion_tpu_torch.core import transforms
from ros_gpu_depthmap_fusion_tpu_torch.pipeline.datasets import (
    SyntheticRigDataset, Sphere, Box)
from ros_gpu_depthmap_fusion_tpu_torch.slam.frontend import RgbdOdometry
from ros_gpu_depthmap_fusion_tpu_torch.slam.ate import (
    ate_rmse, trajectory_positions)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    device = torch.device(args.device)
    print("device:", device, torch.cuda.get_device_name(device)
          if device.type == "cuda" else "")
    intr = PinholeIntrinsics.default_for(320, 240)
    rng = np.random.default_rng(0)
    spheres = [Sphere(rng.uniform(-2.5, 2.5, 3) + [0, 0, 4.0],
                      rng.uniform(0.3, 0.6)) for _ in range(10)]
    boxes = [Box(np.array([-1.0, -1.0, 5.0]), np.array([1.0, 1.0, 6.5]))]
    ds = SyntheticRigDataset(intr, spheres=spheres, boxes=boxes,
                             ground_z=None)
    odo = RgbdOdometry(intr, device, max_keypoints=384, min_inliers=10,
                       keyframe_translation=0.10, inlier_threshold=0.08)

    poses_true = []
    t0 = time.time()
    n_frames = 20
    for f in range(n_frames):
        t = f * 0.05
        pose = transforms.make_se3(
            transforms.rot_y(0.03 * f) @ transforms.rot_z(0.01 * f),
            np.array([t, 0.3 * np.sin(t * 2), 0.05 * f]))
        poses_true.append(pose)
        depth_u16, intensity = ds.render(pose)
        r = odo.process(f / 30.0, intensity, depth_u16 * 0.001)
        if f in (0, 1, n_frames - 1):
            print(f"frame {f}: matches={r.num_matches} "
                  f"inliers={r.num_inliers} rmse={r.rmse:.4f} "
                  f"kf={r.is_keyframe}")
    dt = time.time() - t0
    print(f"{n_frames} frames in {dt:.1f}s "
          f"({dt/n_frames*1e3:.0f} ms/frame incl. first-call set-up)")

    est = trajectory_positions(np.stack([p for _, p in odo.trajectory]))
    gt = trajectory_positions(np.stack(poses_true))
    rmse = ate_rmse(est, gt)
    print(f"odometry ATE RMSE: {rmse*100:.2f} cm over "
          f"{np.linalg.norm(np.diff(gt, axis=0), axis=1).sum():.2f} m path")
    print("keyframes:", len(odo.keyframes),
          "landmarks:", len(odo.landmarks))
    chi2 = odo.run_ba(window=8, iterations=6)
    print("BA final chi2:", chi2)
    assert rmse < 0.05, rmse
    print("SLAM DEMO OK")


if __name__ == "__main__":
    main()
