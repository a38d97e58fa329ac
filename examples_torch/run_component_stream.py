"""Drive the PyTorch port's streaming FusionComponent with a synthetic
2-camera rig: ray-traced depth frames pushed through the sync policy and
the resample timer, fused on the device, objects tracked across frames.

Run: PYTHONPATH=.:$PYTHONPATH python examples_torch/run_component_stream.py \
    [--device cuda|cpu]
"""
import argparse
import time

import numpy as np

from ros_gpu_depthmap_fusion_tpu_torch.core import transforms
from ros_gpu_depthmap_fusion_tpu_torch.core.camera import PinholeIntrinsics
from ros_gpu_depthmap_fusion_tpu_torch.core.config import FusionConfig
from ros_gpu_depthmap_fusion_tpu_torch.pipeline.component import (
    FusionComponent)
from ros_gpu_depthmap_fusion_tpu_torch.pipeline.datasets import (
    Box, Sphere, SyntheticRigDataset)
from ros_gpu_depthmap_fusion_tpu_torch.utils.viz import track_wireframes


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    print("device:", args.device)
    W, H = 320, 240
    intr = PinholeIntrinsics.default_for(W, H)
    cfg = FusionConfig(
        num_depth_streams=2, depth_height=H, depth_width=W,
        resample_rate=30.0,
        crop_min=(-6, -6, 0.05), crop_max=(6, 6, 3),
        voxel_min=(-6, -6, 0), voxel_max=(6, 6, 3),
        voxel_size=(0.1, 0.1, 0.15),
        voxel_occupancy_lifetime=5, object_min_area=0.05,
        rollbuffer_point_capacity=1024, max_points_per_sequence=256,
        flyingpixels_filter_threshold=0.3)

    # a moving sphere "object" above the ground + a static box
    box = Box(np.array([2.0, 2.0, 0.0]), np.array([3.0, 3.0, 1.0]))
    cams = [
        transforms.look_at(np.array([5 * np.cos(ang), 5 * np.sin(ang), 2.5]),
                           np.array([0.5, 0.5, 0.5]))
        for ang in (np.pi, 0.0)
    ]

    results = []
    comp = FusionComponent(cfg, args.device, on_points=results.append,
                           enable_mapping=True)
    mappings = []
    comp.on_mapping = mappings.append

    t0 = time.time()
    for f in range(10):
        t = f / 30.0
        sphere = Sphere(np.array([-1.0 + 0.2 * f, 0.0, 0.6]), 0.5)
        ds = SyntheticRigDataset(intr, spheres=[sphere], boxes=[box],
                                 ground_z=0.0)
        for slot, cam in enumerate(cams):
            depth = ds.render_depth(cam)
            comp.callback_depthmap(slot, t, depth, intr, cam)
        out = comp.tick_resample(t + 0.01)
        assert out is not None
    print(f"10 frames: {time.time() - t0:.1f}s total (kernel build or load "
          "included)")
    print("frames processed:", comp.frames_processed)
    m = mappings[-1]
    print("objects:", m.num_merged - 1, "tracks:", len(m.tracks))
    markers = track_wireframes(m.tracks, score_threshold=0.3)
    print("wireframe markers:", len(markers))
    assert comp.frames_processed == 10
    assert m.num_merged - 1 >= 2   # sphere + box (ground may crop-split)
    assert len(m.tracks) >= 1
    centers = [trk.rrect_filter.rrect.center for trk in m.tracks]
    print("track centers:", [(round(c[0], 2), round(c[1], 2))
                             for c in centers])
    print("COMPONENT STREAM OK")


if __name__ == "__main__":
    main()
