"""``bench.py``'s operating point on the card, for the card tests
(``tests/test_torch_cuda.py``) and the measurements (``chip_smoke.py``,
``scripts/time_kernels.py``): the rigs on ``portbench/pb/scene.py``'s
moving scene, the configuration fields of each path, and the kernels'
launch counters.

The bench rig is 8 depth cameras at 848x480 on an 8-slot ring plus 2
lidar streams of 8192 points, into a 400x400x21 = 3,360,000-cell grid.
The scene is drawn on the CPU from seed 0, so that every machine stages
the same frames. The port is imported only inside the functions, so a
caller may choose which checkout of it to import first.
"""

import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

# bench.py's rig, in pb.scene's terms
BENCH_RIG = dict(cameras=8, width=848, height=480, ring_slots=8,
                 radius_m=8.0, height_m=2.0, tilt_rad=0.3, fov_deg=60.0,
                 staged=8)
LIDAR = dict(streams=2, points=8192)
MOTION = dict(sway_rad=0.02, sway_period_frames=60, shift_px=0)
# the launch-file presets' rigs (core/config.py): Hafen takes the first 6
# of the bench rig's cameras; Office's 8 x 8 m crop holds none of the
# bench rig's surfaces (8 m out), so its 2 cameras face each other from a
# 4 m ring with a RealSense D435's 87 degree depth field of view
PRESETS = {"hafen": ("PRESET_HAFEN", dict(BENCH_RIG, cameras=6)),
           "office": ("PRESET_OFFICE", dict(BENCH_RIG, cameras=2,
                                            ring_slots=2, radius_m=4.0,
                                            fov_deg=87.0))}
# the heterogeneous rig: 4 cameras at 848x480 and 4 at 640x360 (top-left
# crops of the bench scene)
HETERO_SHAPES = ((480, 848),) * 4 + ((360, 640),) * 4
RECORD_FRAME = 6       # from here on the link's lidar window is full

# bench.py's fields for its rig, lidar, crop, grid and rollbuffer; every
# other field at FusionConfig()'s default (the publish configuration)
BENCH_FIELDS = dict(
    num_depth_streams=BENCH_RIG["cameras"],
    depth_height=BENCH_RIG["height"], depth_width=BENCH_RIG["width"],
    num_point_sequences=LIDAR["streams"],
    crop_min=(-20, -20, 0), crop_max=(20, 20, 2.5),
    voxel_min=(-20, -20, 0), voxel_max=(20, 20, 2.5),
    voxel_size=(0.1, 0.1, 0.12), voxel_occupancy_lifetime=10,
    rollbuffer_point_capacity=98304,
    max_points_per_sequence=LIDAR["streams"] * LIDAR["points"])
# bench.py:120-182's depth link, field for field
LINK_FIELDS = dict(
    depth_link_codec="dpcm_temporal", depth_codec_p4_budget=48,
    depth_codec_hysteresis=2, depth_codec_keyframe_interval=120,
    depth_codec_quant_shift=4, depth_codec_max_exceptions=8192,
    lidar_link_quant_step=0.002, lidar_link_delta=True,
    voxelize_partials_capacity=448 * 1024, voxelize_output_capacity=16384,
    emit_raw_points=False, emit_occupancy_u8=False,
    occupancy_sparse_capacity=4096)
# bench.py on the raw depth link: bench.py's 448k partials were sized to
# its 16 mm-quantized series; the raw series breaks more raster runs
# (647,240 level-1 runs measured on frame 0 of the bench scene)
RAW_FIELDS = dict(
    depth_link_codec="none", depth_codec_max_exceptions=8192,
    lidar_link_quant_step=0.002, voxelize_partials_capacity=768 * 1024,
    voxelize_output_capacity=16384, emit_raw_points=False,
    emit_occupancy_u8=False, occupancy_sparse_capacity=4096)

_SCENES = {}


def config(*fields, **kw):
    """The port's ``FusionConfig`` of :data:`BENCH_FIELDS` updated by each
    dict of ``fields``, then by ``kw``."""
    from ros_gpu_depthmap_fusion_tpu_torch.core.config import FusionConfig
    base = dict(BENCH_FIELDS)
    for f in fields + (kw,):
        base.update(f)
    return FusionConfig(**base)


def _pb():
    if os.path.join(HERE, "portbench") not in sys.path:
        sys.path.append(os.path.join(HERE, "portbench"))
    from pb import scene as pb_scene
    return pb_scene


def scene(rig=BENCH_RIG):
    """``pb.scene.Scene`` of ``rig`` with bench.py's lidar arcs and sway,
    seed 0, drawn on the CPU; one a rig in a process."""
    key = tuple(sorted(rig.items()))
    if key not in _SCENES:
        _SCENES[key] = _pb().Scene(0, rig, LIDAR, MOTION, 30.0, "cpu")
    return _SCENES[key]


def stage(eng, sc, f):
    """Stage frame ``f`` of scene ``sc`` into ``eng``: the scene's first
    cameras (a stream smaller than the scene's images gets their top-left
    crop and its own intrinsics at the bench rig's field of view), and the
    lidar packets when the engine takes point sequences. Returns the
    frame's stamp."""
    depth, poses = sc.depth(f), sc.poses(f)
    for i, (h, w) in enumerate(eng.cfg.resolved_stream_shapes):
        intr = sc.intr if (h, w) == (sc.h, sc.w) else _pb().intrinsics(
            w, h, BENCH_RIG["fov_deg"])
        eng.add_depthmap(i, depth[i, :h, :w], intr, poses[i], poses[i])
    if eng.cfg.num_point_sequences:
        for pts, sec, nsec in sc.lidar(f):
            eng.add_point_sequence(pts, sec, nsec,
                                   np.eye(4, dtype=np.float32))
    return sc.stamp(f)


def kernel_modules():
    """The launch counters: each kernel's module (``launches``)."""
    from ros_gpu_depthmap_fusion_tpu_torch.ops.kernels import (
        compact, flying_pixels, fused_unproject_rle, segreduce)
    from ros_gpu_depthmap_fusion_tpu_torch.state import rollbuffer
    return {"segreduce": segreduce, "flying_pixels": flying_pixels,
            "compact": compact, "fused_unproject_rle": fused_unproject_rle,
            "lidar_stages": rollbuffer}
