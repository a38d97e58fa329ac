"""Engine configuration (a numpy-free copy of the JAX package's
``core/config.py``, so the port never imports jax).

The fields, names and defaults are the JAX package's, one for one, so one
keyword set configures both engines. The port's engine runs every
single-device configuration the JAX engine runs, and refuses with
``ValueError`` what the JAX package refuses
(:func:`pipeline.engine.check_supported`).

``voxel_mean_mode="auto"`` follows one rule on every device
(:func:`pipeline.engine.resolve_mean_mode`): "rle" on a grid of fewer than
2^24 cells, else "packed" — the JAX package's rule on a TPU. This is the
one difference from the JAX package on the CPU, which resolves "auto" to
"packed" on any grid. The two give bit-equal outputs unless the level-1
partials overflow their capacity, which ``FrameOutputs.vox_partials_count
> voxelize_partials_capacity`` shows; ``vox_partials_count`` itself
differs under "auto" (the run count against 0).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class FusionConfig:
    """All engine parameters (reference ROS parameter names where one
    exists; ``src/gpu_depthmap_fusion_component.cpp:1115-1187``)."""

    # --- input streams ---
    num_depth_streams: int = 1
    num_point_sequences: int = 0
    depth_height: int = 480
    depth_width: int = 848
    depth_scale: float = 0.001          # u16 depth unit -> meters

    # --- heterogeneous streams: per-stream (height, width) and depth
    # scale; None = every stream uses the global shape / scale ---
    stream_shapes: "Tuple[Tuple[int, int], ...] | None" = None
    depth_scales: "Tuple[float, ...] | None" = None

    # --- frames (host bookkeeping) ---
    world_frame: str = "world"
    crop_frame: str = "crop"
    move_frame: str = "move"
    obj_export_frame: str = "world"

    # --- processing rate ---
    resample_rate: float = 30.0
    tracking_dt: float = 1.0 / 30.0

    # --- crop AABB in the crop frame ---
    crop_min: Tuple[float, float, float] = (-1.0, -1.0, -1.0)
    crop_max: Tuple[float, float, float] = (+1.0, +1.0, +1.0)

    # --- flying-pixel filter ---
    enable_flyingpixels_filter: bool = True
    flyingpixels_filter_threshold: float = 0.5   # cos(view angle)
    flyingpixels_filter_size: int = 1            # rings 1..size
    flyingpixels_filter_enable_rot45: bool = True
    flyingpixels_max_distance: float = 10.0

    # --- point-sequence (lidar) filter ---
    point_sequence_filter_threshold: float = 0.5
    point_sequence_filter_size: int = 1
    point_sequence_aggregation_timespan: float = 0.1  # seconds

    # --- voxel filter / grid ---
    enable_voxel_filter: bool = True
    voxel_min: Tuple[float, float, float] = (-1.0, -1.0, -1.0)
    voxel_max: Tuple[float, float, float] = (+1.0, +1.0, +1.0)
    voxel_size: Tuple[float, float, float] = (0.1, 0.1, 0.1)
    voxel_enable_average: bool = True
    # "auto" | "rle" | "packed" | "exact" (ops/voxelize.py); "rle" and
    # "packed" average 10/10/12-bit cell-relative quantized coordinates,
    # "exact" the float32 coordinates; "auto": see the module docstring
    voxel_mean_mode: str = "auto"
    # cap on level-1 (cell, partial-sum) rows (0 -> max(2^16, N//4));
    # overflowing partials are dropped and reported
    voxelize_partials_capacity: int = 0
    voxel_occupancy_lifetime: int = 1   # frames
    # cap on emitted voxelized points; FrameOutputs.fused_count against
    # this cap is the overflow observable
    voxelize_output_capacity: int = 262144

    # --- host->device depth link: "dpcm" | "dpcm_temporal" | "none" ---
    depth_link_codec: str = "dpcm"
    depth_codec_keyframe_interval: int = 30
    depth_codec_max_exceptions: int = 8192
    depth_codec_p4_budget: int = 0
    depth_codec_hysteresis: int = 0
    depth_codec_quant_shift: int = 0
    # lidar-link quantization step (0 = f32 xyzw staging; s > 0 = 3 x u16
    # multiples of s over [-32768*s, +32767*s))
    lidar_link_quant_step: float = 0.0
    lidar_link_delta: bool = False

    # also emit the compacted raw (pre-voxelize) cloud every frame
    emit_raw_points: bool = True

    # --- segmentation / tracking ---
    segmentation_backend: str = "auto"
    object_min_area: float = 0.2 * 0.2
    cc_max_labels_per_layer: int = 256
    max_objects: int = 64
    mapping_detail_min_area: float = 0.0
    max_tracks: int = 128
    # emit the dense [num_cells] u8 historic occupancy ([1]-stub when off)
    emit_occupancy_u8: bool = True
    # sparse occupancy output: nonzero 128-bit blocks of the packed
    # occupancy bitmap as (block index, 4 words) rows; 0 = disabled
    occupancy_sparse_capacity: int = 0

    # --- radius filter (unimplemented in the reference; config parity) ---
    enable_radius_filter: bool = False
    radius_filter_radius: float = 0.1
    radius_min: Tuple[float, float, float] = (-1.0, -1.0, -1.0)
    radius_max: Tuple[float, float, float] = (+1.0, +1.0, +1.0)

    # --- static capacities (overflow is explicit: excess dropped) ---
    rollbuffer_point_capacity: int = 131072
    rollbuffer_seq_capacity: int = 1024
    max_points_per_sequence: int = 32768

    # --- misc ---
    enable_debug_output: bool = False
    dtype: str = "float32"

    # ------------------------------------------------------------------
    @property
    def depth_pixels_per_stream(self) -> int:
        return self.depth_height * self.depth_width

    @property
    def resolved_stream_shapes(self) -> Tuple[Tuple[int, int], ...]:
        """Per-stream (height, width), defaulting to the global shape."""
        if self.stream_shapes is None:
            return ((self.depth_height, self.depth_width),) \
                * self.num_depth_streams
        if len(self.stream_shapes) != self.num_depth_streams:
            raise ValueError(
                f"stream_shapes has {len(self.stream_shapes)} entries for "
                f"{self.num_depth_streams} depth streams")
        return tuple((int(h), int(w)) for h, w in self.stream_shapes)

    @property
    def resolved_depth_scales(self) -> Tuple[float, ...]:
        """Per-stream depth unit -> meters, defaulting to depth_scale."""
        if self.depth_scales is None:
            return (self.depth_scale,) * self.num_depth_streams
        if len(self.depth_scales) != self.num_depth_streams:
            raise ValueError(
                f"depth_scales has {len(self.depth_scales)} entries for "
                f"{self.num_depth_streams} depth streams")
        return tuple(float(s) for s in self.depth_scales)

    @property
    def is_heterogeneous(self) -> bool:
        return (self.stream_shapes is not None
                and len(set(self.stream_shapes)) > 1)

    @property
    def stream_groups(self) -> Tuple[Tuple[Tuple[int, ...], int, int], ...]:
        """Streams grouped by shared (h, w), first-seen order:
        ``((stream_indices, h, w), ...)``. One group for homogeneous rigs."""
        groups: list = []
        by_shape: dict = {}
        for i, (h, w) in enumerate(self.resolved_stream_shapes):
            if (h, w) not in by_shape:
                by_shape[(h, w)] = len(groups)
                groups.append(([i], h, w))
            else:
                groups[by_shape[(h, w)]][0].append(i)
        return tuple((tuple(ix), h, w) for ix, h, w in groups)

    @property
    def depthmaps_total_elements(self) -> int:
        return sum(h * w for h, w in self.resolved_stream_shapes)

    @property
    def total_point_capacity(self) -> int:
        """Depth points + rollbuffer selection capacity."""
        return self.depthmaps_total_elements + self.rollbuffer_point_capacity

    def replace(self, **kw) -> "FusionConfig":
        return dataclasses.replace(self, **kw)


# Launch-file deployment presets (launch/gpu_depthmap_fusion.launch:144-181).
PRESET_HAFEN = FusionConfig(
    num_depth_streams=6,
    voxel_min=(-20.0, -20.0, 0.0),
    voxel_max=(+20.0, +20.0, 2.5),
    voxel_size=(0.1, 0.1, 0.12),      # 400 x 400 x 21 = 3,360,000 cells
    crop_min=(-20.0, -20.0, 0.0),
    crop_max=(+20.0, +20.0, 2.5),
    voxel_occupancy_lifetime=10,
)

PRESET_OFFICE = FusionConfig(
    num_depth_streams=2,
    voxel_min=(-4.0, -4.0, 0.0),
    voxel_max=(+4.0, +4.0, 2.5),
    voxel_size=(0.1, 0.1, 0.1),       # 80 x 80 x 25 = 160,000 cells
    crop_min=(-4.0, -4.0, 0.0),
    crop_max=(+4.0, +4.0, 2.5),
    voxel_occupancy_lifetime=10,
)
