"""The fusion engine: the per-frame step and its host orchestrator.

Per frame, in the reference's order (``processDepthmaps``,
``src/gpu_depthmap_fusion_component.cpp:92-515``):

    1. filter new point sequences        (cpp:166)      1-5: the lidar
    2. insert into the rollbuffer        (cpp:168)      kernel pair
    3. expire old sequences              (cpp:185)
    4. select the aggregation timespan   (cpp:194)
    5. gather + transform the selection  (cpp:199-203)
    6. decode the depth link; unproject  (cpp:226)
    7. flying-pixel filter               (cpp:234)  kernel 2, once a
                                                    resolution group
    8. crop; optional radius filter      (cpp:241)
    9. compact the raw cloud             (cpp:249)  kernel 3
    10. voxelize                         (cpp:259-288)  kernels 1, 3
    11. occupancy + temporal decay       (cpp:297)
    12. packed and sparse occupancy bitmaps            kernel 3

Two layouts, as in the JAX package's engine (``pipeline/engine.py:
272-397``). When only the averaged cloud is wanted at mode "rle" (no raw
cloud, no radius filter), the split-domain layout: the depth sections and
the lidar selection are never concatenated; they meet at the (cell,
partial-sum) level inside :func:`ops.voxelize.voxelize_average_rle_domains`
(kernel 1 twice), step 9 is skipped and step 11 is a scatter-max at the
emitted cells. Otherwise the reference's layout: lidar appended after the
depth sections, the raw cloud compacted when it is emitted, then one of
the modes "rle", "packed", "exact", the occupied-cell corners, or no
voxel filter, and the dense decay update. :func:`resolve_mean_mode` states
how "auto" resolves.

Every tensor of a step lives on the engine's device and the step never
waits for it: a frame's only host -> device traffic is one packet copy
from pinned memory, and outputs stay on the device until the caller reads
them. The state is never modified in place; each step returns a new one.

The host side encodes the depth link with the native encoders
(:mod:`utils.native`) and, with ``pipeline_depth=1``, encodes and copies
frame k on a worker thread and a side CUDA stream while the device runs
frame k-1.
"""

from __future__ import annotations

import concurrent.futures
import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

from ros_gpu_depthmap_fusion_tpu_torch.core import timeutil
from ros_gpu_depthmap_fusion_tpu_torch.core.config import FusionConfig
from ros_gpu_depthmap_fusion_tpu_torch.core.devconst import const
from ros_gpu_depthmap_fusion_tpu_torch.core.grid import VoxelGrid
from ros_gpu_depthmap_fusion_tpu_torch.mapping.pipeline import (
    MappingPipeline, MappingResult)
from ros_gpu_depthmap_fusion_tpu_torch.ops.depth_codec import (
    B_BUCKETS, EncodedDepth, decode_depth, decode_depth_p4,
    decode_depth_temporal)
from ros_gpu_depthmap_fusion_tpu_torch.ops.kernels.flying_pixels import (
    filter_flying_pixels, filter_flying_pixels_plain)
from ros_gpu_depthmap_fusion_tpu_torch.ops.mask_ops import (
    compact, crop_points)
from ros_gpu_depthmap_fusion_tpu_torch.ops.radius import (
    filter_radius_outliers)
from ros_gpu_depthmap_fusion_tpu_torch.ops.unproject import (
    unproject_depthmaps)
from ros_gpu_depthmap_fusion_tpu_torch.ops.voxel import (
    occupancy_bitmap, occupancy_bitmap_sparse, occupancy_to_u8,
    scatter_occupancy, update_historic_occupancy)
from ros_gpu_depthmap_fusion_tpu_torch.ops.voxelize import (
    RLE_MAX_CELLS, resolve_partials_capacity, voxelize_average,
    voxelize_average_packed, voxelize_average_rle,
    voxelize_average_rle_domains, voxelize_occupied)
from ros_gpu_depthmap_fusion_tpu_torch.pipeline.packet import (
    HostPacket, PacketLayout, unpack_packet)
from ros_gpu_depthmap_fusion_tpu_torch.state import rollbuffer as rbmod
from ros_gpu_depthmap_fusion_tpu_torch.state.rollbuffer import RollBuffer
from ros_gpu_depthmap_fusion_tpu_torch.utils import native, profiling


class EngineState(NamedTuple):
    """Carried device state (the reference's persistent SSBOs)."""
    rollbuffer: RollBuffer
    historic_occupancy: torch.Tensor   # [num_cells] int32
    frame_index: torch.Tensor          # 0-d int32
    # previous frame's quantized depth series (holes = 0), the P-frame
    # prediction of the temporal link codec: [C, H, W] int32 u16 values
    # when cfg.depth_link_codec == "dpcm_temporal", else a [1, 1, 1] stub
    prev_depth_q: torch.Tensor


class SequenceBatch(NamedTuple):
    """Staged new point sequences of one frame."""
    points: torch.Tensor      # [STAGE_CAP, 4] float32
    seq_idx: torch.Tensor     # [STAGE_CAP] int32, 0-based within batch
    seq_sec: torch.Tensor     # [SEQ_STAGE_CAP] int32
    seq_nsec: torch.Tensor    # [SEQ_STAGE_CAP] int32
    seq_count: torch.Tensor   # [SEQ_STAGE_CAP] int32
    seq_tf_move: torch.Tensor  # [SEQ_STAGE_CAP, 4, 4] float32
    num_points: torch.Tensor  # 0-d int32
    num_seqs: torch.Tensor    # 0-d int32


class FrameInputs(NamedTuple):
    # [C, H, W] u16 values (any integer dtype) on the raw link, else the
    # codec's EncodedDepth / EncodedDepthP4 (ops/depth_codec.py)
    depth: "torch.Tensor | tuple"
    intrinsics: torch.Tensor   # [C, 4] (fx, fy, cx, cy)
    tf_world: torch.Tensor     # [C, 4, 4] world <- camera
    tf_crop: torch.Tensor      # [C, 4, 4] crop <- camera
    seq_batch: SequenceBatch
    tf_world_move: torch.Tensor  # [4, 4] world <- move
    tf_crop_move: torch.Tensor   # [4, 4] crop <- move
    now_sec: torch.Tensor
    now_nsec: torch.Tensor
    roll_min_sec: torch.Tensor   # expiry threshold (now - timespan)
    roll_min_nsec: torch.Tensor
    # live-reconfigurable filter scalars (0-d float32 tensors)
    fp_threshold: torch.Tensor
    fp_max_distance: torch.Tensor
    ps_threshold: torch.Tensor


class FrameOutputs(NamedTuple):
    fused_points: torch.Tensor   # [out_cap, 4] voxelized world points
    fused_count: torch.Tensor
    # [n_depth + rollbuffer capacity, 4] compacted world points when the
    # raw cloud is emitted (emit_raw_points, or no voxel filter), else a
    # [1, 4] stub
    raw_points: torch.Tensor
    raw_count: torch.Tensor      # valid depth + lidar points after crop
    occupancy_u8: torch.Tensor   # [num_cells] u8, or a [1] stub
    occupancy_bits: torch.Tensor  # packed 8 cells a byte
    seq_selected_count: torch.Tensor
    # mode "rle": max over raster domains of the true level-1 run count
    # scaled to the full partials capacity; above
    # cfg.voxelize_partials_capacity means partial rows were dropped this
    # frame. 0 in the other modes
    vox_partials_count: torch.Tensor
    # nonzero 128-bit blocks of occupancy_bits (index, 4 words) + clamped
    # and true count; [1]-stubs when cfg.occupancy_sparse_capacity == 0
    occupancy_sparse_idx: torch.Tensor
    occupancy_sparse_words: torch.Tensor
    occupancy_sparse_count: torch.Tensor
    occupancy_sparse_true: torch.Tensor


def resolve_mean_mode(cfg: FusionConfig, grid: VoxelGrid) -> str:
    """The averaging mode a step runs: ``cfg.voxel_mean_mode``, with
    ``"auto"`` resolved by one rule on every device: ``"rle"`` on a grid
    of fewer than 2^24 cells, else ``"packed"`` (the JAX package's rule on
    a TPU; see :class:`core.config.FusionConfig`)."""
    mode = cfg.voxel_mean_mode
    if mode == "auto":
        return "rle" if grid.num_cells < RLE_MAX_CELLS else "packed"
    return mode


def split_layout(cfg: FusionConfig, grid: VoxelGrid) -> bool:
    """Whether the step runs the split-domain layout: only the averaged
    cloud is wanted, at mode "rle" (no raw cloud, no radius filter)."""
    return (cfg.enable_voxel_filter and cfg.voxel_enable_average
            and resolve_mean_mode(cfg, grid) == "rle"
            and not cfg.emit_raw_points and not cfg.enable_radius_filter)


def resolved_partials_capacity(cfg: FusionConfig, grid: VoxelGrid) -> int:
    """The level-1 partial rows the step's "rle" voxelize holds a frame:
    ``cfg.voxelize_partials_capacity``, or resolved by the voxelizer's rule
    (:func:`ops.voxelize.resolve_partials_capacity`) over the rows it
    reduces: the depth pixels in the split-domain layout, the depth pixels
    and the rollbuffer selection otherwise. 0 where the step runs no "rle"
    voxelize."""
    if not (cfg.enable_voxel_filter and cfg.voxel_enable_average
            and resolve_mean_mode(cfg, grid) == "rle"):
        return 0
    n = (cfg.depthmaps_total_elements if split_layout(cfg, grid)
         else cfg.total_point_capacity)
    return resolve_partials_capacity(cfg.voxelize_partials_capacity, n)


def check_supported(cfg: FusionConfig) -> None:
    """Raise ``ValueError``, naming the config field, for a configuration
    the JAX package refuses too: ``dpcm_temporal`` or p4 P-frames on a
    heterogeneous rig (no per-group P-frame state), an unknown depth-link
    codec or voxel mean mode."""
    if cfg.depth_link_codec not in ("none", "dpcm", "dpcm_temporal"):
        raise ValueError(
            f"depth_link_codec={cfg.depth_link_codec!r}: the link is "
            "'none', 'dpcm' or 'dpcm_temporal'")
    if cfg.voxel_mean_mode not in ("auto", "rle", "packed", "exact"):
        raise ValueError(
            f"voxel_mean_mode={cfg.voxel_mean_mode!r}: 'auto', 'rle', "
            "'packed' or 'exact'")
    if cfg.is_heterogeneous:
        if cfg.depth_link_codec == "dpcm_temporal":
            raise ValueError(
                "depth_link_codec='dpcm_temporal' is not supported with "
                "heterogeneous stream_shapes (no per-group P-frame state)")
        if cfg.depth_codec_p4_budget:
            raise ValueError(
                f"depth_codec_p4_budget={cfg.depth_codec_p4_budget}: p4 "
                "P-frames need a homogeneous rig (stream_shapes)")


def initial_state(cfg: FusionConfig, grid: VoxelGrid, device) -> EngineState:
    """Empty state on ``device`` (no default: the caller names it)."""
    prev_q_shape = ((cfg.num_depth_streams, cfg.depth_height,
                     cfg.depth_width)
                    if cfg.depth_link_codec == "dpcm_temporal"
                    else (1, 1, 1))
    return EngineState(
        rollbuffer=rbmod.make_rollbuffer(
            cfg.rollbuffer_point_capacity, cfg.rollbuffer_seq_capacity,
            device),
        historic_occupancy=torch.zeros((grid.num_cells,), dtype=torch.int32,
                                       device=device),
        frame_index=torch.zeros((), dtype=torch.int32, device=device),
        prev_depth_q=torch.zeros(prev_q_shape, dtype=torch.int32,
                                 device=device),
    )


def state_from_jax_numpy(d: dict, device) -> EngineState:
    """An :class:`EngineState` on ``device`` from numpy arrays of the JAX
    engine's state: the ``RollBuffer`` fields by name plus
    ``historic_occupancy``, ``frame_index`` and ``prev_depth_q`` (a
    ``[1, 1, 1]`` stub when absent)."""
    def t(name, dtype):
        return torch.from_numpy(np.array(d[name])).to(device=device,
                                                      dtype=dtype)

    kinds = dict(points=torch.float32, mask=torch.bool,
                 seq_tf_move=torch.float32)
    rb = RollBuffer(**{f: t(f, kinds.get(f, torch.int32))
                       for f in RollBuffer._fields})
    prev_q = (t("prev_depth_q", torch.int32) if "prev_depth_q" in d
              else torch.zeros((1, 1, 1), dtype=torch.int32, device=device))
    return EngineState(rollbuffer=rb,
                       historic_occupancy=t("historic_occupancy",
                                            torch.int32),
                       frame_index=t("frame_index", torch.int32),
                       prev_depth_q=prev_q)


def state_to_numpy(state: EngineState) -> dict:
    """Inverse of :func:`state_from_jax_numpy` (waits for the device);
    ``prev_depth_q`` comes back as u16, the JAX state's type."""
    d = {f: getattr(state.rollbuffer, f).cpu().numpy()
         for f in RollBuffer._fields}
    d["historic_occupancy"] = state.historic_occupancy.cpu().numpy()
    d["frame_index"] = state.frame_index.cpu().numpy()
    d["prev_depth_q"] = state.prev_depth_q.cpu().numpy().astype(np.uint16)
    return d


def _to(x, device, dtype=None) -> torch.Tensor:
    """A host array (numpy or tensor) on ``device``. 16- and 32-bit
    unsigned words travel as their signed bits (torch has no arithmetic on
    them); u16 values widen to int32 on the device."""
    if isinstance(x, torch.Tensor):
        return x.to(device, dtype=dtype or x.dtype, non_blocking=True)
    a = np.asarray(x)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    if a.dtype == np.uint16:
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.int16))
        return t.to(device, non_blocking=True).to(torch.int32) & 0xFFFF
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.to(device, dtype=dtype or t.dtype, non_blocking=True)


def inputs_to_device(inp: FrameInputs, device, cams: slice = slice(None),
                     depth_bits=None) -> FrameInputs:
    """:class:`FrameInputs` of host arrays (numpy or tensors) on
    ``device``, for :func:`fusion_step` on a homogeneous rig: the cameras
    ``cams`` of the depth (raw, or for an I-frame ``depth_bits`` the
    :class:`EncodedDepth` rows, its exception arrays whole), intrinsics
    and transforms; everything else whole."""
    if depth_bits is None:
        depth = _to(inp.depth[cams], device)
    else:
        d = inp.depth
        depth = EncodedDepth(
            words=_to(d.words[cams], device),
            row_first=_to(d.row_first[cams], device),
            exc_idx=_to(d.exc_idx, device, torch.int32),
            exc_zz=_to(d.exc_zz, device, torch.int32),
            exc_count=_to(d.exc_count, device, torch.int32))
    f32, i32 = torch.float32, torch.int32
    sb = inp.seq_batch
    return FrameInputs(
        depth=depth,
        intrinsics=_to(inp.intrinsics[cams], device, f32),
        tf_world=_to(inp.tf_world[cams], device, f32),
        tf_crop=_to(inp.tf_crop[cams], device, f32),
        seq_batch=SequenceBatch(*(
            _to(x, device, f32 if k in ("points", "seq_tf_move") else i32)
            for k, x in sb._asdict().items())),
        tf_world_move=_to(inp.tf_world_move, device, f32),
        tf_crop_move=_to(inp.tf_crop_move, device, f32),
        now_sec=_to(inp.now_sec, device, i32),
        now_nsec=_to(inp.now_nsec, device, i32),
        roll_min_sec=_to(inp.roll_min_sec, device, i32),
        roll_min_nsec=_to(inp.roll_min_nsec, device, i32),
        fp_threshold=_to(inp.fp_threshold, device, f32),
        fp_max_distance=_to(inp.fp_max_distance, device, f32),
        ps_threshold=_to(inp.ps_threshold, device, f32))


def decode_link(state: EngineState, depth, depth_bits, cfg: FusionConfig):
    """The frame's ``[C, H, W]`` depth from its link payload, and the next
    P-frame prediction (``state.prev_depth_q`` unless the frame updates
    it). ``depth_bits``: ``None`` raw, ``"p4"``, ``B > 0`` an I-frame,
    ``-B`` a classic P-frame (JAX ``pipeline/engine.py:233-254``)."""
    h, w = cfg.depth_height, cfg.depth_width
    shift = cfg.depth_codec_quant_shift
    prev_q = state.prev_depth_q
    if depth_bits is None:
        return depth, prev_q
    if depth_bits == "p4":
        return decode_depth_p4(depth, prev_q, h, w,
                               cfg.depth_codec_p4_budget, shift)
    if depth_bits > 0:
        if cfg.depth_link_codec == "dpcm_temporal":
            return decode_depth(depth, h, w, depth_bits, shift,
                                return_series=True)
        return decode_depth(depth, h, w, depth_bits, shift), prev_q
    return decode_depth_temporal(depth, prev_q, h, w, -depth_bits, shift)


def fusion_step(state: EngineState,
                inp: FrameInputs,
                depth_bits=None,
                *,
                cfg: FusionConfig,
                grid: VoxelGrid,
                output_capacity: int,
                plain: bool = False):
    """One frame step; returns ``(new_state, FrameOutputs)``.

    ``depth_bits`` names the depth payload of ``inp.depth`` (see
    :func:`decode_link`); on a heterogeneous rig ``inp.depth`` is a tuple
    of per-group payloads and ``depth_bits`` a tuple of per-group ``None``
    (raw) or ``B > 0`` (an I-frame).

    ``plain=True`` runs the plain PyTorch twins of the kernels even on
    CUDA tensors (the on-card reference the kernels are checked
    against); otherwise each kernel wrapper launches its CUDA kernel for
    CUDA tensors and its twin for CPU tensors.
    """
    check_supported(cfg)
    n_depth = cfg.depthmaps_total_elements
    sel_cap = cfg.rollbuffer_point_capacity
    dev = state.historic_occupancy.device

    # -- 1-5. filter new point sequences (sensor frame), rollbuffer
    #    insert, expiry, selection, gather + transform: the kernel pair of
    #    csrc/lidar_stages.cu (its twin on CPU tensors or plain=True) --
    with profiling.span("fusion.step.lidar"):
        rb, (seq_world, seq_crop, seq_valid), sel = \
            rbmod.advance_and_gather(
                state.rollbuffer, inp.seq_batch, inp.ps_threshold,
                cfg.point_sequence_filter_size,
                (inp.roll_min_sec, inp.roll_min_nsec),
                (inp.now_sec, inp.now_nsec), inp.tf_world_move,
                inp.tf_crop_move, sel_cap, plain=plain)

    # -- 6. decode the link, unproject; 7. flying-pixel filter: per
    #    resolution group (one on a homogeneous rig), each group's world,
    #    crop and mask sections in group order --
    fp = filter_flying_pixels_plain if plain else filter_flying_pixels
    prev_depth_q = state.prev_depth_q
    g_world, g_crop, g_mask = [], [], []
    groups = cfg.stream_groups
    with profiling.span("fusion.step.depth"):
        if len(groups) > 1:
            bits_t = depth_bits if depth_bits is not None else (
                None,) * len(groups)
            scales = cfg.resolved_depth_scales
            fronts = []
            for gi, (ix, gh, gw) in enumerate(groups):
                depth = inp.depth[gi]
                if bits_t[gi] is not None:
                    depth = decode_depth(depth, gh, gw, bits_t[gi],
                                         cfg.depth_codec_quant_shift)
                cams = const(ix, dev, torch.int64)
                fronts.append((depth, inp.intrinsics[cams],
                               inp.tf_world[cams], inp.tf_crop[cams],
                               tuple(scales[i] for i in ix), gh, gw))
        else:
            depth, prev_depth_q = decode_link(state, inp.depth, depth_bits,
                                              cfg)
            scale = (cfg.resolved_depth_scales
                     if cfg.depth_scales is not None else cfg.depth_scale)
            fronts = [(depth, inp.intrinsics, inp.tf_world, inp.tf_crop,
                       scale, cfg.depth_height, cfg.depth_width)]
        for depth, intr, tf_world, tf_crop, scale, gh, gw in fronts:
            pts_cam, pts_world, pts_crop, dmask = unproject_depthmaps(
                depth, intr, tf_world, tf_crop, scale)
            if cfg.enable_flyingpixels_filter:
                dmask = fp(pts_cam, dmask, gh, gw,
                           cfg.flyingpixels_filter_size, inp.fp_threshold,
                           cfg.flyingpixels_filter_enable_rot45,
                           inp.fp_max_distance)
            ng = depth.shape[0] * gh * gw
            g_world.append(pts_world.reshape(ng, 4))
            g_crop.append(pts_crop.reshape(ng, 4))
            g_mask.append(dmask.reshape(ng))

    # -- 8-10. the split-domain layout (JAX pipeline/engine.py:288-318):
    #    the depth sections and the lidar selection meet at the partials,
    #    when only the averaged cloud is wanted at mode "rle" --
    mode = resolve_mean_mode(cfg, grid)
    emit_raw = cfg.emit_raw_points or not cfg.enable_voxel_filter
    total_cap = n_depth + sel_cap
    num_cells = grid.num_cells
    raw_points = torch.zeros((1, 4), dtype=torch.float32, device=dev)
    vox_partials = torch.zeros((), dtype=torch.int32, device=dev)
    if split_layout(cfg, grid):
        with profiling.span("fusion.step.voxelize"):
            domains, raw_count = [], None
            for pw, pc, m in zip(g_world, g_crop, g_mask):
                m = crop_points(pc, m, cfg.crop_min, cfg.crop_max)
                n_m = m.sum(dtype=torch.int32)
                raw_count = n_m if raw_count is None else raw_count + n_m
                domains.append((pw, grid.cell_index_clamped(pw[:, :3]), m))
            seq_valid = crop_points(seq_crop, seq_valid, cfg.crop_min,
                                    cfg.crop_max)
            raw_count = torch.clamp_max(
                raw_count + seq_valid.sum(dtype=torch.int32), total_cap)
            fused_points, fused_count, (cells, cells_live), vox_partials = (
                voxelize_average_rle_domains(
                    domains, grid, output_capacity,
                    partials_capacity=cfg.voxelize_partials_capacity,
                    extra_points=seq_world,
                    extra_cell_indices=grid.cell_index_clamped(
                        seq_world[:, :3]),
                    extra_mask=seq_valid, plain=plain))
        # occupancy + decay: the fresh grid is 0/1 at the emitted cells, so
        # max(aged, fresh * lifetime) is a scatter-max of `lifetime` at
        # those cells into the aged grid
        with profiling.span("fusion.step.occupancy"):
            aged = torch.cat([
                torch.clamp_min(state.historic_occupancy - 1, 0),
                torch.zeros((1,), dtype=torch.int32, device=dev)])
            target = torch.where(cells_live, cells, num_cells).long()
            historic = aged.scatter_reduce_(
                0, target,
                torch.full_like(cells, cfg.voxel_occupancy_lifetime),
                reduce="amax")[:num_cells]
    else:
        with profiling.span("fusion.step.voxelize"):
            # -- 8. depth sections then the lidar selection, concatenated
            #    (the reference's layout), cropped; 8b. the radius filter --
            all_world = torch.cat(g_world + [seq_world])
            all_mask = crop_points(torch.cat(g_crop + [seq_crop]),
                                   torch.cat(g_mask + [seq_valid]),
                                   cfg.crop_min, cfg.crop_max)
            if cfg.enable_radius_filter:
                all_mask = filter_radius_outliers(
                    all_world, all_mask, cfg.radius_min, cfg.radius_max,
                    cfg.radius_filter_radius)
            # -- 9. the raw cloud, compacted when it is emitted (or is the
            #    output); voxelize reads the masked rows otherwise --
            if emit_raw:
                raw_points, raw_count = compact(all_world, all_mask,
                                                total_cap, plain=plain)
                vox_points = raw_points
                live = torch.arange(total_cap, dtype=torch.int32,
                                    device=dev) < raw_count
            else:
                raw_count = torch.clamp_max(all_mask.sum(dtype=torch.int32),
                                            total_cap)
                vox_points, live = all_world, all_mask
            # -- 10. cell ids, voxelize --
            cell_ids = grid.cell_index_clamped(vox_points[:, :3])
            fresh = None
            if not cfg.enable_voxel_filter:
                fused_points, fused_count = raw_points, raw_count
            elif not cfg.voxel_enable_average:
                fresh = scatter_occupancy(cell_ids, live, num_cells)
                fused_points, fused_count = voxelize_occupied(
                    fresh, grid, output_capacity, plain=plain)
            elif mode == "rle":
                fused_points, fused_count, fresh, vox_partials = (
                    voxelize_average_rle(
                        vox_points, cell_ids, live, grid, output_capacity,
                        return_occupancy=True,
                        partials_capacity=cfg.voxelize_partials_capacity,
                        return_partials_count=True, plain=plain))
            else:
                vox = (voxelize_average_packed if mode == "packed"
                       else voxelize_average)
                fused_points, fused_count, fresh = vox(
                    vox_points, cell_ids, live, grid, output_capacity,
                    return_occupancy=True, plain=plain)
        # -- 11. occupancy + temporal decay --
        with profiling.span("fusion.step.occupancy"):
            if fresh is None:
                fresh = scatter_occupancy(cell_ids, live, num_cells)
            historic = update_historic_occupancy(
                state.historic_occupancy, fresh,
                cfg.voxel_occupancy_lifetime)

    # -- 12. the u8 grid, the packed bitmap, and sparse occupancy blocks
    #    for the mapping consumer --
    with profiling.span("fusion.step.occupancy"):
        occupancy_u8 = (occupancy_to_u8(historic) if cfg.emit_occupancy_u8
                        else torch.zeros((1,), dtype=torch.uint8,
                                         device=dev))
        if cfg.occupancy_sparse_capacity > 0:
            si, sw, sc, st = occupancy_bitmap_sparse(
                historic, cfg.occupancy_sparse_capacity, plain=plain)
        else:
            si = torch.zeros((1,), dtype=torch.int32, device=dev)
            sw = torch.zeros((1, 4), dtype=torch.int32, device=dev)
            sc = st = torch.zeros((), dtype=torch.int32, device=dev)
        occupancy_bits = occupancy_bitmap(historic)

    new_state = EngineState(rollbuffer=rb, historic_occupancy=historic,
                            frame_index=state.frame_index + 1,
                            prev_depth_q=prev_depth_q)
    return new_state, FrameOutputs(
        fused_points=fused_points, fused_count=fused_count,
        raw_points=raw_points, raw_count=raw_count,
        occupancy_u8=occupancy_u8,
        occupancy_bits=occupancy_bits,
        seq_selected_count=sel.point_count,
        vox_partials_count=vox_partials,
        occupancy_sparse_idx=si, occupancy_sparse_words=sw,
        occupancy_sparse_count=sc, occupancy_sparse_true=st)


def _output_capacity(cfg: FusionConfig, grid: VoxelGrid,
                     output_capacity: Optional[int]) -> int:
    if output_capacity is None:
        return min(grid.num_cells, cfg.total_point_capacity,
                   cfg.voxelize_output_capacity)
    return output_capacity


def build_fusion_step(cfg: FusionConfig, grid: VoxelGrid,
                      output_capacity: Optional[int] = None,
                      donate: bool = True):
    """The frame step for a static config and grid:
    ``step(state, inp, depth_bits=None, plain=False) -> (new_state,
    outputs)``, :func:`fusion_step` with ``cfg``, ``grid`` and
    ``output_capacity`` bound (default ``min(num_cells,
    total_point_capacity, voxelize_output_capacity)``).

    ``donate`` is accepted for the JAX package's signature and has no
    effect: the step never modifies its input state in place, so the
    caller's state stays valid either way."""
    del donate
    return functools.partial(
        fusion_step, cfg=cfg, grid=grid,
        output_capacity=_output_capacity(cfg, grid, output_capacity))


def build_packet_step(cfg: FusionConfig, grid: VoxelGrid,
                      layout: PacketLayout,
                      output_capacity: Optional[int] = None,
                      donate: bool = True):
    """The frame step over one packed u32 frame buffer (one host ->
    device copy a frame; :mod:`pipeline.packet`): ``step(state, packet,
    depth_bits=None, plain=False)`` unpacks ``packet`` with ``layout``
    and runs :func:`build_fusion_step`'s step on it. ``output_capacity``
    and ``donate`` as there."""
    fusion = build_fusion_step(cfg, grid, output_capacity, donate)

    def step(state: EngineState, packet: torch.Tensor, depth_bits=None,
             plain: bool = False):
        return fusion(state, unpack_packet(packet, layout, depth_bits),
                      depth_bits, plain=plain)

    return step


def _link_counter(depth_bits) -> str:
    """The counter of a frame's depth payload: ``fusion.link.iframes``
    (spatial; on a heterogeneous rig, every group coded),
    ``.pframes`` (classic P-frame), ``.p4frames`` or ``.raw_frames``."""
    if isinstance(depth_bits, tuple):
        kind = ("raw_frames" if any(b is None for b in depth_bits)
                else "iframes")
    elif depth_bits is None:
        kind = "raw_frames"
    elif depth_bits == "p4":
        kind = "p4frames"
    else:
        kind = "iframes" if depth_bits > 0 else "pframes"
    return "fusion.link." + kind


def _write_raw_pairs(tail: np.ndarray, depth: np.ndarray) -> None:
    """Raw u16 depth as little-endian pairs into the packet's u32 ``tail``
    (an odd last pixel in the low half of a last word)."""
    flat = depth.reshape(-1)
    n_pairs = flat.size // 2
    tail[:n_pairs] = flat[: n_pairs * 2].view(np.uint32)
    if flat.size % 2:
        tail[n_pairs] = np.uint32(flat[-1])


def _quantize_into(depth: np.ndarray, quant_shift: int,
                   out: np.ndarray) -> None:
    """Encoder-side quantization into ``out`` (holes stay 0): the P-frame
    prediction after an I-frame."""
    if not quant_shift:
        np.copyto(out, depth)
        return
    qmax = 65535 >> quant_shift
    q = (depth.astype(np.int32) + (1 << (quant_shift - 1))) >> quant_shift
    np.clip(q, 1, qmax, out=q)
    np.copyto(out, np.where(depth == 0, 0, q).astype(np.uint16))


# ---------------------------------------------------------------------------
# Host orchestrator
# ---------------------------------------------------------------------------

class FusionEngine:
    """Host-side engine with the reference component's ingestion API:
    :meth:`add_depthmap` / :meth:`add_point_sequence` stage a frame's
    inputs on the host, :meth:`process` runs the frame step on ``device``
    (the clear/add/process lifecycle of gpu_depthmap_fusion.h:223-307).

    ``device`` has no default: ``"cuda"`` runs the hand-written kernels,
    ``"cpu"`` their plain twins. A configured depth-link codec needs the
    native host library; the engine raises at construction without it. A
    heterogeneous rig (``cfg.stream_shapes``) stages and encodes each
    resolution group on its own (raw or ``"dpcm"``, each group at its own
    width).

    ``pipeline_depth=1`` overlaps frame k's encode and host -> device copy
    (a worker thread, and a side CUDA stream for the copy) with frame k-1's
    step: :meth:`process` then returns frame k-1's outputs (``None`` on
    the first call) and :meth:`flush` the last frame's.

    ``enable_mapping=True`` builds :attr:`mapping`, a
    :class:`MappingPipeline` on the engine's device, for
    :meth:`segment_and_track`; a caller may also set :attr:`mapping`
    itself (to drive it from an ``AsyncMappingWorker``).

    With the tracer on (:mod:`utils.profiling`), the staging, the encode,
    the packet copy, the waits on the encode and on a staging slot, and
    the step's stages are spans of the frame :attr:`frame_id` counts, and
    the link's frames and bytes and the lidar points staged and dropped
    are counted.
    """

    def __init__(self, cfg: FusionConfig, device,
                 grid: Optional[VoxelGrid] = None, pipeline_depth: int = 0,
                 enable_mapping: bool = False):
        check_supported(cfg)
        if pipeline_depth not in (0, 1):
            raise ValueError(f"pipeline_depth is 0 or 1, got "
                             f"{pipeline_depth!r}")
        self._codec = cfg.depth_link_codec != "none"
        if self._codec:
            native.require()
        self.cfg = cfg
        self.device = torch.device(device)
        self.grid = grid or VoxelGrid.from_config(cfg)
        self.output_capacity = _output_capacity(cfg, self.grid, None)
        self.partials_capacity = resolved_partials_capacity(cfg, self.grid)
        self._fusion_step = build_fusion_step(cfg, self.grid,
                                              self.output_capacity)
        self.state = initial_state(cfg, self.grid, self.device)
        self.enable_mapping = enable_mapping
        self.mapping = (MappingPipeline(cfg, self.grid, self.device)
                        if enable_mapping else None)
        self._stage_cap = cfg.max_points_per_sequence
        self._seq_stage_cap = max(1, cfg.num_point_sequences * 4)
        self.layout = PacketLayout.for_config(
            cfg, seq_cap=self._seq_stage_cap, stage_cap=self._stage_cap)
        cuda = self.device.type == "cuda"
        # two host packets alternate, so frame k+1 stages while frame k is
        # encoded and copied; a packet is staged again only after the
        # event of its last copy completed
        self._packets = (HostPacket(self.layout, cuda),
                         HostPacket(self.layout, cuda))
        self._copied = [None, None]
        self._pkt_flip = 0
        # with a codec, or on a heterogeneous rig, the raw depth is staged
        # into these (double-buffered like the packets): the encoder's
        # input; per resolution group on a heterogeneous rig, with slot ->
        # (group, position)
        c, h, w = cfg.num_depth_streams, cfg.depth_height, cfg.depth_width
        self._hetero = cfg.is_heterogeneous
        self._slot_map = {}
        if self._hetero:
            for gi, (ix, _, _) in enumerate(cfg.stream_groups):
                for pos, slot in enumerate(ix):
                    self._slot_map[slot] = (gi, pos)
            self._depth_hosts = tuple(
                [np.zeros((len(ix), gh, gw), np.uint16)
                 for ix, gh, gw in cfg.stream_groups] for _ in range(2))
        elif self._codec:
            self._depth_hosts = (np.zeros((c, h, w), np.uint16),
                                 np.zeros((c, h, w), np.uint16))
        else:
            self._depth_hosts = (None, None)
        # per-group spatial width guesses (heterogeneous rigs)
        self._last_bits_g = [-1] * len(cfg.stream_groups)
        # encoder state (touched only by the thread that encodes)
        self._last_bits = -1        # spatial width guess
        self._last_p_bits = -1      # classic P-frame width guess
        self._host_prev_q = None    # encoder-side P-frame prediction
        self._host_prev_q_spare = None
        self._frames_since_key = 0
        self.last_p4_spilled = 0    # p4 diagnostic: spilled groups
        # depth_bits of the frame whose outputs the latest process() /
        # flush() returned
        self.last_frame_bits = None
        # live-reconfigurable filter scalars: they ride in every packet
        self.fp_threshold = cfg.flyingpixels_filter_threshold
        self.fp_max_distance = cfg.flyingpixels_max_distance
        self.ps_threshold = cfg.point_sequence_filter_threshold
        self.pipeline_depth = pipeline_depth
        self._pending = None        # future of the frame in flight
        # the staging counter: the id of the frame now being staged
        self.frame_id = -1
        self._worker = self._copy_stream = None
        if pipeline_depth:
            self._worker = concurrent.futures.ThreadPoolExecutor(
                1, thread_name_prefix="fusion-enc")
            if cuda:
                self._copy_stream = torch.cuda.Stream(self.device)
        self.clear()

    def set_runtime_filters(self, fp_threshold=None, fp_max_distance=None,
                            ps_threshold=None):
        """Change the filter scalars live: they ride in the next frame's
        packet (filter sizes and rot45 stay fixed per engine)."""
        if fp_threshold is not None:
            self.fp_threshold = float(fp_threshold)
        if fp_max_distance is not None:
            self.fp_max_distance = float(fp_max_distance)
        if ps_threshold is not None:
            self.ps_threshold = float(ps_threshold)

    # --- ingestion (reference addDepthmap / addPointSequence) ---
    def clear(self):
        """Switch to the other host packet and drop the staged inputs
        (the rollbuffer is kept; gpu_depthmap_fusion.cpp:725-732)."""
        self._pkt_flip ^= 1
        event = self._copied[self._pkt_flip]
        if event is not None:
            # the copy of the frame before this one out of that packet
            with profiling.span("fusion.engine.wait_slot", self.frame_id - 1):
                event.synchronize()
        self.frame_id += 1
        self._pkt = self._packets[self._pkt_flip]
        self._pkt.frame = self.frame_id
        self._pkt.lidar_exc_count = 0
        self._pkt.lidar_dropped = 0
        self._depth_host = self._depth_hosts[self._pkt_flip]
        self._depth_filled = [False] * self.cfg.num_depth_streams
        self._num_seqs = 0
        self._seq_fill = 0

    def _depth_slot(self, slot: int) -> np.ndarray:
        if self._hetero:
            gi, pos = self._slot_map[slot]
            return self._depth_host[gi][pos]
        return (self._depth_host[slot] if self._codec
                else self._pkt.depth[slot])

    def add_depthmap(self, slot: int, depth_u16: np.ndarray,
                     intrinsics, tf_world: np.ndarray,
                     tf_crop: np.ndarray):
        with profiling.span("fusion.engine.stage", self.frame_id):
            np.copyto(self._depth_slot(slot), depth_u16, casting="same_kind")
            self._depth_filled[slot] = True
            self._pkt.intr[slot] = np.asarray(
                intrinsics.as_array() if hasattr(intrinsics, "as_array")
                else intrinsics, np.float32)
            self._pkt.tf_world[slot] = tf_world
            self._pkt.tf_crop[slot] = tf_crop

    def add_point_sequence(self, points_xyz: np.ndarray, sec: int, nsec: int,
                           tf_move: np.ndarray):
        """Stage one lidar packet (reference addPointSequence,
        gpu_depthmap_fusion.cpp:747-796); points past the staging capacity
        are dropped. With delta-coded staging a sequence is truncated at
        its first point whose wide deltas no longer fit the exception
        budget (counted in the packet's ``lidar_dropped``)."""
        with profiling.span("fusion.engine.stage", self.frame_id):
            total = len(points_xyz)
            n = min(total, self._stage_cap - self._seq_fill)
            if n <= 0 or self._num_seqs >= self._seq_stage_cap:
                profiling.count("fusion.ingest.lidar_dropped", total)
                return
            pkt = self._pkt
            qs = self.layout.seq_quant_step
            if self.layout.lidar_delta:
                # 3 x 4-bit zigzag deltas a point in one u16, the raw first
                # point a sequence, wide deltas on the exception list
                q = np.clip(np.rint(
                    np.asarray(points_xyz[:n], np.float32)[:, :3] / qs
                    + 32768.0), 0, 65535).astype(np.int32)
                d = np.zeros((n, 3), np.int32)
                if n > 1:
                    d[1:] = np.diff(q, axis=0)
                wide = np.abs(d) > 7
                fill = pkt.lidar_exc_count
                over = fill + np.cumsum(wide.sum(axis=1)) \
                    > self.layout.lidar_exc_cap
                if over.any():
                    n_new = int(np.argmax(over))
                    pkt.lidar_dropped += n - n_new
                    if n_new <= 0:
                        profiling.count("fusion.ingest.lidar_dropped", total)
                        return
                    n, q, d, wide = n_new, q[:n_new], d[:n_new], wide[:n_new]
                sl = slice(self._seq_fill, self._seq_fill + n)
                zz = np.where(d >= 0, d << 1, ((-d) << 1) - 1)
                codes = np.where(wide, 0, zz).astype(np.uint16)
                pkt.seq_points_d[sl] = (codes[:, 0] | (codes[:, 1] << 4)
                                        | (codes[:, 2] << 8))
                pkt.seq_first[self._num_seqs] = q[0].astype(np.uint16)
                ri, ci = np.nonzero(wide)
                ne = len(ri)
                if ne:
                    pkt.lidar_exc_idx[fill:fill + ne] = \
                        ((self._seq_fill + ri) * 3 + ci).astype(np.uint32)
                    pkt.lidar_exc_zz[fill:fill + ne] = \
                        zz[ri, ci].astype(np.uint32)
                    pkt.lidar_exc_count = fill + ne
            else:
                sl = slice(self._seq_fill, self._seq_fill + n)
                if qs:
                    # 3 x u16 link quantization (error <= qs/2, span
                    # +-32768*qs)
                    q = np.asarray(points_xyz[:n], np.float32)[:, :3] / qs \
                        + 32768.0
                    np.clip(np.rint(q), 0, 65535, out=q)
                    pkt.seq_points_q[sl] = q.astype(np.uint16)
                else:
                    native.stage_points_xyz(
                        np.asarray(points_xyz[:n], np.float32),
                        pkt.seq_points[sl])
            i = self._num_seqs
            pkt.seq_sec[i], pkt.seq_nsec[i], pkt.seq_count[i] = sec, nsec, n
            pkt.seq_tf[i] = np.asarray(tf_move, np.float32)
            self._num_seqs += 1
            self._seq_fill += n
            profiling.count("fusion.ingest.lidar_points", n)
            profiling.count("fusion.ingest.lidar_dropped", total - n)

    # --- the frame step ---
    def _finish_packet(self, now_seconds, tf_world_move, tf_crop_move):
        """Write the frame's header into the staged packet (and zero the
        depth of slots not added this frame); returns the scalars for
        :meth:`HostPacket.set_scalars`."""
        now_ns = timeutil.from_seconds(now_seconds)
        now_sec, now_nsec = timeutil.decode(now_ns)
        min_ns = now_ns - timeutil.from_seconds(
            self.cfg.point_sequence_aggregation_timespan)
        min_sec, min_nsec = timeutil.decode(max(min_ns, 0))
        eye = np.eye(4, dtype=np.float32)
        pkt = self._pkt
        for slot, filled in enumerate(self._depth_filled):
            if not filled:
                self._depth_slot(slot)[...] = 0
        pkt.tf_world_move[:] = eye if tf_world_move is None else tf_world_move
        pkt.tf_crop_move[:] = eye if tf_crop_move is None else tf_crop_move
        return (now_sec, now_nsec, min_sec, min_nsec, self._seq_fill,
                self._num_seqs, self.fp_threshold, self.fp_max_distance,
                self.ps_threshold)

    def _encode(self, pkt: HostPacket, depth_host, scalars):
        """Encode the depth link into the packet (JAX
        ``pipeline/engine.py:825-925``): with ``dpcm_temporal`` a keyframe
        every ``depth_codec_keyframe_interval`` frames, otherwise a p4
        P-frame first, then a classic P-frame, then the spatial I-frame
        when an encoder declines; raw depth when every width overflows
        the exception budget; on a heterogeneous rig
        :meth:`_encode_hetero`. Returns ``(packet words, depth_bits)``."""
        with profiling.span("fusion.engine.encode", pkt.frame):
            encode = (self._encode_hetero if self._hetero
                      else self._encode_homogeneous)
            words, depth_bits = encode(pkt, depth_host, scalars)
        profiling.count(_link_counter(depth_bits))
        return words, depth_bits

    def _encode_homogeneous(self, pkt: HostPacket, depth_host, scalars):
        """:meth:`_encode` on a homogeneous rig."""
        cfg = self.cfg
        depth_bits, exc_count = None, 0
        pkt_out = dict(words=pkt.tail, row_first=pkt.row_first,
                       exc_idx=pkt.exc_idx, exc_zz=pkt.exc_zz)
        encoded = None      # (enc, bits) of a spatial I-frame
        if cfg.depth_link_codec == "dpcm_temporal":
            keyframe = (self._host_prev_q is None
                        or self._frames_since_key
                        >= cfg.depth_codec_keyframe_interval)
            res = res4 = None
            if not keyframe and cfg.depth_codec_p4_budget > 0:
                res4 = native.depth_encode_p4(
                    depth_host, self._host_prev_q,
                    cfg.depth_codec_p4_budget,
                    cfg.depth_codec_max_exceptions,
                    out=dict(flags=pkt.p4_flags, lits=pkt.p4_lits,
                             exc_idx=pkt.exc_idx, exc_zz=pkt.exc_zz),
                    quant_shift=cfg.depth_codec_quant_shift,
                    hysteresis=cfg.depth_codec_hysteresis,
                    curr_q_out=self._host_prev_q_spare)
            elif not keyframe:
                res = native.depth_encode_temporal(
                    depth_host, self._host_prev_q,
                    cfg.depth_codec_max_exceptions, allowed_bits=B_BUCKETS,
                    out=pkt_out, guess_bits=self._last_p_bits,
                    quant_shift=cfg.depth_codec_quant_shift,
                    curr_q_out=self._host_prev_q_spare)
                if res is not None and self._last_bits > 0 \
                        and res[1] >= self._last_bits:
                    # not narrower than the last spatial width: the
                    # P-frame buys nothing, send an I-frame
                    res = None
            if res4 is not None:
                enc4, curr_q = res4
                exc_count = int(enc4["exc_count"])
                self.last_p4_spilled = enc4["spilled"]
                profiling.count("fusion.link.p4_spilled_groups",
                                enc4["spilled"])
                depth_bits = "p4"
            elif res is not None:
                enc, p_bits, curr_q = res
                exc_count = int(enc["exc_count"])
                self._last_p_bits = p_bits
                depth_bits = -p_bits
            if depth_bits is not None:
                self._frames_since_key += 1
                self._host_prev_q_spare = self._host_prev_q
                self._host_prev_q = curr_q
            else:
                encoded = native.depth_encode(
                    depth_host, cfg.depth_codec_max_exceptions,
                    allowed_bits=B_BUCKETS, out=pkt_out,
                    guess_bits=max(self._last_bits, -1),
                    quant_shift=cfg.depth_codec_quant_shift)
                if encoded is not None:
                    self._frames_since_key = 0
                    if self._host_prev_q is None:
                        self._host_prev_q = np.empty(depth_host.shape,
                                                     np.uint16)
                        self._host_prev_q_spare = np.empty(
                            depth_host.shape, np.uint16)
                    # the prediction is the encoder's quantized series
                    _quantize_into(depth_host, cfg.depth_codec_quant_shift,
                                   self._host_prev_q)
        elif cfg.depth_link_codec == "dpcm":
            encoded = native.depth_encode(
                depth_host, cfg.depth_codec_max_exceptions,
                allowed_bits=B_BUCKETS, out=pkt_out,
                guess_bits=self._last_bits,
                quant_shift=cfg.depth_codec_quant_shift)
        if encoded is not None:
            enc, depth_bits = encoded
            exc_count = int(enc["exc_count"])
            self._last_bits = depth_bits
        if depth_bits is None and self._codec:
            _write_raw_pairs(pkt.tail, depth_host)
        profiling.count("fusion.link.exceptions", exc_count)
        pkt.set_scalars(exc_count, *scalars)
        return pkt.view(depth_bits), depth_bits

    def _encode_hetero(self, pkt: HostPacket, depth_hosts, scalars):
        """A heterogeneous rig's encode (JAX ``pipeline/engine.py:780-823``):
        each resolution group codes its own ``"dpcm"`` segment at its own
        width (raw when the codec is off or declines), into its tail
        segment, row_first slice and exception share; its exception count
        goes to the packet's group section. ``depth_bits`` is the tuple of
        per-group widths."""
        cfg, lo = self.cfg, self.layout
        bits = []
        tail_off = exc_off = row_off = 0
        for gi, (cg, gh, _) in enumerate(lo.groups):
            d_g, cap_g = depth_hosts[gi], lo.group_exc_caps[gi]
            exc_count_g, bits_g = 0, None
            if cfg.depth_link_codec == "dpcm":
                encoded = native.depth_encode(
                    d_g, cap_g, allowed_bits=B_BUCKETS,
                    out=dict(words=pkt.tail[tail_off:],
                             row_first=pkt.row_first[row_off:
                                                     row_off + cg * gh],
                             exc_idx=pkt.exc_idx[exc_off:exc_off + cap_g],
                             exc_zz=pkt.exc_zz[exc_off:exc_off + cap_g]),
                    guess_bits=self._last_bits_g[gi],
                    quant_shift=cfg.depth_codec_quant_shift)
                if encoded is not None:
                    enc, bits_g = encoded
                    exc_count_g = int(enc["exc_count"])
                    self._last_bits_g[gi] = bits_g
            if bits_g is None:
                _write_raw_pairs(pkt.tail[tail_off:], d_g)
            pkt.buf[lo.off_gmeta + gi] = np.uint32(exc_count_g)
            profiling.count("fusion.link.exceptions", exc_count_g)
            bits.append(bits_g)
            tail_off += lo.group_tail_words(gi, bits_g)
            exc_off += cap_g
            row_off += cg * gh
        bits = tuple(bits)
        pkt.set_scalars(0, *scalars)
        return pkt.view(bits), bits

    def _encode_and_put(self, pkt: HostPacket, depth_host, scalars,
                        flip: int):
        """Encode the staged frame and copy its packet to the device.
        Returns ``(device packet, event or None, depth_bits)``: with a side
        copy stream the step must wait on the event first."""
        words, depth_bits = self._encode(pkt, depth_host, scalars)
        profiling.count("fusion.link.packet_bytes", len(words) * 4)
        with profiling.span("fusion.engine.put", pkt.frame):
            src = pkt.tensor[:len(words)]
            if self.device.type != "cuda":
                return src.clone(), None, depth_bits
            stream = (self._copy_stream if self._copy_stream is not None
                      else torch.cuda.current_stream(self.device))
            with torch.cuda.stream(stream):
                packet = src.to(self.device, non_blocking=True)
                event = torch.cuda.Event()
                event.record(stream)
        self._copied[flip] = event
        return packet, (event if self._copy_stream is not None
                        else None), depth_bits

    def upload(self, now_seconds: float,
               tf_world_move: Optional[np.ndarray] = None,
               tf_crop_move: Optional[np.ndarray] = None) -> FrameInputs:
        """Finish staging the frame, encode it, copy its packet to the
        device (one asynchronous copy from pinned memory) and return the
        unpacked :class:`FrameInputs` (its payload is named by
        :attr:`last_frame_bits`); the staging area is cleared for the next
        frame. The synchronous path: a pipelined engine uploads inside
        :meth:`process`."""
        if self.pipeline_depth:
            raise RuntimeError("upload() is the pipeline_depth=0 path")
        packet, bits = self._put_staged(now_seconds, tf_world_move,
                                        tf_crop_move)
        with profiling.span("fusion.step.unpack", self.frame_id - 1):
            return unpack_packet(packet, self.layout, bits)

    def _put_staged(self, now_seconds, tf_world_move, tf_crop_move):
        """The synchronous path's encode and copy of the staged frame;
        the staging area is cleared. Returns ``(device packet,
        depth_bits)``."""
        scalars = self._finish_packet(now_seconds, tf_world_move,
                                      tf_crop_move)
        packet, _, bits = self._encode_and_put(
            self._pkt, self._depth_host, scalars, self._pkt_flip)
        self.clear()
        self.last_frame_bits = bits
        return packet, bits

    def step(self, inp: FrameInputs, depth_bits=None) -> FrameOutputs:
        """Run the frame step on uploaded inputs and advance the state."""
        self.state, out = self._fusion_step(self.state, inp, depth_bits)
        return out

    def _run_packet(self, packet: torch.Tensor, bits) -> FrameOutputs:
        """Unpack the frame before the staged one from its device packet
        and run its step."""
        frame = self.frame_id - 1
        with profiling.span("fusion.step", frame):
            with profiling.span("fusion.step.unpack"):
                inp = unpack_packet(packet, self.layout, bits)
            out = self.step(inp, bits)
        profiling.count("fusion.frames")
        profiling.gauge("fusion.voxelize.partials_capacity",
                        self.partials_capacity)
        return out

    def _step_put(self, fut) -> FrameOutputs:
        # the frame in flight is the one before the staged one
        with profiling.span("fusion.engine.wait_encode", self.frame_id - 1):
            packet, event, bits = fut.result()
        if event is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(event)
            # the packet was allocated on the copy stream: keep its memory
            # from reuse until the step's work on this stream is done
            packet.record_stream(stream)
        self.last_frame_bits = bits
        return self._run_packet(packet, bits)

    def process(self, now_seconds: float,
                tf_world_move: Optional[np.ndarray] = None,
                tf_crop_move: Optional[np.ndarray] = None
                ) -> Optional[FrameOutputs]:
        """Run the staged frame. Returns device-resident outputs without
        waiting for the device: this frame's, or with ``pipeline_depth=1``
        the previous frame's (``None`` on the first call)."""
        if not self.pipeline_depth:
            return self._run_packet(*self._put_staged(
                now_seconds, tf_world_move, tf_crop_move))
        scalars = self._finish_packet(now_seconds, tf_world_move,
                                      tf_crop_move)
        prev = self._pending
        self._pending = self._worker.submit(
            self._encode_and_put, self._pkt, self._depth_host, scalars,
            self._pkt_flip)
        out = None if prev is None else self._step_put(prev)
        # after the previous frame's encode: clear() hands its buffers to
        # the next frame's staging
        self.clear()
        return out

    def flush(self) -> Optional[FrameOutputs]:
        """Run the frame in flight (pipelined mode) and return its outputs,
        or ``None`` when nothing is pending."""
        if self._pending is None:
            return None
        fut, self._pending = self._pending, None
        return self._step_put(fut)

    def segment_and_track(self, out: FrameOutputs) -> MappingResult:
        """Object segmentation + tracking on a frame's occupancy grid
        (reference objectSegmentation + objectTracking). Needs
        ``out.occupancy_u8`` (``cfg.emit_occupancy_u8``); a frame without it
        goes through ``self.mapping.process_sparse`` or
        ``process_packed``."""
        if self.mapping is None:
            raise RuntimeError("engine constructed with enable_mapping=False")
        if out.occupancy_u8.numel() < self.grid.num_cells:
            raise ValueError(
                "segment_and_track needs the dense occupancy, and this "
                "engine's frames carry a stub (emit_occupancy_u8=False): "
                "use self.mapping.process_sparse on the frame's "
                "occupancy_sparse_* outputs, or process_packed on "
                "occupancy_bits")
        return self.mapping.process(out.occupancy_u8, self.cfg.tracking_dt,
                                    frame=self.frame_id - 1)

    def close(self):
        """Stop the pipelined engine's worker thread (after the frame in
        flight is encoded; :meth:`flush` returns its outputs first)."""
        if self._worker is not None:
            self._worker.shutdown(wait=True)
