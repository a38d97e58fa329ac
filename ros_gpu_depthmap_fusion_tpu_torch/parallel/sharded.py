"""The multi-rank fusion step (the JAX package's ``parallel/sharded.py``).

One rank's part of the frame step over a ``(stream, space)`` mesh
(:mod:`.mesh`), line for line the JAX ``shard_map`` body:

- Depth cameras are sharded over ``stream``: each rank decodes, unprojects
  and filters its own ``C / num_stream`` cameras.
- The lidar rollbuffer is sharded over ``stream``: staged sequences are
  owned round-robin, rotated by the frame index, and each rank keeps a
  rollbuffer of ``1 / num_stream`` of each capacity. The ranks' selections
  are disjoint, so they join exactly at the voxel sums and the occupancy.
- The fresh occupancy of this rank's space block is the max over
  ``stream`` (``all_reduce(MAX)``); each rank ages only its own block of
  the historic grid, which is padded so that blocks split evenly.
- Average mode: each rank's quantized partial sums (one segreduce of its
  sorted stream) go into a dense ``[padded, 4]`` slab; a reduce-scatter
  over ``stream`` hands each rank the summed sub-slab of its space block
  at its stream coordinate, which it dequantizes and compacts. The sums
  are integer-valued float32 below 2^24, so any reduction order gives the
  same bits and the step equals the single engine at
  ``voxel_mean_mode="packed"``. Occupied mode compacts the occupied cell
  corners of the space block.

The JAX step's ``input_shardings`` / ``state_shardings`` become
:func:`shard_inputs` (this rank's slice of a frame's full host inputs,
copied to its device) and :func:`sharded_initial_state` (this rank's
shard of the state).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist

from ros_gpu_depthmap_fusion_tpu_torch.core.config import FusionConfig
from ros_gpu_depthmap_fusion_tpu_torch.core.grid import VoxelGrid
from ros_gpu_depthmap_fusion_tpu_torch.ops.depth_codec import decode_depth
from ros_gpu_depthmap_fusion_tpu_torch.ops.kernels.flying_pixels import (
    filter_flying_pixels)
from ros_gpu_depthmap_fusion_tpu_torch.ops.mask_ops import (
    compact, compact_multi, crop_points)
from ros_gpu_depthmap_fusion_tpu_torch.ops.stencil import (
    filter_point_sequence)
from ros_gpu_depthmap_fusion_tpu_torch.ops.unproject import (
    unproject_depthmaps)
from ros_gpu_depthmap_fusion_tpu_torch.ops.voxel import (
    occupancy_bitmap, occupancy_to_u8, scatter_occupancy,
    update_historic_occupancy)
from ros_gpu_depthmap_fusion_tpu_torch.ops.voxelize import (
    dequantize_cell_means, voxelize_partial_sums)
from ros_gpu_depthmap_fusion_tpu_torch.parallel.mesh import (
    SPACE_AXIS, STREAM_AXIS, Mesh, all_reduce, reduce_scatter)
from ros_gpu_depthmap_fusion_tpu_torch.pipeline.engine import (
    EngineState, FrameInputs, inputs_to_device)
from ros_gpu_depthmap_fusion_tpu_torch.state import rollbuffer as rbmod


class ShardedFrameOutputs(NamedTuple):
    """This rank's shard of every output of a frame (the JAX outputs'
    per-device blocks). The host views of
    :class:`parallel.engine.ShardedFusionEngine` assemble the whole."""
    # average mode: this rank's compacted sub-slab of its space block,
    # [ceil(block_output_capacity / num_stream), 4]; globally the blocks
    # run space-major, stream-minor. Occupied mode: its space block's
    # occupied cells, [block_output_capacity, 4] (the same on every rank
    # of a space column)
    fused_points: torch.Tensor
    fused_counts: torch.Tensor   # [1] int32
    # this rank's cameras and lidar share, compacted: [local_cap, 4] (the
    # same on every rank of a stream row)
    raw_points: torch.Tensor
    raw_counts: torch.Tensor     # [1] int32
    # the space block of the historic occupancy, [padded / num_space] u8
    # (the same on every rank of a space column)
    occupancy_u8: torch.Tensor
    # the block binarized and packed 8 cells a byte (the mapping
    # consumer's payload), [ceil(block / 8)] u8
    occupancy_bits: torch.Tensor


def padded_num_cells(grid: VoxelGrid, n_space: int,
                     n_stream: int = 1) -> int:
    """Grid cells padded so each space block splits evenly over the stream
    axis too (the reduce-scatter hands each stream rank ``block /
    n_stream`` cells)."""
    mult = n_space * n_stream
    return ((grid.num_cells + mult - 1) // mult) * mult


def _rb_caps(cfg: FusionConfig, n_stream: int):
    """Per-rank rollbuffer (point, sequence) capacities: the configured
    ones split over the stream axis."""
    p_cap, s_cap = (cfg.rollbuffer_point_capacity,
                    cfg.rollbuffer_seq_capacity)
    if p_cap % n_stream or s_cap % n_stream:
        raise ValueError(
            f"rollbuffer_point_capacity={p_cap} and rollbuffer_seq_capacity"
            f"={s_cap} must split evenly over {n_stream} stream ranks")
    return p_cap // n_stream, s_cap // n_stream


def check_sharded_supported(cfg: FusionConfig, n_stream: int) -> None:
    """Raise ``ValueError``, naming the field, for what the sharded step
    does not run (the JAX package asserts the same)."""
    if cfg.num_depth_streams % n_stream:
        raise ValueError(f"num_depth_streams={cfg.num_depth_streams} does "
                         f"not split over {n_stream} stream ranks")
    if cfg.is_heterogeneous:
        raise ValueError(
            "heterogeneous stream_shapes are not supported on the sharded "
            "step: use the single-device FusionEngine for mixed-resolution "
            "rigs")
    if cfg.depth_link_codec not in ("dpcm", "none"):
        raise ValueError(
            f"depth_link_codec={cfg.depth_link_codec!r} is not supported on "
            "the sharded step (no per-shard P-frame state): use 'dpcm' or "
            "'none'")


def sharded_initial_state(cfg: FusionConfig, grid: VoxelGrid,
                          mesh: Mesh) -> EngineState:
    """This rank's shard of an empty state on ``mesh.device``: the
    historic grid's space block (``padded / num_space`` cells) and a
    rollbuffer of ``1 / num_stream`` of each capacity, whose extents are
    ``[1]``."""
    n_stream, n_space = mesh.shape[STREAM_AXIS], mesh.shape[SPACE_AXIS]
    padded = padded_num_cells(grid, n_space, n_stream)
    p_cap, s_cap = _rb_caps(cfg, n_stream)
    dev = mesh.device
    rb = rbmod.make_rollbuffer(p_cap, s_cap, dev)
    zero1 = torch.zeros((1,), dtype=torch.int32, device=dev)
    return EngineState(
        rollbuffer=rb._replace(num_points=zero1, num_seqs=zero1.clone()),
        historic_occupancy=torch.zeros((padded // n_space,),
                                       dtype=torch.int32, device=dev),
        frame_index=torch.zeros((), dtype=torch.int32, device=dev),
        prev_depth_q=torch.zeros((1, 1, 1), dtype=torch.int32, device=dev))


def shard_inputs(inp: FrameInputs, mesh: Mesh,
                 depth_bits: Optional[int] = None) -> FrameInputs:
    """This rank's :class:`FrameInputs` on ``mesh.device`` from a frame's
    full host inputs (the JAX step's ``input_shardings``): its ``C /
    num_stream`` cameras' depth (under the coded link, their ``words`` and
    ``row_first`` rows, with the exception arrays whole), intrinsics and
    transforms; everything else whole."""
    c_local = int(np.shape(inp.intrinsics)[0]) // mesh.shape[STREAM_AXIS]
    lo = mesh.stream_id * c_local
    return inputs_to_device(inp, mesh.device, slice(lo, lo + c_local),
                            depth_bits)


def build_sharded_fusion_step(cfg: FusionConfig, grid: VoxelGrid,
                              mesh: Mesh,
                              block_output_capacity: Optional[int] = None,
                              depth_bits: Optional[int] = None):
    """This rank's frame step: ``(state, inputs) -> (state,
    ShardedFrameOutputs)``, with ``state`` from
    :func:`sharded_initial_state` and ``inputs`` from :func:`shard_inputs`.
    Every rank of the mesh must run each step (it holds collectives).

    ``depth_bits``: ``None`` for raw depth, else the DPCM code width of
    ``inputs.depth``, an :class:`EncodedDepth` each rank decodes for its
    own cameras. Raises ``ValueError`` for heterogeneous
    ``stream_shapes`` and for ``depth_link_codec="dpcm_temporal"``.
    """
    n_stream, n_space = mesh.shape[STREAM_AXIS], mesh.shape[SPACE_AXIS]
    check_sharded_supported(cfg, n_stream)
    stream_id, space_id = mesh.stream_id, mesh.space_id
    c_local = cfg.num_depth_streams // n_stream
    h, w = cfg.depth_height, cfg.depth_width
    n_depth_local = c_local * h * w
    sel_cap, _ = _rb_caps(cfg, n_stream)
    local_cap = n_depth_local + sel_cap
    padded = padded_num_cells(grid, n_space, n_stream)
    block = padded // n_space
    if block_output_capacity is None:
        block_output_capacity = min(block, local_cap)
    # average mode compacts per (space, stream) sub-slab
    sub_output_capacity = -(-block_output_capacity // n_stream)
    sub = block // n_stream
    num_cells = grid.num_cells
    # per-stream depth scales: this rank's window of the [C] scales
    scale = (cfg.resolved_depth_scales[stream_id * c_local:
                                       (stream_id + 1) * c_local]
             if cfg.depth_scales is not None else cfg.depth_scale)
    dev = mesh.device
    i32 = torch.int32

    def step(state: EngineState, inp: FrameInputs):
        # the local rollbuffer: its extents arrive as [1]
        rb = state.rollbuffer._replace(
            num_points=state.rollbuffer.num_points[0],
            num_seqs=state.rollbuffer.num_seqs[0])
        sb = inp.seq_batch

        # -- rollbuffer maintenance, stream-sharded: staged sequences are
        #    owned round-robin, rotated by the frame index; each rank
        #    compacts its own records and points (stable, so points stay
        #    contiguous a sequence) and inserts only those --
        stage_idx = torch.arange(sb.points.shape[0], dtype=i32, device=dev)
        staged_mask = stage_idx < sb.num_points
        seq_mask = filter_point_sequence(
            sb.points, staged_mask, sb.num_points,
            cfg.point_sequence_filter_size, inp.ps_threshold)
        s_stage = torch.arange(sb.seq_sec.shape[0], dtype=i32, device=dev)
        own_seq = (((s_stage + state.frame_index) % n_stream == stream_id)
                   & (s_stage < sb.num_seqs))
        (o_sec, o_nsec, o_cnt, o_tf), n_own, _ = compact_multi(
            (sb.seq_sec, sb.seq_nsec, sb.seq_count,
             sb.seq_tf_move.reshape(-1, 16)), own_seq, sb.seq_sec.shape[0])
        own_rank = torch.cumsum(own_seq.to(i32), 0, dtype=i32) - 1
        seq_of = sb.seq_idx.long()
        own_pt = own_seq[seq_of] & staged_mask
        # the sequence mask and rank travel as float32 words (exact below
        # 2^24), as in the JAX step
        (o_pts, o_mask_f, o_idx_f), n_pts, _ = compact_multi(
            (sb.points, seq_mask.to(torch.float32),
             own_rank[seq_of].to(torch.float32)), own_pt,
            sb.points.shape[0])
        rb, _ = rbmod.insert_sequences(
            rb, o_pts, o_mask_f > 0.5, o_idx_f.to(i32), o_sec, o_nsec,
            o_cnt, o_tf.reshape(-1, 4, 4), n_pts, n_own)
        rb = rbmod.roll(rb, inp.roll_min_sec, inp.roll_min_nsec)
        sel = rbmod.select_timespan(rb, inp.roll_min_sec, inp.roll_min_nsec,
                                    inp.now_sec, inp.now_nsec)
        seq_world, seq_crop, seq_valid, _ = rbmod.gather_selection(
            rb, sel, inp.tf_world_move, inp.tf_crop_move, sel_cap)

        # -- this rank's cameras: decode, unproject, flying-pixel filter --
        if depth_bits is None:
            depth = inp.depth
        else:
            # exceptions carry global flat pixel indices: rebase them into
            # this rank's window; the decoder drops the rest (an index of
            # n_depth_local or more)
            enc = inp.depth
            li = enc.exc_idx.to(i32) - stream_id * n_depth_local
            li = torch.where((li >= 0) & (li < n_depth_local), li,
                             n_depth_local)
            depth = decode_depth(enc._replace(exc_idx=li), h, w, depth_bits,
                                 cfg.depth_codec_quant_shift)
        pts_cam, pts_world, pts_crop, dmask = unproject_depthmaps(
            depth, inp.intrinsics, inp.tf_world, inp.tf_crop, scale)
        if cfg.enable_flyingpixels_filter:
            dmask = filter_flying_pixels(
                pts_cam, dmask, h, w, cfg.flyingpixels_filter_size,
                inp.fp_threshold, cfg.flyingpixels_filter_enable_rot45,
                inp.fp_max_distance)
        all_world = torch.cat([pts_world.reshape(n_depth_local, 4),
                               seq_world])
        all_mask = crop_points(
            torch.cat([pts_crop.reshape(n_depth_local, 4), seq_crop]),
            torch.cat([dmask.reshape(n_depth_local), seq_valid]),
            cfg.crop_min, cfg.crop_max)
        raw_points, raw_count = compact(all_world, all_mask, local_cap)

        # -- fresh occupancy of this rank's space block: a local scatter,
        #    the block sliced, then the max over stream --
        cell_ids = grid.cell_index_clamped(raw_points[:, :3])
        live = torch.arange(local_cap, dtype=i32, device=dev) < raw_count
        fresh_local = scatter_occupancy(cell_ids, live, padded)
        b0 = space_id * block
        my_block = all_reduce(fresh_local[b0:b0 + block], dist.ReduceOp.MAX,
                              mesh, STREAM_AXIS)

        # -- the historic update of this rank's block only --
        historic = update_historic_occupancy(
            state.historic_occupancy, my_block, cfg.voxel_occupancy_lifetime)
        occupancy_u8 = occupancy_to_u8(historic)

        # -- fused points of the space block --
        if cfg.voxel_enable_average:
            # integer partial sums of this rank's points into a dense slab
            # (a drop row for the empty ones), summed and scattered over
            # stream: this rank dequantizes and compacts its sub-slab
            p_cells, p_qsums, p_cnts, _ = voxelize_partial_sums(
                raw_points, cell_ids, live, grid, min(local_cap, padded))
            rows = torch.cat([p_qsums, p_cnts[:, None]], dim=-1)
            tgt = torch.where(p_cnts > 0, p_cells, padded).long()
            dense = torch.zeros((padded + 1, 4), dtype=torch.float32,
                                device=dev)
            dense[tgt] = rows
            part = reduce_scatter(dense[b0:b0 + block], mesh, STREAM_AXIS)
            sub_ids = (torch.arange(sub, dtype=i32, device=dev) + b0
                       + stream_id * sub)
            blk_cnts = torch.where(sub_ids < num_cells, part[:, 3], 0.0)
            pts = dequantize_cell_means(sub_ids, part[:, :3], blk_cnts, grid)
            (fused_points,), fused_count, _ = compact_multi(
                (pts,), blk_cnts > 0, sub_output_capacity)
        else:
            blk_ids = torch.arange(block, dtype=i32, device=dev) + b0
            xyz = grid.world_coord_of_index(
                torch.clamp_max(blk_ids, num_cells - 1))
            pts = torch.cat([xyz, torch.ones_like(xyz[:, :1])], dim=-1)
            occ_blk = (my_block > 0) & (blk_ids < num_cells)
            (fused_points,), fused_count, _ = compact_multi(
                (pts,), occ_blk, block_output_capacity)

        new_state = EngineState(
            rollbuffer=rb._replace(num_points=rb.num_points.reshape(1),
                                   num_seqs=rb.num_seqs.reshape(1)),
            historic_occupancy=historic,
            frame_index=state.frame_index + 1,
            prev_depth_q=state.prev_depth_q)
        return new_state, ShardedFrameOutputs(
            fused_points=fused_points, fused_counts=fused_count.reshape(1),
            raw_points=raw_points, raw_counts=raw_count.reshape(1),
            occupancy_u8=occupancy_u8,
            occupancy_bits=occupancy_bitmap(historic))

    return step
