"""The fusion engine: the per-frame step and its host orchestrator.

Per frame, in the reference's order (``processDepthmaps``,
``src/gpu_depthmap_fusion_component.cpp:92-515``):

    1. filter new point sequences        (cpp:166)
    2. insert into the rollbuffer        (cpp:168)
    3. expire old sequences              (cpp:185)
    4. select the aggregation timespan   (cpp:194)
    5. gather + transform the selection  (cpp:199-203)
    6. unproject depth maps              (cpp:226)
    7. flying-pixel filter               (cpp:234)  kernel 2
    8. crop                              (cpp:241)
    9. voxelize (average)                (cpp:259-288)  kernel 1, twice
    10. occupancy + temporal decay       (cpp:297)
    11. packed and sparse occupancy bitmaps            kernel 3

Steps 8-10 take the split-domain layout of the JAX package's engine
(``pipeline/engine.py:294-318, :382-392``): the depth raster and the lidar
selection are never concatenated; they meet at the (cell, partial-sum)
level inside :func:`ops.voxelize.voxelize_average_rle_domains`.

Every tensor of a step lives on the engine's device and the step never
waits for it: a frame's only host -> device traffic is one packet copy
from pinned memory, and outputs stay on the device until the caller reads
them. The state is never modified in place; each step returns a new one.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ros_gpu_depthmap_fusion_tpu_torch.core import timeutil
from ros_gpu_depthmap_fusion_tpu_torch.core.config import FusionConfig
from ros_gpu_depthmap_fusion_tpu_torch.core.grid import VoxelGrid
from ros_gpu_depthmap_fusion_tpu_torch.ops.kernels.flying_pixels import (
    filter_flying_pixels, filter_flying_pixels_plain)
from ros_gpu_depthmap_fusion_tpu_torch.ops.mask_ops import crop_points
from ros_gpu_depthmap_fusion_tpu_torch.ops.stencil import (
    filter_point_sequence)
from ros_gpu_depthmap_fusion_tpu_torch.ops.unproject import (
    unproject_depthmaps)
from ros_gpu_depthmap_fusion_tpu_torch.ops.voxel import (
    occupancy_bitmap, occupancy_bitmap_sparse, occupancy_to_u8)
from ros_gpu_depthmap_fusion_tpu_torch.ops.voxelize import (
    voxelize_average_rle_domains)
from ros_gpu_depthmap_fusion_tpu_torch.pipeline.packet import (
    HostPacket, PacketLayout, unpack_packet)
from ros_gpu_depthmap_fusion_tpu_torch.state import rollbuffer as rbmod
from ros_gpu_depthmap_fusion_tpu_torch.state.rollbuffer import RollBuffer


class EngineState(NamedTuple):
    """Carried device state (the reference's persistent SSBOs)."""
    rollbuffer: RollBuffer
    historic_occupancy: torch.Tensor   # [num_cells] int32
    frame_index: torch.Tensor          # 0-d int32


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
    depth: torch.Tensor        # [C, H, W] u16 values (any integer dtype)
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
    raw_points: torch.Tensor     # [1, 4] stub (raw cloud not emitted)
    raw_count: torch.Tensor      # valid depth + lidar points after crop
    occupancy_u8: torch.Tensor   # [num_cells] u8, or a [1] stub
    occupancy_bits: torch.Tensor  # packed 8 cells a byte
    seq_selected_count: torch.Tensor
    # max over raster domains of the true level-1 run count scaled to the
    # full partials capacity; above cfg.voxelize_partials_capacity means
    # partial rows were dropped this frame
    vox_partials_count: torch.Tensor
    # nonzero 128-bit blocks of occupancy_bits (index, 4 words) + clamped
    # and true count; [1]-stubs when cfg.occupancy_sparse_capacity == 0
    occupancy_sparse_idx: torch.Tensor
    occupancy_sparse_words: torch.Tensor
    occupancy_sparse_count: torch.Tensor
    occupancy_sparse_true: torch.Tensor


def check_supported(cfg: FusionConfig) -> None:
    """Raise ``NotImplementedError`` for a configuration outside the
    port's current slice (homogeneous rig, raw depth link, split-domain
    RLE average voxelize), naming the config field."""
    if cfg.is_heterogeneous:
        raise NotImplementedError(
            "stream_shapes: heterogeneous rigs are not ported yet")
    if cfg.depth_link_codec != "none":
        raise NotImplementedError(
            f"depth_link_codec={cfg.depth_link_codec!r}: the depth-link "
            "codecs are not ported yet; use depth_link_codec='none'")
    if cfg.lidar_link_delta:
        raise NotImplementedError(
            "lidar_link_delta: delta-coded lidar staging is not ported yet")
    for field, bad in (("emit_raw_points", cfg.emit_raw_points),
                       ("enable_voxel_filter", not cfg.enable_voxel_filter),
                       ("voxel_enable_average",
                        not cfg.voxel_enable_average),
                       ("enable_radius_filter", cfg.enable_radius_filter),
                       ("voxel_mean_mode",
                        cfg.voxel_mean_mode not in ("auto", "rle"))):
        if bad:
            raise NotImplementedError(
                f"{field}={getattr(cfg, field)!r}: only the split-domain "
                "RLE average voxelize is ported (emit_raw_points=False, "
                "voxel filter and averaging on, no radius filter, "
                "voxel_mean_mode 'auto' or 'rle')")


def initial_state(cfg: FusionConfig, grid: VoxelGrid, device) -> EngineState:
    """Empty state on ``device`` (no default: the caller names it)."""
    return EngineState(
        rollbuffer=rbmod.make_rollbuffer(
            cfg.rollbuffer_point_capacity, cfg.rollbuffer_seq_capacity,
            device),
        historic_occupancy=torch.zeros((grid.num_cells,), dtype=torch.int32,
                                       device=device),
        frame_index=torch.zeros((), dtype=torch.int32, device=device),
    )


def state_from_jax_numpy(d: dict, device) -> EngineState:
    """An :class:`EngineState` on ``device`` from numpy arrays of the JAX
    engine's state: the ``RollBuffer`` fields by name plus
    ``historic_occupancy`` and ``frame_index`` (other keys, such as the
    depth codec's ``prev_depth_q``, are ignored)."""
    def t(name, dtype):
        return torch.from_numpy(np.array(d[name])).to(device=device,
                                                      dtype=dtype)

    kinds = dict(points=torch.float32, mask=torch.bool,
                 seq_tf_move=torch.float32)
    rb = RollBuffer(**{f: t(f, kinds.get(f, torch.int32))
                       for f in RollBuffer._fields})
    return EngineState(rollbuffer=rb,
                       historic_occupancy=t("historic_occupancy",
                                            torch.int32),
                       frame_index=t("frame_index", torch.int32))


def state_to_numpy(state: EngineState) -> dict:
    """Inverse of :func:`state_from_jax_numpy` (waits for the device)."""
    d = {f: getattr(state.rollbuffer, f).cpu().numpy()
         for f in RollBuffer._fields}
    d["historic_occupancy"] = state.historic_occupancy.cpu().numpy()
    d["frame_index"] = state.frame_index.cpu().numpy()
    return d


def fusion_step(state: EngineState,
                inp: FrameInputs,
                *,
                cfg: FusionConfig,
                grid: VoxelGrid,
                output_capacity: int,
                plain: bool = False):
    """One frame step; returns ``(new_state, FrameOutputs)``.

    ``plain=True`` runs the plain PyTorch twins of the three kernels even
    on CUDA tensors (the on-card reference the kernels are checked
    against); otherwise each kernel wrapper launches its CUDA kernel for
    CUDA tensors and its twin for CPU tensors.
    """
    check_supported(cfg)
    h, w = cfg.depth_height, cfg.depth_width
    n_depth = cfg.depthmaps_total_elements
    sel_cap = cfg.rollbuffer_point_capacity
    dev = state.historic_occupancy.device
    rb = state.rollbuffer
    sb = inp.seq_batch

    # -- 1. filter new point sequences (sensor frame) --
    staged = torch.arange(sb.points.shape[0], dtype=torch.int32,
                          device=dev) < sb.num_points
    seq_mask = filter_point_sequence(
        sb.points, staged, sb.num_points, cfg.point_sequence_filter_size,
        inp.ps_threshold)

    # -- 2-5. rollbuffer insert, expiry, selection, gather + transform --
    rb, _ = rbmod.insert_sequences(
        rb, sb.points, seq_mask, sb.seq_idx, sb.seq_sec, sb.seq_nsec,
        sb.seq_count, sb.seq_tf_move, sb.num_points, sb.num_seqs)
    rb = rbmod.roll(rb, inp.roll_min_sec, inp.roll_min_nsec)
    sel = rbmod.select_timespan(
        rb, inp.roll_min_sec, inp.roll_min_nsec, inp.now_sec, inp.now_nsec)
    seq_world, seq_crop, seq_valid, _ = rbmod.gather_selection(
        rb, sel, inp.tf_world_move, inp.tf_crop_move, sel_cap)

    # -- 6. unproject; 7. flying-pixel filter (camera frame) --
    scale = (cfg.resolved_depth_scales if cfg.depth_scales is not None
             else cfg.depth_scale)
    pts_cam, pts_world, pts_crop, dmask = unproject_depthmaps(
        inp.depth, inp.intrinsics, inp.tf_world, inp.tf_crop, scale)
    if cfg.enable_flyingpixels_filter:
        fp = filter_flying_pixels_plain if plain else filter_flying_pixels
        dmask = fp(pts_cam, dmask, h, w, cfg.flyingpixels_filter_size,
                   inp.fp_threshold, cfg.flyingpixels_filter_enable_rot45,
                   inp.fp_max_distance)

    # -- 8. crop, both domains --
    pw = pts_world.reshape(n_depth, 4)
    m_depth = crop_points(pts_crop.reshape(n_depth, 4),
                          dmask.reshape(n_depth), cfg.crop_min, cfg.crop_max)
    seq_valid = crop_points(seq_crop, seq_valid, cfg.crop_min, cfg.crop_max)
    raw_count = torch.clamp_max(
        m_depth.sum(dtype=torch.int32) + seq_valid.sum(dtype=torch.int32),
        n_depth + sel_cap)

    # -- 9. voxelize: raster domain + lidar rows meet at the partials --
    fused_points, fused_count, (cells, cells_live), vox_partials = (
        voxelize_average_rle_domains(
            [(pw, grid.cell_index_clamped(pw[:, :3]), m_depth)], grid,
            output_capacity,
            partials_capacity=cfg.voxelize_partials_capacity,
            extra_points=seq_world,
            extra_cell_indices=grid.cell_index_clamped(seq_world[:, :3]),
            extra_mask=seq_valid, plain=plain))

    # -- 10. occupancy + decay: the fresh grid is 0/1 at the emitted
    #        cells, so max(aged, fresh * lifetime) is a scatter-max of
    #        `lifetime` at those cells into the aged grid --
    num_cells = grid.num_cells
    aged = torch.cat([torch.clamp_min(state.historic_occupancy - 1, 0),
                      torch.zeros((1,), dtype=torch.int32, device=dev)])
    target = torch.where(cells_live, cells, num_cells).long()
    historic = aged.scatter_reduce_(
        0, target, torch.full_like(cells, cfg.voxel_occupancy_lifetime),
        reduce="amax")[:num_cells]
    occupancy_u8 = (occupancy_to_u8(historic) if cfg.emit_occupancy_u8
                    else torch.zeros((1,), dtype=torch.uint8, device=dev))

    # -- 11. sparse occupancy blocks for the mapping consumer --
    if cfg.occupancy_sparse_capacity > 0:
        si, sw, sc, st = occupancy_bitmap_sparse(
            historic, cfg.occupancy_sparse_capacity, plain=plain)
    else:
        si = torch.zeros((1,), dtype=torch.int32, device=dev)
        sw = torch.zeros((1, 4), dtype=torch.int32, device=dev)
        sc = st = torch.zeros((), dtype=torch.int32, device=dev)

    new_state = EngineState(rollbuffer=rb, historic_occupancy=historic,
                            frame_index=state.frame_index + 1)
    return new_state, FrameOutputs(
        fused_points=fused_points, fused_count=fused_count,
        raw_points=torch.zeros((1, 4), dtype=torch.float32, device=dev),
        raw_count=raw_count, occupancy_u8=occupancy_u8,
        occupancy_bits=occupancy_bitmap(historic),
        seq_selected_count=sel.point_count,
        vox_partials_count=vox_partials,
        occupancy_sparse_idx=si, occupancy_sparse_words=sw,
        occupancy_sparse_count=sc, occupancy_sparse_true=st)


# ---------------------------------------------------------------------------
# Host orchestrator
# ---------------------------------------------------------------------------

class FusionEngine:
    """Host-side engine with the reference component's ingestion API:
    :meth:`add_depthmap` / :meth:`add_point_sequence` stage a frame's
    inputs on the host, :meth:`process` runs the frame step on ``device``
    (the clear/add/process lifecycle of gpu_depthmap_fusion.h:223-307).

    ``device`` has no default: ``"cuda"`` runs the hand-written kernels,
    ``"cpu"`` their plain twins.
    """

    def __init__(self, cfg: FusionConfig, device,
                 grid: Optional[VoxelGrid] = None, pipeline_depth: int = 0):
        check_supported(cfg)
        if pipeline_depth:
            raise NotImplementedError(
                "pipeline_depth=1 (overlapped upload) is not ported yet")
        self.cfg = cfg
        self.device = torch.device(device)
        self.grid = grid or VoxelGrid.from_config(cfg)
        self.output_capacity = min(self.grid.num_cells,
                                   cfg.total_point_capacity,
                                   cfg.voxelize_output_capacity)
        self.state = initial_state(cfg, self.grid, self.device)
        self._stage_cap = cfg.max_points_per_sequence
        self._seq_stage_cap = max(1, cfg.num_point_sequences * 4)
        self.layout = PacketLayout.for_config(
            cfg, seq_cap=self._seq_stage_cap, stage_cap=self._stage_cap)
        # two host packets alternate, so frame k+1 stages while frame k's
        # copy may still be in flight; the event of a packet's last copy
        # is waited on before the packet is staged again
        pin = self.device.type == "cuda"
        self._packets = (HostPacket(self.layout, pin),
                         HostPacket(self.layout, pin))
        self._copied = [None, None]
        self._pkt_flip = 0
        # live-reconfigurable filter scalars: they ride in every packet
        self.fp_threshold = cfg.flyingpixels_filter_threshold
        self.fp_max_distance = cfg.flyingpixels_max_distance
        self.ps_threshold = cfg.point_sequence_filter_threshold
        self.clear()

    # --- ingestion (reference addDepthmap / addPointSequence) ---
    def clear(self):
        """Switch to the other host packet and drop the staged inputs
        (the rollbuffer is kept; gpu_depthmap_fusion.cpp:725-732)."""
        self._pkt_flip ^= 1
        event = self._copied[self._pkt_flip]
        if event is not None:
            event.synchronize()
        self._pkt = self._packets[self._pkt_flip]
        self._depth_filled = [False] * self.cfg.num_depth_streams
        self._num_seqs = 0
        self._seq_fill = 0

    def add_depthmap(self, slot: int, depth_u16: np.ndarray,
                     intrinsics, tf_world: np.ndarray,
                     tf_crop: np.ndarray):
        np.copyto(self._pkt.depth[slot], depth_u16, casting="same_kind")
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
        are dropped."""
        n = min(len(points_xyz), self._stage_cap - self._seq_fill)
        if n <= 0 or self._num_seqs >= self._seq_stage_cap:
            return
        pkt = self._pkt
        qs = self.layout.seq_quant_step
        sl = slice(self._seq_fill, self._seq_fill + n)
        xyz = np.asarray(points_xyz[:n], np.float32)[:, :3]
        if qs:
            # 3 x u16 link quantization (error <= qs/2, span +-32768*qs)
            q = xyz / qs + 32768.0
            np.clip(np.rint(q), 0, 65535, out=q)
            pkt.seq_points_q[sl] = q.astype(np.uint16)
        else:
            pkt.seq_points[sl, :3] = xyz
            pkt.seq_points[sl, 3] = 1.0
        i = self._num_seqs
        pkt.seq_sec[i], pkt.seq_nsec[i], pkt.seq_count[i] = sec, nsec, n
        pkt.seq_tf[i] = np.asarray(tf_move, np.float32)
        self._num_seqs += 1
        self._seq_fill += n

    # --- the frame step ---
    def _finish_packet(self, now_seconds, tf_world_move, tf_crop_move):
        """Write the frame's header into the staged packet; returns the
        packet's words (a view of the host buffer)."""
        now_ns = timeutil.from_seconds(now_seconds)
        now_sec, now_nsec = timeutil.decode(now_ns)
        min_ns = now_ns - timeutil.from_seconds(
            self.cfg.point_sequence_aggregation_timespan)
        min_sec, min_nsec = timeutil.decode(max(min_ns, 0))
        eye = np.eye(4, dtype=np.float32)
        pkt = self._pkt
        for slot, filled in enumerate(self._depth_filled):
            if not filled:
                pkt.depth[slot] = 0
        pkt.tf_world_move[:] = eye if tf_world_move is None else tf_world_move
        pkt.tf_crop_move[:] = eye if tf_crop_move is None else tf_crop_move
        pkt.set_scalars(0, now_sec, now_nsec, min_sec, min_nsec,
                        self._seq_fill, self._num_seqs, self.fp_threshold,
                        self.fp_max_distance, self.ps_threshold)
        return pkt.view(None)

    def upload(self, now_seconds: float,
               tf_world_move: Optional[np.ndarray] = None,
               tf_crop_move: Optional[np.ndarray] = None) -> FrameInputs:
        """Finish staging the frame, copy its packet to the device (one
        asynchronous copy from pinned memory) and return the unpacked
        :class:`FrameInputs`; the staging area is cleared for the next
        frame."""
        n = len(self._finish_packet(now_seconds, tf_world_move,
                                    tf_crop_move))
        packet = self._pkt.tensor[:n].to(self.device, non_blocking=True,
                                         copy=True)
        if self.device.type == "cuda":
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(self.device))
            self._copied[self._pkt_flip] = event
        self.clear()
        return unpack_packet(packet, self.layout, None)

    def step(self, inp: FrameInputs) -> FrameOutputs:
        """Run the frame step on uploaded inputs and advance the state."""
        self.state, out = fusion_step(
            self.state, inp, cfg=self.cfg, grid=self.grid,
            output_capacity=self.output_capacity)
        return out

    def process(self, now_seconds: float,
                tf_world_move: Optional[np.ndarray] = None,
                tf_crop_move: Optional[np.ndarray] = None) -> FrameOutputs:
        """Run the staged frame: :meth:`upload` then :meth:`step`. Returns
        device-resident outputs without waiting for the device."""
        return self.step(self.upload(now_seconds, tf_world_move,
                                     tf_crop_move))
