"""Multi-rank fusion engine: the host orchestrator over the sharded step
(the JAX package's ``parallel/engine.py``).

The ingest API of :class:`pipeline.engine.FusionEngine`, with the frame
step run by every rank of a ``(stream, space)`` mesh (:mod:`.mesh`,
:mod:`.sharded`). As in the JAX package's multi-process path, every rank
stages and encodes the whole frame on its host and copies only its own
shard (its cameras' rows) to its device. Outputs stay sharded; the host
views assemble them, and are collective: every rank calls them, and each
gets the same array.
"""

from __future__ import annotations

import concurrent.futures
from typing import Optional

import numpy as np
import torch

from ros_gpu_depthmap_fusion_tpu_torch.core import timeutil
from ros_gpu_depthmap_fusion_tpu_torch.core.config import FusionConfig
from ros_gpu_depthmap_fusion_tpu_torch.core.grid import VoxelGrid
from ros_gpu_depthmap_fusion_tpu_torch.mapping.pipeline import (
    MappingPipeline, MappingResult)
from ros_gpu_depthmap_fusion_tpu_torch.ops.depth_codec import (
    B_BUCKETS, EncodedDepth)
from ros_gpu_depthmap_fusion_tpu_torch.parallel.mesh import (
    SPACE_AXIS, STREAM_AXIS, Mesh, all_gather, gather_rows)
from ros_gpu_depthmap_fusion_tpu_torch.parallel.sharded import (
    ShardedFrameOutputs, build_sharded_fusion_step, check_sharded_supported,
    padded_num_cells, shard_inputs, sharded_initial_state)
from ros_gpu_depthmap_fusion_tpu_torch.pipeline.engine import (
    FrameInputs, FusionEngine, SequenceBatch)
from ros_gpu_depthmap_fusion_tpu_torch.utils import native


class ShardedFusionEngine(FusionEngine):
    """FusionEngine whose frame step is this rank's part of the sharded
    step. Construct it on every rank of ``mesh``, feed every rank the same
    frames, and call :meth:`process` and the host views on every rank.

    The depth link is the single engine's: the native ``"dpcm"`` encoder
    (raising without the native library) or raw depth; ``"dpcm_temporal"``
    and heterogeneous rigs raise ``ValueError``. Filter scalars change live
    through the inherited :meth:`set_runtime_filters`. With
    ``pipeline_depth=1`` frame k's copy of this rank's shard runs on a
    worker thread (and a side CUDA stream, ordered by an event) while step
    k-1 runs: :meth:`process` returns frame k-1's outputs (``None`` on the
    first call) and :meth:`flush` the last frame's. ``enable_mapping``
    builds :attr:`mapping` for :meth:`segment_and_track`.
    """

    def __init__(self, cfg: FusionConfig, mesh: Mesh,
                 grid: Optional[VoxelGrid] = None,
                 pipeline_depth: int = 0,
                 enable_mapping: bool = False):
        self.n_stream = mesh.shape[STREAM_AXIS]
        self.n_space = mesh.shape[SPACE_AXIS]
        check_sharded_supported(cfg, self.n_stream)
        if pipeline_depth not in (0, 1):
            raise ValueError(f"pipeline_depth is 0 or 1, got "
                             f"{pipeline_depth!r}")
        if cfg.depth_link_codec == "dpcm":
            native.require()
        self.mesh = mesh
        self.cfg = cfg
        self.device = mesh.device
        self.grid = grid or VoxelGrid.from_config(cfg)
        self.state = sharded_initial_state(cfg, self.grid, mesh)
        # one step per depth-link variant (None = raw; else the DPCM width)
        self._steps = {}
        self.enable_mapping = enable_mapping
        self.mapping = (MappingPipeline(cfg, self.grid, self.device)
                        if enable_mapping else None)
        self._stage_cap = cfg.max_points_per_sequence
        self._seq_stage_cap = max(1, cfg.num_point_sequences * 4)
        self._last_bits = -1
        self.last_frame_bits = None
        self.fp_threshold = cfg.flyingpixels_filter_threshold
        self.fp_max_distance = cfg.flyingpixels_max_distance
        self.ps_threshold = cfg.point_sequence_filter_threshold
        self.pipeline_depth = pipeline_depth
        self._pending = None
        self._worker = self._copy_stream = None
        if pipeline_depth:
            self._worker = concurrent.futures.ThreadPoolExecutor(
                1, thread_name_prefix="sharded-xfer")
            if self.device.type == "cuda":
                self._copy_stream = torch.cuda.Stream(self.device)
        c, h, w = cfg.num_depth_streams, cfg.depth_height, cfg.depth_width
        self._depth_np = np.zeros((c, h, w), np.uint16)
        self._seq_points = np.zeros((self._stage_cap, 4), np.float32)
        self._seq_idx = np.zeros((self._stage_cap,), np.int32)
        self.clear()

    def _step_for(self, bits):
        if bits not in self._steps:
            self._steps[bits] = build_sharded_fusion_step(
                self.cfg, self.grid, self.mesh, depth_bits=bits)
        return self._steps[bits]

    # --- ingestion: whole frames staged on every rank's host ---
    def clear(self):
        """Drop the staged inputs (the rollbuffer is kept)."""
        c = self.cfg.num_depth_streams
        self._depth_np.fill(0)
        self._intr = np.zeros((c, 4), np.float32)
        self._tf_world = np.tile(np.eye(4, dtype=np.float32), (c, 1, 1))
        self._tf_crop = np.tile(np.eye(4, dtype=np.float32), (c, 1, 1))
        self._seq_meta = []          # (sec, nsec, count, tf_move)
        self._seq_fill = 0

    def add_depthmap(self, slot: int, depth_u16: np.ndarray,
                     intrinsics, tf_world: np.ndarray,
                     tf_crop: np.ndarray):
        self._depth_np[slot] = depth_u16
        self._intr[slot] = np.asarray(
            intrinsics.as_array() if hasattr(intrinsics, "as_array")
            else intrinsics, np.float32)
        self._tf_world[slot] = tf_world
        self._tf_crop[slot] = tf_crop

    def add_point_sequence(self, points_xyz: np.ndarray, sec: int, nsec: int,
                           tf_move: np.ndarray):
        """Stage one lidar packet as float32 points (points past the
        staging capacity are dropped)."""
        n = min(len(points_xyz), self._stage_cap - self._seq_fill)
        if n <= 0 or len(self._seq_meta) >= self._seq_stage_cap:
            return
        sl = slice(self._seq_fill, self._seq_fill + n)
        native.stage_points_xyz(np.asarray(points_xyz[:n], np.float32),
                                self._seq_points[sl])
        self._seq_idx[sl] = len(self._seq_meta)
        self._seq_meta.append((sec, nsec, n, np.asarray(tf_move, np.float32)))
        self._seq_fill += n

    def _seq_batch(self) -> SequenceBatch:
        s_cap = self._seq_stage_cap
        sec = np.zeros(s_cap, np.int32)
        nsec = np.zeros(s_cap, np.int32)
        cnt = np.zeros(s_cap, np.int32)
        tfs = np.tile(np.eye(4, dtype=np.float32), (s_cap, 1, 1))
        for i, (s, ns, n, tf) in enumerate(self._seq_meta):
            sec[i], nsec[i], cnt[i] = s, ns, n
            tfs[i] = tf
        return SequenceBatch(
            points=self._seq_points.copy(), seq_idx=self._seq_idx.copy(),
            seq_sec=sec, seq_nsec=nsec, seq_count=cnt, seq_tf_move=tfs,
            num_points=np.int32(self._seq_fill),
            num_seqs=np.int32(len(self._seq_meta)))

    def _encode_depth(self):
        """The staged depth block through the native DPCM encoder (the
        single engine's codec and width buckets, guessing the last width).
        Returns (an :class:`EncodedDepth` of numpy arrays, bits), or (a
        copy of the raw depth, None) on the raw link or when every width
        overflows the exception budget."""
        if self.cfg.depth_link_codec != "dpcm":
            return self._depth_np.copy(), None
        enc = native.depth_encode(
            self._depth_np, self.cfg.depth_codec_max_exceptions,
            allowed_bits=B_BUCKETS, guess_bits=self._last_bits,
            quant_shift=self.cfg.depth_codec_quant_shift)
        if enc is None:
            return self._depth_np.copy(), None
        d, bits = enc
        self._last_bits = bits
        return EncodedDepth(
            words=d["words"], row_first=d["row_first"],
            exc_idx=d["exc_idx"], exc_zz=d["exc_zz"],
            exc_count=np.int32(d["exc_count"])), bits

    def _host_inputs(self, now_seconds, tf_world_move, tf_crop_move):
        """The frame's full host :class:`FrameInputs` (fresh arrays: the
        staging buffers are free to restage) and its depth bits."""
        now_ns = timeutil.from_seconds(now_seconds)
        now_sec, now_nsec = timeutil.decode(now_ns)
        min_ns = now_ns - timeutil.from_seconds(
            self.cfg.point_sequence_aggregation_timespan)
        min_sec, min_nsec = timeutil.decode(max(min_ns, 0))
        eye = np.eye(4, dtype=np.float32)
        depth, bits = self._encode_depth()
        return FrameInputs(
            depth=depth, intrinsics=self._intr, tf_world=self._tf_world,
            tf_crop=self._tf_crop, seq_batch=self._seq_batch(),
            tf_world_move=np.array(
                eye if tf_world_move is None else tf_world_move, np.float32),
            tf_crop_move=np.array(
                eye if tf_crop_move is None else tf_crop_move, np.float32),
            now_sec=np.int32(now_sec), now_nsec=np.int32(now_nsec),
            roll_min_sec=np.int32(min_sec), roll_min_nsec=np.int32(min_nsec),
            fp_threshold=np.float32(self.fp_threshold),
            fp_max_distance=np.float32(self.fp_max_distance),
            ps_threshold=np.float32(self.ps_threshold)), bits

    def _put(self, inp: FrameInputs, bits):
        """This rank's shard on its device: on the side stream when
        pipelined (returns the event the step waits on), else on the
        current stream."""
        if self._copy_stream is None:
            return shard_inputs(inp, self.mesh, bits), None
        with torch.cuda.stream(self._copy_stream):
            dev_inp = shard_inputs(inp, self.mesh, bits)
            event = torch.cuda.Event()
            event.record(self._copy_stream)
        return dev_inp, event

    def _run(self, dev_inp, event, bits) -> ShardedFrameOutputs:
        if event is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(event)
            # allocated on the copy stream: keep the memory from reuse
            # until the step's work on this stream is done
            for t in _leaves(dev_inp):
                t.record_stream(stream)
        self.last_frame_bits = bits
        self.state, out = self._step_for(bits)(self.state, dev_inp)
        return out

    def process(self, now_seconds: float,
                tf_world_move: Optional[np.ndarray] = None,
                tf_crop_move: Optional[np.ndarray] = None
                ) -> Optional[ShardedFrameOutputs]:
        """Run the staged frame on every rank: this frame's outputs, or
        with ``pipeline_depth=1`` the previous frame's (``None`` on the
        first call). Outputs stay on the device, sharded."""
        inp, bits = self._host_inputs(now_seconds, tf_world_move,
                                      tf_crop_move)
        self.clear()
        if not self.pipeline_depth:
            return self._run(*self._put(inp, bits), bits)
        prev = self._pending
        self._pending = (self._worker.submit(self._put, inp, bits), bits)
        if prev is None:
            return None
        return self._run(*prev[0].result(), prev[1])

    def flush(self) -> Optional[ShardedFrameOutputs]:
        """Run the frame in flight (pipelined mode), or ``None``."""
        if self._pending is None:
            return None
        (fut, bits), self._pending = self._pending, None
        return self._run(*fut.result(), bits)

    # --- host views of the sharded outputs (collective) ---
    def raw_points_host(self, out: ShardedFrameOutputs) -> np.ndarray:
        """The raw cloud ``[N, 4]``: each stream row's compacted points
        (from its space-0 rank), by stream."""
        rows = gather_rows(out.raw_points, out.raw_counts, self.mesh)
        return np.concatenate([rows[self.mesh.rank_of(t, 0)]
                               for t in range(self.n_stream)])

    def fused_points_host(self, out: ShardedFrameOutputs) -> np.ndarray:
        """The fused points ``[N, 4]``: in average mode the (space, stream)
        sub-blocks space-major, stream-minor; in occupied mode the space
        blocks (from stream row 0)."""
        rows = gather_rows(out.fused_points, out.fused_counts, self.mesh)
        streams = range(self.n_stream) if self.cfg.voxel_enable_average \
            else (0,)
        return np.concatenate([rows[self.mesh.rank_of(t, j)]
                               for j in range(self.n_space)
                               for t in streams])

    def _blocks(self, t: torch.Tensor) -> np.ndarray:
        """A per-space-block output's blocks in space order (from stream
        row 0), concatenated."""
        g = all_gather(t, self.mesh).cpu().numpy()
        return np.concatenate([g[self.mesh.rank_of(0, j)]
                               for j in range(self.n_space)])

    def occupancy_host(self, out: ShardedFrameOutputs) -> np.ndarray:
        """The ``[num_cells]`` u8 historic occupancy."""
        return self._blocks(out.occupancy_u8)[: self.grid.num_cells]

    def occupancy_grid_from_bits(self, out: ShardedFrameOutputs
                                 ) -> np.ndarray:
        """The binarized ``[Z, Y, X]`` occupancy from the per-block packed
        bitmaps (each block padded to a byte)."""
        block = (padded_num_cells(self.grid, self.n_space, self.n_stream)
                 // self.n_space)
        packed = self._blocks(out.occupancy_bits).reshape(self.n_space, -1)
        occ = np.concatenate([np.unpackbits(p, bitorder="little",
                                            count=block) for p in packed])
        return occ[: self.grid.num_cells].reshape(self.grid.shape_zyx)

    def segment_and_track(self, out: ShardedFrameOutputs,
                          dt: float | None = None) -> MappingResult:
        """Segmentation and tracking over the block-partitioned occupancy
        (collective): the packed per-block bitmaps gathered, the grid
        assembled on every rank's host and segmented by the native host
        backend, so every rank holds the same tracks."""
        if self.mapping is None:
            raise RuntimeError("engine constructed with enable_mapping=False")
        return self.mapping.process_host_grid(
            self.occupancy_grid_from_bits(out), dt)

    def close(self):
        """Stop the pipelined engine's worker thread."""
        if self._worker is not None:
            self._worker.shutdown(wait=True)


def _leaves(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, tuple):
        for y in x:
            yield from _leaves(y)
