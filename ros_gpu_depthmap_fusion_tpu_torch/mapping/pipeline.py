"""Mapping pipeline: occupancy grid -> segmented objects -> tracks (the JAX
package's ``mapping/pipeline.py`` on torch tensors).

Segments the fused step's occupancy (native host segmentation, or
:mod:`.segmentation` on the engine's device), then assembles objects and
tracks them on the host, mirroring the reference's objectSegmentation() +
objectTracking() tail (``gpu_depthmap_fusion.cpp:2552-2944``).

Differences from the JAX module: the host backend raises when the native
library is missing (JAX falls back to the device program); a sparse
occupancy that overflowed its capacity without a dense fallback raises
``ValueError`` (JAX: a bare ``assert``); the worker re-raises an exception
of its thread from :meth:`AsyncMappingWorker.latest`, ``submit`` and
``close`` (JAX's thread dies silently); labels stay int32 on the
device and are narrowed to u16 on the host copy; the device backend
groups the foreground on the device, so that the host assembles the
objects from the foreground rows rather than from passes over every cell
(the same objects); the device backend unpacks a packed bitmap on its
device (a host bitmap is uploaded packed), and a submission on the CUDA
device a device-backend pipeline runs on stays there (:class:`OnDevice`:
no host copy of the grid); ``submit(..., block=True)`` waits for the
worker's slot instead of replacing the waiting grid; and
:class:`MappingResult` carries the ``dt`` its tracking stepped with.

Traced (:mod:`..utils.profiling`, on whichever thread runs the cycle):
span ``fusion.mapping`` is one cycle, with ``.segment`` (the device or
host segmentation), ``.fetch`` (the results', bitmap's or sparse blocks'
copy to the host), ``.objects`` and ``.track`` inside it; counters
``fusion.mapping.cycles``, ``.segment_kernel_cycles`` (device
segmentations that ran the CUDA chain, counted by
:func:`.segmentation.segment`), ``.cc_iterations`` and
``.merge_iterations`` (the plain twin's two fixpoint loops, each iteration
of which the host waits for: only a CPU device fills them, the CUDA chain
adds 0), ``.objects`` (merged objects, the background not counted),
``.labels_dropped`` (layers whose labels reached
``cc_max_labels_per_layer``: the last may hold several components) and
``.objects_dropped`` (merged objects without statistics of their own,
beyond ``max_objects``), ``.grouped_cycles`` (cycles whose objects were
built from the device backend's foreground grouping) and
``.foreground_cells`` (the rows of those groupings); gauge
``fusion.mapping.tracks`` (live tracks). Span ``fusion.mapping.unpack``:
the device backend's unpacking of a packed bitmap on its device (on a
CUDA device, its enqueue). The worker: span
``fusion.mapping.worker.submit`` (the submitting thread: the hand-off,
and with ``block=True`` the wait for the slot) and
``fusion.mapping.worker.cycle`` (the worker thread: one cycle, the
pipeline's ``fusion.mapping`` inside it); counters
``fusion.mapping.worker.submitted``, ``.replaced`` (waiting submissions
a newer one replaced) and ``.cycles``; gauge
``fusion.mapping.worker.dt_us`` (the latest cycle's tracking dt, us).
"""

from __future__ import annotations

import contextlib
import queue
import threading
import time
from typing import Any, List, NamedTuple, Optional

import numpy as np
import torch

from ros_gpu_depthmap_fusion_tpu_torch.core.config import FusionConfig
from ros_gpu_depthmap_fusion_tpu_torch.core.grid import VoxelGrid
from ros_gpu_depthmap_fusion_tpu_torch.mapping.objects import (
    CCObject, build_objects)
from ros_gpu_depthmap_fusion_tpu_torch.mapping.segmentation import (
    group_foreground, group_rows_used, grouping_arrays, segment)
from ros_gpu_depthmap_fusion_tpu_torch.mapping.tracking import (
    CCObjectTrack, TrackingStats, track_objects)
from ros_gpu_depthmap_fusion_tpu_torch.ops.voxel import (
    occupancy_bitmap, unpack_bitmap)
from ros_gpu_depthmap_fusion_tpu_torch.utils import native, profiling


class MappingResult(NamedTuple):
    objects: List[CCObject]
    tracks: List[CCObjectTrack]
    stats: TrackingStats
    num_merged: int
    #: the dt (seconds) the cycle's tracking stepped with
    dt: Optional[float] = None


def _host(a) -> np.ndarray:
    """numpy view of a host tensor or array; a device tensor is copied
    (and waited for)."""
    if isinstance(a, torch.Tensor):
        return a.cpu().numpy()
    return np.asarray(a)


def _cycle(frame=None):
    """One mapping cycle: counter ``fusion.mapping.cycles``, and span
    ``fusion.mapping`` of host frame ``frame`` to enter."""
    profiling.count("fusion.mapping.cycles")
    return profiling.span("fusion.mapping", frame)


class MappingPipeline:
    """Stateful (tracks persist across frames) mapping pipeline on
    ``device`` (no default: the caller names it, as for the engine).

    Segmentation backends (``cfg.segmentation_backend``):

    - ``"device"``: :func:`.segmentation.segment` and
      :func:`.segmentation.group_foreground` on ``device`` (a CUDA device
      runs them on the pipeline's own stream, after the caller's current
      stream), the results and the grouping's counts copied back in one
      transfer and the grouping's rows in a second; the objects are then
      assembled from the grouping. A packed bitmap is unpacked on
      ``device`` (a host one is uploaded packed; one on the CUDA device,
      or a sparse tuple's dense fallback there, crosses nothing);
    - ``"host"``: the native ``fh_segment_grid`` on the host; only the
      occupancy bitmap crosses to the host. Raises without the native
      library;
    - ``"auto"`` (default): ``"host"`` when the native library loads,
      else ``"device"``.
    """

    def __init__(self, cfg: FusionConfig, grid: VoxelGrid, device):
        self.cfg = cfg
        self.grid = grid
        self.device = torch.device(device)
        self.tracks: List[CCObjectTrack] = []
        backend = cfg.segmentation_backend
        if backend == "auto":
            backend = "host" if native.available() else "device"
        if backend == "host":
            native.require()
        elif backend != "device":
            raise ValueError(f"segmentation_backend={backend!r}: 'auto', "
                             "'host' or 'device'")
        self.backend = backend
        if backend == "device":
            # the objects' host geometry library builds on first use: start
            # it now, beside the engine's first step and its kernels' build
            threading.Thread(target=native.prebuild_grouped,
                             daemon=True).start()
        self._stream = (torch.cuda.Stream(self.device)
                        if self.device.type == "cuda" else None)
        #: (d2h, segment, assemble + track) ms of the latest host-backend
        #: cycle of process_packed / process_sparse
        self.last_phase_ms = None

    def _segment_host(self, occ: np.ndarray) -> dict:
        # no static-shape constraint on the host: stats cover EVERY merged
        # id (the device program clamps ids to max_objects - 1);
        # Z * max_labels bounds the id space
        host_cap = max(self.cfg.max_objects,
                       occ.shape[0] * self.cfg.cc_max_labels_per_layer)
        with profiling.span("fusion.mapping.segment"):
            return native.segment_grid(
                occ, self.cfg.cc_max_labels_per_layer, host_cap)

    @property
    def card_stream(self) -> Optional[torch.cuda.Stream]:
        """The stream the device backend runs on when ``device`` is a CUDA
        device, else None: a submission on that device stays there
        (:class:`AsyncMappingWorker`)."""
        return self._stream if self.backend == "device" else None

    def _on_card(self, a) -> bool:
        return (self.card_stream is not None
                and isinstance(a, torch.Tensor) and a.is_cuda)

    @contextlib.contextmanager
    def _on_stream(self):
        """The pipeline's own CUDA stream, ordered after the caller's
        current stream; nothing on the CPU."""
        if self._stream is None:
            yield
            return
        caller = torch.cuda.current_stream(self.device)
        with torch.cuda.stream(self._stream):
            self._stream.wait_stream(caller)
            yield

    def _segment_device(self, occ: torch.Tensor) -> dict:
        """:func:`segment` and :func:`group_foreground` on ``self.device``
        (inside :meth:`_on_stream`); the results and the grouping's counts
        come back to the host in one copy, the grouping's rows they size in
        a second."""
        with profiling.span("fusion.mapping.segment"):
            seg = segment(occ.to(self.device),
                          max_labels=self.cfg.cc_max_labels_per_layer,
                          max_objects=self.cfg.max_objects)
        groups = group_foreground(seg)
        parts = (seg.labels, seg.num_labels, seg.merged_of_label,
                 seg.num_merged, seg.voxel_count,
                 seg.centroid.view(torch.int32), seg.vmin, seg.vmax,
                 groups.counts)
        with profiling.span("fusion.mapping.fetch"):
            flat = torch.cat([p.reshape(-1)
                              for p in parts]).cpu().numpy()
            out, off = [], 0
            for p in parts:
                out.append(flat[off:off + p.numel()].reshape(p.shape))
                off += p.numel()
            num_merged, z = int(out[3]), seg.labels.shape[0]
            fg, ncomp = out[8].tolist()
            rows = groups.rows[:group_rows_used(fg, ncomp, num_merged, z)]
            if rows.is_cuda:
                rows = torch.empty(rows.shape, dtype=rows.dtype,
                                   pin_memory=True).copy_(
                                       rows, non_blocking=True)
                self._stream.synchronize()
        profiling.count("fusion.mapping.cc_iterations", seg.iterations[0])
        profiling.count("fusion.mapping.merge_iterations",
                        seg.iterations[1])
        return dict(labels=out[0].astype(np.uint16), num_labels=out[1],
                    merged_of_label=out[2], num_merged=num_merged,
                    voxel_count=out[4], centroid=out[5].view(np.float32),
                    vmin=out[6], vmax=out[7],
                    grouping=grouping_arrays(fg, ncomp, num_merged, z,
                                             rows.numpy()))

    def _detail_mask(self, res: dict) -> Optional[np.ndarray]:
        """Detail-pruning mask: objects whose world-xy AABB area is below
        the threshold get stats-only stubs. Sound for the tracking
        consumer: the topview min-area rect is contained in the AABB, so
        its area is <= the AABB area and every pruned object fails the
        ``object_min_area`` gate (cpp:2776-2777) regardless."""
        thr = self.cfg.mapping_detail_min_area
        if thr < 0:
            thr = self.cfg.object_min_area
        if thr <= 0:
            return None
        nm = int(res["num_merged"])
        vmin, vmax = np.asarray(res["vmin"]), np.asarray(res["vmax"])
        n = min(nm, len(vmin))
        cs = np.asarray(self.grid.cell_size, np.float64)
        ext = (vmax[:n] - vmin[:n] + 1).astype(np.float64)
        area = ext[:, 0] * cs[0] * ext[:, 1] * cs[1]
        mask = np.zeros(nm, bool)
        mask[:n] = (area >= thr) & (np.asarray(
            res["voxel_count"])[:n] > 0)
        return mask

    def _unpack(self, packed: np.ndarray) -> np.ndarray:
        z, y, x = self.grid.shape_zyx
        return np.unpackbits(packed, bitorder="little",
                             count=self.grid.num_cells).reshape(z, y, x)

    def fetch_occupancy(self, occupancy_u8: torch.Tensor) -> np.ndarray:
        """The binarized ``[Z, Y, X]`` occupancy on the host: packed 8 cells
        a byte where the occupancy lives, copied, unpacked."""
        bits = occupancy_bitmap(occupancy_u8[:self.grid.num_cells])
        with profiling.span("fusion.mapping.fetch"):
            packed = _host(bits)
        return self._unpack(packed)

    def _host_cycle(self, t0: float, t1: float, occ: np.ndarray,
                    dt, with_contours) -> MappingResult:
        res = self._segment_host(occ)
        t2 = time.perf_counter()
        out = self._finish(res, dt, with_contours)
        t3 = time.perf_counter()
        self.last_phase_ms = ((t1 - t0) * 1e3, (t2 - t1) * 1e3,
                              (t3 - t2) * 1e3)
        return out

    def process_packed(self, occupancy_bits,
                       dt: float | None = None,
                       with_contours: bool = True) -> MappingResult:
        """Mapping step from the fused step's packed bitmap
        (``FrameOutputs.occupancy_bits``, a tensor on any device or a host
        array): the host backend copies it to the host, the device backend
        unpacks it on its device (:meth:`_device_packed`)."""
        with _cycle():
            return self._packed(occupancy_bits, dt, with_contours)

    def _device_packed(self, bits, dt, with_contours) -> MappingResult:
        """The device backend's cycle on a packed bitmap (a tensor on any
        device or a host array): moved to ``self.device`` as it is packed
        (nothing moves when it is there already) and unpacked to the
        ``[Z, Y, X]`` u8 grid there, on the pipeline's stream."""
        with self._on_stream():
            with profiling.span("fusion.mapping.unpack"):
                occ = unpack_bitmap(torch.as_tensor(bits).to(self.device),
                                    self.grid.num_cells).reshape(
                                        self.grid.shape_zyx)
            res = self._segment_device(occ)
        return self._finish(res, dt, with_contours)

    def _packed(self, occupancy_bits, dt, with_contours) -> MappingResult:
        if self.backend == "device":
            return self._device_packed(occupancy_bits, dt, with_contours)
        t0 = time.perf_counter()
        with profiling.span("fusion.mapping.fetch"):
            packed = _host(occupancy_bits)
        t1 = time.perf_counter()
        return self._host_cycle(t0, t1, self._unpack(packed), dt,
                                with_contours)

    def process_sparse(self, sparse,
                       dt: float | None = None,
                       with_contours: bool = True) -> MappingResult:
        """Mapping step from the fused step's sparse occupancy
        (``FrameOutputs.occupancy_sparse_*``): ``sparse`` is ``(block_idx,
        words, count, true_count[, dense_bits_fallback])``, tensors on any
        device or host arrays. Only the sparse blocks cross to the host;
        when the blocks overflowed their capacity (``true_count >
        capacity``) the dense fallback is processed instead, and without
        one this raises ``ValueError``.

        On the device backend with the dense fallback on its CUDA device,
        nothing crosses: the blocks only shrink a copy to the host, and the
        bitmap they were cut from is where the segmentation runs, so the
        fallback is unpacked there whatever the count (the same cells as
        the blocks whenever they did not overflow)."""
        with _cycle():
            if len(sparse) >= 5 and self._on_card(sparse[4]):
                return self._device_packed(sparse[4], dt, with_contours)
            return self._sparse(sparse, dt, with_contours)

    def _sparse(self, sparse, dt, with_contours) -> MappingResult:
        t0 = time.perf_counter()
        with profiling.span("fusion.mapping.fetch"):
            idx, words = _host(sparse[0]), _host(sparse[1])
            cnt = int(_host(sparse[2]))
            true_cnt = int(_host(sparse[3]))
        cap = int(idx.shape[0])
        if true_cnt > cap:
            if len(sparse) < 5 or sparse[4] is None:
                raise ValueError(
                    f"sparse occupancy overflowed its capacity ({true_cnt} "
                    f"> {cap} blocks) and no dense fallback was passed")
            return self._packed(sparse[4], dt, with_contours)
        t1 = time.perf_counter()
        n = self.grid.num_cells
        nbytes = -(-n // 8)
        buf = np.zeros((-(-nbytes // 16), 4), np.uint32)
        buf[idx[:cnt]] = words[:cnt].view(np.uint32)
        packed = buf.view(np.uint8)[:nbytes]
        if self.backend == "device":
            return self._device_packed(packed, dt, with_contours)
        return self._host_cycle(t0, t1, self._unpack(packed), dt,
                                with_contours)

    def process_host_grid(self, occ_zyx: np.ndarray,
                          dt: float | None = None,
                          with_contours: bool = True) -> MappingResult:
        """Mapping step from a host-assembled ``[Z, Y, X]`` binarized
        occupancy (the sharded engine's assembly of its per-block bitmaps,
        :meth:`parallel.engine.ShardedFusionEngine.segment_and_track`):
        the native host segmentation whatever the backend (the device
        backend would copy the grid back to the device). Raises without
        the native library."""
        native.require()
        with _cycle():
            res = self._segment_host(np.ascontiguousarray(occ_zyx,
                                                          np.uint8))
            return self._finish(res, dt, with_contours)

    def process(self, occupancy_u8: torch.Tensor,
                dt: float | None = None,
                with_contours: bool = True, frame=None) -> MappingResult:
        """One mapping step on a flat ``[num_cells]`` (or longer) occupancy
        tensor on any device; ``frame``: the host frame the tracer files
        the cycle's spans under."""
        with _cycle(frame):
            return self._process(occupancy_u8, dt, with_contours)

    def _process(self, occupancy_u8, dt, with_contours) -> MappingResult:
        if self.backend == "host":
            res = self._segment_host(self.fetch_occupancy(occupancy_u8))
        else:
            with self._on_stream():
                res = self._segment_device(
                    occupancy_u8[:self.grid.num_cells].reshape(
                        self.grid.shape_zyx))
        return self._finish(res, dt, with_contours)

    def _finish(self, res: dict, dt: float | None,
                with_contours: bool) -> MappingResult:
        dt = self.cfg.tracking_dt if dt is None else dt
        num_merged = int(res["num_merged"])
        grouping = res.get("grouping")
        with profiling.span("fusion.mapping.objects"):
            objects = build_objects(
                labels=res["labels"], num_labels=res["num_labels"],
                merged_of_label=res["merged_of_label"],
                num_merged=num_merged,
                voxel_count=res["voxel_count"], centroid=res["centroid"],
                vmin=res["vmin"], vmax=res["vmax"], grid=self.grid,
                with_contours=with_contours,
                detail_mask=self._detail_mask(res), grouping=grouping)
        with profiling.span("fusion.mapping.track"):
            stats = track_objects(objects, self.tracks,
                                  self.cfg.object_min_area, dt,
                                  max_tracks=self.cfg.max_tracks)
        if profiling.enabled():
            profiling.count("fusion.mapping.objects", max(num_merged - 1, 0))
            profiling.count("fusion.mapping.labels_dropped", int(
                (np.asarray(res["num_labels"])
                 >= self.cfg.cc_max_labels_per_layer).sum()))
            profiling.count("fusion.mapping.objects_dropped",
                            max(num_merged - len(res["voxel_count"]), 0))
            if grouping is not None and with_contours:
                profiling.count("fusion.mapping.grouped_cycles")
                profiling.count("fusion.mapping.foreground_cells",
                                len(grouping["pts_xy"]))
            profiling.gauge("fusion.mapping.tracks", len(self.tracks))
        return MappingResult(objects=objects, tracks=self.tracks,
                             stats=stats, num_merged=num_merged, dt=dt)


class HostCopy(NamedTuple):
    """A submission whose device tensors were copied to the host
    asynchronously (:func:`prefetch`)."""
    item: Any                  # the submission as given
    host: Any                  # the same with pinned host copies
    ready: Optional[torch.cuda.Event]  # the copies (and the item) complete


def _cuda_device(members) -> Optional[torch.device]:
    return next((a.device for a in members
                 if isinstance(a, torch.Tensor) and a.is_cuda), None)


def prefetch(item) -> HostCopy:
    """Start the device -> host copy of a submission without waiting: a
    packed bitmap, or a sparse tuple (whose dense fallback, the rare
    overflow path, stays on the device). The copies go into pinned host
    tensors on the current stream of the tensors' device, which must be
    the stream the outputs were produced on (the thread that ran the
    fused step), and an event is recorded after them. Host inputs pass
    through."""
    members = list(item) if isinstance(item, tuple) else [item]
    dev = _cuda_device(members)
    if dev is None:
        return HostCopy(item, item, None)
    host = []
    for k, a in enumerate(members):
        if (isinstance(a, torch.Tensor) and a.is_cuda
                and not (isinstance(item, tuple) and k >= 4)):
            h = torch.empty(a.shape, dtype=a.dtype, pin_memory=True)
            h.copy_(a, non_blocking=True)
            a = h
        host.append(a)
    ready = torch.cuda.Event()
    ready.record(torch.cuda.current_stream(dev))
    return HostCopy(item, tuple(host) if isinstance(item, tuple)
                    else host[0], ready)


def _in_place(item) -> HostCopy:
    """A flat occupancy stays where it is; on a CUDA device an event on the
    current stream marks it complete."""
    dev = _cuda_device([item])
    ready = None
    if dev is not None:
        ready = torch.cuda.Event()
        ready.record(torch.cuda.current_stream(dev))
    return HostCopy(item, item, ready)


class OnDevice(NamedTuple):
    """A submission left on the CUDA device a device-backend pipeline runs
    on (:func:`_on_device`): the worker's cycle runs on the pipeline's
    stream after ``ready`` and reads it there."""
    item: Any                  # the submission as given
    ready: torch.cuda.Event    # recorded after it on the submitting stream


def _on_device(item, stream: torch.cuda.Stream) -> OnDevice:
    """Hand a submission on a CUDA device to ``stream`` without a copy: an
    event is recorded on the device's current stream (the one the fused
    step ran on), and each CUDA tensor of it is marked as used on
    ``stream``, so that the caching allocator does not give its memory to
    the submitting stream's later work before ``stream``'s reads of it are
    done."""
    members = list(item) if isinstance(item, tuple) else [item]
    for a in members:
        if isinstance(a, torch.Tensor) and a.is_cuda:
            a.record_stream(stream)
    ready = torch.cuda.Event()
    ready.record(torch.cuda.current_stream(_cuda_device(members)))
    return OnDevice(item, ready)


class AsyncMappingWorker:
    """Runs the mapping cycle on a worker thread over the LATEST submitted
    occupancy while fusion stages the next frames (the reference's resample
    decoupling, ``_component.cpp:74-90``, applied between fusion and
    mapping).

    Queue depth 1 with drop-oldest: when mapping is slower than fusion it
    processes the newest grid; ``submit(..., block=True)`` waits for the
    slot instead, so that every submission is mapped, in order. Each cycle
    passes the MEASURED wall time since the previous cycle into tracking
    (the filters are dt-corrected, filter.h:70-84), clamped to
    ``[tracking_dt, dt_max]``; :attr:`MappingResult.dt` gives it back.

    A submission is a packed bitmap (``packed=True``), a sparse tuple
    (:meth:`MappingPipeline.process_sparse`), a flat occupancy, or a
    :class:`HostCopy` of one made earlier by :func:`prefetch`. On a
    device-backend pipeline on a CUDA device, a submission on that device
    stays there (:func:`_on_device`): the cycle runs with the pipeline's
    stream, made to wait for the submission's event, as the worker
    thread's current stream, and nothing waits on the host.
    Otherwise a sparse tuple or a packed bitmap is prefetched to the host
    and the worker waits for the copy's event before it reads the host
    bytes. An exception in the worker stops it and is raised again from
    :meth:`latest`, :meth:`submit` and :meth:`close`.
    """

    #: upper clamp for the measured inter-cycle dt (seconds)
    dt_max = 2.0
    #: how often a blocked :meth:`submit` looks for the worker's exception
    poll_s = 0.05

    def __init__(self, pipeline: MappingPipeline, packed: bool = False):
        self.pipeline = pipeline
        self.packed = packed
        self._q: "queue.Queue" = queue.Queue(maxsize=1)
        self._latest: Optional[MappingResult] = None
        self._error: Optional[BaseException] = None
        self._lock = threading.Lock()
        self.cycles = 0
        self._stop = False
        self._last_cycle_t: Optional[float] = None
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _raise_error(self):
        if self._error is not None:
            raise self._error

    def _hand_off(self, item):
        if isinstance(item, HostCopy):
            return item
        members = list(item) if isinstance(item, tuple) else [item]
        if _cuda_device(members) is not None:
            stream = self.pipeline.card_stream
            if stream is not None:
                return _on_device(item, stream)
        if isinstance(item, tuple) or self.packed:
            return prefetch(item)
        return _in_place(item)

    def submit(self, occupancy, block: bool = False,
               timeout: Optional[float] = None) -> None:
        """Hand the newest occupancy to the worker. Non-blocking by
        default: it replaces one not yet taken. With ``block=True`` it
        waits for the worker to take the one waiting, raising the worker's
        exception if the worker fails meanwhile and ``TimeoutError`` after
        ``timeout`` seconds (None: no limit). Call it from the thread that
        ran the fused step (see the class docstring for where the
        submission goes)."""
        self._raise_error()
        with profiling.span("fusion.mapping.worker.submit"):
            sub = self._hand_off(occupancy)
            if block:
                self._put_waiting(sub, timeout)
            elif self._put_replacing(sub):
                profiling.count("fusion.mapping.worker.replaced")
            profiling.count("fusion.mapping.worker.submitted")

    def _put_replacing(self, sub) -> bool:
        """Put ``sub``, dropping the waiting one; True when one was
        dropped."""
        try:
            self._q.put_nowait(sub)
            return False
        except queue.Full:
            pass
        try:    # replace the stale grid with the newest
            self._q.get_nowait()
            dropped = True
        except queue.Empty:
            dropped = False
        try:
            self._q.put_nowait(sub)
        except queue.Full:
            pass
        return dropped

    def _put_waiting(self, sub, timeout: Optional[float]) -> None:
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            try:
                self._q.put(sub, timeout=self.poll_s)
                return
            except queue.Full:
                self._raise_error()
                if self._stop or not self._thread.is_alive():
                    raise RuntimeError("the mapping worker was closed")
                if deadline is not None and time.monotonic() >= deadline:
                    raise TimeoutError(
                        f"the mapping worker took no submission in "
                        f"{timeout} s") from None

    def latest(self) -> Optional[MappingResult]:
        self._raise_error()
        with self._lock:
            return self._latest

    def _cycle(self, sub):
        if isinstance(sub, OnDevice):
            # the pipeline's stream, after the step that made the
            # submission and after nothing else the submitting thread has
            # enqueued since, is this thread's current stream: the
            # pipeline orders its work after it
            stream = self.pipeline.card_stream
            stream.wait_event(sub.ready)
            with torch.cuda.stream(stream):
                return self._map(sub.item)
        if sub.ready is not None:
            sub.ready.synchronize()
        return self._map(sub.host)

    def _map(self, occ):
        now = time.monotonic()
        cfg = self.pipeline.cfg
        dt = (cfg.tracking_dt if self._last_cycle_t is None
              else min(max(now - self._last_cycle_t, cfg.tracking_dt),
                       self.dt_max))
        self._last_cycle_t = now
        profiling.gauge("fusion.mapping.worker.dt_us", round(dt * 1e6))
        if isinstance(occ, tuple):
            return self.pipeline.process_sparse(occ, dt=dt)
        if self.packed:
            return self.pipeline.process_packed(occ, dt=dt)
        return self.pipeline.process(occ, dt=dt)

    def _run(self):
        while not self._stop:
            try:
                sub = self._q.get(timeout=0.1)
            except queue.Empty:
                continue
            if sub is None:
                break
            try:
                with profiling.span("fusion.mapping.worker.cycle"):
                    res = self._cycle(sub)
            except Exception as e:  # noqa: BLE001 — surfaced to the caller
                self._error = e
                return
            profiling.count("fusion.mapping.worker.cycles")
            with self._lock:
                self._latest = res
                self.cycles += 1

    def close(self):
        """Stop the worker (after the cycle in progress) and raise its
        exception, if it failed."""
        self._stop = True
        try:
            self._q.put_nowait(None)
        except queue.Full:
            pass
        self._thread.join(timeout=30.0)
        self._raise_error()
