"""Profiling utilities (port of the JAX package's ``utils/profiling.py``).

- :class:`MeasureTime` — section timers with exponentially-weighted-average
  smoothing and per-frame accumulation, mirroring the reference's profiler
  (``measure_time.h:6-133``, EWA gain 0.1 set at gpu_depthmap_fusion.cpp:655).
- :class:`StageTimer` — the per-frame stage-timing schema the reference
  prints when ``enable_debug_output`` is set (``_component.cpp:471-514``):
  a fixed stage list with per-frame microsecond readings, on the host
  clock after :func:`hard_sync` of the stage's device.
- :func:`trace` — a ``torch.profiler`` capture, exported as a Chrome
  trace for Perfetto.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, List, Optional

import torch


def hard_sync(device) -> None:
    """Wait for all work queued on ``device`` (a ``torch.device``, a device
    string or a tensor, whose device is taken): ``torch.cuda.synchronize``
    on a CUDA device, nothing on the CPU, where every op has finished when
    it returns. Timing code must sync before it reads the host clock, or
    it measures the enqueue rate, not the work."""
    if isinstance(device, torch.Tensor):
        device = device.device
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)


# the reference's canonical stage schema (_component.cpp:471-514)
REFERENCE_STAGES = [
    "add", "upload_process_point_sequences", "upload_depth", "convert",
    "flying_pixel", "crop", "mask", "voxel_coords", "download_points",
    "voxelize", "occupancy", "download_grid", "segmentation", "tracking",
    "publish_objects", "publish", "total",
]


class MeasureTime:
    """EWA section profiler (measure_time.h translation), host clock. A
    section that ends in device work must :func:`hard_sync` before
    :meth:`end` to count that work."""

    def __init__(self, gain: float = 0.1):
        self.gain = gain
        self.smoothed: Dict[str, float] = {}
        self.frame_acc: Dict[str, float] = {}
        self._open: Dict[str, float] = {}
        self._frame_start: Optional[float] = None

    def begin_frame(self):
        self._frame_start = time.perf_counter()
        self.frame_acc = {}

    def begin(self, name: str):
        self._open[name] = time.perf_counter()

    def end(self, name: str):
        t = time.perf_counter() - self._open.pop(name)
        self.frame_acc[name] = self.frame_acc.get(name, 0.0) + t

    @contextlib.contextmanager
    def section(self, name: str):
        self.begin(name)
        try:
            yield
        finally:
            self.end(name)

    def end_frame(self):
        if self._frame_start is not None:
            self.frame_acc["__frame__"] = (time.perf_counter()
                                           - self._frame_start)
        for name, t in self.frame_acc.items():
            if name in self.smoothed:
                self.smoothed[name] = (t * self.gain
                                       + (1 - self.gain) * self.smoothed[name])
            else:
                self.smoothed[name] = t

    def report(self) -> str:
        lines = []
        for name, t in sorted(self.smoothed.items()):
            lines.append(f"{name:36s} {t * 1e6:12.1f} us")
        return "\n".join(lines)


class StageTimer:
    """Fixed-schema per-frame stage timing (microseconds)."""

    def __init__(self, stages: Optional[List[str]] = None):
        self.stages = stages or REFERENCE_STAGES
        self.readings: Dict[str, List[float]] = {s: [] for s in self.stages}

    def record(self, stage: str, seconds: float):
        self.readings.setdefault(stage, []).append(seconds)

    @contextlib.contextmanager
    def stage(self, name: str, block=None):
        """Time the body on the host clock; with ``block`` (a device, a
        device string or a tensor) the reading waits for that device's
        queued work first."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if block is not None:
                hard_sync(block)
            self.record(name, time.perf_counter() - t0)

    def summary_us(self) -> Dict[str, float]:
        return {s: (1e6 * sum(v) / len(v)) for s, v in self.readings.items()
                if v}

    def report(self) -> str:
        return "\n".join(f"{s:32s} {us:12.1f} us"
                         for s, us in self.summary_us().items())


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a ``torch.profiler`` trace (host and CUDA activity) of the
    body and write it to ``log_dir/trace.json`` (Chrome trace format,
    viewable in Perfetto).

    Profile after the loops you time, never before them: once
    ``torch.profiler`` has run in a process, that process's later host work
    runs slower (a Python worker thread about 10x on an NVIDIA H100 host;
    ``chip_smoke.py`` keeps its profiler phase last for this reason)."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
