"""Reading a ``torch.profiler`` capture of the traced stretch.

The capture is exported as a Chrome trace (a file under the temporary
directory, deleted once read). Device activities are the kernels,
copies and fills on the card's timeline. Each is attributed, through its
correlation id, to the host call that launched it, and from there to the
innermost harness span (:mod:`pb.spans`) open on that thread at the time.
The traced window runs from the first ``portbench.frame`` range's start
to the last one's end.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
from dataclasses import dataclass, field

from pb.drive import FRAME

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CALL_CATS = ("cuda_runtime", "cuda_driver")


@dataclass
class Trace:
    window_s: float = 0.0
    busy_s: float = 0.0
    frames: int = 0
    # (name, start s, dur s, span label or None)
    device: list = field(default_factory=list)
    # (label, seconds) of idle gaps, longest first
    gaps: list = field(default_factory=list)

    def device_by_label(self, prefix: str):
        return [e for e in self.device
                if e[3] is not None and e[3].startswith(prefix)]


def capture(run_frames, frames: int, spans) -> Trace:
    """Profile ``run_frames(frames)`` and read the capture."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fd, path = tempfile.mkstemp(suffix=".json", prefix="portbench_trace_")
    os.close(fd)
    try:
        spans.profiling = True
        try:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                run_frames(frames)
                torch.cuda.synchronize()
        finally:
            spans.profiling = False
        prof.export_chrome_trace(path)
        with open(path) as fh:
            events = json.load(fh)
    finally:
        os.unlink(path)
    if isinstance(events, dict):
        events = events.get("traceEvents", [])
    return parse(events)


def _innermost(ranges, t):
    """The innermost of properly nested ``ranges`` ``[(start, end,
    name)]`` sorted by start that holds ``t``, or None."""
    i = bisect.bisect_right(ranges, (t, float("inf"), "")) - 1
    while i >= 0:
        _, end, name = ranges[i]
        if end >= t:
            # any range that also holds t starts earlier and encloses it
            return name
        i -= 1
    return None


def parse(events) -> Trace:
    """A :class:`Trace` from Chrome-trace events."""
    ranges, calls, device = {}, {}, []
    frames = []
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat = str(ev.get("cat", "")).lower()
        ts, dur = float(ev.get("ts", 0.0)), float(ev.get("dur", 0.0))
        args = ev.get("args") or {}
        if cat == "user_annotation":
            key = (ev.get("pid"), ev.get("tid"))
            ranges.setdefault(key, []).append((ts, ts + dur, ev["name"]))
            if ev["name"] == FRAME:
                frames.append((ts, ts + dur, key))
        elif cat in HOST_CALL_CATS and "correlation" in args:
            calls[args["correlation"]] = (ts, (ev.get("pid"),
                                               ev.get("tid")))
        elif cat in DEVICE_CATS:
            device.append((ev.get("name", ""), ts, dur,
                           args.get("correlation")))
    tr = Trace()
    if not frames:
        return tr
    for key in ranges:
        ranges[key].sort()
    w0 = min(s for s, _, _ in frames)
    w1 = max(e for _, e, _ in frames)
    main = frames[0][2]
    tr.frames = len(frames)
    tr.window_s = (w1 - w0) * 1e-6
    spans = []
    for name, ts, dur, corr in device:
        if ts + dur < w0 or ts > w1:
            continue
        label = None
        call = calls.get(corr)
        if call is not None:
            inner = ranges.get(call[1])
            if inner:
                label = _innermost(inner, call[0])
        tr.device.append((name, ts * 1e-6, dur * 1e-6, label))
        spans.append((max(ts, w0), min(ts + dur, w1)))
    spans.sort()
    busy, gaps, cursor = 0.0, [], w0
    for s, e in spans:
        if s > cursor:
            gaps.append((cursor, s))
        if e > cursor:
            busy += e - max(s, cursor)
            cursor = e
    if w1 > cursor:
        gaps.append((cursor, w1))
    tr.busy_s = busy * 1e-6
    main_ranges = [r for r in ranges.get(main, []) if r[2] != FRAME]
    gaps.sort(key=lambda g: g[0] - g[1])
    for s, e in gaps[:10]:
        label = _innermost(main_ranges, 0.5 * (s + e)) or "harness"
        tr.gaps.append((label, (e - s) * 1e-6))
    return tr


@dataclass
class Reading:
    """What a per-layer reader reads: the traced stretch, the host spans
    of the window before it (``span_frames`` frames), and the bound
    seconds of each recorded kernel call by kernel."""
    trace: Trace
    spans: object
    span_frames: int
    bounds: dict

    def span_ms(self, *names) -> float | None:
        """Self ms a frame of the named spans, or None if none ran."""
        if not any(n in self.spans.calls for n in names) \
                or not self.span_frames:
            return None
        return sum(self.spans.self_s.get(n, 0.0) for n in names) \
            * 1e3 / self.span_frames

    def roofline_pct(self, kernel: str) -> float | None:
        """The share of its roofline a kernel reached over the stretch:
        its calls' bound seconds over their device seconds."""
        dev = sum(e[2] for e in self.trace.device_by_label(
            "kernel." + kernel))
        bound = sum(self.bounds.get(kernel, []))
        if dev <= 0 or bound <= 0:
            return None
        return 100.0 * bound / dev


def breakdown(tr: Trace) -> dict:
    """The ten device operations that took most time, and the ten longest
    idle gaps by what the main thread was doing."""
    by_name = {}
    for name, _, dur, _ in tr.device:
        by_name[name] = by_name.get(name, 0.0) + dur
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[n[:160], s] for n, s in ops],
            "idle_gaps": [[n, s] for n, s in tr.gaps]}
