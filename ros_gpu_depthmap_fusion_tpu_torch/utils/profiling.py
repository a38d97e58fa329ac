"""Profiling: the port's one tracer, the device sync, and a profiler capture.

The tracer is process-wide and off by default. Switched on
(:func:`enable`), it keeps:

- **spans** (:func:`span`): named host intervals where the port does its
  work, each on its thread's stack, so a span's self time leaves out the
  spans nested in it on that thread. A span carries the id of the host
  frame it serves (the engine's staging counter, inherited from the
  enclosing span when not given), so the worker thread's encode of frame
  k and the main thread's wait for it share an id. Totals per name, and
  per frame for the last :data:`FRAMES_KEPT` frames;
- **counters** (:func:`count`) and **gauges** (:func:`gauge`): integers per
  name, taken only from values the host already holds (never from a
  device tensor, which would wait for the device).

While a ``torch.profiler`` capture runs, each span is also a
``torch.profiler.record_function`` range of the same name (its args
``frame=<id>``), so the port's spans sit in the device trace on the
profiler's own clock. Every span and counter name starts with
``fusion.``.

Off, a span is one check of the module's switch that returns a shared
no-op context manager, and a counter one early return: no clock, no lock,
no profiler range.

:func:`snapshot` returns what the tracer holds, :func:`reset` clears it,
and :func:`report` is the per-frame printout that
``FusionComponent`` writes when ``cfg.enable_debug_output`` is set (the
reference's timing printout, ``_component.cpp:466-515``).

:func:`hard_sync` waits for a device's queued work; :func:`trace` captures
a ``torch.profiler`` Chrome trace.
"""

from __future__ import annotations

import collections
import contextlib
import os
import threading
import time

import torch

# per-frame span totals kept for this many of the latest frames
FRAMES_KEPT = 64

_on = False


class _Tracer:
    def __init__(self):
        self.lock = threading.Lock()
        self.local = threading.local()
        self.reset()

    def reset(self):
        with self.lock:
            self.self_s = {}
            self.calls = {}
            self.by_frame = collections.OrderedDict()
            self.counters = {}

    def stack(self) -> list:
        st = getattr(self.local, "stack", None)
        if st is None:
            st = self.local.stack = []
        return st


_TRACER = _Tracer()


class _Noop:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP = _Noop()


class _Span:
    __slots__ = ("name", "frame", "t0", "child", "rf")

    def __init__(self, name: str, frame):
        self.name, self.frame = name, frame

    def __enter__(self):
        st = _TRACER.stack()
        if self.frame is None and st:
            self.frame = st[-1].frame
        self.rf = None
        if torch.autograd.profiler._is_profiler_enabled:
            self.rf = torch.profiler.record_function(
                self.name, None if self.frame is None
                else f"frame={self.frame}")
            self.rf.__enter__()
        st.append(self)
        self.child = 0.0
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self.t0
        st = _TRACER.stack()
        st.pop()
        if st:
            st[-1].child += dt
        own = dt - self.child
        tr = _TRACER
        with tr.lock:
            tr.self_s[self.name] = tr.self_s.get(self.name, 0.0) + own
            tr.calls[self.name] = tr.calls.get(self.name, 0) + 1
            if self.frame is not None:
                per = tr.by_frame.get(self.frame)
                if per is None:
                    per = tr.by_frame[self.frame] = {}
                    if len(tr.by_frame) > FRAMES_KEPT:
                        tr.by_frame.popitem(last=False)
                s, n = per.get(self.name, (0.0, 0))
                per[self.name] = (s + own, n + 1)
        if self.rf is not None:
            self.rf.__exit__(*exc)
        return False


def enable(on: bool = True) -> None:
    """Switch the tracer on (or off). What it holds is kept either way."""
    global _on
    _on = bool(on)


def enabled() -> bool:
    return _on


def span(name: str, frame=None):
    """A context manager that records the body as span ``name`` of host
    frame ``frame`` (the enclosing span's when None); a shared no-op when
    the tracer is off."""
    if not _on:
        return _NOOP
    return _Span(name, frame)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` (a host integer) to counter ``name``."""
    if not _on:
        return
    with _TRACER.lock:
        _TRACER.counters[name] = _TRACER.counters.get(name, 0) + int(n)


def gauge(name: str, value: int) -> None:
    """Set gauge ``name`` (a host integer) to ``value``."""
    if not _on:
        return
    with _TRACER.lock:
        _TRACER.counters[name] = int(value)


def snapshot() -> dict:
    """``{"spans": {name: (self seconds, calls)}, "counters": {name:
    value}}``: every span's totals, every counter and gauge."""
    tr = _TRACER
    with tr.lock:
        return {"spans": {k: (tr.self_s[k], tr.calls[k]) for k in tr.self_s},
                "counters": dict(tr.counters)}


def frame_spans(frame) -> dict:
    """``{name: (self seconds, calls)}`` of the spans that served host
    frame ``frame`` (empty once it is older than the last
    :data:`FRAMES_KEPT` frames)."""
    with _TRACER.lock:
        return dict(_TRACER.by_frame.get(frame, {}))


def reset() -> None:
    """Drop every span total, counter and gauge."""
    _TRACER.reset()


def report(frame) -> str:
    """The per-frame printout: host ms and calls of each span that served
    ``frame`` and their sum, then every counter's total and every gauge."""
    spans = frame_spans(frame)
    counters = snapshot()["counters"]
    lines = [f"fusion frame {frame}: host ms (calls)"]
    for name, (s, n) in spans.items():
        lines.append(f"  {name:32s} {s * 1e3:9.3f} ({n})")
    lines.append(f"  {'total':32s} "
                 f"{sum(s for s, _ in spans.values()) * 1e3:9.3f}")
    lines.append("  totals since reset:")
    for name in sorted(counters):
        lines.append(f"  {name:32s} {counters[name]}")
    return "\n".join(lines)


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


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a ``torch.profiler`` trace (host and CUDA activity) of the
    body and write it to ``log_dir/trace.json`` (Chrome trace format,
    viewable in Perfetto). With the tracer on, the port's spans are
    ranges in it.

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
