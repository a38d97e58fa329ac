"""Host spans the harness records around its calls into the port.

A span is a named interval on one thread. Each thread keeps a stack, so
a span's self time leaves out the spans nested in it; totals are kept
per name. While a profiler runs, every span is also a
``torch.profiler.record_function`` range of the same name, so that the
trace can attribute device activity and host gaps to it.
"""

from __future__ import annotations

import functools
import threading
import time
from contextlib import nullcontext


class Spans:
    def __init__(self):
        self.on = False
        self.profiling = False
        self.self_s: dict = {}
        self.calls: dict = {}
        self._local = threading.local()
        self._lock = threading.Lock()

    def span(self, name: str):
        return _Span(self, name)

    def wrap(self, obj, attr: str, name: str):
        """Replace ``obj.attr`` (a bound method or function attribute)
        with a wrapper that records it as span ``name``."""
        fn = getattr(obj, attr)

        @functools.wraps(fn)
        def wrapped(*a, **k):
            with self.span(name):
                return fn(*a, **k)
        setattr(obj, attr, wrapped)


class _Span:
    __slots__ = ("spans", "name", "t0", "child", "rf")

    def __init__(self, spans: Spans, name: str):
        self.spans, self.name = spans, name

    def __enter__(self):
        sp = self.spans
        if sp.profiling:
            import torch
            self.rf = torch.profiler.record_function(self.name)
        else:
            self.rf = nullcontext()
        self.rf.__enter__()
        stack = getattr(sp._local, "stack", None)
        if stack is None:
            stack = sp._local.stack = []
        stack.append(self)
        self.child = 0.0
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self.t0
        sp = self.spans
        stack = sp._local.stack
        stack.pop()
        if stack:
            stack[-1].child += dt
        if sp.on:
            with sp._lock:
                sp.self_s[self.name] = (sp.self_s.get(self.name, 0.0)
                                        + dt - self.child)
                sp.calls[self.name] = sp.calls.get(self.name, 0) + 1
        self.rf.__exit__(*exc)
        return False
