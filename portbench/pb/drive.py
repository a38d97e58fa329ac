"""The general driver: one cell's system under test, fed its traffic.

A traffic mix (``portbench/traffic/<mix>.json``) is data:

- ``entry``: the name of the module ``portbench/entries/<entry>.py``
  that builds the port's entry point and feeds it one frame (see
  :class:`System`); ``engine`` and ``component`` are there;
- ``loop``: ``"closed"`` releases a frame as soon as the previous call
  returned; ``"open"`` releases frame ``f`` at ``f / stamp_hz`` seconds
  after the loop's start (or as soon as the previous call returned, if
  that is later), and its latency counts from that scheduled release;
- ``stamp_hz``: the frames' stamps are ``10 + f / stamp_hz`` s whatever
  the loop's rate, and the lidar packets are stamped alike;
- ``motion``: the scene's motion (:class:`pb.scene.Scene`);
- ``warmup_frames``: frames run in set-up, before the window;
- ``trace_reserve_s``, ``trace_frames``: the traced run's profiled
  stretch (the seconds taken from the window, the frames profiled);
- any key the entry reads itself (``pipeline_depth``).

Publishing a frame (:meth:`System.publish`, the component's
``on_points``, or right after ``process`` returns it) waits for its fused
cloud, copies ``fused_points[:fused_count]`` to host memory and reads
the counts that tell whether rows were dropped. A frame's latency runs
from its release (the first staging call, or its scheduled release in an
open loop) to that copy's end. A frame the seed samples for the
comparison has what the comparison reads copied to host memory there
too, so that nothing the harness keeps stays on the card.
"""

from __future__ import annotations

import collections
import importlib
import inspect
import sys
import time

import numpy as np

PKG = "ros_gpu_depthmap_fusion_tpu_torch"

CALLBACK = "pipeline.component.callback"
TICK = "pipeline.component.tick"
STAGE = "pipeline.engine.stage"
ENCODE = "utils.native.encode"
UPLOAD = "pipeline.engine.upload"
PROCESS = "pipeline.engine.process"
PUBLISH = "harness.publish"
FRAME = "portbench.frame"

EYE = np.eye(4, dtype=np.float32)


def fusion_config(fields: dict):
    """The port's ``FusionConfig`` from the file's ``fusion`` fields
    (lists become tuples)."""
    from ros_gpu_depthmap_fusion_tpu_torch.core.config import FusionConfig

    def tup(v):
        return tuple(tup(x) for x in v) if isinstance(v, list) else v
    return FusionConfig(**{k: tup(v) for k, v in fields.items()})


def wrap_engine(engine, spans) -> None:
    """The harness's spans around a ``FusionEngine``'s entry points."""
    spans.wrap(engine, "add_depthmap", STAGE)
    spans.wrap(engine, "add_point_sequence", STAGE)
    spans.wrap(engine, "_encode", ENCODE)
    spans.wrap(engine, "_encode_and_put", UPLOAD)
    spans.wrap(engine, "process", PROCESS)
    spans.wrap(engine, "flush", PROCESS)


class System:
    """The port built for a cell by its traffic's entry module, with the
    harness's spans around its entry points, fed frame by frame from
    ``scene``.

    An entry module defines ``Entry(system, cfg, traffic, device)`` with
    ``engine`` (the ``FusionEngine`` it drives), ``feed(f)`` (stage and
    run frame ``f``, handing each finished frame's outputs to
    :meth:`publish`, or calling :meth:`complete` where a frame is done
    otherwise) and ``close()``. It may define ``judge(ref, f,
    prog)`` and ``Reference(fields, scene, device)`` where its frames are
    judged otherwise than :mod:`pb.check` and :mod:`reference.fusion`
    judge a fused frame."""

    def __init__(self, cell, scene, device, spans, sample: set):
        from pb import spec
        self.scene, self.spans = scene, spans
        self.sample = sample
        fields = cell.config["fusion"]
        self.cfg = fusion_config(fields)
        tr = cell.traffic
        self.open_loop = tr["loop"] == "open"
        if tr["loop"] not in ("open", "closed"):
            raise ValueError(f"traffic loop {tr['loop']!r}")
        self.period = 1.0 / float(tr["stamp_hz"])
        self.entry_module = spec.entry(tr["entry"])
        self.entry = self.entry_module.Entry(self, self.cfg, tr, device)
        self.engine = self.entry.engine
        self.out_cap = self.engine.output_capacity
        # drops the step reports against a capacity the configuration
        # states; with voxelize_partials_capacity 0 the program resolves
        # the capacity itself, and dropped partials show in the
        # comparison alone
        self.partials_cap = self.cfg.voxelize_partials_capacity
        self.sparse_cap = self.cfg.occupancy_sparse_capacity
        self.next_frame = 0
        self.pending = collections.deque()   # (frame, release time)
        self.done = []       # (frame, release, completion, failed)
        self.kept = {}       # sampled frame -> its outputs, on the host
        self.pace()

    def pace(self, t: float | None = None) -> None:
        """An open loop's schedule restarts: the next frame is released
        at ``t`` (now by default), each later one a stamp period on."""
        self.t_base = time.perf_counter() if t is None else t
        self.f_base = self.next_frame
        self.late_s = 0.0   # the open loop's latest release behind schedule

    def publish(self, out) -> None:
        """Frame ``out``'s fused cloud to host memory; the frame is done."""
        from pb import check
        with self.spans.span(PUBLISH):
            n = int(out.fused_count)
            fused = out.fused_points[:n].cpu()
            partials = int(out.vox_partials_count)
            sparse = int(out.occupancy_sparse_true)
        f = self.complete((self.partials_cap > 0
                           and partials > self.partials_cap)
                          or n >= self.out_cap
                          or (self.sparse_cap > 0
                              and sparse > self.sparse_cap))
        if f in self.sample:
            self.kept[f] = check.program_outputs(out, fused)

    def complete(self, failed: bool) -> int:
        """The oldest frame in flight is done now; returns it."""
        t = time.perf_counter()
        f, released = self.pending.popleft()
        self.done.append((f, released, t, failed))
        return f

    def run(self, frames: int):
        """Release ``frames`` frames, each fed to the entry."""
        for _ in range(frames):
            f = self.next_frame
            release = time.perf_counter()
            if self.open_loop:
                due = self.t_base + (f - self.f_base) * self.period
                if due > release:
                    time.sleep(due - release)
                self.late_s = max(self.late_s, release - due)
                release = due
            self.next_frame += 1
            with self.spans.span(FRAME):
                self.pending.append((f, release))
                self.entry.feed(f)

    def close(self):
        """Run the frame in flight to its end, then stop the entry."""
        self.entry.close()


def patch_kernels(readers, spans, calls: list):
    """Wrap each kernel wrapper that a per-layer reader names (``CALL =
    (module, function)``) wherever the port's modules bound it: each call
    becomes span ``kernel.<KERNEL>`` and is recorded with its arguments
    and outputs. Returns what to restore."""
    patched = []
    for r in readers:
        call = getattr(r, "CALL", None)
        if call is None:
            continue
        mod, attr = call
        orig = getattr(importlib.import_module(mod), attr)
        if any(o is orig for _, _, o in patched):
            continue
        sig = inspect.signature(orig)
        name = r.KERNEL

        def wrapper(*a, _o=orig, _n=name, _s=sig, **k):
            with spans.span("kernel." + _n):
                out = _o(*a, **k)
            b = _s.bind(*a, **k)
            b.apply_defaults()
            calls.append((_n, tuple(b.arguments.values()), out))
            return out
        for m in list(sys.modules.values()):
            if not getattr(m, "__name__", "").startswith(PKG):
                continue
            for key, val in list(vars(m).items()):
                if val is orig:
                    setattr(m, key, wrapper)
                    patched.append((m, key, orig))
    return patched


def unpatch(patched):
    for m, key, orig in patched:
        setattr(m, key, orig)
