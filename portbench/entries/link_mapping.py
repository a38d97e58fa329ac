"""Traffic entry ``link_mapping``: ``FusionEngine(cfg, device,
pipeline_depth, enable_mapping=True).process`` with
``AsyncMappingWorker(engine.mapping, packed=True)``, the tuned link with
mapping on a worker thread one frame behind fusion.

A frame is staged and run as ``engine`` runs it. The outputs ``process``
returns (with ``pipeline_depth=1``, the previous frame's) are published
at once (:meth:`pb.drive.System.publish`: the frame is done when its
fused cloud is in host memory), then their sparse occupancy, with the
dense bitmap as fallback (``bench.py:457-460``), is submitted to the
worker with ``block=True``: every frame is mapped, in order, with at most
one cycle running and one waiting, so the loop cannot outrun the mapping.
The frame in flight at the end is run but neither counted nor mapped;
:meth:`Entry.close` waits for the submitted frames' cycles.

Harness spans: ``mapping.submit`` around ``worker.submit`` (the main
thread: the hand-off and the wait for the worker's slot) and
``mapping.worker_cycle`` around ``engine.mapping.process_packed`` /
``process_sparse`` as the worker calls them (the worker thread).
``build_objects`` as ``mapping/pipeline.py`` binds it is wrapped to keep
its arguments, restored at :meth:`Entry.close`. A frame is ``failed``
when its cycle's ``build_objects`` arguments show a layer's labels at
``cc_max_labels_per_layer`` or more objects than ``max_objects`` (the
node's rule, :mod:`entries.node`); the main thread reads the cycles the
worker finished before each frame, so the flag lands a frame or two after
the frame was published (for the last ones, at :meth:`Entry.close`).

Every wait here has a limit of :data:`WAIT_S` seconds and raises past it,
so that a program that cannot run the cell fails and does not hang.

The comparison: the fusion frame's numbers (:func:`pb.check.judge`: the
link emits no raw cloud) and the node's four mapping numbers
(:func:`entries.node.mapping_numbers`), the objects against the mapping
reference's segmentation of the fusion reference's history, the tracks
against :mod:`reference.mapping`'s tracker replayed over the program's
cycles, each with the dt it was given (:mod:`reference.replay`).
"""

from __future__ import annotations

import collections
import importlib
import queue
import time

import torch

from entries import node
from pb import check, drive
from reference.replay import Replay

SUBMIT = "mapping.submit"
CYCLE = "mapping.worker_cycle"
WAIT_S = 30.0


def sparse_of(out) -> tuple:
    """A frame's sparse occupancy with its dense fallback."""
    return (out.occupancy_sparse_idx, out.occupancy_sparse_words,
            out.occupancy_sparse_count, out.occupancy_sparse_true,
            out.occupancy_bits)


class Entry:
    def __init__(self, system, cfg, traffic, device):
        from ros_gpu_depthmap_fusion_tpu_torch.mapping.pipeline import (
            AsyncMappingWorker)
        from ros_gpu_depthmap_fusion_tpu_torch.pipeline.engine import (
            FusionEngine)
        self.system, self.cfg = system, cfg
        self.engine = FusionEngine(cfg, device,
                                   pipeline_depth=traffic["pipeline_depth"],
                                   enable_mapping=True)
        spans = system.spans
        drive.wrap_engine(self.engine, spans)
        for name in ("process_packed", "process_sparse"):
            self._wrap_cycle(self.engine.mapping, name)
        self.pipeline = importlib.import_module(node.PIPELINE)
        self.build = self.pipeline.build_objects

        def build_objects(*a, **k):
            self.args = k
            return self.build(*a, **k)
        self.pipeline.build_objects = build_objects
        self.args = None
        self.frames = collections.deque()   # submitted, not yet mapped
        self.finished = queue.SimpleQueue()  # the worker's cycle records
        self.inputs, self.dts = [], []      # by cycle: [(id, box5)], dt
        self.submitted = 0
        self.worker = AsyncMappingWorker(self.engine.mapping, packed=True)
        spans.wrap(self.worker, "submit", SUBMIT)

    def _wrap_cycle(self, mapping, name: str) -> None:
        fn, spans = getattr(mapping, name), self.system.spans

        def cycle(occ, dt=None, **k):
            with spans.span(CYCLE):
                res = fn(occ, dt=dt, **k)
            self._record(res)
            return res
        setattr(mapping, name, cycle)

    def _record(self, res) -> None:
        """On the worker thread, right after a cycle: what the comparison
        and ``failed`` need of it, before the next cycle moves the
        tracks."""
        f, args, self.args = self.frames.popleft(), self.args, None
        inputs = [(k, node.box5(o.topview.shapes.world.box))
                  for k, o in enumerate(res.objects) if o.topview is not None]
        lab, obj = node.dropped(args, self.cfg.cc_max_labels_per_layer,
                                self.cfg.max_objects)
        snap = None
        if f in self.system.sample:
            index = {id(o): k for k, o in enumerate(res.objects)}
            snap = {
                "args": args,
                "corners": {k: o.topview.shapes.world.box.points()
                            for k, o in enumerate(res.objects)
                            if k > 0 and o.topview is not None},
                "tracks": {t.track_id: (index.get(id(t.last_object), -1),
                                        t.rrect_filter.rrect.points())
                           for t in res.tracks}}
        self.finished.put((f, res.dt, inputs, bool(lab or obj), snap))

    def _collect(self) -> None:
        """Take in the cycles the worker finished (main thread)."""
        sys_ = self.system
        while True:
            try:
                f, dt, inputs, bad, snap = self.finished.get_nowait()
            except queue.Empty:
                return
            if f != len(self.inputs):
                raise RuntimeError(f"mapped frame {f} after "
                                   f"{len(self.inputs)} cycles")
            self.inputs.append(inputs)
            self.dts.append(dt)
            if bad:
                for i in range(len(sys_.done) - 1, -1, -1):
                    if sys_.done[i][0] == f:
                        sys_.done[i] = sys_.done[i][:3] + (True,)
                        break
            if snap is not None and f in sys_.kept:
                sys_.kept[f]["node"] = dict(snap, inputs=self.inputs,
                                            dts=self.dts)

    def feed(self, f: int) -> None:
        sc, eng = self.system.scene, self.engine
        depth, poses = sc.depth(f), sc.poses(f)
        for i in range(sc.c):
            eng.add_depthmap(i, depth[i], sc.intr, poses[i], poses[i])
        for pts, sec, nsec in sc.lidar(f):
            eng.add_point_sequence(pts, sec, nsec, drive.EYE)
        out = eng.process(sc.stamp(f))
        if out is not None:
            self.system.publish(out)
            self.frames.append(self.system.done[-1][0])
            self.worker.submit(sparse_of(out), block=True, timeout=WAIT_S)
            self.submitted += 1
        self._collect()

    def close(self) -> None:
        """Run the frame in flight to its end (neither counted nor
        mapped), wait for every submitted frame's cycle, then stop the
        worker and the engine."""
        try:
            if self.engine.pipeline_depth:
                self.engine.flush()
            deadline = time.monotonic() + WAIT_S
            while len(self.inputs) < self.submitted:
                self.worker.latest()    # raises the worker's exception
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"{self.submitted - len(self.inputs)} submitted "
                        f"frames not mapped in {WAIT_S} s")
                time.sleep(0.002)
                self._collect()
        finally:
            self.worker.close()
            self.pipeline.build_objects = self.build
            self.engine.close()


class Reference(node.Reference):
    """The node cell's reference (fusion, and the mapping reference on its
    occupancy history), with the tracker replayed over the program's
    cycles at their own dts."""

    def __init__(self, cfg: dict, scene, device, dtype=torch.float32):
        super().__init__(cfg, scene, device, dtype)
        self.replay = Replay(cfg["object_min_area"], cfg["max_tracks"])


def judge(ref: Reference, f: int, prog: dict) -> dict:
    """Frame ``f``'s fusion numbers and mapping numbers."""
    nums = check.judge(ref, f, prog)
    snap = prog["node"]
    nums.update(node.mapping_numbers(
        node.reference_objects(ref.objects(f)),
        node.program_objects(snap["args"], snap["corners"]),
        ref.replay.tracks(f, snap["inputs"], snap["dts"]), snap["tracks"],
        ref.grid.cell))
    return nums
