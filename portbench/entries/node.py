"""Traffic entry ``node``: ``FusionComponent(cfg, device,
enable_mapping=True)``, upstream's node with mapping on every frame.

A frame is fed as ``component`` feeds it: one ``callback_depthmap`` a
camera, the sync policy's trigger slot 0 last, then ``tick_resample``.
The component runs the step, hands the outputs to ``on_points``, then
runs ``engine.segment_and_track`` (segmentation, the results' copy to
the host, ``build_objects``, ``track_objects``) and hands its
``MappingResult`` to ``on_mapping``. A node frame is finished when its
objects and tracks are on the host: only then is its fused cloud
published (``system.publish``), so the closed loop releases the next
frame after them.

Harness spans: ``mapping.cycle`` around ``engine.segment_and_track``;
``mapping.segment``, ``mapping.objects`` and ``mapping.track`` around the
names ``segment``, ``build_objects`` and ``track_objects`` as
``mapping/pipeline.py`` binds them, restored at :meth:`Entry.close`. A
frame is ``failed`` when ``build_objects``' arguments (host arrays) show
a layer's labels at ``cc_max_labels_per_layer`` (its last label may hold
several components) or more objects than ``max_objects``.

The comparison: the fusion frame's four numbers (:func:`pb.check.judge`)
and four of the mapping stage, against :mod:`reference.mapping`:

- ``objects_pct``: objects (not the background) not matched one to one
  by id, voxel count, box and first cell, per 100 reference objects; the
  reference segments ``Reference.history(f) > 0``, so from the scene on
  no step of it uses a number the program made;
- ``object_gap_mm``: the widest gap among matched objects, of a centroid
  coordinate (at the cell's size) or of a top-view rectangle's corner
  (against the nearest of the reference's minimal rectangles);
- ``tracks_pct``: live tracks whose id, matched object or liveness
  differs, per 100 reference tracks;
- ``track_gap_mm``: the widest gap among matched tracks' filtered box
  corners.

The tracks depend on every earlier frame. The reference's tracks are its
tracker replayed from frame 0 over the objects the program produced
(kept for every frame: the tracker's inputs, which the host holds
anyway), and those objects are themselves held to the reference's
segmentation at the sampled frames. That checks every frame's
association at the cost of a replay on the host, where working 300-500
frames of reference fusion out again after each run would not.
"""

from __future__ import annotations

import importlib
import math

import numpy as np
import torch

from pb import check, drive
from reference import mapping as refmap
from reference.fusion import Reference as FusionReference

CYCLE = "mapping.cycle"
SEGMENT = "mapping.segment"
OBJECTS = "mapping.objects"
TRACK = "mapping.track"
PIPELINE = "ros_gpu_depthmap_fusion_tpu_torch.mapping.pipeline"


def box5(box) -> tuple:
    """A ``RotatedRect`` as ``(cx, cy, w, h, angle_deg)``."""
    return (float(box.center[0]), float(box.center[1]), float(box.size[0]),
            float(box.size[1]), float(box.angle))


def dropped(args: dict, max_labels: int, max_objects: int) -> tuple:
    """``(layers at the label capacity, objects beyond max_objects)`` from
    ``build_objects``' arguments."""
    return (int((np.asarray(args["num_labels"]) >= max_labels).sum()),
            max(0, int(args["num_merged"]) - max_objects))


def program_objects(args: dict, corners: dict) -> dict:
    """``{(id, count, vmin, vmax, first cell): (centroid [3], top-view
    corners [4, 2] or None)}`` of the objects but the background, from
    ``build_objects``' arguments and the objects' top-view boxes."""
    labels = np.asarray(args["labels"]).astype(np.int64)
    mol = np.asarray(args["merged_of_label"]).astype(np.int64)
    z = labels.shape[0]
    merged = np.take_along_axis(mol, labels.reshape(z, -1), 1).reshape(-1)
    occ = np.flatnonzero(labels.reshape(-1) > 0)
    ids, first_at = np.unique(merged[occ], return_index=True)
    first = dict(zip(ids.tolist(), occ[first_at].tolist()))
    count, cen = args["voxel_count"], args["centroid"]
    vmin, vmax = args["vmin"], args["vmax"]
    out = {}
    for m in range(1, int(args["num_merged"])):
        stats = m < len(count)
        key = (m, int(count[m]) if stats else 0,
               tuple(int(v) for v in vmin[m]) if stats else (),
               tuple(int(v) for v in vmax[m]) if stats else (),
               first.get(m, -1))
        c = np.asarray(cen[m], np.float64) if stats else np.zeros(3)
        out[key] = (c, corners.get(m))
    return out


class Entry:
    def __init__(self, system, cfg, traffic, device):
        from ros_gpu_depthmap_fusion_tpu_torch.pipeline.component import (
            FusionComponent)
        self.system, self.cfg = system, cfg
        self.comp = FusionComponent(cfg, device, on_points=self._points,
                                    on_mapping=self._mapping,
                                    enable_mapping=True)
        self.engine = self.comp.engine
        spans = system.spans
        spans.wrap(self.comp, "callback_depthmap", drive.CALLBACK)
        spans.wrap(self.comp, "tick_resample", drive.TICK)
        drive.wrap_engine(self.engine, spans)
        spans.wrap(self.engine, "segment_and_track", CYCLE)
        self.pipeline = importlib.import_module(PIPELINE)
        names = ("segment", "build_objects", "track_objects")
        self.restore = [(n, getattr(self.pipeline, n)) for n in names]
        for n, span in zip(names, (SEGMENT, OBJECTS, TRACK)):
            spans.wrap(self.pipeline, n, span)
        build = self.pipeline.build_objects

        def build_objects(*a, **k):
            self.args = k
            return build(*a, **k)
        self.pipeline.build_objects = build_objects
        c = system.scene.c
        self.slot_order = list(range(1, c)) + [0]
        self.inputs = []        # each frame's [(object id, box5)]
        self.frame = -1
        self.out = None
        self.args = None

    def feed(self, f: int) -> None:
        sc, comp = self.system.scene, self.comp
        self.frame = f
        depth, poses, stamp = sc.depth(f), sc.poses(f), sc.stamp(f)
        for pts, sec, nsec in sc.lidar(f):
            comp.callback_point_sequence(sec + nsec * 1e-9, pts, drive.EYE)
        for slot in self.slot_order:
            comp.callback_depthmap(slot, stamp, depth[slot], sc.intr,
                                   poses[slot], poses[slot])
        comp.tick_resample(stamp)

    def _points(self, out) -> None:
        self.out = out

    def _mapping(self, res) -> None:
        sys_, f, args = self.system, self.frame, self.args
        self.inputs.append([(k, box5(o.topview.shapes.world.box))
                            for k, o in enumerate(res.objects)
                            if o.topview is not None])
        lab, obj = dropped(args, self.cfg.cc_max_labels_per_layer,
                           self.cfg.max_objects)
        node = None
        if f in sys_.sample:
            index = {id(o): k for k, o in enumerate(res.objects)}
            node = {
                "args": args, "inputs": self.inputs,
                "corners": {k: o.topview.shapes.world.box.points()
                            for k, o in enumerate(res.objects)
                            if k > 0 and o.topview is not None},
                "tracks": {t.track_id: (index.get(id(t.last_object), -1),
                                        t.rrect_filter.rrect.points())
                           for t in res.tracks}}
        out, self.out, self.args = self.out, None, None
        sys_.publish(out)
        if lab or obj:
            d = sys_.done[-1]
            sys_.done[-1] = d[:3] + (True,)
        if f in sys_.kept:
            sys_.kept[f]["node"] = node

    def close(self) -> None:
        for n, fn in self.restore:
            setattr(self.pipeline, n, fn)
        self.engine.close()


def segment_history(fusion: FusionReference, f: int, dtype=torch.float32,
                    host_dtype=torch.float64) -> refmap.Segmentation:
    """The mapping reference's objects of a fusion reference's occupancy
    history after frame ``f``."""
    cfg, g = fusion.cfg, fusion.grid
    occ = (fusion.history(f) > 0).reshape(g.size[::-1]).cpu().numpy()
    return refmap.segment(occ, cfg["cc_max_labels_per_layer"],
                          cfg["max_objects"], g.cell, g.lower, dtype,
                          host_dtype)


class Reference(FusionReference):
    """The fusion reference, with the mapping stage's reference on its
    occupancy history and a tracker replayed over the program's objects
    (in ascending frames, as the judge asks)."""

    def __init__(self, cfg: dict, scene, device, dtype=torch.float32):
        # built once the program's run is over: its settings are not moved
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        super().__init__(cfg, scene, device, dtype)
        self.tracker = refmap.Tracker(cfg["object_min_area"],
                                      cfg["tracking_dt"], cfg["max_tracks"])

    def objects(self, f: int) -> refmap.Segmentation:
        return segment_history(self, f, self.dt)

    def tracks(self, f: int, inputs: list) -> dict:
        """The replayed tracker's live tracks after frame ``f``."""
        while self.tracker.frame < f:
            self.tracker.step(inputs[self.tracker.frame + 1])
        return self.tracker.state()


def reference_objects(seg: refmap.Segmentation) -> dict:
    """The reference's objects keyed as :func:`program_objects` keys the
    program's, each with its centroid and minimal rectangles."""
    return {(k, int(seg.voxel_count[k]), tuple(int(v) for v in seg.vmin[k]),
             tuple(int(v) for v in seg.vmax[k]), int(seg.first_cell[k])):
            (seg.centroid[k], refmap.min_area_rects(seg.topview[k]))
            for k in range(1, seg.objects + 1)}


def mapping_numbers(ref_objs: dict, prog_objs: dict, ref_tracks: dict,
                    prog_tracks: dict, cell) -> dict:
    """The four mapping numbers of one frame (see the module docstring)."""
    common = ref_objs.keys() & prog_objs.keys()
    nums = {"objects_pct": 100.0 * (len(ref_objs) + len(prog_objs)
                                    - 2 * len(common))
            / max(len(ref_objs), 1)}
    gap = 0.0
    cs = np.asarray(cell, np.float64)
    for key in common:
        (rc, rects), (pc, corners) = ref_objs[key], prog_objs[key]
        gap = max(gap, float((np.abs(np.asarray(pc) - rc) * cs).max()))
        if corners is None:
            gap = math.inf
        else:
            gap = max(gap, min(refmap.corner_gap(np.asarray(corners), r)
                               for r in rects))
    nums["object_gap_mm"] = gap * 1e3
    both = ref_tracks.keys() & prog_tracks.keys()
    bad = len(ref_tracks) + len(prog_tracks) - 2 * len(both) + sum(
        1 for t in both if ref_tracks[t][0] != prog_tracks[t][0])
    nums["tracks_pct"] = 100.0 * bad / max(len(ref_tracks), 1)
    nums["track_gap_mm"] = max(
        (float(np.hypot(*(np.asarray(prog_tracks[t][1])
                          - ref_tracks[t][1]).T).max()) for t in both),
        default=0.0) * 1e3
    return nums


def judge(ref: Reference, f: int, prog: dict) -> dict:
    """Frame ``f``'s fusion numbers and mapping numbers."""
    nums = check.judge(ref, f, prog)
    node = prog["node"]
    objs = node.get("objects")
    if objs is None:
        objs = program_objects(node["args"], node["corners"])
    nums.update(mapping_numbers(reference_objects(ref.objects(f)), objs,
                                ref.tracks(f, node["inputs"]),
                                node["tracks"], ref.grid.cell))
    return nums
