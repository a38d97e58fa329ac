"""Object tracking (a copy of the JAX package's ``mapping/tracking.py``;
numpy only).

Behavioral translation of the reference tracker
(``gpu_depthmap_fusion.cpp:2579-2944``): per-track exponential-gain filters
on a rotated rectangle + a 1-D score, track<->object comparison with
best-of-4 box-corner roll alignment, and the greedy two-pass assignment
loop. Host-side small-N per frame, same constants.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional

import numpy as np

from ros_gpu_depthmap_fusion_tpu_torch.mapping.filters import (
    ObservePredictFilter, RotatedRectFilter)
from ros_gpu_depthmap_fusion_tpu_torch.mapping.geometry import RotatedRect
from ros_gpu_depthmap_fusion_tpu_torch.mapping.objects import CCObject


def rolled_rrect(rrect: RotatedRect, roll: int) -> RotatedRect:
    """cpp:2650-2664: rotate the corner correspondence by 90deg steps;
    odd rolls swap width/height."""
    if roll % 2 == 0:
        return RotatedRect(rrect.center, rrect.size,
                           rrect.angle + 90.0 * roll)
    return RotatedRect(rrect.center, (rrect.size[1], rrect.size[0]),
                       rrect.angle + 90.0 * roll)


class TrackComparison:
    """cpp:2667-2725: geometric comparison of a track box vs an object box."""

    W_CENTER = 0.0
    W_PTS = 0.1
    W_AREA = 0.0

    def __init__(self, track: "CCObjectTrack", obj: CCObject):
        self.track = track
        self.object = obj
        self.track_box = track.rrect_filter.rrect
        self.object_box = obj.topview.shapes.world.box
        ca = np.asarray(self.track_box.center)
        cb = np.asarray(self.object_box.center)
        self.center_diff = ca - cb
        self.center_dist = float(np.hypot(*self.center_diff))
        pts_a = self.track_box.points()
        pts_b = self.object_box.points()
        self.best_roll = 0
        self.mean_box_point_dist = math.inf
        for roll in range(4):
            d = pts_a - pts_b[(np.arange(4) + roll) % 4]
            dists = np.hypot(d[:, 0], d[:, 1])
            mean_d = float(dists.mean())
            if roll == 0 or mean_d < self.mean_box_point_dist:
                self.best_roll = roll
                self.mean_box_point_dist = mean_d
                self.box_point_dists = dists
        self.area_diff = abs(self.track_box.area() - self.object_box.area())
        self.score = -(self.W_CENTER * self.center_dist
                       + self.W_PTS * self.mean_box_point_dist
                       + self.W_AREA * self.area_diff)


class CCObjectTrack:
    """cpp:2579-2648. ``track_id`` is a persistent identity assigned by
    :func:`track_objects` (monotone per tracker) — unlike the reference,
    whose tracks are only addressable by a list index that shifts when
    dead tracks compact out."""

    def __init__(self, obj: Optional[CCObject] = None):
        self.age = 0.0
        self.track_id = -1
        self.last_object: Optional[CCObject] = obj
        if obj is None:
            self.initialized = False
            self.rrect_filter = RotatedRectFilter()
            self.score_filter = ObservePredictFilter(0.5, 0.1, 0.9, 0.1)
        else:
            self.initialized = True
            self.rrect_filter = RotatedRectFilter(
                obj.topview.shapes.world.box)
            self.score_filter = ObservePredictFilter(0.25, 0.1, 0.9, 0.1)
            self.score_filter.correct(1.0, [0.5])

    @property
    def score(self) -> float:
        return float(self.score_filter.values[0])

    def is_dead(self) -> bool:
        """cpp:2601-2605: death once the decayed score drops below 0.1."""
        return (self.age > 0.06) and (self.score < 0.1)

    def is_acceptable(self, comp: TrackComparison) -> bool:
        """Gates, cpp:2607-2631."""
        area = comp.track_box.area()
        track_size = comp.track_box.size[0] + comp.track_box.size[1]
        object_size = comp.object_box.size[0] + comp.object_box.size[1]
        if area > 0.5 and comp.area_diff > area * 0.5:
            return False
        if comp.center_dist > 0.5 * (track_size + object_size):
            return False
        if comp.center_dist > 2.5:
            return False
        if comp.mean_box_point_dist > 2.5:
            return False
        return True

    def advance(self, dt: float):
        """Unmatched decay, cpp:2632-2639."""
        self.age += dt
        self.score_filter.predict(dt, [0.0])

    def merge(self, dt: float, obj: CCObject, comp: TrackComparison):
        """Matched update, cpp:2640-2648."""
        self.age += 1.0
        self.rrect_filter.filter(
            dt, rolled_rrect(obj.topview.shapes.world.box, comp.best_roll))
        self.last_object = obj
        self.score_filter.correct(dt, [1.0])


@dataclasses.dataclass
class TrackingStats:
    num_new_tracks: int = 0
    num_updated_tracks: int = 0
    num_dead_tracks: int = 0      # genuine score-decay deaths only
    num_capped_tracks: int = 0    # live tracks evicted by the max_tracks cap


def track_objects(objects: List[CCObject],
                  tracks: List[CCObjectTrack],
                  min_area: float,
                  dt: float = 1.0 / 30.0,
                  max_tracks: Optional[int] = None) -> TrackingStats:
    """Greedy two-pass association (cpp:2727-2944), mutating ``tracks``:

    1. every object (skipping background index 0 and tiny areas) picks its
       best acceptable track by comparison score;
    2. each track keeps only its best object; losers become new tracks;
    3. unmatched tracks decay via advance(); dead tracks compacted out.

    New tracks get persistent, monotonically increasing ``track_id``s.
    With ``max_tracks`` set, the live set is bounded: lowest-score tracks
    are dropped first (explicit policy where the reference grows
    unboundedly under clutter; its ``max_tracks``-free loop is
    cpp:2894-2940).
    """
    stats = TrackingStats()
    next_id = max((t.track_id for t in tracks), default=-1) + 1
    num_objects = len(objects)
    num_tracks = len(tracks)
    assigned_track = [-2] * num_objects  # -2 ignore, -1 new track
    comparisons = {}

    # gate objects (background 0, no topview, tiny area — cpp:2776-2777)
    gated = []
    for oid in range(1, num_objects):
        obj = objects[oid]
        if obj.topview is None:
            continue
        if obj.topview.shapes.world.box.area() < min_area:
            continue
        assigned_track[oid] = -1
        gated.append(oid)

    # all (object, track) comparisons at once (identical arithmetic to
    # TrackComparison, batched: per-comparison numpy overhead dominated
    # the cycle under clutter). Comparison records are materialized only
    # for the pairs the assignment actually uses.
    if gated and num_tracks:
        obj_boxes = [objects[oid].topview.shapes.world.box
                     for oid in gated]
        pb = np.stack([np.asarray(b.points(), np.float64)
                       for b in obj_boxes])                    # [O, 4, 2]
        cb = np.stack([np.asarray(b.center, np.float64)
                       for b in obj_boxes])                    # [O, 2]
        sb = np.stack([np.asarray(b.size, np.float64)
                       for b in obj_boxes])
        trk_boxes = [t.rrect_filter.rrect for t in tracks]
        pa = np.stack([np.asarray(r.points(), np.float64)
                       for r in trk_boxes])                    # [T, 4, 2]
        ca = np.stack([np.asarray(r.center, np.float64)
                       for r in trk_boxes])
        sa = np.stack([np.asarray(r.size, np.float64)
                       for r in trk_boxes])
        cd = ca[None, :, :] - cb[:, None, :]
        center_dist = np.hypot(cd[..., 0], cd[..., 1])         # [O, T]
        ridx = (np.arange(4)[None, :] + np.arange(4)[:, None]) % 4
        pb_rolled = pb[:, ridx]                                # [O, 4r, 4, 2]
        d = pa[None, :, None, :, :] - pb_rolled[:, None]       # [O,T,4r,4,2]
        dists = np.hypot(d[..., 0], d[..., 1])                 # [O, T, 4r, 4]
        mean_d = dists.mean(-1)                                # [O, T, 4r]
        best_roll_m = np.argmin(mean_d, axis=-1)               # first min
        mean_best = np.take_along_axis(
            mean_d, best_roll_m[..., None], -1)[..., 0]        # [O, T]
        area_a = sa[:, 0] * sa[:, 1]
        area_b = sb[:, 0] * sb[:, 1]
        area_diff = np.abs(area_a[None, :] - area_b[:, None])
        score_m = -(TrackComparison.W_CENTER * center_dist
                    + TrackComparison.W_PTS * mean_best
                    + TrackComparison.W_AREA * area_diff)
        # is_acceptable gates (cpp:2607-2631)
        tsize = sa.sum(1)[None, :]
        osize = sb.sum(1)[:, None]
        reject = (((area_a[None, :] > 0.5)
                   & (area_diff > area_a[None, :] * 0.5))
                  | (center_dist > 0.5 * (tsize + osize))
                  | (center_dist > 2.5) | (mean_best > 2.5))

        class _Comp:
            __slots__ = ("score", "best_roll")

            def __init__(self, score, best_roll):
                self.score = score
                self.best_roll = best_roll

        for k, oid in enumerate(gated):
            accs = np.flatnonzero(~reject[k])
            if not len(accs):
                continue
            # first acceptable, then strictly-greater replacement ==
            # first-occurrence argmax over the acceptable set
            tid = int(accs[np.argmax(score_m[k, accs])])
            assigned_track[oid] = tid
            comparisons[(oid, tid)] = _Comp(float(score_m[k, tid]),
                                            int(best_roll_m[k, tid]))

    # each track keeps its best object
    best_object = [-1] * num_tracks
    best_object_score = [0.0] * num_tracks
    for oid in range(1, num_objects):
        tid = assigned_track[oid]
        if tid < 0:
            continue
        comp = comparisons[(oid, tid)]
        if best_object[tid] == -1 or comp.score > best_object_score[tid]:
            best_object[tid] = oid
            best_object_score[tid] = comp.score
    for oid in range(1, num_objects):
        tid = assigned_track[oid]
        if tid < 0:
            continue
        if best_object[tid] != oid:
            assigned_track[oid] = -1  # loser becomes a new track

    advanced = [True] * num_tracks
    for oid in range(1, num_objects):
        tid = assigned_track[oid]
        if tid == -2:
            continue
        if tid == -1:
            t = CCObjectTrack(objects[oid])
            t.track_id = next_id
            next_id += 1
            tracks.append(t)
            advanced.append(False)
            stats.num_new_tracks += 1
        else:
            tracks[tid].merge(dt, objects[oid], comparisons[(oid, tid)])
            advanced[tid] = False
            stats.num_updated_tracks += 1

    for tid, adv in enumerate(advanced):
        if adv:
            tracks[tid].advance(dt)

    survivors = [t for t in tracks if not t.is_dead()]
    stats.num_dead_tracks = len(tracks) - len(survivors)
    if max_tracks is not None and len(survivors) > max_tracks:
        # bound the live set: keep the highest-score tracks, stable order
        # (ties resolved toward earlier tracks). Capacity evictions are
        # counted separately from decay deaths (stats.num_capped_tracks).
        order = sorted(range(len(survivors)),
                       key=lambda i: (-survivors[i].score, i))
        keep = sorted(order[:max_tracks])
        stats.num_capped_tracks = len(survivors) - max_tracks
        survivors = [survivors[i] for i in keep]
    tracks[:] = survivors
    return stats
