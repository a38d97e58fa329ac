"""Plain reference of the node's mapping stage: what one frame's objects
and the tracks after it must be.

Written from the semantics of upstream's ``objectSegmentation()`` and
``objectTracking(min_area)`` (``gpu_depthmap_fusion.cpp:1872-2550``,
``:2579-2944``) and its filter headers (``filter/*.h``), in plain numpy
and torch, with nothing of the port imported:

1. per layer of the ``[Z, Y, X]`` occupancy, 8-connected components,
   numbered from 1 in raster order of each component's first pixel as
   ``cv::connectedComponents`` numbers them; found here by a union-find
   over the runs of each row;
2. the cross-layer merge: two layer components that share an (x, y)
   column in adjacent layers are one object (the ``layers_connections``
   shader, ``:2200-2214``); objects are numbered from 1 in ascending
   order of their first ``(layer, label)``, 0 is the background;
3. per object its voxel count, centroid (the mean voxel coordinate, sums
   exact, the division in ``dtype``), axis-aligned box and first cell
   (the least ``z * Y * X + y * X + x``), and its world top view: the
   occupied (x, y) columns at their cells' lower corners, and its
   minimum-area rectangles;
4. the tracker: each object (not the background) with a top view whose
   box is at least ``object_min_area`` picks its best acceptable track,
   each track keeps its best object, the rest start tracks; matched
   tracks are filtered, the others decay; dead tracks go, and at most
   ``max_tracks`` stay, the highest scores (:class:`Tracker`).

Nothing here is a matrix product or a convolution on the card, so TF32
never enters; the node entry's reference switches it off all the same.

Departures, each noted where it is made:

- A layer's labels are not capped: components a layer has beyond
  ``max_labels - 1`` are reported (:attr:`Segmentation.labels_dropped`),
  where the program folds them into its last label; objects beyond
  ``max_objects`` likewise (:attr:`Segmentation.objects_dropped`).
- Every minimal rectangle is returned where several have the least area
  (:func:`min_area_rects`): ``cv::minAreaRect`` keeps whichever its
  rounding finds first, and a comparison must not hang on that choice.
- ``max_tracks`` is the port's bound on the live tracks (upstream's list
  grows without one); its order is upstream's list order.
- The tracker and the top-view geometry compute in ``host_dtype``,
  float64 by default, as the port's host does, where upstream's
  ``cv::RotatedRect`` holds float32: in float32 a box of exactly 0.2 x
  0.2 m decides the 0.04 m^2 gate otherwise, one new track shifts every
  later track's id, and the tracks could not be compared at all.
"""

from __future__ import annotations

import math
from typing import List, NamedTuple

import numpy as np
import torch


def _rounder(dtype):
    """``x`` rounded to ``dtype`` and back to float64 (numbers or arrays);
    the identity for float64."""
    if dtype == torch.float64:
        return lambda x: x

    def r(x):
        a = torch.as_tensor(np.asarray(x, np.float64)).to(dtype).double()
        return float(a) if np.ndim(x) == 0 else a.numpy()
    return r


class _UnionFind:
    """Union by the smaller index: a set's root is its least member."""

    def __init__(self, n: int):
        self.parent = list(range(n))

    def find(self, a: int) -> int:
        p = self.parent
        while p[a] != a:
            p[a] = p[p[a]]
            a = p[a]
        return a

    def union(self, a: int, b: int) -> None:
        ra, rb = self.find(a), self.find(b)
        if ra != rb:
            self.parent[max(ra, rb)] = min(ra, rb)

    def roots(self) -> np.ndarray:
        return np.array([self.find(i) for i in range(len(self.parent))],
                        dtype=np.int64)


def label_layers(occ: np.ndarray):
    """8-connected components of each layer of ``occ`` ``[Z, Y, X]``:
    labels ``[Z, Y, X]`` int64 (0 background, then 1.. in raster order of
    each component's first pixel) and each layer's component count."""
    z, y, x = occ.shape
    rows = occ.reshape(z * y, x).astype(np.int8)
    pad = np.zeros((z * y, x + 2), np.int8)
    pad[:, 1:-1] = rows
    d = np.diff(pad, axis=1)
    row, x0 = np.nonzero(d == 1)          # runs in raster order
    _, x1 = np.nonzero(d == -1)           # their ends, exclusive
    n = len(row)
    uf = _UnionFind(n)
    if n:
        width = x + 2
        start = row * width + x0
        end = row * width + x1
        # run b touches run a of the row above (same layer) when their
        # pixel spans come within one column: a0 <= b1 and b0 <= a1
        above = (row % y) != 0
        lo = np.searchsorted(end, (row - 1) * width + x0, side="left")
        hi = np.searchsorted(start, (row - 1) * width + x1, side="right")
        for b in np.flatnonzero(above & (hi > lo)):
            for a in range(lo[b], hi[b]):
                uf.union(int(a), int(b))
    root = uf.roots()
    is_root = root == np.arange(n)
    layer = row // y
    # the first run of a component holds its first pixel: number the
    # roots in run order within each layer
    rank = np.zeros(n, np.int64)
    counts = np.zeros(z, np.int64)
    for i in np.flatnonzero(is_root):
        counts[layer[i]] += 1
        rank[i] = counts[layer[i]]
    labels = np.zeros(z * y * x, np.int64)
    flat = np.flatnonzero(occ.reshape(-1))
    labels[flat] = np.repeat(rank[root], x1 - x0)
    return labels.reshape(z, y, x), counts


def merge_layers(labels: np.ndarray, counts: np.ndarray) -> np.ndarray:
    """The object of each ``(layer, label)``: ``[Z, max(counts) + 1]``
    int64, 0 for the background, objects 1.. in ascending order of their
    first ``(layer, label)``."""
    z = labels.shape[0]
    width = int(counts.max(initial=0)) + 1
    offset = np.concatenate([[0], np.cumsum(counts)])
    uf = _UnionFind(int(offset[-1]))
    a, b = labels[:-1], labels[1:]
    both = (a > 0) & (b > 0)
    zz = np.broadcast_to(np.arange(z - 1)[:, None, None], a.shape)[both]
    ga = offset[zz] + a[both] - 1
    gb = offset[zz + 1] + b[both] - 1
    for p, q in set(zip(ga.tolist(), gb.tolist())):
        uf.union(p, q)
    root = uf.roots()
    obj_of_root = np.cumsum(root == np.arange(len(root)))
    obj = np.zeros((z, width), np.int64)
    for k in range(z):
        m = int(counts[k])
        obj[k, 1:m + 1] = obj_of_root[root[offset[k]:offset[k] + m]]
    return obj


def convex_hull(pts: np.ndarray) -> np.ndarray:
    """Hull vertices of 2-D points, counter-clockwise (monotone chain);
    collinear points are left out. Only each row's and each column's
    outermost points can be vertices, so only they are chained."""
    p = np.unique(pts, axis=0)
    if len(p) > 64:
        keep = np.zeros(len(p), bool)
        for a in (0, 1):
            order = np.lexsort((p[:, 1 - a], p[:, a]))
            key = p[order, a]
            edge = key[1:] != key[:-1]
            keep[order[np.r_[True, edge] | np.r_[edge, True]]] = True
        p = p[keep]
    if len(p) <= 2:
        return p

    def half(seq):
        out = []
        for q in seq:
            while len(out) >= 2 and (
                    (out[-1][0] - out[-2][0]) * (q[1] - out[-2][1])
                    - (out[-1][1] - out[-2][1]) * (q[0] - out[-2][0])) <= 0:
                out.pop()
            out.append(q)
        return out
    lower, upper = half(p), half(p[::-1])
    return np.array(lower[:-1] + upper[:-1])


def min_area_rects(pts: np.ndarray, rel: float = 1e-9) -> List[np.ndarray]:
    """The corners ``[4, 2]`` of every rectangle of least area that holds
    ``pts``, each with a side along a hull edge (ties within ``rel``);
    a single point or a segment gives its degenerate rectangle."""
    hull = convex_hull(np.asarray(pts, np.float64))
    if len(hull) == 1:
        return [np.repeat(hull, 4, axis=0)]
    if len(hull) == 2:
        return [np.stack([hull[0], hull[1], hull[1], hull[0]])]
    cands = []
    for i in range(len(hull)):
        e = hull[(i + 1) % len(hull)] - hull[i]
        norm = math.hypot(e[0], e[1])
        u = e / norm
        v = np.array([-u[1], u[0]])
        s, t = hull @ u, hull @ v
        area = (s.max() - s.min()) * (t.max() - t.min())
        corners = np.stack([s.min() * u + t.min() * v,
                            s.max() * u + t.min() * v,
                            s.max() * u + t.max() * v,
                            s.min() * u + t.max() * v])
        cands.append((area, corners))
    least = min(a for a, _ in cands)
    return [c for a, c in cands if a <= least * (1 + rel) + 1e-15]


def corner_gap(a: np.ndarray, b: np.ndarray) -> float:
    """The widest corner distance between two rectangles' corners
    ``[4, 2]``, taken at the best correspondence (any start corner, either
    direction)."""
    best = math.inf
    for seq in (b, b[::-1]):
        for roll in range(4):
            d = np.hypot(*(a - np.roll(seq, roll, axis=0)).T).max()
            best = min(best, float(d))
    return best


class Segmentation(NamedTuple):
    labels: np.ndarray          # [Z, Y, X] per-layer labels
    counts: np.ndarray          # [Z] components of each layer
    objects: int                # objects, the background not counted
    voxel_count: np.ndarray     # [objects + 1]
    centroid: np.ndarray        # [objects + 1, 3] mean voxel (x, y, z)
    vmin: np.ndarray            # [objects + 1, 3] (x, y, z)
    vmax: np.ndarray
    first_cell: np.ndarray      # [objects + 1], -1 for the background
    topview: list               # per object: world (x, y) columns [K, 2]
    labels_dropped: int         # layers with more labels than capacity
    objects_dropped: int        # objects beyond the capacity


def segment(occ: np.ndarray, max_labels: int, max_objects: int,
            cell, lower, dtype=torch.float32,
            host_dtype=torch.float64) -> Segmentation:
    """Objects of a ``[Z, Y, X]`` occupancy (nonzero = occupied) on a grid
    of cells ``cell`` (x, y, z) from ``lower``."""
    occ = np.asarray(occ) != 0
    z, y, x = occ.shape
    labels, counts = label_layers(occ)
    obj_of = merge_layers(labels, counts)
    objmap = np.take_along_axis(obj_of, labels.reshape(z, -1), 1)
    m = int(obj_of.max(initial=0))
    flat = np.flatnonzero(occ.reshape(-1))
    ids = objmap.reshape(-1)[flat]
    cz, rem = np.divmod(flat, y * x)
    cy, cx = np.divmod(rem, x)
    coords = np.stack([cx, cy, cz], 1)
    count = np.bincount(ids, minlength=m + 1)
    sums = np.stack([np.bincount(ids, weights=c, minlength=m + 1)
                     for c in coords.T], 1)          # exact below 2^53
    cen = (torch.from_numpy(sums).to(dtype)
           / torch.from_numpy(count).clamp_min(1).to(dtype)[:, None])
    vmin = np.zeros((m + 1, 3), np.int64)
    vmax = np.full((m + 1, 3), -1, np.int64)
    first = np.full(m + 1, -1, np.int64)
    order = np.argsort(ids, kind="stable")
    bounds = np.searchsorted(ids[order], np.arange(m + 2))
    r = _rounder(host_dtype)
    cs = np.asarray(cell[:2], np.float64)
    lo = np.asarray(lower[:2], np.float64)
    topview = [np.zeros((0, 2))]
    for k in range(1, m + 1):
        sel = order[bounds[k]:bounds[k + 1]]
        c = coords[sel]
        vmin[k], vmax[k] = c.min(0), c.max(0)
        first[k] = flat[sel].min()
        cols = np.unique(c[:, :2], axis=0).astype(np.float64)
        topview.append(r(r(cols * r(cs)) + r(lo)))
    return Segmentation(
        labels=labels, counts=counts, objects=m, voxel_count=count,
        centroid=cen.double().numpy(), vmin=vmin, vmax=vmax,
        first_cell=first, topview=topview,
        labels_dropped=int((counts + 1 > max_labels).sum()),
        objects_dropped=max(0, m + 1 - max_objects))


# --- tracking ---------------------------------------------------------------

def box_points(box, r=lambda v: v) -> np.ndarray:
    """``cv::RotatedRect::points()`` of ``(cx, cy, w, h, angle_deg)``."""
    cx, cy, w, h, ang = box
    rad = math.radians(ang)
    b, a = r(math.cos(rad) * 0.5), r(math.sin(rad) * 0.5)
    p0 = (r(cx - a * h - b * w), r(cy + b * h - a * w))
    p1 = (r(cx + a * h - b * w), r(cy - b * h - a * w))
    return np.array([p0, p1, (r(2 * cx - p0[0]), r(2 * cy - p0[1])),
                     (r(2 * cx - p1[0]), r(2 * cy - p1[1]))])


def _gain(gain: float, ref_dt: float, dt: float) -> float:
    """``filter.h``: a gain set for ``ref_dt`` applied over ``dt``."""
    if abs(gain) < 1e-9:
        return 0.0
    den = ref_dt / gain + dt - ref_dt
    return 1.0 if abs(den) < 1e-9 else dt / den


class _ObservePredict:
    """``ObservePredictFilter``: one state, a correcting and a predicting
    gain; the first value given is taken as it is."""

    def __init__(self, pred, corr, r):
        self.pred, self.corr, self.r = pred, corr, r
        self.v = None

    def _mix(self, gains, dt, new):
        new = np.asarray(new, np.float64)
        if self.v is None:
            self.v = new.copy()
            return
        g = _gain(*gains, dt)
        self.v = self.r(new * g + (1.0 - g) * self.v)

    def correct(self, dt, new):
        self._mix(self.corr, dt, new)

    def predict(self, dt, new):
        self._mix(self.pred, dt, new)


class _Velocity:
    """``ConstGlobalVelocityFilter``: a value and its velocity, the
    velocity observed as the finite difference of measurements."""

    def __init__(self, value_gains, velocity_gains, dim, r):
        self.value = _ObservePredict(*value_gains, r)
        self.vel = _ObservePredict(*velocity_gains, r)
        self.values = np.zeros(dim)
        self.velocity = np.zeros(dim)
        self.last = None
        self.r = r

    def predict(self, dt):
        if self.last is None:
            return
        self.value.predict(dt, self.r(self.values + self.velocity * dt))
        self.vel.predict(dt, np.zeros_like(self.velocity))
        self.values, self.velocity = self.value.v, self.vel.v

    def correct(self, dt, obs):
        obs = np.asarray(obs, np.float64)
        if self.last is not None and abs(dt) > 1e-6:
            self.vel.correct(dt, self.r((obs - self.last) / dt))
            self.velocity = self.vel.v
        self.value.correct(dt, obs)
        self.values = self.value.v
        self.last = obs.copy()


def _wrap_2pi(a):
    return math.fmod(a, 2 * math.pi) + (2 * math.pi if a < 0 else 0.0)


def _wrap_pi(a):
    return _wrap_2pi(a + math.pi) - math.pi


def _angle_diff(before, now):
    """``wrap_pi.h``: ``now - before`` unwrapped, in (-pi, pi]."""
    b, n = _wrap_pi(before), _wrap_pi(now)
    if n - b > math.pi:
        n -= 2 * math.pi
    if n - b < -math.pi:
        n += 2 * math.pi
    return _wrap_pi(n - b)


class _RectFilter:
    """``RotatedRectFilter``: the centre through a constant-velocity
    filter, the angle through one that unwraps modulo 90 degrees, the
    size through a plain gain; reference dt 0.1 s."""

    def __init__(self, box, r):
        ref = 0.1
        self.center = _Velocity(((1.0, ref), (0.3, ref)),
                                ((1.0, ref), (0.0, ref)), 2, r)
        self.angle = _Velocity(((1.0, ref), (0.5, ref)),
                               ((1.0, ref), (0.5, ref)), 1, r)
        self.size = _ObservePredict((0.2, ref), (0.2, ref), r)
        self.r = r
        self.filter(1.0, box)

    def filter(self, dt, box):
        cx, cy, w, h, ang = box
        self.center.predict(dt)
        self.center.correct(dt, [cx, cy])
        a = math.radians(ang)
        if self.angle.last is not None:
            last = float(self.angle.last[0])
            d = _angle_diff(last, a)
            wrap = math.pi / 2
            a = last + (-wrap / 2 + math.fmod(d + wrap / 2, wrap))
        self.angle.correct(dt, [a])
        self.size.correct(dt, [w, h])
        self.box = (float(self.center.values[0]),
                    float(self.center.values[1]),
                    float(self.size.v[0]), float(self.size.v[1]),
                    math.degrees(float(self.angle.values[0])))


class Track:
    """A track: id, age, rectangle filter, score filter, and the object
    matched at the latest frame it was updated in."""

    def __init__(self, tid, box, oid, frame, r):
        self.id, self.age = tid, 0.0
        self.rect = _RectFilter(box, r)
        self.score = _ObservePredict((0.25, 0.1), (0.9, 0.1), r)
        self.score.correct(1.0, [0.5])
        self.oid, self.frame = oid, frame

    def dead(self) -> bool:
        return self.age > 0.06 and float(self.score.v[0]) < 0.1


def _compare(track_box, obj_box, r):
    """``(score, roll, acceptable)`` of a track's box against an object's
    (``:2607-2725``): the best of the four corner correspondences, and the
    gates on area, centre distance and mean corner distance."""
    pa, pb = box_points(track_box, r), box_points(obj_box, r)
    best, roll = math.inf, 0
    for k in range(4):
        d = pa - pb[(np.arange(4) + k) % 4]
        mean = float(r(np.mean(np.hypot(d[:, 0], d[:, 1]))))
        if mean < best:
            best, roll = mean, k
    dc = math.hypot(track_box[0] - obj_box[0], track_box[1] - obj_box[1])
    area_t = track_box[2] * track_box[3]
    area_o = obj_box[2] * obj_box[3]
    area_diff = abs(area_t - area_o)
    ok = not ((area_t > 0.5 and area_diff > area_t * 0.5)
              or dc > 0.5 * ((track_box[2] + track_box[3])
                             + (obj_box[2] + obj_box[3]))
              or dc > 2.5 or best > 2.5)
    return -(0.0 * dc + 0.1 * best + 0.0 * area_diff), roll, ok


def _rolled(box, roll):
    cx, cy, w, h, ang = box
    if roll % 2:
        w, h = h, w
    return (cx, cy, w, h, ang + 90.0 * roll)


class Tracker:
    """Upstream's greedy association over frames (``:2727-2944``), fed
    each frame's ``[(object id, box)]`` of the objects with a top view,
    ``box = (cx, cy, w, h, angle_deg)`` in the world."""

    def __init__(self, min_area: float, dt: float, max_tracks: int,
                 host_dtype=torch.float64):
        self.min_area, self.dt, self.max_tracks = min_area, dt, max_tracks
        self.r = _rounder(host_dtype)
        self.tracks: List[Track] = []
        self.next_id = 0
        self.frame = -1

    def step(self, boxes) -> None:
        self.frame += 1
        dt, tracks = self.dt, self.tracks
        cands = [(oid, b) for oid, b in boxes
                 if oid > 0 and b[2] * b[3] >= self.min_area]
        choice = {}
        for oid, b in cands:
            best = None
            for tid, t in enumerate(tracks):
                score, roll, ok = _compare(t.rect.box, b, self.r)
                if ok and (best is None or score > best[0]):
                    best = (score, tid, roll)
            choice[oid] = best
        winner = {}
        for oid, _ in cands:
            c = choice[oid]
            if c is not None and (c[1] not in winner
                                  or c[0] > choice[winner[c[1]]][0]):
                winner[c[1]] = oid
        updated = set()
        for oid, b in cands:
            c = choice[oid]
            if c is not None and winner[c[1]] == oid:
                t = tracks[c[1]]
                t.age += 1.0
                t.rect.filter(dt, _rolled(b, c[2]))
                t.score.correct(dt, [1.0])
                t.oid, t.frame = oid, self.frame
                updated.add(c[1])
            else:
                tracks.append(Track(self.next_id, b, oid, self.frame,
                                    self.r))
                self.next_id += 1
        for tid in range(len(tracks)):
            if tid not in updated and tracks[tid].frame != self.frame:
                tracks[tid].age += dt
                tracks[tid].score.predict(dt, [0.0])
        live = [t for t in tracks if not t.dead()]
        if len(live) > self.max_tracks:
            keep = sorted(range(len(live)),
                          key=lambda i: (-float(live[i].score.v[0]), i))
            live = [live[i] for i in sorted(keep[:self.max_tracks])]
        self.tracks = live

    def state(self) -> dict:
        """``{id: (object matched at this frame or -1, box corners)}`` of
        the live tracks."""
        return {t.id: (t.oid if t.frame == self.frame else -1,
                       box_points(t.rect.box))
                for t in self.tracks}
