"""Host-side 2-D computational geometry (a copy of the JAX package's
``mapping/geometry.py``; numpy only).

Replaces the OpenCV calls the reference leans on for object extraction
(no OpenCV dependency here):

- ``cv::minAreaRect``      -> :func:`min_area_rect` (convex hull + rotating
  calipers)
- ``cv::minEnclosingCircle``-> :func:`min_enclosing_circle` (Welzl)
- ``cv::findContours(RETR_EXTERNAL, CHAIN_APPROX_NONE)``
                           -> :func:`trace_external_contours` (Moore
  neighbor tracing on the binary mask, 8-connected, pixel chains)
- ``cv::RotatedRect``      -> :class:`RotatedRect`, with ``points()``
  reproducing OpenCV's exact corner formula so the tracker's best-of-4
  roll alignment (gpu_depthmap_fusion.cpp:2689-2714) behaves identically.

All functions operate on small per-object point sets (host numpy).
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Tuple

import numpy as np


@dataclasses.dataclass
class RotatedRect:
    """cv::RotatedRect-compatible: center (x, y), size (w, h), angle in
    degrees."""
    center: Tuple[float, float] = (0.0, 0.0)
    size: Tuple[float, float] = (0.0, 0.0)
    angle: float = 0.0

    def area(self) -> float:
        return float(self.size[0]) * float(self.size[1])

    def points(self) -> np.ndarray:
        """``[4, 2]`` corners, OpenCV's formula (types.cpp RotatedRect::points)."""
        _angle = math.radians(self.angle)
        b = math.cos(_angle) * 0.5
        a = math.sin(_angle) * 0.5
        cx, cy = self.center
        w, h = self.size
        p0 = (cx - a * h - b * w, cy + b * h - a * w)
        p1 = (cx + a * h - b * w, cy - b * h - a * w)
        p2 = (2 * cx - p0[0], 2 * cy - p0[1])
        p3 = (2 * cx - p1[0], 2 * cy - p1[1])
        return np.array([p0, p1, p2, p3], dtype=np.float64)


@dataclasses.dataclass
class EnclosingCircle:
    center: Tuple[float, float] = (0.0, 0.0)
    radius: float = 0.0


def _row_extremes(pts: np.ndarray) -> np.ndarray:
    """Per distinct y keep only the min-x and max-x points — a superset of
    the hull vertices (interior points of a row are never on the hull).
    Vectorized prefilter so the O(n) Python chain below runs on O(rows)."""
    order = np.lexsort((pts[:, 0], pts[:, 1]))
    p = pts[order]
    new_row = np.empty(len(p), dtype=bool)
    new_row[0] = True
    new_row[1:] = p[1:, 1] != p[:-1, 1]
    first = np.flatnonzero(new_row)
    last = np.concatenate([first[1:] - 1, [len(p) - 1]])
    return np.unique(np.concatenate([p[first], p[last]]), axis=0)


def convex_hull(points: np.ndarray) -> np.ndarray:
    """Andrew monotone chain; returns hull vertices CCW, ``[H, 2]``."""
    pts = np.asarray(points, dtype=np.float64)
    if len(pts) > 64:
        # skip the full dedup sort: the row-extreme prefilter already
        # lexsorts and a few residual duplicates are harmless to the chain
        pts = _row_extremes(pts)
    else:
        pts = np.unique(pts, axis=0)
    if len(pts) <= 2:
        return pts
    # sort by (x, y)
    order = np.lexsort((pts[:, 1], pts[:, 0]))
    pts = pts[order]

    def cross(o, a, b):
        return ((a[0] - o[0]) * (b[1] - o[1])
                - (a[1] - o[1]) * (b[0] - o[0]))

    lower: List[np.ndarray] = []
    for p in pts:
        while len(lower) >= 2 and cross(lower[-2], lower[-1], p) <= 0:
            lower.pop()
        lower.append(p)
    upper: List[np.ndarray] = []
    for p in pts[::-1]:
        while len(upper) >= 2 and cross(upper[-2], upper[-1], p) <= 0:
            upper.pop()
        upper.append(p)
    return np.array(lower[:-1] + upper[:-1])


def min_area_rect(points: np.ndarray) -> RotatedRect:
    """Minimum-area bounding rectangle via rotating calipers over hull
    edges (the classic result: one side is collinear with a hull edge)."""
    pts = np.asarray(points, dtype=np.float64)
    if len(pts) == 0:
        return RotatedRect()
    hull = convex_hull(pts)
    if len(hull) == 1:
        return RotatedRect((float(hull[0][0]), float(hull[0][1])), (0, 0), 0)
    if len(hull) == 2:
        d = hull[1] - hull[0]
        c = (hull[0] + hull[1]) / 2
        return RotatedRect((float(c[0]), float(c[1])),
                           (float(np.hypot(*d)), 0.0),
                           math.degrees(math.atan2(d[1], d[0])))
    # all candidate edges at once (rotating calipers, vectorized)
    e = np.roll(hull, -1, axis=0) - hull            # [N, 2]
    norms = np.hypot(e[:, 0], e[:, 1])
    keep = norms > 1e-12
    e = e[keep]
    norms = norms[keep]
    ux = e / norms[:, None]                         # [E, 2]
    uy = np.stack([-ux[:, 1], ux[:, 0]], axis=-1)
    px = hull @ ux.T                                # [N, E]
    py = hull @ uy.T
    pxm, pxM = px.min(axis=0), px.max(axis=0)
    pym, pyM = py.min(axis=0), py.max(axis=0)
    ws = pxM - pxm
    hs = pyM - pym
    i = int(np.argmin(ws * hs))
    w, h = float(ws[i]), float(hs[i])
    center = ((pxM[i] + pxm[i]) / 2) * ux[i] + ((pyM[i] + pym[i]) / 2) * uy[i]
    angle = math.degrees(math.atan2(ux[i, 1], ux[i, 0]))
    # normalize angle into [0, 90) with a size swap, mirroring the modern
    # OpenCV convention so downstream 90-degree wrap filters behave
    angle = angle % 180.0
    if angle >= 90.0:
        angle -= 90.0
        w, h = h, w
    return RotatedRect((float(center[0]), float(center[1])),
                       (float(w), float(h)), float(angle))


def min_enclosing_circle(points: np.ndarray,
                         rng_seed: int = 0) -> EnclosingCircle:
    """Welzl's algorithm (iterative, randomized)."""
    pts = np.unique(np.asarray(points, dtype=np.float64), axis=0)
    if len(pts) == 0:
        return EnclosingCircle()
    if len(pts) == 1:
        return EnclosingCircle((float(pts[0][0]), float(pts[0][1])), 0.0)
    rng = np.random.default_rng(rng_seed)
    p = pts[rng.permutation(len(pts))]

    def circle_two(a, b):
        c = (a + b) / 2
        return c, np.hypot(*(a - c))

    def circle_three(a, b, c):
        ax, ay = a
        bx, by = b
        cx, cy = c
        d = 2 * (ax * (by - cy) + bx * (cy - ay) + cx * (ay - by))
        if abs(d) < 1e-12:
            # collinear: span of farthest pair
            pairs = [(a, b), (a, c), (b, c)]
            far = max(pairs, key=lambda t: np.hypot(*(t[0] - t[1])))
            return circle_two(*far)
        ux = ((ax ** 2 + ay ** 2) * (by - cy) + (bx ** 2 + by ** 2) * (cy - ay)
              + (cx ** 2 + cy ** 2) * (ay - by)) / d
        uy = ((ax ** 2 + ay ** 2) * (cx - bx) + (bx ** 2 + by ** 2) * (ax - cx)
              + (cx ** 2 + cy ** 2) * (bx - ax)) / d
        ctr = np.array([ux, uy])
        return ctr, np.hypot(*(a - ctr))

    def inside(c, r, q, eps=1e-7):
        return np.hypot(*(q - c)) <= r + eps

    c, r = circle_two(p[0], p[1])
    for i in range(2, len(p)):
        if inside(c, r, p[i]):
            continue
        c, r = circle_two(p[0], p[i])
        for j in range(1, i):
            if inside(c, r, p[j]):
                continue
            c, r = circle_two(p[i], p[j])
            for k in range(j):
                if inside(c, r, p[k]):
                    continue
                c, r = circle_three(p[i], p[j], p[k])
    return EnclosingCircle((float(c[0]), float(c[1])), float(r))


# 8-neighborhood in clockwise order starting East (Moore tracing)
_MOORE = [(0, 1), (1, 1), (1, 0), (1, -1), (0, -1), (-1, -1), (-1, 0), (-1, 1)]


def trace_external_contours(mask: np.ndarray) -> List[np.ndarray]:
    """External contours of 8-connected components of a binary ``[H, W]``
    mask, one ``[K, 2]`` array of (x, y) pixel coordinates per component
    (full chains, like CHAIN_APPROX_NONE). Raster-scan start order matches
    OpenCV's outer-contour enumeration closely enough for the reference's
    contour->label assignment trick (cpp:1941-1952)."""
    m = np.asarray(mask) != 0
    h, w = m.shape
    visited_start = np.zeros_like(m, dtype=bool)
    labeled = _label8(m)
    done_labels = set()
    contours: List[np.ndarray] = []
    for y in range(h):
        for x in range(w):
            if not m[y, x]:
                continue
            lab = labeled[y, x]
            if lab in done_labels:
                continue
            done_labels.add(lab)
            contours.append(_trace_from(m, y, x))
    return contours


def _label8(m: np.ndarray) -> np.ndarray:
    """Small BFS 8-connected labeling (host oracle scale)."""
    h, w = m.shape
    lab = np.zeros((h, w), np.int32)
    nxt = 1
    from collections import deque
    for y in range(h):
        for x in range(w):
            if not m[y, x] or lab[y, x]:
                continue
            lab[y, x] = nxt
            dq = deque([(y, x)])
            while dq:
                cy, cx = dq.popleft()
                for dy, dx in _MOORE:
                    ny, nx_ = cy + dy, cx + dx
                    if 0 <= ny < h and 0 <= nx_ < w and m[ny, nx_] \
                            and not lab[ny, nx_]:
                        lab[ny, nx_] = nxt
                        dq.append((ny, nx_))
            nxt += 1
    return lab


def _trace_from(m: np.ndarray, sy: int, sx: int) -> np.ndarray:
    """Moore boundary tracing from the component's first raster pixel, with
    Jacob's stopping criterion (terminate on re-entering the start pixel in
    the initial crossing direction) — robust on 1-pixel-wide shapes."""
    h, w = m.shape

    def at(y, x):
        return 0 <= y < h and 0 <= x < w and m[y, x]

    contour = [(sx, sy)]
    cy, cx = sy, sx
    backtrack = 4  # we conceptually entered the start pixel from the West
    first_move = None
    while True:
        found_dir = -1
        for k in range(1, 9):
            d = (backtrack + k) % 8
            dy, dx = _MOORE[d]
            if at(cy + dy, cx + dx):
                found_dir = d
                break
        if found_dir < 0:  # isolated pixel
            return np.array(contour, dtype=np.int32)
        if (cy, cx) == (sy, sx):
            if first_move is None:
                first_move = found_dir
            elif found_dir == first_move and len(contour) > 1:
                contour.pop()  # drop the duplicate start re-entry
                return np.array(contour, dtype=np.int32)
        dy, dx = _MOORE[found_dir]
        cy, cx = cy + dy, cx + dx
        contour.append((cx, cy))
        backtrack = (found_dir + 4) % 8
        if len(contour) > 4 * h * w:  # safety backstop
            return np.array(contour, dtype=np.int32)
