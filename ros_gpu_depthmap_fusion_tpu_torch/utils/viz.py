"""Visualization payload builders (numpy copy of the JAX package's
``utils/viz.py``, typed against the port's ``mapping`` objects).

Replaces the reference's RViz publishing (``_component.cpp:518-967``) with
renderer-agnostic structures: wireframe line lists for tracked-object boxes
(score-alpha coloring, score >= 0.65 display gate as at cpp:928) and the
centroid debug cloud (``out/VizPcl``, cpp:333-384).
"""

from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, List, Sequence

import numpy as np

if TYPE_CHECKING:  # avoid a circular import at runtime (tracking -> objects
    from ros_gpu_depthmap_fusion_tpu_torch.mapping.tracking import (
        CCObjectTrack)

SCORE_DISPLAY_THRESHOLD = 0.65  # _component.cpp:928


@dataclasses.dataclass
class WireframeMarker:
    """One tracked box as a line list (pairs of endpoints)."""
    track_id: int
    points: np.ndarray      # [K, 2, 3] line segments in world coords
    color_rgba: np.ndarray  # [4], alpha = track score
    score: float
    age: float


def track_wireframes(tracks: Sequence[CCObjectTrack],
                     z_range=(0.0, 2.0),
                     score_threshold: float = SCORE_DISPLAY_THRESHOLD
                     ) -> List[WireframeMarker]:
    """Box wireframes (12 edges) for tracks above the score gate."""
    out: List[WireframeMarker] = []
    z0, z1 = z_range
    for t in tracks:
        if t.score < score_threshold:
            continue
        corners2d = t.rrect_filter.rrect.points()         # [4, 2]
        bottom = np.concatenate(
            [corners2d, np.full((4, 1), z0)], axis=-1)
        top = np.concatenate(
            [corners2d, np.full((4, 1), z1)], axis=-1)
        segs = []
        for k in range(4):
            segs.append([bottom[k], bottom[(k + 1) % 4]])
            segs.append([top[k], top[(k + 1) % 4]])
            segs.append([bottom[k], top[k]])
        out.append(WireframeMarker(
            track_id=t.track_id, points=np.asarray(segs),
            color_rgba=np.array([0.1, 0.9, 0.2, min(1.0, t.score)]),
            score=t.score, age=t.age))
    return out


def centroid_cloud(objects) -> np.ndarray:
    """[N, 3] world centroids of segmented objects (skipping background)."""
    pts = []
    for o in objects[1:]:
        pts.append(o.center_coord_world)
    return np.asarray(pts, np.float32).reshape(-1, 3)


# ---------------------------------------------------------------------------
# Optional debug payloads — the reference keeps four ``if(false)`` viz
# blocks in visualizeObjects (_component.cpp:528-762); these builders
# provide the same payloads renderer-agnostically, opt-in at the call site
# exactly like flipping those blocks on.
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class TextMarker:
    """TEXT_VIEW_FACING analog (object-label texts, cpp:653-676)."""
    text: str
    position: np.ndarray    # [3] world
    color_rgba: np.ndarray


@dataclasses.dataclass
class LineListMarker:
    """LINE_LIST analog."""
    namespace: str
    points: np.ndarray      # [K, 2, 3] segments in world coords
    color_rgba: np.ndarray


def _component_centroids(obj, grid):
    """Per-layer component centroids of one object in world coords
    (the reference reads per-layer CC stats centroids, cpp:540-548; here
    each component's contour mean with the layer's cell-center z)."""
    cz = np.asarray(grid.cell_size, np.float64)[2]
    z0 = np.asarray(grid.lower, np.float64)[2]
    out = []
    for comp in obj.components:
        if len(comp.contour2d_world) == 0:
            continue
        xy = np.mean(np.asarray(comp.contour2d_world, np.float64), axis=0)
        out.append((comp.layer,
                    np.array([xy[0], xy[1], z0 + (comp.layer + 0.5) * cz])))
    return out


def layer_centroid_points(objects, grid) -> np.ndarray:
    """POINTS payload of per-layer component centroids (cpp:528-565).
    Returns [N, 3] world points (background object 0 skipped)."""
    pts = [c for o in objects[1:] for _, c in _component_centroids(o, grid)]
    return np.asarray(pts, np.float32).reshape(-1, 3)


def layer_connection_lines(objects, grid) -> LineListMarker:
    """LINE_LIST between connected components on adjacent layers
    (cpp:597-651: a line per nonzero entry of the layer-connection
    matrix). Here the cross-layer merge already ran, so the connected
    pairs are the adjacent-layer component pairs within each merged
    object."""
    segs = []
    for o in objects[1:]:
        cents = _component_centroids(o, grid)
        by_layer = {}
        for layer, c in cents:
            by_layer.setdefault(layer, []).append(c)
        for layer, lower in by_layer.items():
            for upper in by_layer.get(layer + 1, []):
                for c in lower:
                    segs.append([c, upper])
    return LineListMarker(
        namespace="gpu_cc_layer_connections",
        points=np.asarray(segs, np.float32).reshape(-1, 2, 3),
        color_rgba=np.array([1.0, 170 / 255.0, 0.0, 1.0]))


def object_id_texts(objects) -> List[TextMarker]:
    """Object-label text markers at object centers (cpp:653-676)."""
    return [TextMarker(text=str(o.label),
                       position=np.asarray(o.center_coord_world, np.float32),
                       color_rgba=np.array([1.0, 1.0, 0.0, 1.0]))
            for o in objects[1:]]


def _box_segments(corners: np.ndarray) -> np.ndarray:
    """12 edges from 8 corners ordered bottom quad then top quad
    (the reference's boxLinePoints table, cpp:786-805)."""
    idx = [(0, 1), (1, 2), (2, 3), (3, 0),
           (4, 5), (5, 6), (6, 7), (7, 4),
           (0, 4), (1, 5), (2, 6), (3, 7)]
    return np.asarray([[corners[a], corners[b]] for a, b in idx],
                      np.float32)


def object_aabb_wireframes(objects) -> List[LineListMarker]:
    """Axis-aligned bounding boxes of segmented objects (cpp:676-760)."""
    out = []
    for o in objects[1:]:
        lo = np.asarray(o.min_coord_world, np.float64)
        hi = np.asarray(o.max_coord_world, np.float64)
        corners = np.array([[x, y, z]
                            for z in (lo[2], hi[2])
                            for x, y in ((lo[0], lo[1]), (hi[0], lo[1]),
                                         (hi[0], hi[1]), (lo[0], hi[1]))])
        out.append(LineListMarker(
            namespace="gpu_cc_obj_boxes", points=_box_segments(corners),
            color_rgba=np.array([1.0, 1.0, 0.0, 1.0])))
    return out


def object_min_box_wireframes(objects) -> List[LineListMarker]:
    """Min-area-rect boxes of the topview, extruded over the object's z
    extent (the 4th disabled block, cpp:762-860)."""
    out = []
    for o in objects[1:]:
        if o.topview is None:
            continue
        rect = o.topview.shapes.world.box
        c2d = np.asarray(rect.points(), np.float64)     # [4, 2]
        z0 = float(o.min_coord_world[2])
        z1 = float(o.max_coord_world[2])
        corners = np.concatenate([
            np.concatenate([c2d, np.full((4, 1), z0)], axis=-1),
            np.concatenate([c2d, np.full((4, 1), z1)], axis=-1)], axis=0)
        out.append(LineListMarker(
            namespace="gpu_cc_obj_min_boxes", points=_box_segments(corners),
            color_rgba=np.array([0.0, 0.2, 1.0, 1.0])))
    return out
