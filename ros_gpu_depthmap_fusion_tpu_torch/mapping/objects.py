"""Segmented-object assembly, host side (a copy of the JAX package's
``mapping/objects.py``; numpy and the native library).

Builds the reference's ``CCObject`` structures
(``gpu_depthmap_fusion.h:33-113``, constructed at
``gpu_depthmap_fusion.cpp:2364-2550``) from the device
:class:`~..mapping.segmentation.SegmentationResult`: per merged label a
centroid, paired world/voxel min/max/center/AABB, per-component 2-D/3-D
contours, per-layer point sets, a topview, and min-area-rect /
min-enclosing-circle shapes for each (``MinShapes``, h:54-75).

Object index 0 is the background group, as in the reference (tracking skips
it, cpp:2776). Small-N per-frame host work; the heavy labeling already
happened on device.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from ros_gpu_depthmap_fusion_tpu_torch.core.grid import VoxelGrid
from ros_gpu_depthmap_fusion_tpu_torch.mapping import geometry as geo
from ros_gpu_depthmap_fusion_tpu_torch.utils import native


@dataclasses.dataclass
class MinShapes:
    box: geo.RotatedRect
    circle: geo.EnclosingCircle

    @staticmethod
    def of(points: np.ndarray) -> "MinShapes":
        if len(points) == 0:
            return MinShapes(geo.RotatedRect(), geo.EnclosingCircle())
        # both min shapes are determined by the convex hull; reducing to it
        # first keeps the host-side cost O(hull) for large point sets
        hull = geo.convex_hull(points) if len(points) > 8 else points
        return MinShapes(geo.min_area_rect(hull),
                         geo.min_enclosing_circle(hull))


def shape_pair(points_voxel: np.ndarray, grid: VoxelGrid) -> "ShapePair":
    """World + voxel MinShapes for one 2-D point set, computing the convex
    hull ONCE on the integer voxel points: hulls are affine-invariant, so
    the world-frame shapes are fit on the affinely mapped hull vertices
    (exact, and ~an order of magnitude cheaper than hulling float world
    points per frame)."""
    if len(points_voxel) == 0:
        empty = MinShapes(geo.RotatedRect(), geo.EnclosingCircle())
        return ShapePair(empty, empty)
    hull_v = (geo.convex_hull(points_voxel)
              if len(points_voxel) > 8 else np.asarray(points_voxel,
                                                       np.float64))
    hull_w = _voxel_xy_to_world(grid, hull_v)
    return ShapePair(
        world=MinShapes(geo.min_area_rect(hull_w),
                        geo.min_enclosing_circle(hull_w)),
        voxel=MinShapes(geo.min_area_rect(hull_v),
                        geo.min_enclosing_circle(hull_v)))


@dataclasses.dataclass
class ShapePair:
    """CCObject::Pair<MinShapes, MinShapes> — world + voxel coordinates."""
    world: MinShapes
    voxel: MinShapes


@dataclasses.dataclass
class ObjectComponent:
    """One per-layer connected component of an object."""
    layer: int
    local_label: int
    contour2d_voxel: np.ndarray   # [K, 2] (x, y) pixels
    contour2d_world: np.ndarray   # [K, 2] world (x, y)
    contour3d_voxel: np.ndarray   # [K, 3]
    contour3d_world: np.ndarray   # [K, 3]
    shapes: ShapePair


@dataclasses.dataclass
class ObjectLayer:
    layer: int
    points2d_voxel: np.ndarray    # [K, 2]
    points2d_world: np.ndarray    # [K, 2]
    shapes: ShapePair


@dataclasses.dataclass
class CCObject:
    label: int
    centroid: Tuple[float, float]           # voxel (x, y)
    num_components: int
    num_layers: int
    center_coord_world: np.ndarray          # [3]
    center_coord_voxel: np.ndarray          # [3]
    min_coord_voxel: np.ndarray             # [3] int
    max_coord_voxel: np.ndarray             # [3] int
    min_coord_world: np.ndarray
    max_coord_world: np.ndarray
    aabb_size_voxel: np.ndarray
    aabb_size_world: np.ndarray
    components: List[ObjectComponent]
    layers: List[ObjectLayer]
    topview: Optional[ObjectLayer]


def _voxel_xy_to_world(grid: VoxelGrid, pts: np.ndarray) -> np.ndarray:
    """Voxel (x, y) -> world (x, y), lower-corner convention
    (voxelCoordToWorldCoord, cpp:1720-1730)."""
    cs = np.asarray(grid.cell_size[:2], np.float64)
    lo = np.asarray(grid.lower[:2], np.float64)
    return np.asarray(pts, np.float64) * cs + lo


def _voxel_xyz_to_world(grid: VoxelGrid, pts: np.ndarray) -> np.ndarray:
    cs = np.asarray(grid.cell_size, np.float64)
    lo = np.asarray(grid.lower, np.float64)
    return np.asarray(pts, np.float64) * cs + lo


class StubCCObject:
    """Lazy stats-only object for pruned merged ids.

    Duck-types the CCObject stats fields (components/layers/topview are
    always empty; tracking skips it at the ``topview is None`` check).
    Construction is O(1) — on cluttered grids thousands of sub-min-area
    specks exist per frame and eagerly materializing full CCObjects for
    them dominated the mapping cycle."""

    __slots__ = ("label", "_cen", "_mn", "_mx", "_grid")
    num_components = 0
    num_layers = 0
    components: tuple = ()
    layers: tuple = ()
    topview = None

    def __init__(self, m, cen, mn, mx, grid):
        self.label = m
        self._cen = cen
        self._mn = mn
        self._mx = mx
        self._grid = grid

    @property
    def centroid(self):
        return (float(self._cen[0]), float(self._cen[1]))

    @property
    def min_coord_voxel(self):
        return self._mn

    @property
    def max_coord_voxel(self):
        return self._mx

    @property
    def center_coord_voxel(self):
        return (self._mn + self._mx) / 2.0

    @property
    def center_coord_world(self):
        return _voxel_xyz_to_world(self._grid, self.center_coord_voxel)

    @property
    def min_coord_world(self):
        return _voxel_xyz_to_world(self._grid, self._mn)

    @property
    def max_coord_world(self):
        return _voxel_xyz_to_world(self._grid, self._mx)

    @property
    def aabb_size_voxel(self):
        return self._mx - self._mn

    @property
    def aabb_size_world(self):
        return self.max_coord_world - self.min_coord_world


_STUB_ZEROS3 = np.zeros(3, np.int64)


def _stats_stub(m: int, voxel_count, centroid, vmin, vmax,
                grid: VoxelGrid) -> StubCCObject:
    """Stats-only stub (no components/layers/topview)."""
    inb = m < len(vmin)
    return StubCCObject(
        m,
        centroid[m] if m < len(centroid) else _STUB_ZEROS3,
        vmin[m] if inb else _STUB_ZEROS3,
        vmax[m] if inb else _STUB_ZEROS3, grid)


def _take(a, keep: np.ndarray) -> np.ndarray:
    """Rows ``keep`` of ``a`` after a zero row (the background), zeros
    where ``keep`` runs past ``a``."""
    a = np.asarray(a)
    out = np.zeros((len(keep) + 1,) + a.shape[1:], a.dtype)
    ok = keep < len(a)
    out[1:][ok] = a[keep[ok]]
    return out


def _select_groups(grouping: dict, keep: np.ndarray, z: int) -> dict:
    """The grouping of the objects ``keep`` alone, renumbered 1, 2, ... in
    their order: what the grouping of the native call's remapped lookup
    table would be."""
    gs = grouping["group_start"]
    lo, hi = gs[keep * z], gs[(keep + 1) * z]
    sizes = np.diff(gs)[(keep[:, None] * z + np.arange(z)).reshape(-1)]
    starts = np.zeros((len(keep) + 1) * z + 1, np.int64)
    np.cumsum(sizes, out=starts[z + 1:])
    n = hi - lo
    rows = np.repeat(lo - (np.cumsum(n) - n), n) + np.arange(n.sum())
    remap = np.zeros((len(gs) - 1) // z, np.int32)
    remap[keep] = np.arange(1, len(keep) + 1, dtype=np.int32)
    comps = grouping["comps"]
    comps = comps[remap[comps[:, 2]] > 0]
    comps[:, 2] = remap[comps[:, 2]]
    return dict(group_start=starts, pts_xy=grouping["pts_xy"][rows],
                comps=comps)


def _assembled(labels, merged_of_label, num_merged: int, voxel_count,
               centroid, vmin, vmax, grid: VoxelGrid,
               detail_mask: Optional[np.ndarray],
               grouping: Optional[dict]) -> Optional[List[CCObject]]:
    """Objects with contours from the native assembly over ``labels``, or
    from a foreground grouping when one is given (the same flat arrays);
    with a ``detail_mask`` the kept objects are assembled and the rest are
    stubs. ``None`` when the assembly reports an overflow."""
    stats = (voxel_count, centroid, vmin, vmax)
    keep, m = None, num_merged
    if detail_mask is not None:
        keep = np.flatnonzero(np.asarray(detail_mask)[:num_merged])
        keep = keep[keep > 0].astype(np.int64)
        m = len(keep) + 1
        stats = tuple(_take(a, keep) for a in stats)
    cs, lo = grid.cell_size[:2], grid.lower[:2]
    if grouping is not None:
        if keep is not None:
            grouping = _select_groups(grouping, keep, labels.shape[0])
        res = native.assemble_grouped(labels, grouping, m, cs, lo)
    else:
        lut = merged_of_label
        if keep is not None:
            remap = np.zeros(max(num_merged, 1), np.int32)
            remap[keep] = np.arange(1, m, dtype=np.int32)
            lut = remap[np.clip(merged_of_label, 0, num_merged - 1)]
        res = native.assemble_objects(labels, lut, m, cs, lo)
    if res is None:
        return None
    objects = _objects_from_flat(res, m, *stats, grid)
    if keep is None:
        return objects
    by_old = dict(zip(keep.tolist(), objects[1:]))
    out = []
    for k in range(num_merged):
        obj = by_old.get(k)
        if obj is not None:
            obj.label = k
            out.append(obj)
        else:
            out.append(_stats_stub(k, voxel_count, centroid, vmin, vmax,
                                   grid))
    return out


def build_objects(labels: np.ndarray,
                  num_labels: np.ndarray,
                  merged_of_label: np.ndarray,
                  num_merged: int,
                  voxel_count: np.ndarray,
                  centroid: np.ndarray,
                  vmin: np.ndarray,
                  vmax: np.ndarray,
                  grid: VoxelGrid,
                  with_contours: bool = True,
                  background_full: bool = False,
                  detail_mask: Optional[np.ndarray] = None,
                  grouping: Optional[dict] = None
                  ) -> List[CCObject]:
    """Assemble CCObjects from (host copies of) the segmentation outputs.

    Args:
        labels: ``[Z, Y, X]`` per-layer dense labels.
        merged_of_label: ``[Z, L]``.
        background_full: build contours/layers for the background object too
            (the reference does; it is then skipped by tracking). Default
            False keeps index 0 as a stats-only stub to save host time.
        detail_mask: optional ``[num_merged]`` bool — objects with False
            get stats-only stubs (no contours/hulls/shapes). The mapping
            pipeline prunes objects below ``object_min_area`` this way:
            they are provably skipped by tracking (min-rect area <= AABB
            area), and on cluttered/noisy grids the speck objects dominate
            assembly cost by an order of magnitude.
        grouping: optional foreground grouping of these labels
            (``mapping/segmentation.py grouping_arrays``, made on the
            device): the geometry is then fitted over it
            (``native.assemble_grouped``) instead of over passes of the
            native call across every cell; the objects are the same.
    """
    num_merged = int(num_merged)
    if with_contours and not background_full:
        objects = _assembled(labels, merged_of_label, num_merged,
                             voxel_count, centroid, vmin, vmax, grid,
                             detail_mask, grouping)
        if objects is not None:
            return objects

    z_layers, h, w = labels.shape
    objects: List[CCObject] = []
    merged_map = np.take(merged_of_label.reshape(-1),
                         (np.arange(z_layers)[:, None, None]
                          * merged_of_label.shape[1] + labels))

    for m in range(int(num_merged)):
        cnt = int(voxel_count[m]) if m < len(voxel_count) else 0
        cen = centroid[m] if m < len(centroid) else np.zeros(3)
        mn = vmin[m].astype(np.int64) if m < len(vmin) else np.zeros(3, int)
        mx = vmax[m].astype(np.int64) if m < len(vmax) else np.zeros(3, int)
        detail = with_contours and (m > 0 or background_full) and (
            detail_mask is None or bool(detail_mask[m]))

        components: List[ObjectComponent] = []
        layer_objs: List[ObjectLayer] = []
        topview = None
        if detail and cnt > 0:
            top_pts = []
            for z in range(z_layers):
                in_layer = merged_map[z] == m
                if not in_layer.any():
                    continue
                ys, xs = np.nonzero(in_layer)
                pts2d = np.stack([xs, ys], axis=-1)
                top_pts.append(pts2d)
                pts2d_w = _voxel_xy_to_world(grid, pts2d)
                layer_objs.append(ObjectLayer(
                    layer=z, points2d_voxel=pts2d, points2d_world=pts2d_w,
                    shapes=shape_pair(pts2d, grid)))
                # one component per local label present in this layer
                locals_here = np.unique(labels[z][in_layer])
                for l in locals_here:
                    if l == 0 and not background_full:
                        continue
                    comp_mask = (labels[z] == l) & in_layer
                    cy, cx = np.unravel_index(
                        np.argmax(comp_mask), comp_mask.shape)
                    contour = native.trace_contour(comp_mask, int(cy),
                                                   int(cx))
                    contour_w = _voxel_xy_to_world(grid, contour)
                    z_w = z * grid.cell_size[2] + grid.lower[2]
                    c3v = np.concatenate(
                        [contour, np.full((len(contour), 1), z)], axis=-1)
                    c3w = np.concatenate(
                        [contour_w, np.full((len(contour), 1), z_w)], axis=-1)
                    components.append(ObjectComponent(
                        layer=z, local_label=int(l),
                        contour2d_voxel=contour, contour2d_world=contour_w,
                        contour3d_voxel=c3v, contour3d_world=c3w,
                        shapes=shape_pair(contour, grid)))
            if top_pts:
                tv = np.unique(np.concatenate(top_pts, axis=0), axis=0)
                tv_w = _voxel_xy_to_world(grid, tv)
                topview = ObjectLayer(
                    layer=-1, points2d_voxel=tv, points2d_world=tv_w,
                    shapes=shape_pair(tv, grid))

        center_vox = (mn + mx) / 2.0
        objects.append(CCObject(
            label=m,
            centroid=(float(cen[0]), float(cen[1])),
            num_components=len(components),
            num_layers=len(layer_objs),
            center_coord_voxel=center_vox,
            center_coord_world=_voxel_xyz_to_world(grid, center_vox),
            min_coord_voxel=mn, max_coord_voxel=mx,
            min_coord_world=_voxel_xyz_to_world(grid, mn),
            max_coord_world=_voxel_xyz_to_world(grid, mx),
            aabb_size_voxel=mx - mn,
            aabb_size_world=_voxel_xyz_to_world(grid, mx)
            - _voxel_xyz_to_world(grid, mn),
            components=components, layers=layer_objs, topview=topview))
    return objects


def _shapes_from16(row: list) -> ShapePair:
    """Decode one shape record of an assembly (a list of 16 floats):
    voxel (rect cx,cy,w,h,angle; circle cx,cy,r) then world (same 8)."""
    vox = MinShapes(geo.RotatedRect((row[0], row[1]), (row[2], row[3]),
                                    row[4]),
                    geo.EnclosingCircle((row[5], row[6]), row[7]))
    wrl = MinShapes(geo.RotatedRect((row[8], row[9]), (row[10], row[11]),
                                    row[12]),
                    geo.EnclosingCircle((row[13], row[14]), row[15]))
    return ShapePair(wrl, vox)


def _objects_from_flat(res: dict, num_merged: int,
                       voxel_count: np.ndarray, centroid: np.ndarray,
                       vmin: np.ndarray, vmax: np.ndarray,
                       grid: VoxelGrid) -> List[CCObject]:
    """Build the CCObject list from the flat arrays of an assembly
    (``native.assemble_objects`` or ``native.assemble_grouped``: grouping,
    hulls, shapes and contours all computed in C++). Points, top views and
    contours are mapped to world coordinates once each, and the 3-D
    contours built once; layers and components get views of them."""
    z_layers = res["num_layers"]
    gs = res["group_start"]
    pts = res["pts_xy"]
    tvs = res["tv_start"]
    tvp = res["tv_xy"]
    comp_zlm = res["comp_zlm"]
    cst = res["contour_start"]
    nc = len(comp_zlm)
    cxy = res["contour_xy"][:int(cst[nc])]
    pts_w = _voxel_xy_to_world(grid, pts)
    tv_w = _voxel_xy_to_world(grid, tvp)
    z_world = (np.arange(z_layers) * grid.cell_size[2] + grid.lower[2])
    comp_z = np.repeat(comp_zlm[:, 0], np.diff(cst))
    c3v = np.concatenate([cxy, comp_z[:, None].astype(np.int64)], axis=-1)
    cxy_w = _voxel_xy_to_world(grid, cxy)
    c3w = np.concatenate([cxy_w, z_world[comp_z][:, None]], axis=-1)
    lsh = res["layer_shapes"].tolist()
    tsh = res["tv_shapes"].tolist()
    csh = res["comp_shapes"].tolist()
    gs_l, tvs_l, cst_l = gs.tolist(), tvs.tolist(), cst.tolist()
    zlm = comp_zlm.tolist()

    # every object's statistics and box at once; objects past the
    # statistics' slots read zeros
    n = num_merged
    cen = np.zeros((n, 2))
    mn, mx = np.zeros((n, 3), np.int64), np.zeros((n, 3), np.int64)
    cen[:min(n, len(centroid))] = centroid[:n, :2]
    mn[:min(n, len(vmin))] = vmin[:n]
    mx[:min(n, len(vmax))] = vmax[:n]
    cen_l = cen.tolist()
    center = (mn + mx) / 2.0
    center_w = _voxel_xyz_to_world(grid, center)
    mn_w, mx_w = _voxel_xyz_to_world(grid, mn), _voxel_xyz_to_world(grid, mx)
    size, size_w = mx - mn, mx_w - mn_w

    # pre-bucket component rows per merged label (keeps (z, local) order)
    comp_rows_of: List[List[int]] = [[] for _ in range(num_merged)]
    for ci, (_, _, m) in enumerate(zlm):
        if 0 <= m < num_merged:
            comp_rows_of[m].append(ci)

    objects: List[CCObject] = []
    for m in range(num_merged):
        components: List[ObjectComponent] = []
        layer_objs: List[ObjectLayer] = []
        topview = None
        if m > 0:
            for z in range(z_layers):
                g = m * z_layers + z
                lo, hi = gs_l[g], gs_l[g + 1]
                if hi == lo:
                    continue
                layer_objs.append(ObjectLayer(
                    z, pts[lo:hi], pts_w[lo:hi], _shapes_from16(lsh[g])))
            for ci in comp_rows_of[m]:
                lo, hi = cst_l[ci], cst_l[ci + 1]
                components.append(ObjectComponent(
                    zlm[ci][0], zlm[ci][1], cxy[lo:hi], cxy_w[lo:hi],
                    c3v[lo:hi], c3w[lo:hi], _shapes_from16(csh[ci])))
            lo, hi = tvs_l[m], tvs_l[m + 1]
            if hi > lo:
                topview = ObjectLayer(-1, tvp[lo:hi], tv_w[lo:hi],
                                      _shapes_from16(tsh[m]))
        objects.append(CCObject(
            label=m, centroid=tuple(cen_l[m]),
            num_components=len(components), num_layers=len(layer_objs),
            center_coord_world=center_w[m], center_coord_voxel=center[m],
            min_coord_voxel=mn[m], max_coord_voxel=mx[m],
            min_coord_world=mn_w[m], max_coord_world=mx_w[m],
            aabb_size_voxel=size[m], aabb_size_world=size_w[m],
            components=components, layers=layer_objs, topview=topview))
    return objects
