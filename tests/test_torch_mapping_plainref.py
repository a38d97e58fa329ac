"""The port's mapping pipeline against the benchmark's plain reference of
the mapping stage (``portbench/reference/mapping.py``, imported by path;
it imports nothing of the port), on the CPU at a 5 x 40 x 48 grid.

- Segmentation, objects and statistics: per-layer labels, the merged
  object of every voxel, voxel counts and boxes exact; centroids and the
  world top-view rectangles within the tolerances below; both backends.
- Tracking: six frames of moving blobs through one pipeline; the
  reference's tracker, fed each frame's objects as the pipeline made
  them, gives the same live track ids, the same matched objects, and
  filtered boxes within the tolerance below.
- Capacities: a layer over ``cc_max_labels_per_layer`` and objects over
  ``max_objects``: both sides report the drop.

The reference computed in bfloat16 fails the tolerances.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from ros_gpu_depthmap_fusion_tpu_torch.core.config import FusionConfig
from ros_gpu_depthmap_fusion_tpu_torch.core.grid import VoxelGrid
from ros_gpu_depthmap_fusion_tpu_torch.mapping import pipeline as mp
from ros_gpu_depthmap_fusion_tpu_torch.utils import native, profiling

_SPEC = importlib.util.spec_from_file_location(
    "portbench_reference_mapping",
    Path(__file__).resolve().parents[1] / "portbench" / "reference"
    / "mapping.py")
ref = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(ref)

ZYX = (5, 40, 48)
KW = dict(voxel_min=(-2.4, -2.0, 0.0), voxel_max=(2.4, 2.0, 0.5),
          voxel_size=(0.1, 0.1, 0.1), cc_max_labels_per_layer=64,
          max_objects=256, max_tracks=32, object_min_area=0.04)
# centroids, in voxels: the device backend and the reference divide exact
# sums in float32 (each mean of coordinates below 48 rounds within 48 *
# 2^-24 = 3e-6), the host backend in float64; bfloat16's 8-bit mantissa
# moves such a mean by up to 0.125
CENTROID_TOL = 1e-4
# world corners of rectangles and track boxes, in m: both sides compute in
# float64 from coordinates below 3 m (a few products and sums: 1e-14);
# a box corner's bfloat16 rounding there is up to 0.008 m
CORNER_TOL = 1e-9


@pytest.fixture
def need_native():
    if not native.available():
        pytest.skip("native host library not built")


@pytest.fixture(autouse=True)
def tracer():
    profiling.reset()
    yield
    profiling.enable(False)
    profiling.reset()


def blobs(rng, boxes=12, speckle=0.01, shift=0):
    """Random boxes a few cells wide and deep, shifted ``shift`` cells
    along x, plus speckle."""
    z, y, x = ZYX
    occ = np.zeros(ZYX, bool)
    for _ in range(boxes):
        x0, y0 = rng.integers(0, x - 12), rng.integers(0, y - 10)
        w, h = rng.integers(2, 9, 2)
        z0 = rng.integers(0, z - 1)
        occ[z0:z0 + int(rng.integers(1, 3)), y0:y0 + h,
            x0 + shift:x0 + shift + w] = True
    return occ | (rng.random(ZYX) < speckle)


def pipeline(backend, **kw):
    cfg = FusionConfig(**{**KW, "segmentation_backend": backend, **kw})
    grid = VoxelGrid.from_config(cfg)
    assert grid.shape_zyx == ZYX
    return mp.MappingPipeline(cfg, grid, "cpu"), cfg


def run(pipe, occ, monkeypatch):
    """One cycle of ``pipe`` on ``occ``; the result and the arguments the
    cycle passed to ``build_objects``."""
    seen = {}
    build = mp.build_objects

    def spy(**k):
        seen.update(k)
        return build(**k)
    monkeypatch.setattr(mp, "build_objects", spy)
    res = pipe.process(torch.from_numpy(occ.reshape(-1).astype(np.uint8)))
    monkeypatch.setattr(mp, "build_objects", build)
    return res, seen


def segment_ref(occ, cfg, dtype=torch.float32, host_dtype=torch.float64):
    return ref.segment(occ, cfg.cc_max_labels_per_layer, cfg.max_objects,
                       cfg.voxel_size, cfg.voxel_min, dtype, host_dtype)


def object_gaps(res, args, seg):
    """``(centroid gap in voxels, corner gap in m)``, the widest over the
    objects, after the exact checks."""
    nm = int(args["num_merged"])
    assert nm == seg.objects + 1
    labels = np.asarray(args["labels"]).astype(np.int64)
    assert np.array_equal(labels, seg.labels)
    mol = np.asarray(args["merged_of_label"])
    merged = np.take_along_axis(mol, labels.reshape(ZYX[0], -1), 1)
    obj_of = ref.merge_layers(seg.labels, seg.counts)
    assert np.array_equal(merged, np.take_along_axis(
        obj_of, seg.labels.reshape(ZYX[0], -1), 1))
    assert np.array_equal(args["voxel_count"][1:nm], seg.voxel_count[1:])
    assert np.array_equal(args["vmin"][1:nm], seg.vmin[1:])
    assert np.array_equal(args["vmax"][1:nm], seg.vmax[1:])
    cen = float(np.abs(np.asarray(args["centroid"][1:nm], np.float64)
                       - seg.centroid[1:]).max())
    corner = 0.0
    for k in range(1, nm):
        box = res.objects[k].topview.shapes.world.box
        corner = max(corner, min(ref.corner_gap(box.points(), r)
                                 for r in ref.min_area_rects(seg.topview[k])))
    return cen, corner


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("backend", ["device", "host"])
def test_segmentation_matches_plain_reference(need_native, backend, seed,
                                              monkeypatch):
    pipe, cfg = pipeline(backend)
    occ = blobs(np.random.default_rng(seed))
    res, args = run(pipe, occ, monkeypatch)
    seg = segment_ref(occ, cfg)
    assert seg.objects > 10 and seg.labels_dropped == 0
    cen, corner = object_gaps(res, args, seg)
    assert cen <= CENTROID_TOL and corner <= CORNER_TOL


@pytest.mark.parametrize("backend", ["device", "host"])
def test_tracks_match_plain_reference(need_native, backend, monkeypatch):
    pipe, cfg = pipeline(backend)
    tracker = ref.Tracker(cfg.object_min_area, cfg.tracking_dt,
                          cfg.max_tracks)
    rng = np.random.default_rng(7)
    state = rng.bit_generator.state
    gap, matched = 0.0, 0
    for f in range(6):
        rng.bit_generator.state = state        # the same blobs, moving
        occ = blobs(rng, speckle=0.0, shift=f)
        res, args = run(pipe, occ, monkeypatch)
        object_gaps(res, args, segment_ref(occ, cfg))
        index = {id(o): k for k, o in enumerate(res.objects)}
        tracker.step([(k, (o.topview.shapes.world.box.center[0],
                           o.topview.shapes.world.box.center[1],
                           o.topview.shapes.world.box.size[0],
                           o.topview.shapes.world.box.size[1],
                           o.topview.shapes.world.box.angle))
                      for k, o in enumerate(res.objects)
                      if o.topview is not None])
        want = tracker.state()
        got = {t.track_id: (index.get(id(t.last_object), -1),
                            t.rrect_filter.rrect.points())
               for t in res.tracks}
        assert sorted(got) == sorted(want)
        for tid, (oid, pts) in want.items():
            assert got[tid][0] == oid
            matched += oid >= 0
            gap = max(gap, float(np.abs(got[tid][1] - pts).max()))
    assert len(want) >= 5 and matched > 20
    assert gap <= CORNER_TOL


@pytest.mark.parametrize("what", ["labels", "objects"])
def test_capacity_drops_reported_on_both_sides(need_native, what,
                                               monkeypatch):
    occ = np.zeros(ZYX, bool)
    occ[2, 4:36:3, 4:44:4] = True           # 11 x 10 isolated cells
    n = int(occ.sum())
    kw = ({"cc_max_labels_per_layer": 64} if what == "labels"
          else {"cc_max_labels_per_layer": 256, "max_objects": 16})
    pipe, cfg = pipeline("device", **kw)
    profiling.enable()
    res, args = run(pipe, occ, monkeypatch)
    counters = profiling.snapshot()["counters"]
    seg = segment_ref(occ, cfg)
    if what == "labels":
        assert seg.labels_dropped == 1
        assert int((np.asarray(args["num_labels"])
                    >= cfg.cc_max_labels_per_layer).sum()) == 1
        assert counters["fusion.mapping.labels_dropped"] == 1
    else:
        assert seg.labels_dropped == 0 and seg.objects_dropped == n + 1 - 16
        assert counters["fusion.mapping.objects_dropped"] == n + 1 - 16
        assert counters["fusion.mapping.labels_dropped"] == 0


def test_bfloat16_reference_fails_the_tolerances(need_native, monkeypatch):
    pipe, cfg = pipeline("device")
    occ = blobs(np.random.default_rng(0))
    res, args = run(pipe, occ, monkeypatch)
    cen, corner = object_gaps(res, args, segment_ref(
        occ, cfg, torch.bfloat16, torch.bfloat16))
    assert cen > CENTROID_TOL and corner > CORNER_TOL
