"""The port's mapping (``ros_gpu_depthmap_fusion_tpu_torch.mapping``) against
the JAX package's, on the CPU.

Segmentation: the port's ``label_layers``, ``layer_connections``,
``merge_labels`` and ``segment`` against the jitted JAX program (as
``tests/test_mapping_core.py`` runs it) on that file's grids; integer
outputs bit-equal, and the centroid bit-equal because every per-object
coordinate sum of these grids is below 2^24 (asserted). Against the native
host segmentation: integers exact, centroid within 1e-4 (float32 against
float64). Objects, tracks and ``MappingResult``s: bit-equal, compared field
by field through every nested object.

The native host library is loaded here through the port's
``native.require()`` path (a private-name build renamed into place) when
this module is imported, before anything calls into the JAX package's
mapping; tests that need it skip only where that build fails.
"""

import functools
import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ros_gpu_depthmap_fusion_tpu_torch.utils import native as tnative

_NATIVE = tnative.available()

from ros_gpu_depthmap_fusion_tpu.core.config import FusionConfig as JCfg  # noqa: E402,E501
from ros_gpu_depthmap_fusion_tpu.core.grid import VoxelGrid as JGrid  # noqa: E402,E501
from ros_gpu_depthmap_fusion_tpu.mapping import (  # noqa: E402
    objects as jobj, segmentation as jseg, tracking as jtrk)
from ros_gpu_depthmap_fusion_tpu.mapping.pipeline import (  # noqa: E402
    MappingPipeline as JPipeline)
from ros_gpu_depthmap_fusion_tpu.utils import native as jnative  # noqa: E402

from ros_gpu_depthmap_fusion_tpu_torch.core.config import FusionConfig as TCfg  # noqa: E402,E501
from ros_gpu_depthmap_fusion_tpu_torch.core.grid import VoxelGrid as TGrid  # noqa: E402,E501
from ros_gpu_depthmap_fusion_tpu_torch.mapping import (  # noqa: E402
    objects as tobj, segmentation as tseg, tracking as ttrk)
from ros_gpu_depthmap_fusion_tpu_torch.mapping.pipeline import (  # noqa: E402
    AsyncMappingWorker, MappingPipeline)
from ros_gpu_depthmap_fusion_tpu_torch.ops.voxel import (  # noqa: E402
    occupancy_bitmap, occupancy_bitmap_sparse, unpack_bitmap)

from test_torch_cuda import (  # noqa: E402
    GROUPING_GRIDS, ZYX, assert_same, grouping_grid, mapping_scene as scene)


@pytest.fixture
def need_native():
    if not _NATIVE:
        pytest.skip(f"native host library did not build: {tnative._error}")


# --- grids (tests/test_mapping_core.py) ------------------------------------

def _box_grid(rng, z=7, y=40, x=48, boxes=10, speckle=0.02):
    occ = np.zeros((z, y, x), bool)
    for _ in range(boxes):
        x0, y0 = rng.integers(0, x - 10), rng.integers(0, y - 10)
        w, h = rng.integers(2, 9, 2)
        z0 = rng.integers(0, z - 2)
        occ[z0:z0 + int(rng.integers(1, 4)), y0:y0 + h, x0:x0 + w] = True
    return occ | (rng.random((z, y, x)) < speckle)


def _zigzag():
    occ = np.zeros((6, 4, 20), bool)
    for k in range(6):
        occ[k, 1:3, 2 * k: 2 * k + 4] = True
    return occ


def _snake():
    occ = np.zeros((1, 10, 30), bool)
    occ[0, 0, :] = True
    occ[0, 1:, -1] = True
    occ[0, -1, ::2] = True
    return occ


def grid_case(name):
    """(occupancy [Z, Y, X] bool, max_labels, max_objects)."""
    if name == "dense":
        return np.random.default_rng(0).random((3, 20, 24)) < 0.35, 128, 32
    if name == "zigzag":
        return _zigzag(), 16, 8
    if name.startswith("boxes"):
        rng = np.random.default_rng(11)
        for _ in range(int(name[-1]) + 1):
            occ = _box_grid(rng)
        return occ, 64, 32
    if name == "clamped":   # ~220 merged objects into 4 stats slots
        return _box_grid(np.random.default_rng(11)), 64, 4
    raise KeyError(name)


GRIDS = ["dense", "zigzag", "boxes0", "boxes1", "boxes2", "clamped"]


@functools.lru_cache(maxsize=None)
def _jax_segment(max_labels, max_objects):
    return jax.jit(functools.partial(jseg.segment, max_labels=max_labels,
                                     max_objects=max_objects))


def _assert_sums_below_2_24(occ, merged_map, m):
    ids = np.where(occ, np.minimum(merged_map, m - 1), m).reshape(-1)
    zz, yy, xx = np.meshgrid(*[np.arange(s) for s in occ.shape],
                             indexing="ij")
    for c in (xx, yy, zz):
        sums = np.bincount(ids, weights=c.reshape(-1), minlength=m + 1)
        assert sums.max() < 2 ** 24


@pytest.mark.parametrize("name", GRIDS)
def test_segment_matches_jax(name):
    """Every field of ``segment`` bit-equal to the jitted JAX program,
    and the port's ``label_layers`` / ``layer_connections`` /
    ``merge_labels`` equal to the JAX program's labels, connections and
    merge table on the same grid. On the CPU ``segment`` runs its plain
    twin: the fixpoint loops' iterations counted, no CUDA launch and no
    ``segment_kernel_cycles`` with the tracer on."""
    from ros_gpu_depthmap_fusion_tpu_torch.utils import profiling
    occ, l, m = grid_case(name)
    j = _jax_segment(l, m)(occ.astype(np.uint8))
    before = tseg.launches
    profiling.reset()
    profiling.enable()
    try:
        t = tseg.segment(torch.from_numpy(occ.astype(np.uint8)), l, m)
        counters = profiling.snapshot()["counters"]
    finally:
        profiling.enable(False)
        profiling.reset()
    assert tseg.launches == before and counters == {}
    assert min(t.iterations) >= 1
    _assert_sums_below_2_24(occ, np.asarray(j.merged_map), m)
    for f in jseg.SegmentationResult._fields:
        a, b = np.asarray(getattr(j, f)), getattr(t, f).numpy()
        assert a.dtype == b.dtype, (f, a.dtype, b.dtype)
        np.testing.assert_array_equal(b, a, err_msg=f)
    labels, num = tseg.label_layers(torch.from_numpy(occ), l)
    np.testing.assert_array_equal(labels.numpy(), np.asarray(j.labels))
    np.testing.assert_array_equal(num.numpy(), np.asarray(j.num_labels))
    conn = tseg.layer_connections(labels, l)
    np.testing.assert_array_equal(
        conn.numpy(), np.asarray(jseg.layer_connections(j.labels, l)))
    mr = tseg.merge_labels(conn, num, l)
    np.testing.assert_array_equal(mr.merged_of_label.numpy(),
                                  np.asarray(j.merged_of_label))
    assert int(mr.num_merged) == int(j.num_merged)
    assert t.iterations[0] >= 2 and t.iterations[1] >= 1
    if name == "clamped":
        assert int(t.num_merged) > m


def test_label_layers_snake_matches_jax():
    """A single-layer snake (the JAX ``segment`` needs two layers; its
    ``layer_connections`` cannot reshape an empty stack, the port's can)."""
    occ = _snake()
    jl, jn = jseg.label_layers(jnp.asarray(occ), 64)
    tl, tn = tseg.label_layers(torch.from_numpy(occ), 64)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    assert tuple(tseg.layer_connections(tl, 64).shape) == (0, 64, 64)
    assert int(tseg.segment(torch.from_numpy(occ), 64, 8).num_merged) == \
        int(jn[0])


def test_segment_chain_input_checks():
    """What the CUDA chain takes (``check_chain_input``, which ``segment``
    applies to a CUDA tensor before any launch, with its device's shared
    memory; here the H100's): a contiguous bool or uint8 ``[Z, Y, X]``
    stack within the kernels' 32-bit indices and grid, and a merge table
    and object slots that fit one block's shared memory; anything else
    raises ``ValueError`` naming it. ``segment`` refuses a device that is
    neither the CPU nor CUDA."""
    optin = 232448
    table, slots = tseg.chain_limits(optin)
    assert (table, slots) == (57856, 4450)

    def check(occ, l, m):
        tseg.check_chain_input(occ, l, m, optin)

    def meta(*shape):       # no memory: the checks read only the shape
        return torch.empty(shape, dtype=torch.bool, device="meta")
    lim = table // 256
    for dtype in (torch.bool, torch.uint8):
        check(torch.zeros((lim, 2, 3), dtype=dtype), 256, slots)
    check(meta(1, 65535 * 32, 1), 256, 64)
    check(meta(1, 1, 2 ** 27), 256, 64)
    check(meta(1, 2 ** 15, 2 ** 15 - 1), 256, 64)
    extents = "1 <= Z <= 65535"
    bad = [
        (torch.zeros((2, 4, 4), dtype=torch.int32), 256, 64, "bool or uint8"),
        (torch.zeros((2, 4, 4), dtype=torch.float32), 256, 64,
         "bool or uint8"),
        (torch.zeros((2, 4, 6), dtype=torch.uint8)[:, :, ::2], 256, 64,
         "contiguous"),
        (torch.zeros((2, 4, 4), dtype=torch.bool).transpose(0, 2), 256, 64,
         "contiguous"),
        (torch.zeros((4, 4), dtype=torch.bool), 256, 64, r"\[Z, Y, X\]"),
        (torch.zeros((2, 0, 4), dtype=torch.bool), 256, 64, extents),
        (meta(65536, 1, 1), 1, 64, extents),
        (meta(1, 65535 * 32 + 1, 1), 256, 64, extents),
        (meta(1, 1, 2 ** 27 + 1), 256, 64, extents),
        (meta(1, 2 ** 15, 2 ** 15), 256, 64, extents),
        (torch.zeros((lim + 1, 2, 3), dtype=torch.bool), 256, 64,
         "merge table"),
        (torch.zeros((2, 2, 3), dtype=torch.bool), 256, slots + 1,
         "max_objects"),
        (torch.zeros((2, 2, 3), dtype=torch.bool), 0, 64, "at least 1")]
    for occ, l, m, what in bad:
        with pytest.raises(ValueError, match=what):
            check(occ, l, m)
    with pytest.raises(ValueError, match="unsupported device meta"):
        tseg.segment(meta(2, 4, 4), 256, 64)


@pytest.mark.parametrize("name", ["boxes0", "boxes1", "boxes2", "clamped"])
def test_segment_matches_native(need_native, name):
    """The port's device program against the native host segmentation
    (through the port's binding) with the same caps."""
    occ, l, m = grid_case(name)
    t = tseg.segment(torch.from_numpy(occ), l, m)
    res = tnative.segment_grid(occ, l, m)
    for f in ("labels", "num_labels", "merged_of_label", "voxel_count",
              "vmin", "vmax"):
        np.testing.assert_array_equal(res[f], getattr(t, f).numpy(),
                                      err_msg=f)
    assert res["num_merged"] == int(t.num_merged)
    np.testing.assert_allclose(res["centroid"], t.centroid.numpy(),
                               rtol=0, atol=1e-4)


# --- objects + tracking ----------------------------------------------------

CELL = (0.125, 0.125, 0.25)


def map_kw(**kw):
    base = dict(voxel_min=(0.0, 0.0, 0.0),
                voxel_max=(ZYX[2] * CELL[0], ZYX[1] * CELL[1],
                           ZYX[0] * CELL[2]),
                voxel_size=CELL, cc_max_labels_per_layer=64, max_objects=32)
    base.update(kw)
    return base


@pytest.mark.parametrize("detail", [False, True])
def test_objects_and_tracks_match_jax(need_native, detail):
    """``build_objects`` (native assembly) and ``track_objects`` over five
    frames from one host segmentation: objects, tracks (filter states
    included) and stats bit-equal."""
    grid = TGrid.from_config(TCfg(**map_kw()))
    jgrid = JGrid.from_config(JCfg(**map_kw()))
    jtracks, ttracks = [], []
    for occ in scene():
        res = tnative.segment_grid(occ, 64, 32)
        nm = res["num_merged"]
        mask = None
        if detail:
            mask = np.zeros(nm, bool)
            mask[: min(nm, 32)] = res["voxel_count"][: min(nm, 32)] > 6
        kw = dict(labels=res["labels"], num_labels=res["num_labels"],
                  merged_of_label=res["merged_of_label"], num_merged=nm,
                  voxel_count=res["voxel_count"], centroid=res["centroid"],
                  vmin=res["vmin"], vmax=res["vmax"], detail_mask=mask)
        jo = jobj.build_objects(grid=jgrid, **kw)
        to = tobj.build_objects(grid=grid, **kw)
        assert_same(jo, to, "objects")
        js = jtrk.track_objects(jo, jtracks, 0.04, 1 / 30, max_tracks=8)
        ts = ttrk.track_objects(to, ttracks, 0.04, 1 / 30, max_tracks=8)
        assert_same(js, ts, "stats")
        assert_same(jtracks, ttracks, "tracks")
    assert len(ttracks) > 0 and ttracks[0].age > 1


@pytest.mark.parametrize("name", GROUPING_GRIDS)
def test_grouped_assembly_equals_native(need_native, name, monkeypatch):
    """The foreground grouping (its twin, from the device segmentation's
    twin) and the host geometry over it (``native.assemble_grouped``) give
    ``native.assemble_objects``' dict over the labels, array for array in
    values and dtypes; ``build_objects`` with the grouping gives the
    objects it gives without, field for field, with no detail mask and
    with one that keeps two objects in three, and never calls the native
    assembly. On the mapping tests' frames and the edge cases: an empty
    grid, one-cell objects, objects on all four edges, one object of 238
    components a layer, merged objects past ``max_objects`` and a layer
    past ``cc_max_labels_per_layer``."""
    occ, lab, objs = grouping_grid(name)
    seg = tseg.segment(torch.from_numpy(occ), lab, objs)
    groups = tseg.group_foreground(seg)
    fg, nc = groups.counts.tolist()
    nm, z = int(seg.num_merged), occ.shape[0]
    used = tseg.group_rows_used(fg, nc, nm, z)
    assert fg == int(occ.sum()) and not groups.rows[used:].any()
    grouping = tseg.grouping_arrays(fg, nc, nm, z, groups.rows.numpy())
    labels = seg.labels.numpy().astype(np.uint16)
    mol = seg.merged_of_label.numpy()
    grid = TGrid.from_config(TCfg(**map_kw()))
    at = (grid.cell_size[:2], grid.lower[:2])
    assert_same(tnative.assemble_objects(labels, mol, nm, *at),
                tnative.assemble_grouped(labels, grouping, nm, *at),
                "assembly")
    kw = dict(labels=labels, num_labels=seg.num_labels.numpy(),
              merged_of_label=mol, num_merged=nm,
              voxel_count=seg.voxel_count.numpy(),
              centroid=seg.centroid.numpy(), vmin=seg.vmin.numpy(),
              vmax=seg.vmax.numpy(), grid=grid)

    def no_native(*a, **k):
        raise AssertionError("the grouped path called the native assembly")
    for mask in (None, np.arange(nm) % 3 != 1):
        want = tobj.build_objects(detail_mask=mask, **kw)
        with monkeypatch.context() as mp:
            mp.setattr(tnative, "assemble_objects", no_native)
            got = tobj.build_objects(detail_mask=mask, grouping=grouping,
                                     **kw)
        assert_same(want, got, f"objects, mask {mask is not None}")
    comps_z = grouping["comps"][:, 0]
    if name == "empty":
        assert nm == 1 and fg == nc == 0
    elif name == "single_cells":
        assert nm - 1 == nc == fg
    elif name == "many_components":
        assert nm == 2 and (comps_z == 1).sum() == 238
    elif name == "objects_folded":
        assert nm > objs
    elif name == "labels_at_capacity":
        assert int(seg.num_labels[2]) == lab and (comps_z == 2).sum() == 15
    else:
        assert nm > 2 and nc > nm


def test_native_labeling_and_contours_match_jax(need_native):
    """The port's ``cc_label`` and ``trace_contour`` bindings return what
    the JAX package's bindings of the same library return, bit for bit."""
    rng = np.random.default_rng(2)
    img = rng.random((40, 50)) < 0.35
    for a, b in zip(jnative.cc_label(img), tnative.cc_label(img)):
        assert_same(np.asarray(a), np.asarray(b), "cc_label")
    ring = np.zeros((15, 15), bool)
    yy, xx = np.mgrid[0:15, 0:15]
    r = np.hypot(yy - 7, xx - 7)
    ring[(r > 4.5) & (r < 5.5)] = True
    labels = tnative.cc_label(img)[0]
    for mask in [ring] + [labels == k for k in (1, 2, 3)]:
        ys, xs = np.nonzero(mask)
        assert_same(jnative.trace_contour(mask, int(ys[0]), int(xs[0])),
                    tnative.trace_contour(mask, int(ys[0]), int(xs[0])),
                    "trace_contour")


def test_objects_python_assembly_matches_jax(need_native, monkeypatch):
    """With the native assembly reporting an overflow (``None``) both
    packages assemble in Python, tracing contours natively: bit-equal."""
    occ = next(scene())
    res = tnative.segment_grid(occ, 64, 32)
    kw = dict(labels=res["labels"], num_labels=res["num_labels"],
              merged_of_label=res["merged_of_label"],
              num_merged=res["num_merged"], voxel_count=res["voxel_count"],
              centroid=res["centroid"], vmin=res["vmin"], vmax=res["vmax"])
    monkeypatch.setattr(jnative, "assemble_objects", lambda *a, **k: None)
    monkeypatch.setattr(tnative, "assemble_objects", lambda *a, **k: None)
    jo = jobj.build_objects(grid=JGrid.from_config(JCfg(**map_kw())), **kw)
    to = tobj.build_objects(grid=TGrid.from_config(TCfg(**map_kw())), **kw)
    assert_same(jo, to, "objects")
    assert sum(o.num_components for o in to) > 0


def _inputs(occ, capacity):
    """The fused step's mapping outputs for one frame, from the port's ops
    on the CPU: flat u8 occupancy, packed bits, and the sparse tuple with
    its dense fallback."""
    flat = torch.from_numpy(occ.reshape(-1).astype(np.int32))
    bits = occupancy_bitmap(flat)
    sparse = occupancy_bitmap_sparse(flat, capacity)
    return flat.to(torch.uint8), bits, tuple(sparse) + (bits,)


ENTRIES = ("process", "process_packed", "process_sparse",
           "process_sparse", "process_sparse")


@pytest.mark.parametrize("backend", ["host", "device"])
@pytest.mark.parametrize("detail_min_area", [0.0, -1.0])
def test_mapping_pipeline_matches_jax(need_native, backend,
                                      detail_min_area):
    """Five frames through ``process``, ``process_packed`` and
    ``process_sparse`` (frame 3 overflows its 4-block capacity and takes
    the dense fallback) of one pipeline each, so tracks evolve:
    ``MappingResult``s bit-equal to the JAX pipeline's."""
    kw = map_kw(segmentation_backend=backend,
                mapping_detail_min_area=detail_min_area)
    tp = MappingPipeline(TCfg(**kw), TGrid.from_config(TCfg(**kw)), "cpu")
    jp = JPipeline(JCfg(**kw), JGrid.from_config(JCfg(**kw)))
    assert tp.backend == jp.backend == backend
    for f, (occ, entry) in enumerate(zip(scene(), ENTRIES)):
        cap = 4 if f == 3 else 256
        u8, bits, sparse = _inputs(occ, cap)
        if entry == "process":
            t_arg, j_arg = u8, jnp.asarray(u8.numpy())
        elif entry == "process_packed":
            t_arg, j_arg = bits, bits.numpy()
        else:
            t_arg, j_arg = sparse, tuple(a.numpy() for a in sparse)
            assert (int(sparse[3]) > cap) == (f == 3)
        t_res = getattr(tp, entry)(t_arg, dt=0.05)
        j_res = getattr(jp, entry)(j_arg, dt=0.05)
        assert_same(j_res, t_res, f"frame {f} {entry}")
        assert t_res.num_merged > 2
    assert len(t_res.tracks) > 0
    if backend == "host":
        assert len(tp.last_phase_ms) == 3


@pytest.mark.parametrize("backend", ["host", "device"])
def test_process_host_grid_matches_jax(need_native, backend):
    """``mapping/pipeline.py:199 process_host_grid`` (the sharded engine's
    mapping step): five host-assembled grids through one pipeline each,
    ``MappingResult``s bit-equal to the JAX pipeline's; the host
    segmentation runs whatever the configured backend."""
    kw = map_kw(segmentation_backend=backend)
    tp = MappingPipeline(TCfg(**kw), TGrid.from_config(TCfg(**kw)), "cpu")
    jp = JPipeline(JCfg(**kw), JGrid.from_config(JCfg(**kw)))
    for f, occ in enumerate(scene()):
        t_res = tp.process_host_grid(occ, dt=0.05)
        j_res = jp.process_host_grid(occ, dt=0.05)
        assert_same(j_res, t_res, f"frame {f} process_host_grid")
        assert t_res.num_merged > 2
    assert len(t_res.tracks) > 0


def test_sparse_overflow_without_fallback_raises():
    kw = map_kw(segmentation_backend="device")
    tp = MappingPipeline(TCfg(**kw), TGrid.from_config(TCfg(**kw)), "cpu")
    _, _, sparse = _inputs(next(scene()), 4)
    with pytest.raises(ValueError, match="overflowed its capacity"):
        tp.process_sparse(sparse[:4])
    with pytest.raises(ValueError, match="no dense fallback"):
        tp.process_sparse(sparse[:4] + (None,))


def test_pipeline_needs_explicit_device_and_known_backend():
    kw = map_kw(segmentation_backend="device")
    grid = TGrid.from_config(TCfg(**kw))
    with pytest.raises(TypeError):
        MappingPipeline(TCfg(**kw), grid)
    with pytest.raises(ValueError, match="segmentation_backend"):
        MappingPipeline(TCfg(**map_kw(segmentation_backend="gpu")), grid,
                        "cpu")


def test_host_backend_raises_without_native(monkeypatch):
    """No silent switch to the device program when the library is
    missing (the JAX pipeline switches)."""
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "_tried", True)
    monkeypatch.setattr(tnative, "_error", "test: no library")
    kw = map_kw(segmentation_backend="host")
    with pytest.raises(RuntimeError, match="no library"):
        MappingPipeline(TCfg(**kw), TGrid.from_config(TCfg(**kw)), "cpu")
    auto = MappingPipeline(TCfg(**map_kw()), TGrid.from_config(TCfg(
        **map_kw())), "cpu")
    assert auto.backend == "device"


# --- AsyncMappingWorker ----------------------------------------------------

class _Cfg:
    tracking_dt = 1.0 / 30.0


class _FakePipeline:
    """Records what each cycle got; ``gate`` (if set) holds a cycle until
    released; ``fail`` makes a cycle raise."""
    cfg = _Cfg()

    def __init__(self, gate=None, fail=False):
        self.seen, self.dts = [], []
        self.gate, self.fail = gate, fail
        self.entered = threading.Event()

    def process(self, occ, dt=None):
        self.entered.set()
        if self.gate is not None:
            assert self.gate.wait(10)
        if self.fail:
            raise RuntimeError(f"cycle failed on {occ}")
        self.seen.append(occ)
        self.dts.append(dt)
        return occ

    process_packed = process


def _wait(pred, timeout=10.0):
    t0 = time.monotonic()
    while not pred() and time.monotonic() - t0 < timeout:
        time.sleep(0.005)
    assert pred()


def test_async_worker_passes_measured_wallclock_dt():
    """As ``tests/test_mapping_core.py:308``: the first cycle gets the
    nominal dt, the next the measured wall time since it."""
    pipe = _FakePipeline()
    w = AsyncMappingWorker(pipe)
    try:
        w.submit("grid0")
        _wait(lambda: w.cycles >= 1)
        time.sleep(0.25)
        w.submit("grid1")
        _wait(lambda: w.cycles >= 2)
    finally:
        w.close()
    assert pipe.seen == ["grid0", "grid1"]
    assert pipe.dts[0] == _Cfg.tracking_dt
    assert 0.2 <= pipe.dts[1] <= AsyncMappingWorker.dt_max
    assert not w._thread.is_alive()


def test_async_worker_replaces_stale_submission():
    """Queue depth 1, drop-oldest: while a cycle runs, a newer submission
    replaces the one waiting, and the worker then maps the newest."""
    gate = threading.Event()
    pipe = _FakePipeline(gate=gate)
    w = AsyncMappingWorker(pipe, packed=True)
    try:
        w.submit("a")
        assert pipe.entered.wait(10)
        w.submit("b")
        w.submit("c")
        gate.set()
        _wait(lambda: w.cycles >= 2)
        time.sleep(0.2)
    finally:
        w.close()
    assert pipe.seen == ["a", "c"] and w.cycles == 2
    assert w.latest() == "c"


def test_async_worker_under_fast_thread_switching():
    """500 submissions under a 1 us thread switch interval: the worker maps
    an increasing subsequence of them that ends with the last one, and
    counts each cycle once."""
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    pipe = _FakePipeline()
    w = AsyncMappingWorker(pipe)
    try:
        for k in range(500):
            w.submit(k)
        _wait(lambda: 499 in pipe.seen)
    finally:
        w.close()
        sys.setswitchinterval(old)
    assert not w._thread.is_alive()
    assert pipe.seen == sorted(set(pipe.seen)) and pipe.seen[-1] == 499
    assert w.cycles == len(pipe.seen) and w.latest() == 499


def test_async_worker_surfaces_its_exception():
    pipe = _FakePipeline(fail=True)
    w = AsyncMappingWorker(pipe)
    w.submit("bad")
    _wait(lambda: not w._thread.is_alive())
    with pytest.raises(RuntimeError, match="cycle failed on bad"):
        w.latest()
    with pytest.raises(RuntimeError, match="cycle failed on bad"):
        w.submit("next")
    with pytest.raises(RuntimeError, match="cycle failed on bad"):
        w.close()
    assert w.cycles == 0


def test_async_worker_sparse_cycles_match_sync(need_native):
    """The worker on real sparse submissions (CPU tensors): each cycle's
    result equals a synchronous pipeline's on the same frame and dt."""
    kw = map_kw(segmentation_backend="host")
    grid = TGrid.from_config(TCfg(**kw))
    ref = MappingPipeline(TCfg(**kw), grid, "cpu")
    pipe = MappingPipeline(TCfg(**kw), grid, "cpu")
    dts = []
    orig = pipe.process_sparse

    def recording(sparse, dt=None):
        dts.append(dt)
        return orig(sparse, dt=dt)
    pipe.process_sparse = recording
    w = AsyncMappingWorker(pipe)
    try:
        for f, occ in enumerate(scene(3)):
            sparse = _inputs(occ, 256)[2]
            w.submit(sparse)
            _wait(lambda: w.cycles >= f + 1)
            assert_same(w.latest(), ref.process_sparse(sparse, dt=dts[f]),
                        f"cycle {f}")
    finally:
        w.close()
    assert dts[0] == TCfg().tracking_dt and len(ref.tracks) > 0


def test_async_worker_blocking_submit_maps_every_submission():
    """``submit(block=True)`` waits for the slot: 60 submissions to a
    worker slower than the loop are all mapped, in order, none replaced."""
    pipe = _FakePipeline()
    orig = pipe.process

    def slow(occ, dt=None):
        time.sleep(0.002)
        return orig(occ, dt=dt)
    pipe.process = slow
    w = AsyncMappingWorker(pipe)
    try:
        for k in range(60):
            w.submit(k, block=True, timeout=10)
        _wait(lambda: w.cycles >= 60)
    finally:
        w.close()
    assert pipe.seen == list(range(60)) and w.cycles == 60
    assert pipe.dts[0] == _Cfg.tracking_dt
    assert all(_Cfg.tracking_dt <= d <= AsyncMappingWorker.dt_max
               for d in pipe.dts)


def test_async_worker_blocking_submit_raises_while_it_waits():
    """A blocked ``submit`` raises the worker's exception once the cycle
    in progress fails, and ``TimeoutError`` when its time runs out."""
    gate = threading.Event()
    pipe = _FakePipeline(gate=gate)
    w = AsyncMappingWorker(pipe)
    try:
        w.submit("a", block=True)
        assert pipe.entered.wait(10)
        w.submit("b", block=True)          # waits in the slot
        t0 = time.monotonic()
        with pytest.raises(TimeoutError):
            w.submit("c", block=True, timeout=0.2)
        assert 0.2 <= time.monotonic() - t0 < 5
        pipe.fail = True
        timer = threading.Timer(0.2, gate.set)
        timer.start()
        with pytest.raises(RuntimeError, match="cycle failed on a"):
            w.submit("c", block=True, timeout=10)
        timer.join(10)
    finally:
        gate.set()
        with pytest.raises(RuntimeError, match="cycle failed on a"):
            w.close()
    assert not w._thread.is_alive() and pipe.seen == []


def test_unpack_bitmap_inverts_the_packing():
    rng = np.random.default_rng(3)
    for n in (1, 7, 8, 9, 1000, 4099):
        cells = (rng.random(n) < 0.3).astype(np.int32)
        packed = occupancy_bitmap(torch.from_numpy(cells))
        out = unpack_bitmap(packed, n)
        assert out.dtype == torch.uint8
        assert np.array_equal(out.numpy(), np.unpackbits(
            packed.numpy(), bitorder="little", count=n))
        assert np.array_equal(out.numpy(), cells)


@pytest.mark.parametrize("entry", ["process_packed", "process_sparse"])
def test_async_worker_results_equal_sync_cycles(need_native, entry):
    """A device-backend worker fed with ``block=True``: every result,
    its ``dt`` included, equals a synchronous pipeline's ``process_packed``
    / ``process_sparse`` on the same bits with the same ``dt``."""
    kw = map_kw(segmentation_backend="device")
    grid = TGrid.from_config(TCfg(**kw))
    pipe = MappingPipeline(TCfg(**kw), grid, "cpu")
    ref = MappingPipeline(TCfg(**kw), grid, "cpu")
    results = []
    orig = getattr(pipe, entry)

    def recording(occ, dt=None):
        res = orig(occ, dt=dt)
        results.append(res)
        return res
    setattr(pipe, entry, recording)
    subs = []
    for occ in scene(5):
        _, bits, sparse = _inputs(occ, 4)
        subs.append(bits if entry == "process_packed" else sparse)
    w = AsyncMappingWorker(pipe, packed=True)
    try:
        for f, sub in enumerate(subs):
            w.submit(sub, block=True, timeout=30)
            _wait(lambda: w.cycles >= f + 1)
            # the tracks are the pipeline's live list: compared before the
            # next cycle moves them
            res = results[f]
            assert_same(res, getattr(ref, entry)(sub, dt=res.dt),
                        f"cycle {f}")
            time.sleep(0.05)
    finally:
        w.close()
    assert len(results) == len(subs) and len(ref.tracks) > 0
    assert results[0].dt == TCfg().tracking_dt
    assert all(r.dt > TCfg().tracking_dt for r in results[1:])
