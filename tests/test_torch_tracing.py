"""The port's tracer (``utils/profiling.py``) and the spans and counters
the port records with it: off it records nothing and opens no profiler
range; on, self time with nesting, a stack per thread, the frame id that
joins the worker's encode to the main thread's wait, counters and gauges,
and ``fusion.*`` ranges in a ``torch.profiler`` capture. A traced tiny
pipelined engine gives every engine span, its link counters add up to its
frames and its packet bytes to the packets' words; the component's sync
span, drop counters and ``enable_debug_output`` printout; the engine's
resolved partials capacity against the voxelizer's own; the mapping
cycle's spans and counters, equal to what the cycle itself returns, and
nothing of them with the tracer off."""

import json
import threading
import time

import numpy as np
import pytest
import torch

from ros_gpu_depthmap_fusion_tpu_torch.core.camera import PinholeIntrinsics
from ros_gpu_depthmap_fusion_tpu_torch.core.config import FusionConfig
from ros_gpu_depthmap_fusion_tpu_torch.core.grid import VoxelGrid
from ros_gpu_depthmap_fusion_tpu_torch.mapping import pipeline as mapmod
from ros_gpu_depthmap_fusion_tpu_torch.ops import voxelize as voxmod
from ros_gpu_depthmap_fusion_tpu_torch.pipeline.component import (
    FusionComponent)
from ros_gpu_depthmap_fusion_tpu_torch.pipeline.engine import FusionEngine
from ros_gpu_depthmap_fusion_tpu_torch.utils import native, profiling

EYE = np.eye(4, dtype=np.float32)
ENGINE_SPANS = ("fusion.engine.stage", "fusion.engine.encode",
                "fusion.engine.put", "fusion.engine.wait_encode",
                "fusion.step", "fusion.step.unpack", "fusion.step.lidar",
                "fusion.step.depth", "fusion.step.voxelize",
                "fusion.step.occupancy")
MAPPING_SPANS = ("fusion.mapping", "fusion.mapping.segment",
                 "fusion.mapping.fetch", "fusion.mapping.objects",
                 "fusion.mapping.track")
LINK_KINDS = ("fusion.link.iframes", "fusion.link.pframes",
              "fusion.link.p4frames", "fusion.link.raw_frames")


@pytest.fixture(autouse=True)
def tracer():
    """A clean tracer, switched off again after the test (it is
    process-wide)."""
    profiling.reset()
    yield profiling
    profiling.enable(False)
    profiling.reset()


@pytest.fixture
def need_native():
    if not native.available():
        pytest.skip("native library not built")


def rig_kw(**kw):
    """Two 32 x 24 cameras, one lidar stream, a 20^3-cell grid, and the
    bench link (p4 temporal depth, delta-coded lidar)."""
    base = dict(
        num_depth_streams=2, depth_height=24, depth_width=32,
        num_point_sequences=1,
        crop_min=(-5, -5, -5), crop_max=(5, 5, 5),
        voxel_min=(-5, -5, -5), voxel_max=(5, 5, 5),
        voxel_size=(0.5, 0.5, 0.5),
        rollbuffer_point_capacity=256, rollbuffer_seq_capacity=16,
        max_points_per_sequence=64, voxel_occupancy_lifetime=3,
        depth_link_codec="dpcm_temporal", depth_codec_quant_shift=3,
        depth_codec_hysteresis=2, depth_codec_p4_budget=16,
        depth_codec_keyframe_interval=4, depth_codec_max_exceptions=2048,
        lidar_link_quant_step=0.002, lidar_link_delta=True,
        occupancy_sparse_capacity=64, emit_occupancy_u8=False,
        emit_raw_points=False)
    base.update(kw)
    return base


def frames(n, seed=3, pattern_sigma=6.0):
    """``n`` frames (depth [2, 24, 32] u16, a lidar arc of 60 points,
    stamp) of a slanted wall with a fixed pattern, a little noise, holes
    and a sweeping step (a strong pattern codes wider spatially than
    temporally)."""
    rng = np.random.default_rng(seed)
    u = np.arange(32)[None, :] + np.zeros((24, 1))
    pattern = pattern_sigma * rng.standard_normal((2, 24, 32))
    t = np.linspace(0, np.pi, 60)
    arc = np.stack([0.8 * np.cos(t), 0.8 * np.sin(t),
                    1 + 0.1 * np.sin(5 * t)], -1).astype(np.float32)
    for f in range(n):
        d = 2000 + 40 * u + pattern + rng.standard_normal((2, 24, 32))
        d[:, 6:12, 4 + 3 * f:10 + 3 * f] -= 400
        d = d.astype(np.uint16)
        d[rng.random((2, 24, 32)) < 0.01] = 0
        yield d, arc + np.float32(0.01 * f), 1.0 + f / 30.0


def stage(eng, d, arc, now):
    intr = PinholeIntrinsics.default_for(32, 24)
    for i in range(2):
        eng.add_depthmap(i, d[i], intr, EYE, EYE)
    sec = int(now)
    eng.add_point_sequence(arc, sec, int((now - sec) * 1e9), EYE)


def traced_run(kw, n=10, pipeline_depth=1, pattern_sigma=6.0):
    """``n`` frames of a tiny engine on the CPU with the tracer on; the
    engine, the snapshot and the packet words each encode returned."""
    profiling.enable()
    eng = FusionEngine(FusionConfig(**kw), "cpu",
                       pipeline_depth=pipeline_depth)
    words = []
    encode = eng._encode

    def record(*a):
        w, bits = encode(*a)
        words.append(len(w))
        return w, bits
    eng._encode = record
    try:
        for d, arc, now in frames(n, pattern_sigma=pattern_sigma):
            stage(eng, d, arc, now)
            eng.process(now)
        eng.flush()
    finally:
        eng.close()
    return eng, profiling.snapshot(), words


# --- the tracer --------------------------------------------------------------

def test_tracer_off_records_nothing_and_opens_no_range(tmp_path):
    assert not profiling.enabled()
    assert profiling.span("fusion.a") is profiling.span("fusion.b", 3)
    with profiling.trace(str(tmp_path)):
        with profiling.span("fusion.a", 1):
            with profiling.span("fusion.b"):
                torch.ones(8).sum()
        profiling.count("fusion.frames")
        profiling.gauge("fusion.voxelize.partials_capacity", 5)
    assert profiling.snapshot() == {"spans": {}, "counters": {}}
    assert profiling.frame_spans(1) == {}
    with open(tmp_path / "trace.json") as fh:
        events = json.load(fh)
    events = events.get("traceEvents", []) if isinstance(events, dict) \
        else events
    assert not [e for e in events if str(e.get("name", "")).startswith(
        "fusion.")]


def test_tracer_self_time_with_nesting():
    profiling.enable()
    with profiling.span("fusion.outer", 7):
        time.sleep(0.01)
        with profiling.span("fusion.inner"):
            time.sleep(0.05)
        with profiling.span("fusion.inner"):
            pass
    spans = profiling.snapshot()["spans"]
    outer, n_outer = spans["fusion.outer"]
    inner, n_inner = spans["fusion.inner"]
    assert (n_outer, n_inner) == (1, 2)
    assert inner >= 0.05
    # the outer span's own time leaves out its children's
    assert 0.01 <= outer < 0.045
    # the inner spans inherit the enclosing span's frame
    assert set(profiling.frame_spans(7)) == {"fusion.outer", "fusion.inner"}


def test_tracer_threads_keep_separate_stacks():
    profiling.enable()

    def work():
        with profiling.span("fusion.worker"):
            time.sleep(0.03)

    with profiling.span("fusion.main", 2):
        th = threading.Thread(target=work)
        th.start()
        th.join(timeout=30)
    assert not th.is_alive()
    spans = profiling.snapshot()["spans"]
    # the worker's span is not a child of the main thread's, nor of its
    # frame: the main span's self time holds the whole join
    assert spans["fusion.main"][0] >= 0.03
    assert spans["fusion.worker"][1] == 1
    assert set(profiling.frame_spans(2)) == {"fusion.main"}


def test_tracer_counters_and_gauges():
    profiling.enable()
    profiling.count("fusion.frames")
    profiling.count("fusion.frames", np.int64(2))
    profiling.gauge("fusion.voxelize.partials_capacity", 10)
    profiling.gauge("fusion.voxelize.partials_capacity", 12)
    with profiling.span("fusion.step", 4):
        pass
    snap = profiling.snapshot()
    assert snap["counters"] == {"fusion.frames": 3,
                                "fusion.voxelize.partials_capacity": 12}
    assert snap["spans"]["fusion.step"][1] == 1
    text = profiling.report(4)
    assert "fusion frame 4" in text and "fusion.step" in text
    assert "fusion.voxelize.partials_capacity" in text
    assert f"{'fusion.frames':32s} 3" in text
    profiling.reset()
    assert profiling.snapshot() == {"spans": {}, "counters": {}}


def test_tracer_ranges_in_a_profiler_capture(tmp_path):
    profiling.enable()
    with profiling.trace(str(tmp_path)):
        with profiling.span("fusion.step", 0):
            with profiling.span("fusion.step.depth"):
                torch.ones(64).cumsum(0)
    with open(tmp_path / "trace.json") as fh:
        events = json.load(fh)
    events = events.get("traceEvents", []) if isinstance(events, dict) \
        else events
    ranges = {e["name"]: e for e in events
              if str(e.get("name", "")).startswith("fusion.")}
    assert set(ranges) == {"fusion.step", "fusion.step.depth"}
    outer, inner = ranges["fusion.step"], ranges["fusion.step.depth"]
    assert outer["ts"] <= inner["ts"]
    assert inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]
    # the spans are still counted
    assert profiling.snapshot()["spans"]["fusion.step"][1] == 1


# --- the engine's spans and counters ----------------------------------------

@pytest.mark.parametrize("kw,kinds", [
    (dict(), {"fusion.link.iframes", "fusion.link.p4frames"}),
    (dict(depth_codec_p4_budget=0, depth_codec_quant_shift=0,
          depth_codec_hysteresis=0, depth_codec_max_exceptions=128),
     {"fusion.link.iframes", "fusion.link.pframes"}),
    (dict(depth_link_codec="none"), {"fusion.link.raw_frames"}),
])
def test_traced_pipelined_engine(need_native, kw, kinds):
    n = 10
    eng, snap, words = traced_run(rig_kw(**kw), n, pattern_sigma=60.0)
    spans, counters = snap["spans"], snap["counters"]
    # wait_slot waits on a CUDA copy event: test_wait_slot_span
    assert set(ENGINE_SPANS) <= set(spans)
    assert spans["fusion.step"][1] == n
    assert spans["fusion.engine.wait_encode"][1] == n
    assert spans["fusion.engine.stage"][1] == 3 * n
    assert counters["fusion.frames"] == n
    assert sum(counters.get(k, 0) for k in LINK_KINDS) == n
    assert {k for k in LINK_KINDS if counters.get(k)} >= kinds
    assert counters["fusion.link.packet_bytes"] == 4 * sum(words)
    assert counters["fusion.ingest.lidar_points"] \
        + counters["fusion.ingest.lidar_dropped"] == 60 * n
    assert counters["fusion.voxelize.partials_capacity"] \
        == eng.partials_capacity
    # the worker thread's encode of a frame and the main thread's wait for
    # it share the frame's id
    for f in range(n):
        per = profiling.frame_spans(f)
        assert {"fusion.engine.stage", "fusion.engine.encode",
                "fusion.engine.wait_encode", "fusion.step"} <= set(per), f


def test_traced_synchronous_engine_spans_a_frame(need_native):
    eng, snap, _ = traced_run(rig_kw(), 4, pipeline_depth=0)
    assert "fusion.engine.wait_encode" not in snap["spans"]
    assert snap["counters"]["fusion.frames"] == 4
    per = profiling.frame_spans(2)
    assert set(ENGINE_SPANS) - {"fusion.engine.wait_encode"} <= set(per)


def test_wait_slot_span():
    """``clear()`` waits on the copy event of the packet it stages into
    next (a CUDA event on the card; a stand-in here)."""
    class Event:
        def __init__(self):
            self.waited = 0

        def synchronize(self):
            self.waited += 1

    profiling.enable()
    eng = FusionEngine(FusionConfig(**rig_kw(depth_link_codec="none")),
                       "cpu")
    ev = Event()
    eng._copied[eng._pkt_flip ^ 1] = ev
    frame = eng.frame_id
    eng.clear()
    assert ev.waited == 1 and eng.frame_id == frame + 1
    assert profiling.frame_spans(frame - 1)[
        "fusion.engine.wait_slot"][1] == 1


def test_lidar_drops_are_counted():
    profiling.enable()
    eng = FusionEngine(FusionConfig(**rig_kw(
        depth_link_codec="none", lidar_link_delta=False)), "cpu")
    pts = np.zeros((100, 3), np.float32)
    eng.add_point_sequence(pts, 1, 0, EYE)       # 64 staged, 36 dropped
    eng.add_point_sequence(pts, 1, 0, EYE)       # the stage is full
    c = profiling.snapshot()["counters"]
    assert c["fusion.ingest.lidar_points"] == 64
    assert c["fusion.ingest.lidar_dropped"] == 136


# --- the component -----------------------------------------------------------

def test_component_sync_span_drops_and_debug_printout(capsys):
    kw = rig_kw(depth_link_codec="none", lidar_link_delta=False,
                resample_rate=30.0, enable_debug_output=True)
    comp = FusionComponent(FusionConfig(**kw), "cpu")
    # the component traces its own callbacks only
    assert not profiling.enabled()
    intr = PinholeIntrinsics.default_for(32, 24)
    fr = list(frames(3))
    for k, (d, _, now) in enumerate(fr):
        comp.callback_depthmap(1, now, d[1], intr, EYE)
        comp.callback_depthmap(0, now, d[0], intr, EYE)
        if k == 1:
            # a second tuple before the tick replaces the stashed one
            comp.callback_depthmap(1, now + 1e-3, d[1], intr, EYE)
            comp.callback_depthmap(0, now + 1e-3, d[0], intr, EYE)
        comp.tick_resample(now)
    # five messages on an optional slot without a trigger: the queue of
    # four drops the oldest
    for k in range(5):
        comp.callback_depthmap(1, 10.0 + k, fr[0][0][1], intr, EYE)
    assert not profiling.enabled()
    # another engine in the process is not traced for the component
    other = FusionEngine(FusionConfig(**rig_kw(depth_link_codec="none",
                                               lidar_link_delta=False)),
                         "cpu")
    d, arc, now = fr[0]
    stage(other, d, arc, now)
    other.process(now)
    other.close()
    comp.engine.close()
    snap = profiling.snapshot()
    assert snap["spans"]["fusion.component.sync"][1] == 2 * 3 + 2 + 5
    assert snap["spans"]["fusion.step"][1] == 3
    assert snap["counters"]["fusion.component.stash_replaced"] == 1
    assert snap["counters"]["fusion.component.sync_dropped"] \
        == comp.sync.dropped >= 1
    assert snap["counters"]["fusion.frames"] == 3
    assert snap["counters"]["fusion.link.raw_frames"] == 3
    out = capsys.readouterr().out
    assert out.count("fusion frame ") == 3
    for name in ("fusion.component.sync", "fusion.engine.stage",
                 "fusion.engine.encode", "fusion.step.voxelize", "total"):
        assert name in out, name
    # the last printout's totals: every counter and the gauge
    last = out[out.rindex("fusion frame "):]
    for name in snap["counters"]:
        assert name in last, name
    assert f"{'fusion.frames':32s} 3" in last
    for name in ("fusion.frames", "fusion.link.raw_frames",
                 "fusion.link.packet_bytes", "fusion.link.exceptions",
                 "fusion.voxelize.partials_capacity"):
        assert name in snap["counters"], name


# --- the resolved partials capacity ------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(),                                    # split layout
    dict(emit_raw_points=True),                # one domain, lidar appended
    dict(voxelize_partials_capacity=700),      # stated
    dict(voxel_mean_mode="packed"),            # no level-1 partials
])
def test_partials_capacity_is_the_voxelizers(monkeypatch, kw):
    resolved = []
    orig = voxmod.resolve_partials_capacity

    def record(cap, n):
        resolved.append(orig(cap, n))
        return resolved[-1]
    monkeypatch.setattr(voxmod, "resolve_partials_capacity", record)
    eng = FusionEngine(FusionConfig(**rig_kw(depth_link_codec="none",
                                             **kw)), "cpu")
    d, arc, now = next(frames(1))
    stage(eng, d, arc, now)
    eng.process(now)
    assert resolved == ([eng.partials_capacity] if eng.partials_capacity
                        else [])


# --- the mapping cycle -------------------------------------------------------

def mapping_frames(n=4, seed=5):
    """``n`` flat ``[5 * 20 * 24]`` u8 occupancies: a few boxes drifting a
    cell a frame, plus speckle."""
    rng = np.random.default_rng(seed)
    boxes = [(int(rng.integers(0, 12)), int(rng.integers(0, 10)),
              int(rng.integers(2, 6)), int(rng.integers(2, 6)),
              int(rng.integers(0, 4))) for _ in range(5)]
    for f in range(n):
        occ = np.zeros((5, 20, 24), np.uint8)
        for x0, y0, w, h, z0 in boxes:
            occ[z0:z0 + 2, y0:y0 + h, x0 + f:x0 + f + w] = 1
        occ |= (rng.random(occ.shape) < 0.02).astype(np.uint8)
        yield torch.from_numpy(occ.reshape(-1))


def mapping_pipeline(backend, device="cpu", **kw):
    cfg = FusionConfig(voxel_min=(0, 0, 0), voxel_max=(2.4, 2.0, 0.5),
                       voxel_size=(0.1, 0.1, 0.1), max_objects=64,
                       segmentation_backend=backend, **kw)
    return mapmod.MappingPipeline(cfg, VoxelGrid.from_config(cfg), device)


@pytest.mark.parametrize("backend", ["device", "host"])
def test_mapping_spans_and_counters(need_native, backend, monkeypatch):
    """Each mapping span per cycle, ``process`` filed under its frame; the
    counters equal the cycles' own results: merged objects, iterations of
    the device's fixpoint loops, live tracks, and the cycles built from
    the device's foreground grouping (every device-backend cycle, no
    host-backend one) with the grouping's rows."""
    iters, rows = [], []
    segment, group = mapmod.segment, mapmod.group_foreground

    def spy(*a, **k):
        seg = segment(*a, **k)
        iters.append(seg.iterations)
        return seg

    def group_spy(seg):
        groups = group(seg)
        rows.append(int(groups.counts[0]))
        return groups
    monkeypatch.setattr(mapmod, "segment", spy)
    monkeypatch.setattr(mapmod, "group_foreground", group_spy)
    pipe = mapping_pipeline(backend)
    profiling.enable()
    results = [pipe.process(occ, frame=f)
               for f, occ in enumerate(mapping_frames())]
    snap = profiling.snapshot()
    for name in MAPPING_SPANS:
        assert snap["spans"][name][1] == 4, name
    assert set(profiling.frame_spans(2)) == set(MAPPING_SPANS)
    c = snap["counters"]
    assert c["fusion.mapping.cycles"] == 4
    assert c["fusion.mapping.objects"] == sum(r.num_merged - 1
                                              for r in results) > 8
    assert c["fusion.mapping.tracks"] == len(results[-1].tracks) > 0
    assert c["fusion.mapping.labels_dropped"] == 0
    assert c["fusion.mapping.objects_dropped"] == 0
    if backend == "device":
        assert c["fusion.mapping.cc_iterations"] == sum(
            i[0] for i in iters) >= 4 * 2
        assert c["fusion.mapping.merge_iterations"] == sum(
            i[1] for i in iters)
        assert c["fusion.mapping.grouped_cycles"] == 4
        assert c["fusion.mapping.foreground_cells"] == sum(rows) > 4 * 40
    else:
        assert not iters and "fusion.mapping.cc_iterations" not in c
        assert not rows and "fusion.mapping.grouped_cycles" not in c
        assert "fusion.mapping.foreground_cells" not in c
    assert "fusion.mapping.tracks" in profiling.report(2)


def test_mapping_entry_points_count_one_cycle_each(need_native):
    """``process_packed`` and ``process_sparse`` through the device
    backend, which unpacks the bitmap on its device and segments the grid:
    one cycle, one span each, the unpacking as ``unpack`` and the copies
    to the host as ``fetch``."""
    from ros_gpu_depthmap_fusion_tpu_torch.ops.voxel import (
        occupancy_bitmap, occupancy_bitmap_sparse)
    pipe = mapping_pipeline("device")
    occ = next(mapping_frames())
    profiling.enable()
    pipe.process_packed(occupancy_bitmap(occ))
    pipe.process_sparse(occupancy_bitmap_sparse(occ, 64))
    snap = profiling.snapshot()
    assert snap["counters"]["fusion.mapping.cycles"] == 2
    assert snap["spans"]["fusion.mapping"][1] == 2
    assert snap["spans"]["fusion.mapping.segment"][1] == 2
    # the bitmap, then the one the sparse blocks rebuild on the host
    assert snap["spans"]["fusion.mapping.unpack"][1] == 2
    # the segmentation's results; the sparse blocks, then the results
    assert snap["spans"]["fusion.mapping.fetch"][1] == 3


def test_mapping_records_nothing_with_tracer_off(need_native):
    from ros_gpu_depthmap_fusion_tpu_torch.ops.voxel import occupancy_bitmap
    for backend in ("device", "host"):
        pipe = mapping_pipeline(backend)
        for occ in mapping_frames(2):
            pipe.process(occ, frame=0)
        w = mapmod.AsyncMappingWorker(pipe, packed=True)
        try:
            for occ in mapping_frames(2):
                w.submit(occupancy_bitmap(occ), block=True, timeout=30)
            _wait_for(lambda: w.cycles >= 2)
        finally:
            w.close()
    assert profiling.snapshot() == {"spans": {}, "counters": {}}


def _wait_for(pred, timeout=30.0):
    t0 = time.monotonic()
    while not pred() and time.monotonic() - t0 < timeout:
        time.sleep(0.005)
    assert pred()


WORKER_SPANS = ("fusion.mapping.worker.submit", "fusion.mapping.worker.cycle")


@pytest.mark.parametrize("device", [
    "cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def test_mapping_worker_spans_counters_and_gauge(need_native, device):
    """A device-backend worker fed packed bitmaps with ``block=True``: its
    ``submit`` span (the submitting thread) and ``cycle`` span (the
    worker's, the pipeline's cycle inside it) once a submission, every
    submission mapped and none replaced, the gauge the latest cycle's dt
    in us. Each cycle unpacks the bitmap on the device
    (``fusion.mapping.unpack``) and copies only its results to the
    host."""
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from ros_gpu_depthmap_fusion_tpu_torch.ops.voxel import occupancy_bitmap
    pipe = mapping_pipeline("device", device)
    w = mapmod.AsyncMappingWorker(pipe, packed=True)
    profiling.enable()
    try:
        for occ in mapping_frames():
            w.submit(occupancy_bitmap(occ.to(device)), block=True,
                     timeout=30)
        _wait_for(lambda: w.cycles >= 4)
    finally:
        w.close()
    snap = profiling.snapshot()
    for name in WORKER_SPANS + MAPPING_SPANS + ("fusion.mapping.unpack",):
        assert snap["spans"][name][1] == 4, name
    c = snap["counters"]
    assert c["fusion.mapping.worker.submitted"] == 4
    assert c["fusion.mapping.worker.cycles"] == 4
    assert "fusion.mapping.worker.replaced" not in c
    assert c["fusion.mapping.worker.dt_us"] == round(w.latest().dt * 1e6)
    assert c["fusion.mapping.cycles"] == c["fusion.mapping.grouped_cycles"]


def test_mapping_worker_counts_replacements():
    """Drop-oldest: two submissions while a cycle runs, the first of them
    replaced by the second; three submitted, one replaced, two cycles."""
    gate, entered = threading.Event(), threading.Event()

    class Gated:
        cfg = FusionConfig()

        def process(self, occ, dt=None):
            entered.set()
            assert gate.wait(10)
            return occ

    w = mapmod.AsyncMappingWorker(Gated())
    profiling.enable()
    try:
        w.submit("a")
        assert entered.wait(10)
        w.submit("b")
        w.submit("c")
        gate.set()
        _wait_for(lambda: w.cycles >= 2)
    finally:
        w.close()
    c = profiling.snapshot()["counters"]
    assert (c["fusion.mapping.worker.submitted"],
            c["fusion.mapping.worker.replaced"],
            c["fusion.mapping.worker.cycles"]) == (3, 1, 2)
    assert w.latest() == "c"


@pytest.mark.parametrize("device", [
    "cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def test_segment_kernel_cycles(need_native, device):
    """The device backend's cycles on the card each run the CUDA chain:
    ``fusion.mapping.segment_kernel_cycles`` equals
    ``fusion.mapping.cycles``, and the chain adds no fixpoint iterations.
    On the CPU the twin runs, and the counter is absent. On both, every
    cycle builds its objects from the foreground grouping."""
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    pipe = mapping_pipeline("device", device)
    profiling.enable()
    for f, occ in enumerate(mapping_frames()):
        pipe.process(occ.to(device), frame=f)
    c = profiling.snapshot()["counters"]
    assert c["fusion.mapping.cycles"] == 4
    assert c["fusion.mapping.grouped_cycles"] == 4
    if device == "cuda":
        assert c["fusion.mapping.segment_kernel_cycles"] == 4
        assert c["fusion.mapping.cc_iterations"] == 0
        assert c["fusion.mapping.merge_iterations"] == 0
    else:
        assert "fusion.mapping.segment_kernel_cycles" not in c
        assert c["fusion.mapping.cc_iterations"] >= 4 * 2
