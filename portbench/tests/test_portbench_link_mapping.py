"""The link-mapping cell (``entries/link_mapping.py``) on a tiny rig
through ``run.py``'s code on the CPU: correct as the port runs it, every
frame mapped; not correct for each fault planted in the worker's
tracking or objects: a cycle tracked with the nominal dt while it
reports the measured one, one cycle's tracking skipped, a top-view box
moved 20 mm; and the control fails."""

import time

import pytest
import torch

import control_node
import run

CELL = "hafen_link.mapping"


def _pipe():
    import ros_gpu_depthmap_fusion_tpu_torch.mapping.pipeline as pipe
    return pipe


def _on_call(mp, name, k, broken):
    """``mapping/pipeline.py``'s ``name`` replaced by ``broken(orig, *a,
    **kw)`` on its ``k``-th call (1-based)."""
    pipe = _pipe()
    orig = getattr(pipe, name)
    calls = []

    def fn(*a, **kw):
        calls.append(1)
        if len(calls) == k:
            return broken(orig, *a, **kw)
        return orig(*a, **kw)
    mp.setattr(pipe, name, fn)


def compared_cycle() -> int:
    """The 1-based cycle of the window's first frame, which every run
    compares: frame ``k`` is the ``k + 1``-th cycle. A fault in the
    filters fades by a factor ``1 - gain`` a cycle, so the faults below
    are planted where the comparison looks."""
    from pb import spec
    return int(spec.cell(CELL).traffic["warmup_frames"]) + 1


def nominal_dt(mp):
    """A cycle tracked with the configuration's ``tracking_dt``; its
    ``MappingResult.dt`` still reports the measured one."""
    def broken(orig, objects, tracks, min_area, dt, **kw):
        return orig(objects, tracks, min_area, 1.0 / 30.0, **kw)
    _on_call(mp, "track_objects", compared_cycle(), broken)


def cycle_skipped(mp):
    """A cycle's tracking skipped: its objects are built, the tracks do
    not move."""
    def broken(orig, objects, tracks, *a, **kw):
        return _pipe().TrackingStats()
    _on_call(mp, "track_objects", compared_cycle(), broken)


def box_moved(mp):
    """Object 1's top-view box moved 20 mm along x in every cycle."""
    pipe = _pipe()
    build = pipe.build_objects

    def broken(**k):
        objs = build(**k)
        if len(objs) > 1 and objs[1].topview is not None:
            box = objs[1].topview.shapes.world.box
            box.center = (box.center[0] + 0.02, box.center[1])
        return objs
    mp.setattr(pipe, "build_objects", broken)


def run_tiny(tiny_cell, seed):
    """A 10 s window: a frame takes about a second on the CPU (the full
    grid's segmentation, which the frame waits for) and several when the
    CPU is shared, and the window's first frame, which every run
    compares, is published a frame after it is released."""
    torch.manual_seed(0)
    res = run.run_cell(tiny_cell(CELL), seed, 10.0, False, "cpu",
                       time.perf_counter())
    assert res["checks"], ("no frame compared", res["host"])
    return res


def test_portbench_link_mapping_tiny_run_is_correct(tiny_cell, monkeypatch):
    from ros_gpu_depthmap_fusion_tpu_torch.mapping import objects
    from ros_gpu_depthmap_fusion_tpu_torch.mapping import pipeline as pipe
    from ros_gpu_depthmap_fusion_tpu_torch.utils import profiling
    monkeypatch.setattr(profiling, "_on", True)
    profiling.reset()
    try:
        res = run_tiny(tiny_cell, 2147484013)
        counters = profiling.snapshot()["counters"]
    finally:
        profiling.reset()
    assert res["correct"] is True and res["failed"] == 0, (res["checks"],
                                                           res["failed"])
    assert res["attempted"] > 0
    assert set(res["checks"]) == {
        "fused_cells_pct", "fused_gap_mm", "occupancy_pct", "objects_pct",
        "object_gap_mm", "tracks_pct", "track_gap_mm"}
    assert res["checks"]["objects_pct"]["value"] == 0.0
    assert res["checks"]["tracks_pct"]["value"] == 0.0
    # every published frame mapped, none replaced
    assert counters["fusion.mapping.worker.cycles"] \
        == counters["fusion.mapping.worker.submitted"] >= 13, counters
    assert "fusion.mapping.worker.replaced" not in counters
    # the entry put back what it wrapped
    assert pipe.build_objects is objects.build_objects


@pytest.mark.parametrize("fault", [nominal_dt, cycle_skipped, box_moved])
def test_portbench_link_mapping_fault_is_not_correct(fault, tiny_cell,
                                                     monkeypatch):
    fault(monkeypatch)
    res = run_tiny(tiny_cell, 2147484017)
    assert res["attempted"] > 0 and res["failed"] == 0
    assert res["correct"] is False, res["checks"]


def test_portbench_link_mapping_control_fails(tiny_cell):
    for chain in (True, False):
        checks = control_node.control_numbers(tiny_cell(CELL), 2147484101,
                                              40, "cpu", chain)
        assert any(c["value"] > c["limit"] for c in checks.values()), checks
