"""The node cell (``entries/node.py``) on a tiny rig through ``run.py``'s
code on the CPU: correct as the port runs it, and not correct for each
fault planted in the mapping stage: an object left out, a top-view box
moved 20 mm, two track ids swapped, components folded by a label
capacity the run does not report; and the control fails."""

import time

import pytest
import torch

import control_node
import run

CELL = "hafen_node.stream"
PIPELINE = "ros_gpu_depthmap_fusion_tpu_torch.mapping.pipeline"


def object_left_out(mp):
    """The lowest occupied layer's cells left out of the segmentation."""
    import ros_gpu_depthmap_fusion_tpu_torch.mapping.pipeline as pipe
    segment = pipe.segment

    def broken(occ, **k):
        occ = occ.clone()
        layers = torch.nonzero(occ.reshape(occ.shape[0], -1).any(1))
        if layers.numel():
            occ[int(layers[0])] = 0
        return segment(occ, **k)
    mp.setattr(pipe, "segment", broken)


def box_moved(mp):
    """Object 1's top-view box moved 20 mm along x."""
    import ros_gpu_depthmap_fusion_tpu_torch.mapping.pipeline as pipe
    build = pipe.build_objects

    def broken(**k):
        objs = build(**k)
        if len(objs) > 1 and objs[1].topview is not None:
            box = objs[1].topview.shapes.world.box
            box.center = (box.center[0] + 0.02, box.center[1])
        return objs
    mp.setattr(pipe, "build_objects", broken)


def track_ids_swapped(mp):
    """The first two tracks' ids swapped once, at the sixth frame."""
    import ros_gpu_depthmap_fusion_tpu_torch.mapping.pipeline as pipe
    track = pipe.track_objects
    calls = []

    def broken(objects, tracks, *a, **k):
        stats = track(objects, tracks, *a, **k)
        calls.append(1)
        if len(calls) == 6:
            assert len(tracks) >= 2
            tracks[0].track_id, tracks[1].track_id = (tracks[1].track_id,
                                                      tracks[0].track_id)
        return stats
    mp.setattr(pipe, "track_objects", broken)


def labels_folded(mp):
    """Segmentation at a capacity of 2 labels a layer: components past the
    first fold into one, and ``num_labels`` shows no layer at the
    configured capacity."""
    import ros_gpu_depthmap_fusion_tpu_torch.mapping.pipeline as pipe
    segment = pipe.segment

    def broken(occ, max_labels, max_objects):
        return segment(occ, max_labels=2, max_objects=max_objects)
    mp.setattr(pipe, "segment", broken)


def run_tiny(tiny_cell, seed):
    torch.manual_seed(0)
    return run.run_cell(tiny_cell(CELL), seed, 1.0, False, "cpu",
                        time.perf_counter())


def test_portbench_node_tiny_run_is_correct(tiny_cell):
    res = run_tiny(tiny_cell, 2147484003)
    assert res["correct"] is True and res["failed"] == 0, res["checks"]
    assert res["attempted"] > 0
    assert set(res["checks"]) == {
        "fused_cells_pct", "fused_gap_mm", "occupancy_pct", "raw_pct",
        "objects_pct", "object_gap_mm", "tracks_pct", "track_gap_mm"}
    assert res["checks"]["objects_pct"]["value"] == 0.0
    assert res["checks"]["tracks_pct"]["value"] == 0.0


@pytest.mark.parametrize("fault", [object_left_out, box_moved,
                                   track_ids_swapped, labels_folded])
def test_portbench_node_fault_is_not_correct(fault, tiny_cell,
                                             monkeypatch):
    fault(monkeypatch)
    res = run_tiny(tiny_cell, 2147484005)
    assert res["attempted"] > 0 and res["failed"] == 0
    assert res["correct"] is False, res["checks"]


def test_portbench_node_control_fails(tiny_cell):
    for chain in (True, False):
        checks = control_node.control_numbers(tiny_cell(CELL), 2147484101,
                                              40, "cpu", chain)
        assert any(c["value"] > c["limit"] for c in checks.values()), checks
