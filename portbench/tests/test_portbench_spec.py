"""BENCHMARK.json against the contract, and every piece it names found by
name."""

import dataclasses
import json
import re

import pytest

from pb import check, drive, spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TOP = {"command", "paths", "run_seconds", "configs", "workloads",
       "end_to_end", "per_layer"}


@pytest.fixture(scope="module")
def bench():
    return spec.benchmark()


def test_portbench_top_level(bench):
    assert set(bench) == TOP
    assert bench["paths"] == ["portbench"]
    assert bench["command"] == ["python3", "portbench/run.py"]
    assert 1 <= bench["run_seconds"] <= 51
    assert len(json.dumps(bench)) < 64 * 1024


def test_portbench_names_and_lines(bench):
    names = [c["name"] for c in bench["configs"]] \
        + [w["name"] for w in bench["workloads"]] \
        + [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/") and not c["reduced"]
        for k in ("source", "why"):
            assert 1 <= len(c[k]) <= 200 and "\n" not in c[k]
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] == "host_clock"
    assert {m["name"] for m in bench["end_to_end"]} == {
        "fps", "frame_p95_ms", "setup_s"}


@pytest.mark.parametrize("cell", ["hafen_link.stream", "hafen.stream"])
def test_portbench_cell_pieces_found(bench, cell):
    c = spec.cell(cell, bench)
    assert hasattr(spec.entry(c.traffic["entry"]), "Entry")
    assert c.traffic["loop"] in ("open", "closed")
    assert set(c.traffic["motion"]) == {"sway_rad", "sway_period_frames",
                                        "shift_px"}
    cfg = drive.fusion_config(c.config["fusion"])
    assert dataclasses.asdict(cfg).keys() == c.config["fusion"].keys()
    assert set(c.config["limits"]) <= set(check.NUMBERS)
    assert c.per_layer, "every cell reports a per-layer metric"
    for m in c.per_layer:
        r = spec.metric_reader(m["name"])
        assert (r.UNIT, r.LAYER, r.SOURCE, r.MOVES) == (
            m["unit"], m["layer"], m["source"], m["moves"])
        assert m["moves"] in {e["name"] for e in c.end_to_end}


def test_portbench_every_metric_file_is_named(bench):
    files = {p.stem for p in (spec.HERE / "metrics").glob("*.py")}
    assert files == {m["name"] for m in bench["per_layer"]}


def test_portbench_hafen_is_the_launch_preset():
    from ros_gpu_depthmap_fusion_tpu_torch.core.config import PRESET_HAFEN
    fields = spec.cell("hafen.stream").config["fusion"]
    assert drive.fusion_config(fields) == PRESET_HAFEN


def test_portbench_hafen_link_is_bench_link():
    """The launch preset with bench.py:120-182's link fields."""
    from ros_gpu_depthmap_fusion_tpu_torch.core.config import PRESET_HAFEN
    link = PRESET_HAFEN.replace(
        num_point_sequences=2, rollbuffer_point_capacity=98304,
        max_points_per_sequence=16384, depth_link_codec="dpcm_temporal",
        depth_codec_p4_budget=48, depth_codec_hysteresis=2,
        depth_codec_keyframe_interval=120, depth_codec_quant_shift=4,
        depth_codec_max_exceptions=8192, lidar_link_quant_step=0.002,
        lidar_link_delta=True, voxelize_partials_capacity=448 * 1024,
        voxelize_output_capacity=16384, emit_raw_points=False,
        emit_occupancy_u8=False, occupancy_sparse_capacity=4096)
    fields = spec.cell("hafen_link.stream").config["fusion"]
    assert drive.fusion_config(fields) == link
