"""A tiny rig of each configuration through ``run.py``'s code on the CPU
(the port's plain twins), in a fresh process: one JSON last line with
exactly the contract's keys, correct, and no JAX loaded."""

import json
import subprocess
import sys

import pytest

from conftest import CELLS, HERE

SCRIPT = """
import json, sys, time
sys.path[:0] = [{here!r}, {tests!r}]
import run
from conftest import tiny
t = time.perf_counter()
r = run.run_cell(tiny({cell!r}), 2147483999, {seconds}, {trace}, "cpu", t)
print("loaded:", run.forbidden_modules())
print(json.dumps(run.finite(r), allow_nan=False))
"""


def run_tiny(cell, seconds=1.0, trace=False):
    code = SCRIPT.format(here=str(HERE), tests=str(HERE / "tests"),
                         cell=cell, seconds=seconds, trace=trace)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=600, cwd=str(HERE.parent))
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.strip().splitlines()
    return lines, proc.stderr


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("cell", CELLS)
def test_portbench_tiny_run_line(cell, trace):
    lines, err = run_tiny(cell, trace=trace)
    assert lines[-2] == "loaded: []"
    res = json.loads(lines[-1])
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    if trace:
        keys.append("breakdown")
    assert list(res) == keys + ["host", "checks"]
    assert res["host"]["frames"] > 0 and res["host"]["cpu_s"] > 0
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] > 0
    assert set(res["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    for name, c in res["checks"].items():
        assert c["value"] == 0.0 and c["limit"] > 0, name
        assert f"{name} = " in err
    if trace:
        assert res["metrics"]["host.stage_ms"]["value"] > 0
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        from pb import spec
        assert set(res["metrics"]) == {
            m["name"] for m in spec.cell(cell).end_to_end}
        assert all(m["value"] > 0 for m in res["metrics"].values())


def test_portbench_refuses_without_a_card():
    """No CUDA card: exit status 2 and no result line."""
    code = ("import sys, torch; torch.cuda.is_available = lambda: False; "
            f"sys.path.insert(0, {str(HERE)!r}); import run; "
            "sys.exit(run.main(['--workload', 'hafen.stream', '--seed', "
            "'1', '--seconds', '1']))")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300, cwd=str(HERE.parent))
    assert proc.returncode == 2
    assert proc.stdout.strip() == ""
