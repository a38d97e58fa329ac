"""The port's own tracer (``utils/profiling.py``) stays off under the
harness: a tiny rig of each configuration run through ``pb/drive.py``, its
spans on and a ``torch.profiler`` capture around its frames as the traced
run makes it, leaves the tracer off and empty, and the capture holds no
``fusion.*`` range. The trace reader attributes each device activity to
the innermost range open at its launch, so a port range nested in a
harness span would move what the readers read."""

import json

import pytest

from conftest import CELLS, tiny

from pb import drive, trace
from pb.scene import Scene
from pb.spans import Spans


@pytest.mark.parametrize("cell", CELLS)
def test_portbench_port_tracer_stays_off(cell, tmp_path):
    from ros_gpu_depthmap_fusion_tpu_torch.utils import profiling
    from torch.profiler import ProfilerActivity, profile
    profiling.reset()
    c = tiny(cell)
    spans = Spans()
    system = drive.System(c, Scene.for_cell(5, c, "cpu"), "cpu", spans,
                          set())
    try:
        system.run(2)
        spans.on = True
        system.run(2)
        spans.on = False
        spans.profiling = True
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            system.run(2)
        spans.profiling = False
    finally:
        system.close()
    assert not profiling.enabled()
    assert profiling.snapshot() == {"spans": {}, "counters": {}}
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())
    if isinstance(events, dict):
        events = events.get("traceEvents", [])
    names = {e.get("name") for e in events
             if e.get("cat") == "user_annotation"}
    assert drive.FRAME in names and drive.PROCESS in names
    assert not [n for n in names if str(n).startswith("fusion.")]
    assert trace.parse(events).frames == 2
    assert spans.calls[drive.STAGE] > 0
