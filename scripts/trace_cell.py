#!/usr/bin/env python3
"""The port's own spans and counters in one benchmark cell, on the card.

    python3 scripts/trace_cell.py --workload <cell> --seed <n> \
        [--seconds 10] [--frames 48] [--out trace.json]

Builds the cell as ``portbench/run.py`` does (its configuration and
traffic mix from ``BENCHMARK.json``, the scene from the seed, the
harness's spans around the port's entry points, the warm-up frames),
then runs four windows of ``--seconds`` each with the port's tracer
(:mod:`utils.profiling`) off, on, on, off and the harness's spans off,
for the frame rate the tracer costs; a fifth window with both on, for the
port's spans and counters a frame beside the harness's ``host.*`` spans
(and whether ``fusion.lidar.kernel_steps``, the steps whose lidar stages
ran on their kernel pair, equals ``fusion.frames``);
and last ``--frames`` frames under ``torch.profiler`` with both on. From
that capture: device activities a frame and device ms by the innermost
port span that launched them, and the ten longest idle gaps of the
device labelled ``<harness span> / <port span>`` by what the main thread
had open, with the share of idle time the main thread spent in a port
wait span. The capture is read by the harness's own reader,
``portbench/pb/trace.py``, once as the harness's spans label it and once
as the port's do.

Prints one JSON object (and writes it to ``--out``). Needs a CUDA card;
imports neither JAX nor the JAX package.
"""

from __future__ import annotations

import argparse
import bisect
import json
import os
import sys
import tempfile
import time
import timeit
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "portbench"), str(ROOT)]

PORT = "fusion."
WAITS = ("fusion.engine.wait_encode", "fusion.engine.wait_slot")


def window(system, seconds: float) -> tuple:
    """Frames run closed-loop for ``seconds``: (frames released, s)."""
    f0, t0 = system.next_frame, time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        system.run(1)
    return system.next_frame - f0, time.perf_counter() - t0


def _views(events) -> tuple:
    """The capture as the harness reads it (no port range) and as the
    port's spans label it (no harness range but the frames, which bound
    the window)."""
    from pb.drive import FRAME

    def ranges(ev, port):
        name = str(ev.get("name", ""))
        return (str(ev.get("cat", "")).lower() == "user_annotation"
                and name != FRAME and name.startswith(PORT) == port)
    return ([ev for ev in events if not ranges(ev, True)],
            [ev for ev in events if not ranges(ev, False)])


def _idle_in(device, ranges) -> float:
    """Seconds of ``ranges`` ``[(start s, end s)]`` in which no activity
    of ``device`` (a :class:`pb.trace.Trace`'s) ran."""
    busy = []
    for _, s, d, _ in sorted(device, key=lambda e: e[1]):
        if busy and s <= busy[-1][1]:
            busy[-1][1] = max(busy[-1][1], s + d)
        else:
            busy.append([s, s + d])
    starts = [s for s, _ in busy]
    idle = 0.0
    for a, b in ranges:
        covered = 0.0
        for s, e in busy[max(0, bisect.bisect_right(starts, a) - 1):]:
            if s >= b:
                break
            covered += max(0.0, min(e, b) - max(s, a))
        idle += b - a - covered
    return idle


def read_capture(events) -> dict:
    """The harness's reading of the capture (:func:`pb.trace.parse`) and
    the same read with the port's spans as the labels: device activities
    a frame by innermost port span, the ten longest idle gaps labelled
    ``<harness span> / <port span>``, and the share of idle time the main
    thread spent in a port wait span."""
    from pb.drive import FRAME
    from pb.trace import parse
    harness_events, port_events = _views(events)
    th, tp = parse(harness_events), parse(port_events)
    nf = th.frames
    main = next((ev.get("pid"), ev.get("tid")) for ev in events
                if ev.get("ph") == "X" and ev.get("name") == FRAME)
    waits = [(float(ev["ts"]) * 1e-6,
              (float(ev["ts"]) + float(ev.get("dur", 0.0))) * 1e-6)
             for ev in port_events
             if ev.get("ph") == "X" and ev.get("name") in WAITS
             and (ev.get("pid"), ev.get("tid")) == main]
    idle = th.window_s - th.busy_s
    by_port = {}
    for _, _, dur, label in tp.device:
        label = "none" if label in (None, FRAME) else label
        n, s = by_port.get(label, (0, 0.0))
        by_port[label] = (n + 1, s + dur)
    return {
        "frames": nf,
        "window_ms": th.window_s * 1e3,
        "busy_ms_per_frame": th.busy_s * 1e3 / nf,
        "idle_pct": 100.0 * idle / th.window_s,
        "idle_in_wait_pct": (100.0 * _idle_in(th.device, waits) / idle
                             if idle else None),
        "launches_per_frame_by_port_span": {
            k: n / nf for k, (n, _) in sorted(by_port.items())},
        "device_ms_per_frame_by_port_span": {
            k: s * 1e3 / nf for k, (_, s) in sorted(by_port.items())},
        "longest_gaps_ms": [
            [f"{h} / {'-' if p == 'harness' else p}", s * 1e3]
            for (h, s), (p, _) in zip(th.gaps, tp.gaps)],
    }


def span_cost_ns() -> dict:
    """The tracer's cost per span and per counter on this host, off and
    on (best of 5 repeats)."""
    from ros_gpu_depthmap_fusion_tpu_torch.utils import profiling

    def span():
        with profiling.span("fusion.cost", 0):
            pass

    def count():
        profiling.count("fusion.cost")

    out = {}
    was = profiling.enabled()
    for on in (False, True):
        profiling.enable(on)
        for name, fn, n in (("span", span, 200000),
                            ("count", count, 200000)):
            t = min(timeit.repeat(fn, number=n, repeat=5)) / n
            out[f"{name}_{'on' if on else 'off'}_ns"] = t * 1e9
    profiling.enable(was)
    return out


def measure(cell, seed: int, seconds: float, frames: int,
            device: str) -> dict:
    """The windows and the capture of :mod:`this script <trace_cell>` for
    ``cell`` (a :class:`pb.spec.Cell`) on ``device``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from pb import drive
    from pb.scene import Scene
    from pb.spans import Spans
    from ros_gpu_depthmap_fusion_tpu_torch.utils import profiling

    cuda = device == "cuda"
    scene = Scene.for_cell(seed, cell, device)
    spans = Spans()
    system = drive.System(cell, scene, device, spans, set())
    system.run(int(cell.traffic["warmup_frames"]))
    if cuda:
        torch.cuda.synchronize()
    res = {"seconds": seconds, "span_cost": span_cost_ns()}

    fps = {"off": [], "on": []}
    for on in (False, True, True, False):
        profiling.enable(on)
        n, s = window(system, seconds)
        fps["on" if on else "off"].append(n / s)
    res["fps_tracer"] = fps

    # both on: the port's spans and counters beside the harness's
    profiling.reset()
    profiling.enable()
    spans.on = True
    n, s = window(system, seconds)
    spans.on = False
    snap = profiling.snapshot()
    res["window"] = {
        "frames_released": n, "fps": n / s,
        "port_ms": {k: t * 1e3 / n for k, (t, _) in snap["spans"].items()},
        "port_calls_per_frame": {k: c / n for k, (_, c)
                                 in snap["spans"].items()},
        "counters": snap["counters"],
        "harness_ms": {k: v * 1e3 / n for k, v in spans.self_s.items()},
    }
    # steps whose lidar stages ran on the kernel pair: every frame's
    res["lidar_kernel_steps"] = snap["counters"].get(
        "fusion.lidar.kernel_steps", 0)
    res["lidar_kernel_steps_equal_frames"] = (
        res["lidar_kernel_steps"] == snap["counters"].get("fusion.frames"))

    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    fd, path = tempfile.mkstemp(suffix=".json", prefix="trace_cell_")
    os.close(fd)
    try:
        spans.profiling = True
        with profile(activities=activities) as prof:
            system.run(frames)
            if cuda:
                torch.cuda.synchronize()
        spans.profiling = False
        prof.export_chrome_trace(path)
        with open(path) as fh:
            events = json.load(fh)
    finally:
        os.unlink(path)
        profiling.enable(False)
        system.close()
    if isinstance(events, dict):
        events = events.get("traceEvents", [])
    res["capture"] = read_capture(events)
    res["capture"]["port_range_args"] = next(
        (e.get("args") for e in events
         if e.get("name") == "fusion.engine.wait_encode"), None)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--frames", type=int, default=48)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import run as pbrun
    os.environ["OMP_NUM_THREADS"] = pbrun.OMP_THREADS
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("trace_cell.py: no CUDA card")
    from pb import spec
    res = {"workload": args.workload, "seed": args.seed,
           "device": torch.cuda.get_device_name(0),
           "power_limit_w": pbrun.smi().get("power.limit")}
    res.update(measure(spec.cell(args.workload), args.seed, args.seconds,
                       args.frames, "cuda"))
    line = json.dumps(res)
    print(line, flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "w") as fh:
            fh.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
