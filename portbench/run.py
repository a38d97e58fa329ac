#!/usr/bin/env python3
"""Run one cell of the port's benchmark once, on the card.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Builds the cell's system from ``BENCHMARK.json`` (its configuration file
and traffic mix), makes the scene from the seed, warms up the shapes the
traffic uses, then measures for ``--seconds``. With ``--trace 0`` it
reports the cell's end-to-end metrics; with ``--trace 1`` it records host
spans over the window and profiles a short stretch after them, and
reports the per-layer metrics. Either way it then holds a sample of the
window's frames to the plain reference and prints, as the last line of
standard output, one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics``, ``device`` (with ``busy_s`` and ``window_s`` when traced),
``breakdown`` when traced, ``host`` (the process's CPU seconds over the
window and its threads, and the card's clocks and power read after it),
and ``checks``, each compared number beside its limit (also the
last lines of standard error).

Without a CUDA card, or with fewer cards than the cell asks for, it exits
with status 2 and prints no result. It never imports JAX or the JAX
package; it exits with status 3 if one is loaded when it is done.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
sys.path[:0] = [str(HERE), str(ROOT)]

FORBIDDEN = ("jax", "jaxlib", "flax", "ros_gpu_depthmap_fusion_tpu")
# caches a kernel build may use, at fixed paths inside the checkout
CACHES = {"TORCH_EXTENSIONS_DIR": "torch_extensions",
          "TRITON_CACHE_DIR": "triton", "CUDA_CACHE_PATH": "cuda"}
# the OpenMP teams of torch and of the port's native host library: half
# the card machine's 8 cores. With all 8, their spinning threads burn
# 76-96 ms of CPU a 20 ms frame and the frame rate spreads wider, at the
# same median (PERF.md, section 2)
OMP_THREADS = "4"


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(
        FORBIDDEN))


def finite(x):
    """``x`` with every float that is not finite replaced by None."""
    if isinstance(x, dict):
        return {k: finite(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [finite(v) for v in x]
    if isinstance(x, float) and not math.isfinite(x):
        return None
    return x


SMI = ("power.limit", "power.draw", "clocks.sm", "clocks.mem",
       "temperature.gpu", "clocks_throttle_reasons.active")


def smi(index: int = 0) -> dict:
    """The card's power limit, and its power, clocks, temperature and
    throttle reasons as ``nvidia-smi`` reads them now (None where it
    cannot)."""
    try:
        line = subprocess.run(
            ["nvidia-smi", "-i", str(index), "--query-gpu=" + ",".join(SMI),
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=30).stdout.strip().splitlines()[0]
        vals = [v.strip() for v in line.split(",")]
    except (OSError, IndexError, subprocess.TimeoutExpired):
        vals = []
    out = {}
    for key, v in zip(SMI, vals + [None] * len(SMI)):
        try:
            out[key] = float(v) if not v.startswith("0x") else v
        except (AttributeError, ValueError):
            out[key] = None
    return out


class HostMeter:
    """What the process did between :meth:`start` and :meth:`stop`: its
    CPU seconds over all threads, and its threads."""

    def start(self):
        self.cpu0 = time.process_time()

    def stop(self, torch) -> dict:
        return {"cpu_s": time.process_time() - self.cpu0,
                "threads": len(os.listdir("/proc/self/task"))
                if os.path.isdir("/proc/self/task") else None,
                "torch_threads": torch.get_num_threads(),
                "omp_num_threads": os.environ.get("OMP_NUM_THREADS")}


def run_cell(cell, seed: int, seconds: float, trace: bool, device,
             t_start: float) -> dict:
    """One run of ``cell`` (a :class:`pb.spec.Cell`) on ``device``; the
    result line as a dict."""
    import numpy as np
    import torch

    from pb import check, drive, roofline
    from pb import trace as tracemod
    from pb.scene import Scene
    from pb.spans import Spans
    from pb.spec import metric_reader

    tr = cell.traffic
    cuda = torch.device(device).type == "cuda"
    scene = Scene.for_cell(seed, cell, device)
    if cuda:
        # the program's peak from here on: the scene's draws on the card
        # are the harness's, and freed
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    warm = int(tr["warmup_frames"])
    sample = check.sample_frames(seed, warm, warm + 10 ** 6)
    spans = Spans()
    system = drive.System(cell, scene, device, spans, sample)
    system.run(warm)
    if cuda:
        torch.cuda.synchronize()
    spans.on = bool(trace)
    span_seconds = max(seconds - float(tr["trace_reserve_s"]), 1.0) \
        if trace else seconds
    released0 = system.next_frame
    done0 = len(system.done)
    meter = HostMeter()
    meter.start()
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    system.pace(t0)
    while time.perf_counter() - t0 < span_seconds:
        system.run(1)
    t1 = time.perf_counter()
    host = meter.stop(torch)
    spans.on = False
    span_frames = system.next_frame - released0
    window = [d for d in system.done[done0:] if t0 <= d[2] <= t1]
    host["frames"] = len(window)
    if system.open_loop:
        host["release_late_ms"] = system.late_s * 1e3
    # the program's peak over its set-up and the window; the traced
    # stretch after it keeps the recorded kernel calls' tensors
    memory_peak = int(torch.cuda.max_memory_allocated()) if cuda else 0
    attempted = span_frames
    trace_res, readers, calls = None, [], []
    if trace:
        readers = [(m, metric_reader(m["name"])) for m in cell.per_layer]
        patched = drive.patch_kernels([r for _, r in readers], spans, calls)
        try:
            k = int(tr["trace_frames"])
            done1 = len(system.done)
            r0 = system.next_frame
            if cuda:
                trace_res = tracemod.capture(system.run, k, spans)
            else:
                system.run(k)
                trace_res = tracemod.Trace(frames=k)
            attempted += system.next_frame - r0
            window += system.done[done1:]
        finally:
            drive.unpatch(patched)
    failed = sum(1 for d in window if d[3])
    # the frame in flight runs to its end; its result is not counted
    system.close()

    metrics = {}
    if trace:
        bounds = {}
        for name, args, out in calls:
            bounds.setdefault(name, []).append(
                roofline.call_bound_s(name, args, out))
        ctx = tracemod.Reading(trace=trace_res, spans=spans,
                               span_frames=span_frames, bounds=bounds)
        for m, reader in readers:
            v = reader.read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": reader.UNIT}
    else:
        lat = [(d[2] - d[1]) * 1e3 for d in window]
        values = {"fps": len(window) / (t1 - t0),
                  "frame_p95_ms": (float(np.percentile(lat, 95))
                                   if lat else float("inf")),
                  "setup_s": setup_s}
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}

    # the comparison: the window's sampled frames, once the program's
    # state is freed
    in_window = {d[0] for d in window}
    prog = {f: o for f, o in sorted(system.kept.items()) if f in in_window}
    entry = system.entry_module
    del system
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
        host.update(smi())
    from reference.fusion import Reference
    ref = getattr(entry, "Reference", Reference)(cell.config["fusion"],
                                                 scene, device)
    judge = getattr(entry, "judge", check.judge)
    per_frame = {f: judge(ref, f, p) for f, p in prog.items()}
    correct, checks = check.verdict(per_frame, cell.config["limits"])
    check.print_checks(checks, len(per_frame))

    dev = {"platform": "gpu" if cuda else "cpu", "kind": None, "count": 1,
           "memory_peak_bytes": memory_peak}
    if cuda:
        dev["kind"] = torch.cuda.get_device_name(0)
        dev["power_limit_w"] = host.get("power.limit")
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": dev}
    if trace and trace_res is not None:
        dev["busy_s"] = trace_res.busy_s
        dev["window_s"] = trace_res.window_s
        result["breakdown"] = tracemod.breakdown(trace_res)
    result["host"] = host
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    for var, sub in CACHES.items():
        os.environ[var] = str(ROOT / ".portbench_cache" / sub)
    os.environ["OMP_NUM_THREADS"] = OMP_THREADS

    from pb import spec
    cell = spec.cell(args.workload)
    import torch
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < cell.chips:
        print(f"portbench: {args.workload} needs {cell.chips} CUDA "
              f"card(s); found {found}", file=sys.stderr)
        return 2
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      "cuda", T_START)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    print(json.dumps(finite(result), allow_nan=False), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
