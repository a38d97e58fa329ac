#!/usr/bin/env python3
"""Where the time of one frame goes in the PyTorch port, on one GPU.

    python3 scripts/profile_torch_step.py [trace.json]

Runs ``chip_smoke.py``'s configuration and scene (the ``bench.py``
operating point on the raw depth link) and prints three JSON lines: the
median host phases of a synchronized frame (staging, upload, step enqueue,
whole frame, and the step's CUDA-event time); the time of 20 steps
chained from one state with one sync, against their host enqueue time (a
step is host-bound when the two agree); and the ``torch.profiler`` device
time of one step with its busy share and launch count, followed by the
top device kernels. With an argument it also writes the Chrome trace.
"""

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main():
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_step.py: no CUDA device")
    import chip_smoke as cs
    from ros_gpu_depthmap_fusion_tpu_torch.core import transforms
    from ros_gpu_depthmap_fusion_tpu_torch.core.camera import (
        PinholeIntrinsics)
    from ros_gpu_depthmap_fusion_tpu_torch.core.config import FusionConfig
    from ros_gpu_depthmap_fusion_tpu_torch.pipeline import engine as engmod

    gpu = cs.gpu_line()
    cfg = cs.bench_config(FusionConfig)
    intr = PinholeIntrinsics.default_for(cs.W, cs.H)
    scene = cs.Scene(transforms, seed=0)
    eng = engmod.FusionEngine(cfg, device="cuda")
    for f in range(8):
        eng.process(scene.stage(eng, intr, f))
    torch.cuda.synchronize()

    phases = {k: [] for k in ("stage_ms", "upload_ms", "step_enqueue_ms",
                              "frame_ms", "step_event_ms")}
    for f in range(8, 28):
        t0 = time.perf_counter()
        now = scene.stage(eng, intr, f)
        t1 = time.perf_counter()
        inp = eng.upload(now)
        t2 = time.perf_counter()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        eng.step(inp)
        end.record()
        t3 = time.perf_counter()
        torch.cuda.synchronize()
        t4 = time.perf_counter()
        for k, v in zip(phases, (t1 - t0, t2 - t1, t3 - t2, t4 - t0)):
            phases[k].append(v * 1e3)
        phases["step_event_ms"].append(start.elapsed_time(end))
    print(json.dumps(dict(gpu=gpu, **{k: float(np.median(v))
                                      for k, v in phases.items()})))

    state = eng.state
    inp = eng.upload(scene.stage(eng, intr, 30))

    def step():
        engmod.fusion_step(state, inp, cfg=cfg, grid=eng.grid,
                           output_capacity=eng.output_capacity)
    for _ in range(3):
        step()
    torch.cuda.synchronize()
    reps = 20
    t0 = time.perf_counter()
    for _ in range(reps):
        step()
    enqueue = (time.perf_counter() - t0) / reps * 1e3
    torch.cuda.synchronize()
    chained = (time.perf_counter() - t0) / reps * 1e3
    print(json.dumps(dict(gpu=gpu, step_chained_ms=chained,
                          step_host_enqueue_ms=enqueue)))

    n = 5
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / n * 1e3
    by_name = {}
    launches = 0
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            launches += 1
            by_name[ev.name] = by_name.get(ev.name, 0.0) \
                + ev.device_time_total / 1e3 / n
    device = sum(by_name.values())
    print(json.dumps(dict(gpu=gpu, profiled_wall_ms=wall,
                          device_ms=device, busy_share=device / wall,
                          launches_per_step=launches / n)))
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:30]:
        print(f"{ms:9.4f} ms/step  {name[:110]}")
    if len(sys.argv) > 1:
        prof.export_chrome_trace(sys.argv[1])


if __name__ == "__main__":
    main()
