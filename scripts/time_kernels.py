#!/usr/bin/env python3
"""Device time of the port's four CUDA kernels on one link frame, for an
A/B of two checkouts of the port on one GPU.

    python3 scripts/time_kernels.py [--root DIR] [--label NAME] [--split]

Imports ``ros_gpu_depthmap_fusion_tpu_torch`` from ``DIR`` (default: this
checkout; it builds that checkout's kernels), ``operating_point.py``'s
scene and configuration and ``chip_smoke.py``'s timers from this checkout.
Runs ``bench.py``'s link configuration (``operating_point.LINK_FIELDS``)
for 8 frames, records the kernels' calls of frame
``operating_point.RECORD_FRAME`` and, on those inputs
(kernel 4, which the engine does not call: on that frame's masked metric
depth, as ``chip_smoke.py``'s fused phase), prints one JSON line: the card
and its power limit, the label, and per kernel and frame the device ms
(``torch.profiler``, 20 calls after 3 warm-ups), the call ms (CUDA events
around a call, median of 20) and the
bound ms (``portbench/pb/roofline.py``'s work and peaks,
``call_bound_s``); for compact also the boolean-index
library call. Run it for two
roots in turns (A, B, B, A) in one process group on one card to compare
them.

``--split`` adds where level-1 segreduce's device time goes: device
microseconds of the recorded call (``l1``) and of variants that take parts
of its work away: capacity 16 (almost no rows written, no fill,
``l1_cap16``), capacity 1.5M (a 1.1M-row fill, ``l1_cap1.5M``), an
all-sentinel stream of the same length (keys read, no values, no runs,
``sent_cap16``), one tile of sentinels (a launch's floor,
``sent_2048_cap16``), and ``keys.clone()`` (the keys read and written,
``copy_keys``), for scale.
"""

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--label", default="")
    ap.add_argument("--split", action="store_true")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("time_kernels.py: no CUDA device")
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    import operating_point as op
    sys.path.insert(0, os.path.abspath(args.root))
    for mod in [m for m in sys.modules
                if m.startswith("ros_gpu_depthmap_fusion_tpu_torch")]:
        del sys.modules[mod]
    import ros_gpu_depthmap_fusion_tpu_torch as pkg
    if not os.path.abspath(pkg.__file__).startswith(
            os.path.abspath(args.root)):
        raise SystemExit(f"imported {pkg.__file__}, not from {args.root}")
    from ros_gpu_depthmap_fusion_tpu_torch.ops import mask_ops, voxelize
    from ros_gpu_depthmap_fusion_tpu_torch.ops.kernels import (
        compact, flying_pixels, fused_unproject_rle, segreduce)
    from ros_gpu_depthmap_fusion_tpu_torch.pipeline import engine as engmod

    wrappers = {"segreduce": segreduce.segreduce,
                "flying_pixels": flying_pixels.filter_flying_pixels,
                "compact": compact.compact_rows}
    cfg = op.config(op.LINK_FIELDS)
    eng = engmod.FusionEngine(cfg, device="cuda", pipeline_depth=1)
    mods = [("segreduce", voxelize, "segreduce"),
            ("flying_pixels", engmod, "filter_flying_pixels"),
            ("compact", mask_ops, "compact_rows"),
            ("unproject", engmod, "unproject_depthmaps")]
    calls = cs.run_engine(torch, eng, op.scene(), 8,
                          record=(op.RECORD_FRAME, mods))[4]
    out = dict(gpu=cs.gpu_line(), label=args.label,
               root=os.path.abspath(args.root), kernels={})
    for name, kern in wrappers.items():
        row = dict(ms=0.0, call_ms=0.0, bound_ms=0.0)
        for a, k, res in calls[name]:
            row["ms"] += cs.device_ms(torch, lambda: kern(*a, **k))
            row["call_ms"] += cs.cuda_ms(torch, lambda: kern(*a, **k))
            row["bound_ms"] += cs.roofline.call_bound_s(name, a, res) * 1e3
        if name == "compact":
            words, mask = calls[name][0][0][:2]
            row["library_ms"] = cs.device_ms(torch, lambda: words[mask])
        out["kernels"][name] = row
    _, _, fargs = cs.fused_inputs(torch, calls, cfg, eng.grid)

    def fused():
        return fused_unproject_rle.unproject_voxelize_l1(*fargs)
    out["kernels"]["fused_unproject_rle"] = dict(
        ms=cs.device_ms(torch, fused), call_ms=cs.cuda_ms(torch, fused),
        bound_ms=cs.bound(*cs.fused_work(fargs, int(fused()[4])))[0])
    if args.split:
        out["segreduce_split_us"] = segreduce_split(torch, cs, segreduce,
                                                    calls["segreduce"][0])
    print(json.dumps(out), flush=True)


def segreduce_split(torch, cs, segreduce, level1):
    """Device us of the recorded level-1 call and of its variants."""
    (keys, vals, cap, sent), k, _ = level1
    fb = k["force_break"]
    run = segreduce.segreduce
    sentinels = torch.full_like(keys, sent)
    cases = {
        "l1": lambda: run(keys, vals, cap, sent, fb),
        "l1_cap16": lambda: run(keys, vals, 16, sent, fb),
        "l1_cap1.5M": lambda: run(keys, vals, 1500000, sent, fb),
        "sent_cap16": lambda: run(sentinels, vals, 16, sent, fb),
        "sent_2048_cap16": lambda: run(sentinels[:2048], vals[:2048], 16,
                                       sent, fb),
        "copy_keys": lambda: keys.clone(),
    }
    out = dict(n=keys.shape[0], valid=int((keys != sent).sum()))
    for name, fn in cases.items():
        out[name] = cs.device_ms(torch, fn) * 1e3
    return out


if __name__ == "__main__":
    main()
