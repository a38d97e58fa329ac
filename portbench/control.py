#!/usr/bin/env python3
"""The control of a cell's comparison: the plain reference computed in
bfloat16, the precision below the configuration's float32, put in the
program's place and judged as a run's outputs are.

    python3 portbench/control.py --workload <cell> --seeds 1 2 3 \
        [--frames 1500]

For each seed it judges the frames a run of ``--frames`` window frames
would compare (the seed's sample) and prints each
number, then one JSON line with every number's smallest reading over
the seeds: the upper reading a limit must stay below. The benchmark's
own runs never run it. It needs a CUDA card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent)]


def control_outputs(ref, f: int, cfg: dict) -> dict:
    """Frame ``f`` of reference ``ref`` in the judge's form of a
    program's outputs, as the configuration emits them."""
    import torch
    raw, _, means = ref.frame(f)
    out = {"fused": means.to(torch.float32)}
    hist = ref.history(f)
    if cfg["emit_occupancy_u8"]:
        out["occ_dense"] = torch.clamp(hist, 0, 255)
    else:
        n = -(-hist.shape[0] // 128) * 128
        bits = torch.zeros((n,), dtype=torch.bool, device=hist.device)
        bits[:hist.shape[0]] = hist > 0
        out["occ_bits"] = bits
    if cfg["emit_raw_points"]:
        out["raw"] = raw.to(torch.float32)
    return out


def control_numbers(cell, seed: int, frames: int, device) -> dict:
    """The control's numbers over the frames a run of ``frames`` window
    frames compares."""
    import torch

    from pb import check
    from pb.scene import Scene
    from reference.fusion import Reference
    cfg = cell.config["fusion"]
    scene = Scene.for_cell(seed, cell, device)
    warm = int(cell.traffic["warmup_frames"])
    sample = sorted(check.sample_frames(seed, warm, warm + frames - 1))
    ref = Reference(cfg, scene, device)
    low = Reference(cfg, scene, device, dtype=torch.bfloat16)
    per_frame = {f: check.judge(ref, f, control_outputs(low, f, cfg))
                 for f in sample}
    return check.verdict(per_frame, cell.config["limits"])[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--frames", type=int, default=1500)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    import torch

    from pb import spec
    if args.device == "cuda" and not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        return 2
    cell = spec.cell(args.workload)
    least = {}
    for seed in args.seeds:
        checks = control_numbers(cell, seed, args.frames, args.device)
        print(f"seed {seed}: " + ", ".join(
            f"{k} {c['value']!r} (limit {c['limit']!r})"
            for k, c in checks.items()), flush=True)
        for k, c in checks.items():
            least[k] = min(least.get(k, c["value"]), c["value"])
    print(json.dumps({"workload": args.workload, "seeds": args.seeds,
                      "least": least}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
