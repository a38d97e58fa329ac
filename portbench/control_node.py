#!/usr/bin/env python3
"""The control of the node cell's comparison: the plain references of
fusion and of the mapping stage computed in bfloat16, the precision
below the configuration's float32, put in the program's place and judged
as a run's outputs are (``entries/node.py``'s ``judge``).

    python3 portbench/control_node.py --workload hafen_node.stream \
        --seeds 1 2 3 [--frames 200]

Two controls a seed. "chain": everything in bfloat16: the fusion
reference (``control.control_outputs``' outputs), its occupancy history
segmented with centroids and top-view columns in bfloat16, and a
tracker computing in bfloat16 replayed over those objects from frame 0.
"stage": the mapping stage alone in bfloat16 on the float32 occupancy
history, since the chain's occupancy differs so widely that hardly an
object matches and the gaps of matched objects and tracks go unread.
For each seed it judges the frames a run of ``--frames`` window frames
would compare; as the tracks need every frame from 0, the default is
shorter than ``control.py``'s. It prints each control's numbers, then
one JSON line with every number's smallest reading over the seeds of
the larger of the two controls. The benchmark's own runs never run it. It needs a CUDA card unless
``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent)]


def box_of(corners):
    """``(cx, cy, w, h, angle_deg)`` of a rectangle's corners ``[4, 2]``."""
    import numpy as np
    c = np.asarray(corners, np.float64)
    e0, e1 = c[1] - c[0], c[2] - c[1]
    return (float(c[:, 0].mean()), float(c[:, 1].mean()),
            float(np.hypot(*e0)), float(np.hypot(*e1)),
            math.degrees(math.atan2(e0[1], e0[0])))


def control_numbers(cell, seed: int, frames: int, device,
                    chain: bool) -> dict:
    """The control's numbers over the frames a run of ``frames`` window
    frames compares: the whole chain in bfloat16 (``chain``), or the
    mapping stage alone on the float32 occupancy history."""
    import torch

    import control
    from entries import node
    from pb import check
    from pb.scene import Scene
    from reference import mapping as refmap
    from reference.fusion import Reference as FusionReference
    cfg = cell.config["fusion"]
    scene = Scene.for_cell(seed, cell, device)
    warm = int(cell.traffic["warmup_frames"])
    sample = sorted(check.sample_frames(seed, warm, warm + frames - 1))
    bf16 = torch.bfloat16
    ref = node.Reference(cfg, scene, device)
    fusion = FusionReference(cfg, scene, device, dtype=bf16) if chain \
        else ref
    tracker = refmap.Tracker(cfg["object_min_area"], cfg["tracking_dt"],
                             cfg["max_tracks"], bf16)
    inputs, per_frame = [], {}
    for f in range(sample[-1] + 1):
        objs = node.reference_objects(node.segment_history(fusion, f, bf16,
                                                           bf16))
        inputs.append([(key[0], box_of(rects[0]))
                       for key, (_, rects) in objs.items()])
        tracker.step(inputs[-1])
        if f in sample:
            out = control.control_outputs(fusion, f, cfg)
            out["node"] = {
                "objects": {k: (c, rects[0]) for k, (c, rects)
                            in objs.items()},
                "inputs": inputs, "tracks": tracker.state()}
            per_frame[f] = node.judge(ref, f, out)
    return check.verdict(per_frame, cell.config["limits"])[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--frames", type=int, default=200)
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
        both = {}
        for chain in (True, False):
            checks = control_numbers(cell, seed, args.frames, args.device,
                                     chain)
            print(f"seed {seed} {'chain' if chain else 'stage'}: "
                  + ", ".join(f"{k} {c['value']!r} (limit {c['limit']!r})"
                              for k, c in checks.items()), flush=True)
            for k, c in checks.items():
                both[k] = max(both.get(k, c["value"]), c["value"])
        for k, v in both.items():
            least[k] = min(least.get(k, v), v)
    print(json.dumps({"workload": args.workload, "seeds": args.seeds,
                      "least": least}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
