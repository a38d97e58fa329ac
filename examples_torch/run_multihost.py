"""Multi-rank sharded fusion runner for the PyTorch port.

Every rank is one process on ``torch.distributed`` and owns one
``(stream, space)`` coordinate of the mesh; all run the same
:class:`ShardedFusionEngine` program on the same synthetic frames, with
the collectives on NCCL (one GPU a rank) or gloo (CPU ranks, or several
ranks sharing one GPU). Run it one of two ways:

    # spawns its own ranks
    PYTHONPATH=.:$PYTHONPATH python examples_torch/run_multihost.py \
        --ranks 2 --num-space 1 --backend gloo --device cpu \
        --digest-out /tmp/dist.json

    # one process a rank, started by torchrun (reads its environment)
    PYTHONPATH=.:$PYTHONPATH torchrun --nproc-per-node 2 \
        examples_torch/run_multihost.py --device cuda --backend nccl

Writes (from rank 0) the digest JSON of the JAX package's
``examples/run_multihost.py``, with the same keys: fused and raw point
totals, the occupancy sum, and hashes of the sorted fused rows and of the
occupancy (the grid's cells, without the mesh's padding), so that runs on
any number of ranks can be compared exactly (the ranks add integer
partial sums, which commute).
"""

import argparse
import datetime
import hashlib
import json
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

from ros_gpu_depthmap_fusion_tpu_torch.core import transforms
from ros_gpu_depthmap_fusion_tpu_torch.core.camera import PinholeIntrinsics
from ros_gpu_depthmap_fusion_tpu_torch.core.config import FusionConfig
from ros_gpu_depthmap_fusion_tpu_torch.parallel.engine import (
    ShardedFusionEngine)
from ros_gpu_depthmap_fusion_tpu_torch.parallel.mesh import make_mesh, spawn
from ros_gpu_depthmap_fusion_tpu_torch.utils import native

H, W, C = 48, 64, 4


def config() -> FusionConfig:
    return FusionConfig(
        num_depth_streams=C, depth_height=H, depth_width=W,
        num_point_sequences=1,
        crop_min=(-6, -6, 0), crop_max=(6, 6, 2.5),
        voxel_min=(-6, -6, 0), voxel_max=(6, 6, 2.5),
        voxel_size=(0.25, 0.25, 0.25), voxel_occupancy_lifetime=5,
        rollbuffer_point_capacity=512, rollbuffer_seq_capacity=16,
        max_points_per_sequence=256)


def rank_device(rank: int, device: str) -> torch.device:
    """``cuda`` ranks take the cards round-robin; ``cpu`` ranks the CPU."""
    if device == "cuda":
        return torch.device("cuda", rank % torch.cuda.device_count())
    return torch.device(device)


def run_rank(rank: int, args: dict) -> dict:
    """One rank: the mesh, the engine, the frames; the digest (the host
    views are collective, so every rank computes it)."""
    mesh = make_mesh(num_space=args["num_space"],
                     device=rank_device(rank, args["device"]))
    log = (lambda m: print(f"[rank {rank}] {m}", flush=True))
    log(f"world={dist.get_world_size()} backend={mesh.backend} "
        f"mesh={mesh.shape} device={mesh.device}")
    cfg = config()
    eng = ShardedFusionEngine(cfg, mesh)
    intr = PinholeIntrinsics.default_for(W, H)
    cams = []
    for i in range(C):
        ang = i * 2 * np.pi / C
        pos = np.array([3 * np.cos(ang), 3 * np.sin(ang), 1.5])
        cams.append(transforms.make_se3(
            transforms.rot_z(ang + np.pi) @ transforms.rot_x(-np.pi / 2),
            pos))
    # deterministic synthetic frames: every rank generates the same
    rng = np.random.default_rng(7)
    out = None
    for f in range(args["frames"]):
        d = (2000 + 300 * rng.standard_normal((C, H, W))).astype(np.uint16)
        d[rng.random((C, H, W)) < 0.05] = 0
        t = np.linspace(0, np.pi, 64)
        arc = np.stack([2 * np.cos(t + f * 0.1), 2 * np.sin(t + f * 0.1),
                        1 + 0 * t], axis=-1).astype(np.float32)
        for i in range(C):
            eng.add_depthmap(i, d[i], intr, cams[i], cams[i])
        eng.add_point_sequence(arc, sec=5, nsec=int(f * 33e6),
                               tf_move=np.eye(4, dtype=np.float32))
        out = eng.process(5.0 + f / 30.0)
    log(f"ran {args['frames']} frames")
    rows = eng.fused_points_host(out)
    raw = eng.raw_points_host(out)
    occ = eng.occupancy_host(out)
    eng.close()
    return {
        "ranks": dist.get_world_size(),
        "mesh": dict(mesh.shape),
        "fused_total": int(len(rows)),
        "raw_total": int(len(raw)),
        "occ_sum": int(occ.astype(np.int64).sum()),
        "fused_rows_sha": hashlib.sha256(np.ascontiguousarray(
            rows[np.lexsort(rows.T)]).tobytes()).hexdigest(),
        "occ_sha": hashlib.sha256(occ.tobytes()).hexdigest(),
    }


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ranks", type=int, default=1)
    ap.add_argument("--num-space", type=int, default=1)
    ap.add_argument("--backend", choices=("gloo", "nccl"), default=None,
                    help="default: nccl on cuda, gloo on cpu")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--frames", type=int, default=3)
    ap.add_argument("--timeout", type=float, default=120.0,
                    help="seconds a collective may take")
    ap.add_argument("--digest-out", default="")
    args = ap.parse_args()
    backend = args.backend or ("nccl" if args.device == "cuda" else "gloo")
    rank_args = dict(num_space=args.num_space, device=args.device,
                     frames=args.frames)
    native.require()     # built once here, before any rank loads it
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        # started by torchrun: this process is one rank
        rank = int(os.environ["RANK"])
        dist.init_process_group(
            backend, init_method="env://",
            timeout=datetime.timedelta(seconds=args.timeout))
        try:
            digest = run_rank(rank, rank_args)
        finally:
            dist.destroy_process_group()
    else:
        rank = 0
        digest = spawn(run_rank, args.ranks, backend,
                       timeout=args.timeout,
                       join_timeout=10 * args.timeout,
                       args=(rank_args,))[0]
    if rank == 0:
        print(f"digest: {json.dumps(digest)}", flush=True)
        if args.digest_out:
            with open(args.digest_out, "w") as fh:
                json.dump(digest, fh)
    return 0


if __name__ == "__main__":
    sys.exit(main())
