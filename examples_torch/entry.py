"""Entry points of the PyTorch port (the JAX package's
``__graft_entry__.py``), on a named device:

- :func:`entry` -- one step of the fused depth + lidar frame step on a
  tiny rig: ``(fn, example_args)`` with the state and inputs on the device.
- :func:`dryrun_multichip` -- the sharded frame step on ``n_ranks`` ranks
  (a ``(stream, space)`` mesh, cameras data-parallel, the voxel grid
  block-partitioned) for one step on tiny shapes, held to the single step
  on the same inputs: occupancy and raw count equal, the fused point set
  equal; then the same at the operating point (8 cameras at 848x480 into
  the 3.36M-cell grid) through the engines.

Run: PYTHONPATH=.:$PYTHONPATH python examples_torch/entry.py \
    [--device cuda|cpu] [--ranks 2] [--no-operating-scale]
"""

import argparse
import functools

import numpy as np
import torch

from ros_gpu_depthmap_fusion_tpu_torch.core.camera import PinholeIntrinsics
from ros_gpu_depthmap_fusion_tpu_torch.core.config import FusionConfig
from ros_gpu_depthmap_fusion_tpu_torch.core.grid import VoxelGrid
from ros_gpu_depthmap_fusion_tpu_torch.pipeline.engine import (
    FrameInputs, SequenceBatch, fusion_step, initial_state, inputs_to_device)


def _tiny_cfg(num_cams):
    return FusionConfig(
        num_depth_streams=num_cams, depth_height=16, depth_width=24,
        num_point_sequences=1,
        crop_min=(-6, -6, -6), crop_max=(6, 6, 6),
        voxel_min=(-6, -6, -6), voxel_max=(6, 6, 6),
        voxel_size=(0.5, 0.5, 0.5),
        rollbuffer_point_capacity=128, rollbuffer_seq_capacity=8,
        max_points_per_sequence=64,
        voxel_occupancy_lifetime=3,
    )


def _frame_inputs(cfg, seed=0) -> FrameInputs:
    """A frame of host (numpy) inputs: random depth, identity poses and a
    16-point lidar arc."""
    rng = np.random.default_rng(seed)
    c = cfg.num_depth_streams
    depth = rng.integers(800, 4000, size=(c, cfg.depth_height,
                                          cfg.depth_width), dtype=np.uint16)
    intr = np.tile(PinholeIntrinsics.default_for(
        cfg.depth_width, cfg.depth_height).as_array(), (c, 1))
    eye = np.eye(4, dtype=np.float32)
    tfs = np.tile(eye, (c, 1, 1))
    s_cap = max(1, cfg.num_point_sequences * 4)
    pts = np.zeros((cfg.max_points_per_sequence, 4), np.float32)
    t = np.linspace(0, 1, 16)
    pts[:16, 0] = 3 * np.cos(t)
    pts[:16, 1] = 3 * np.sin(t)
    pts[:16, 2:4] = 1.0
    sec = np.zeros(s_cap, np.int32)
    cnt = np.zeros(s_cap, np.int32)
    sec[0], cnt[0] = 5, 16
    batch = SequenceBatch(
        points=pts, seq_idx=np.zeros((cfg.max_points_per_sequence,),
                                     np.int32),
        seq_sec=sec, seq_nsec=np.zeros(s_cap, np.int32), seq_count=cnt,
        seq_tf_move=np.tile(eye, (s_cap, 1, 1)),
        num_points=np.int32(16), num_seqs=np.int32(1))
    return FrameInputs(
        depth=depth, intrinsics=intr.astype(np.float32), tf_world=tfs,
        tf_crop=tfs, seq_batch=batch, tf_world_move=eye, tf_crop_move=eye,
        now_sec=np.int32(5), now_nsec=np.int32(0), roll_min_sec=np.int32(4),
        roll_min_nsec=np.int32(900_000_000),
        fp_threshold=np.float32(cfg.flyingpixels_filter_threshold),
        fp_max_distance=np.float32(cfg.flyingpixels_max_distance),
        ps_threshold=np.float32(cfg.point_sequence_filter_threshold))


def entry(device):
    """``(fn, (state, inputs))`` of one frame step on ``device``: ``fn(*args)``
    returns ``(new_state, FrameOutputs)``."""
    cfg = _tiny_cfg(num_cams=2)
    grid = VoxelGrid.from_config(cfg)
    fn = functools.partial(fusion_step, cfg=cfg, grid=grid,
                           output_capacity=256)
    state = initial_state(cfg, grid, device)
    return fn, (state, inputs_to_device(_frame_inputs(cfg), device))


def _backend(device, n_ranks):
    """NCCL when every rank has a card of its own, else gloo."""
    if torch.device(device).type == "cuda" \
            and n_ranks <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def _rank_device(rank, device):
    if torch.device(device).type == "cuda":
        return torch.device("cuda", rank % torch.cuda.device_count())
    return torch.device(device)


def _tiny_rank(rank, n_stream, n_space, device):
    """One rank of the tiny sharded step: its shard's outputs, on the host."""
    from ros_gpu_depthmap_fusion_tpu_torch.parallel import (
        build_sharded_fusion_step, make_mesh, shard_inputs,
        sharded_initial_state)
    mesh = make_mesh(n_stream, n_space, device=_rank_device(rank, device))
    cfg = _tiny_cfg(num_cams=n_stream)   # one camera a stream rank
    grid = VoxelGrid.from_config(cfg)
    step = build_sharded_fusion_step(cfg, grid, mesh)
    _, out = step(sharded_initial_state(cfg, grid, mesh),
                  shard_inputs(_frame_inputs(cfg), mesh))
    return {k: v.cpu().numpy() for k, v in out._asdict().items()}


def _point_set(rows):
    return set(map(tuple, np.round(rows, 5).tolist()))


def dryrun_multichip(n_ranks: int, device, operating_scale: bool = True
                     ) -> None:
    """The sharded step on ``n_ranks`` spawned ranks (stream x space =
    n_ranks / 2 x 2 for an even count, else n_ranks x 1) held to the
    single step on the same inputs; raises ``AssertionError`` when they
    differ. ``operating_scale`` also runs :func:`_operating_scale_check`."""
    from ros_gpu_depthmap_fusion_tpu_torch.parallel import spawn
    n_space = 2 if n_ranks % 2 == 0 else 1
    n_stream = n_ranks // n_space
    shards = spawn(_tiny_rank, n_ranks, _backend(device, n_ranks),
                   join_timeout=600, args=(n_stream, n_space, str(device)))
    cfg = _tiny_cfg(num_cams=n_stream)
    grid = VoxelGrid.from_config(cfg)
    occ = np.concatenate([shards[j]["occupancy_u8"]
                          for j in range(n_space)])[:grid.num_cells]
    raw = sum(int(shards[t * n_space]["raw_counts"][0])
              for t in range(n_stream))
    fused = np.concatenate([s["fused_points"][:int(s["fused_counts"][0])]
                            for s in shards])
    assert raw > 0, "sharded step produced no points"
    assert (occ > 0).sum() > 0, "sharded step produced no occupancy"
    # the single step on the same inputs, at "packed": the ranks add
    # integer partial sums, which commute, so the fused set is equal
    pcfg = cfg.replace(voxel_mean_mode="packed")
    _, ref = fusion_step(initial_state(pcfg, grid, device),
                         inputs_to_device(_frame_inputs(pcfg), device),
                         cfg=pcfg, grid=grid, output_capacity=256)
    np.testing.assert_array_equal(occ, ref.occupancy_u8.cpu().numpy())
    assert raw == int(ref.raw_count), (raw, int(ref.raw_count))
    got = _point_set(fused)
    want = _point_set(ref.fused_points.cpu().numpy()[:int(ref.fused_count)])
    assert got == want, (f"fused point sets differ: {len(got)} vs "
                         f"{len(want)}")
    print(f"dryrun_multichip({n_ranks}): mesh stream {n_stream} x space "
          f"{n_space} raw_points={raw} occupied_cells={int((occ > 0).sum())}"
          f" fused={len(got)} == single step OK")
    if operating_scale:
        _operating_scale_check(n_ranks, device)


def _operating_cfg():
    return FusionConfig(
        num_depth_streams=8, depth_height=480, depth_width=848,
        num_point_sequences=2,
        crop_min=(-20, -20, 0), crop_max=(20, 20, 2.5),
        voxel_min=(-20, -20, 0), voxel_max=(20, 20, 2.5),
        voxel_size=(0.1, 0.1, 0.12),        # 400 x 400 x 21 cells
        voxel_occupancy_lifetime=10,
        rollbuffer_point_capacity=98304, rollbuffer_seq_capacity=1024,
        max_points_per_sequence=16384,
        voxel_mean_mode="packed", emit_raw_points=True)


def _operating_frames():
    """Two frames of the operating point: 8 cameras around the grid and two
    lidar arcs (``__graft_entry__.py``'s scene)."""
    from ros_gpu_depthmap_fusion_tpu_torch.core import transforms
    H, W, C = 480, 848, 8
    rng = np.random.default_rng(7)
    u, v = np.meshgrid(np.arange(W), np.arange(H))
    base = 2500 + 200 * np.sin(u / 150.0) + 150 * np.cos(v / 120.0)
    t_l = np.linspace(0, np.pi, 16384)
    arc = np.stack([6 * np.cos(t_l), 6 * np.sin(t_l),
                    1 + 0.3 * np.sin(5 * t_l)], -1).astype(np.float32)
    cams = []
    for i in range(C):
        ang = i * 2 * np.pi / C
        pos = np.array([8 * np.cos(ang), 8 * np.sin(ang), 2.0])
        cams.append(transforms.make_se3(
            transforms.rot_z(ang + np.pi)
            @ transforms.rot_x(-np.pi / 2 - 0.3), pos))
    frames = []
    for f in range(2):
        d = (base + rng.standard_normal((H, W))).astype(np.uint16)
        d[rng.random((H, W)) < 0.01] = 0
        frames.append((d, cams, arc, f))
    return frames


def _drive(eng, frames):
    intr = PinholeIntrinsics.default_for(848, 480)
    out = None
    for d, cams, arc, f in frames:
        for i, tf in enumerate(cams):
            eng.add_depthmap(i, d, intr, tf, tf)
        for _ in range(2):
            eng.add_point_sequence(arc, sec=10, nsec=int(f * 33e6),
                                   tf_move=np.eye(4, dtype=np.float32))
        out = eng.process(10.0 + f / 30.0)
    return out


def _operating_rank(rank, n_stream, n_space, device):
    from ros_gpu_depthmap_fusion_tpu_torch.parallel import make_mesh
    from ros_gpu_depthmap_fusion_tpu_torch.parallel.engine import (
        ShardedFusionEngine)
    mesh = make_mesh(n_stream, n_space, device=_rank_device(rank, device))
    eng = ShardedFusionEngine(_operating_cfg(), mesh)
    out = _drive(eng, _operating_frames())
    return dict(occ=eng.occupancy_host(out), fused=eng.fused_points_host(out),
                raw=len(eng.raw_points_host(out)))


def _operating_scale_check(n_ranks: int, device) -> None:
    """The sharded engine against the single engine at the operating point
    (8 cameras at 848x480, 2 x 16,384 lidar points, 3,360,000 cells, the
    "dpcm" link): occupancy and the fused point set equal."""
    from ros_gpu_depthmap_fusion_tpu_torch.parallel import spawn
    from ros_gpu_depthmap_fusion_tpu_torch.pipeline.engine import (
        FusionEngine)
    from ros_gpu_depthmap_fusion_tpu_torch.utils import native
    n_space = 2 if n_ranks % 2 == 0 else 1
    n_stream = n_ranks // n_space
    native.require()     # built once here, before any rank loads it
    got = spawn(_operating_rank, n_ranks, _backend(device, n_ranks),
                join_timeout=1200, args=(n_stream, n_space, str(device)))[0]
    single = FusionEngine(_operating_cfg(), device)
    out = _drive(single, _operating_frames())
    occ = out.occupancy_u8.cpu().numpy()
    np.testing.assert_array_equal(got["occ"], occ)
    fused = out.fused_points.cpu().numpy()[:int(out.fused_count)]
    assert got["fused"].shape == fused.shape, (got["fused"].shape,
                                               fused.shape)
    assert _point_set(got["fused"]) == _point_set(fused)
    assert got["raw"] == int(out.raw_count)
    print(f"operating-scale check({n_ranks}): 8 x 848x480 depth, "
          f"{VoxelGrid.from_config(_operating_cfg()).num_cells} cells, "
          f"raw_points={got['raw']} occupied={int((occ > 0).sum())} "
          f"fused={len(fused)} == single engine OK")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--no-operating-scale", action="store_true")
    args = ap.parse_args()
    fn, fargs = entry(args.device)
    _, out = fn(*fargs)
    print("entry OK; fused:", int(out.fused_count))
    dryrun_multichip(args.ranks, args.device,
                     operating_scale=not args.no_operating_scale)


if __name__ == "__main__":
    main()
