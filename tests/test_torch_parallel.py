"""The port's distributed step (``parallel/``) and sharded BA on gloo CPU
ranks, against the JAX package's sharded step (``tests/test_parallel.py``'s
config and seeds, its 8 virtual CPU devices) and the port's single engine.

One 8-rank world runs every multi-rank check of this file (a 4 x 2 mesh
over 3 frames with lidar, a 2 x 4 mesh in occupied mode with decay, the
mesh layout and its errors, the BA over an 8 x 1 mesh); a 1-rank world
runs the 1 x 1 mesh. The ranks never import JAX: the JAX side runs in the
test process.

Bounds, stated before the code: against the port's single engine at
``voxel_mean_mode="packed"``, everything bit-equal (the sums the ranks add
are integers below 2^24). Against the JAX sharded step, which is jitted
(XLA:CPU contracts multiply-adds): occupancy exact, raw points within
1e-5 (as ``tests/test_parallel.py``), fused points equal but where the
contraction moved a mean, there within one quantization step (such rows
are counted and printed). BA: poses within 1e-4, the last chi2 within
rtol 1e-3 (``tests/test_slam.py:175-211``), accept decisions equal where a
step changes chi2 by more than 1e-5 relative plus 1e-9 absolute (closer,
the ``<=`` test compares sums rounded in each package's own order; below
1e-9 the chi2s are at float32's resolution of the residuals, 5 m
coordinates rounding at 3e-7 m, and this problem gets there by its third
step).
"""

import numpy as np
import pytest
import torch

from ros_gpu_depthmap_fusion_tpu_torch.core import transforms
from ros_gpu_depthmap_fusion_tpu_torch.core.camera import PinholeIntrinsics
from ros_gpu_depthmap_fusion_tpu_torch.core.config import FusionConfig
from ros_gpu_depthmap_fusion_tpu_torch.core.grid import VoxelGrid
from ros_gpu_depthmap_fusion_tpu_torch.parallel import (
    SPACE_AXIS, STREAM_AXIS, Mesh, build_sharded_fusion_step, make_mesh,
    shard_inputs, sharded_initial_state, spawn)
from ros_gpu_depthmap_fusion_tpu_torch.pipeline import engine as teng
from ros_gpu_depthmap_fusion_tpu_torch.slam import ba

WORLD = 8
AVG_MESH, OCC_MESH = (4, 2), (2, 4)
N_FRAMES = 3
BA_ITERS = 10


def _cfg(num_cams=4):
    return FusionConfig(
        num_depth_streams=num_cams, depth_height=16, depth_width=24,
        num_point_sequences=1,
        crop_min=(-6, -6, -6), crop_max=(6, 6, 6),
        voxel_min=(-6, -6, -6), voxel_max=(6, 6, 6),
        voxel_size=(0.5, 0.5, 0.5),
        rollbuffer_point_capacity=128, rollbuffer_seq_capacity=8,
        max_points_per_sequence=64,
        voxel_occupancy_lifetime=3,
        depth_link_codec="none",
        voxel_mean_mode="packed")


def _frame(cfg, seed=0, with_lidar=True):
    """``tests/test_parallel.py _frame_inputs`` as numpy FrameInputs."""
    rng = np.random.default_rng(seed)
    c = cfg.num_depth_streams
    depth = rng.integers(800, 4000, size=(c, cfg.depth_height,
                                          cfg.depth_width), dtype=np.uint16)
    depth[rng.random(depth.shape) < 0.1] = 0
    intr = np.tile(PinholeIntrinsics.default_for(
        cfg.depth_width, cfg.depth_height).as_array(), (c, 1))
    tfw = np.stack([transforms.make_se3(transforms.rot_z(i * 0.7),
                                        np.array([i, -i, 0.5 * i]))
                    for i in range(c)])
    s_cap = max(1, cfg.num_point_sequences * 4)
    pts = np.zeros((cfg.max_points_per_sequence, 4), np.float32)
    n_lidar = 20 if with_lidar else 0
    if with_lidar:
        t = np.linspace(0, 1, n_lidar)
        pts[:n_lidar, 0] = 3 * np.cos(t)
        pts[:n_lidar, 1] = 3 * np.sin(t)
        pts[:n_lidar, 2] = 1.0
        pts[:n_lidar, 3] = 1.0
    sec = np.zeros(s_cap, np.int32)
    cnt = np.zeros(s_cap, np.int32)
    sec[0], cnt[0] = 5, n_lidar
    eye = np.eye(4, dtype=np.float32)
    batch = teng.SequenceBatch(
        points=pts, seq_idx=np.zeros((cfg.max_points_per_sequence,),
                                     np.int32),
        seq_sec=sec, seq_nsec=np.zeros(s_cap, np.int32), seq_count=cnt,
        seq_tf_move=np.tile(eye, (s_cap, 1, 1)),
        num_points=np.int32(n_lidar), num_seqs=np.int32(1 if with_lidar
                                                        else 0))
    return teng.FrameInputs(
        depth=depth, intrinsics=intr.astype(np.float32),
        tf_world=tfw.astype(np.float32), tf_crop=tfw.astype(np.float32),
        seq_batch=batch, tf_world_move=eye, tf_crop_move=eye,
        now_sec=np.int32(5), now_nsec=np.int32(0), roll_min_sec=np.int32(4),
        roll_min_nsec=np.int32(900_000_000), fp_threshold=np.float32(0.5),
        fp_max_distance=np.float32(10.0), ps_threshold=np.float32(0.5))


def _empty(cfg):
    """An empty frame at t = 50 s (no depth, no lidar)."""
    f = _frame(cfg, seed=8, with_lidar=False)
    return f._replace(depth=np.zeros_like(f.depth), now_sec=np.int32(50),
                      roll_min_sec=np.int32(49))


def _ba_problem(seed=5, m=4, l=64):
    """``tests/test_slam.py _synthetic_ba_problem(l=64)`` in numpy, and its
    observations sharded landmark-major over WORLD shards (local landmark
    indices), as ``test_ba_sharded_matches_single`` shards them."""
    rng = np.random.default_rng(seed)
    lms_true = rng.uniform(-3, 3, size=(l, 3)).astype(np.float32)
    lms_true[:, 2] += 5.0
    poses_true = np.stack([np.asarray(transforms.make_se3(
        transforms.rot_y(0.1 * k), np.array([0.5 * k, 0, 0])))
        for k in range(m)])
    op, ol, pt = [], [], []
    for k in range(m):
        r, t = poses_true[k, :3, :3], poses_true[k, :3, 3]
        for j in range(l):
            p_cam = r.T @ (lms_true[j] - t)
            if p_cam[2] > 0.5:
                op.append(k)
                ol.append(j)
                pt.append(p_cam)
    poses0 = poses_true.copy()
    for k in range(1, m):
        poses0[k, :3, 3] += rng.normal(size=3) * 0.05
    lms0 = lms_true + rng.normal(size=lms_true.shape) * 0.05
    whole = (poses0.astype(np.float32), lms0.astype(np.float32),
             np.array(op, np.int32), np.array(ol, np.int32),
             np.array(pt, np.float32), np.ones(len(op), bool))
    lps = l // WORLD
    shard_obs = [[] for _ in range(WORLD)]
    for i, j in enumerate(ol):
        shard_obs[j // lps].append(i)
    ops = max(len(s) for s in shard_obs)
    sh = dict(obs_pose=np.zeros((WORLD, ops), np.int32),
              obs_lm=np.zeros((WORLD, ops), np.int32),
              obs_pt=np.zeros((WORLD, ops, 3), np.float32),
              obs_valid=np.zeros((WORLD, ops), bool))
    for d, idxs in enumerate(shard_obs):
        for q, i in enumerate(idxs):
            sh["obs_pose"][d, q] = op[i]
            sh["obs_lm"][d, q] = ol[i] - d * lps
            sh["obs_pt"][d, q] = pt[i]
            sh["obs_valid"][d, q] = True
    return whole, sh, lps, ops


def _host(out):
    return {k: v.numpy().copy() for k, v in out._asdict().items()}


def _run_mesh(cfg, shape, frames):
    """The sharded step over ``frames`` on a ``shape`` mesh: this rank's
    outputs of each frame."""
    mesh = make_mesh(*shape, device="cpu")
    grid = VoxelGrid.from_config(cfg)
    step = build_sharded_fusion_step(cfg, grid, mesh)
    st = sharded_initial_state(cfg, grid, mesh)
    outs = []
    for inp in frames:
        st, out = step(st, shard_inputs(inp, mesh))
        outs.append(_host(out))
    return outs


def _world(rank):
    """Every multi-rank check of this file, on one rank of the 8-rank
    world; returns this rank's results."""
    import torch.distributed as dist
    res = {}
    cfg = _cfg(4)
    res["avg"] = _run_mesh(cfg, AVG_MESH, [_frame(cfg, seed=s)
                                           for s in range(N_FRAMES)])[-1]
    occ_cfg = _cfg(2).replace(voxel_enable_average=False)
    occ = _run_mesh(occ_cfg, OCC_MESH, [_frame(occ_cfg, seed=7)]
                    + [_empty(occ_cfg)] * occ_cfg.voxel_occupancy_lifetime)
    res["occ_first"], res["occ_last"] = occ[0], occ[-1]
    # the mesh's layout, and its errors
    m = make_mesh(num_space=2, device="cpu")
    res["layout"] = (dict(m.shape), m.stream_id, m.space_id, m.rank,
                     dist.get_process_group_ranks(m.group(STREAM_AXIS)),
                     dist.get_process_group_ranks(m.group(SPACE_AXIS)))
    res["shape_8x1"] = dict(make_mesh(num_stream=8, num_space=1,
                                      device="cpu").shape)
    res["errors"] = []
    for kw in (dict(num_stream=3, num_space=2), dict(num_space=3),
               dict(num_stream=8, num_space=2)):
        try:
            make_mesh(**kw, device="cpu")
            res["errors"].append(None)
        except ValueError as e:
            res["errors"].append(str(e))
    # BA over the stream axis of an 8 x 1 mesh, this rank's shard
    whole, sh, lps, ops = _ba_problem()
    mesh = make_mesh(WORLD, 1, device="cpu")
    step = ba.build_sharded_ba_step(mesh, STREAM_AXIS, num_poses=4,
                                    landmarks_per_shard=lps,
                                    obs_per_shard=ops, iterations=BA_ITERS)
    t = torch.from_numpy
    poses, lms, chi2s, cands = step(
        t(whole[0]), t(whole[1][rank * lps:(rank + 1) * lps]),
        t(sh["obs_pose"][rank]), t(sh["obs_lm"][rank]),
        t(sh["obs_pt"][rank]), t(sh["obs_valid"][rank]))
    res["ba"] = (poses.numpy(), lms.numpy(), chi2s.numpy(), cands.numpy())
    return res


def _world_1x1(rank):
    cfg = _cfg(4)
    return _run_mesh(cfg, (1, 1), [_frame(cfg, seed=s)
                                   for s in range(N_FRAMES)])


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    store = tmp_path_factory.mktemp("world") / "store"
    return spawn(_world, WORLD, "gloo", init_method=f"file://{store}",
                 timeout=60, join_timeout=300, threads=1)


def _local_mesh():
    """A 1 x 1 mesh on the CPU without a process group: enough for the
    builders' checks."""
    return Mesh(shape={STREAM_AXIS: 1, SPACE_AXIS: 1}, stream_id=0,
                space_id=0, groups={}, device=torch.device("cpu"),
                backend="gloo")


def _single(cfg, frames):
    """The port's single engine step over ``frames`` (raw cloud emitted):
    the last frame's outputs."""
    grid = VoxelGrid.from_config(cfg)
    out_cap = min(grid.num_cells, cfg.total_point_capacity,
                  cfg.voxelize_output_capacity)
    st = teng.initial_state(cfg, grid, "cpu")
    for inp in frames:
        st, out = teng.fusion_step(st, teng.inputs_to_device(inp, "cpu"),
                                   cfg=cfg, grid=grid,
                                   output_capacity=out_cap)
    return out


def _sorted(rows):
    rows = np.asarray(rows)
    return rows[np.lexsort(rows.T)]


def _avg_views(world, n_stream, n_space):
    """(occupancy [padded], raw rows by stream, fused rows by (space,
    stream) block) of the average-mode run, from the ranks' shards."""
    r = [w["avg"] for w in world]
    occ = np.concatenate([r[j]["occupancy_u8"] for j in range(n_space)])
    raw = [r[t * n_space]["raw_points"][:int(r[t * n_space]["raw_counts"][0])]
           for t in range(n_stream)]
    fused = [r[t * n_space + j]["fused_points"][
        :int(r[t * n_space + j]["fused_counts"][0])]
        for j in range(n_space) for t in range(n_stream)]
    return occ, raw, fused


def test_sharded_4x2_matches_single_engine(world):
    cfg = _cfg(4)
    grid = VoxelGrid.from_config(cfg)
    n_stream, n_space = AVG_MESH
    ref = _single(cfg, [_frame(cfg, seed=s) for s in range(N_FRAMES)])
    occ, raw, fused = _avg_views(world, n_stream, n_space)
    np.testing.assert_array_equal(occ[:grid.num_cells],
                                  ref.occupancy_u8.numpy())
    assert not occ[grid.num_cells:].any()
    # replicated shards agree: raw over space, occupancy over stream
    for t in range(n_stream):
        for j in range(n_space):
            w = world[t * n_space + j]["avg"]
            np.testing.assert_array_equal(
                w["raw_points"], world[t * n_space]["avg"]["raw_points"])
            np.testing.assert_array_equal(
                w["occupancy_bits"], world[j]["avg"]["occupancy_bits"])
    got_raw = np.concatenate(raw)
    ref_raw = ref.raw_points.numpy()[:int(ref.raw_count)]
    assert got_raw.shape == ref_raw.shape
    np.testing.assert_array_equal(_sorted(got_raw), _sorted(ref_raw))
    got_f = np.concatenate(fused)
    ref_f = ref.fused_points.numpy()[:int(ref.fused_count)]
    # the space-major, stream-minor blocks are in ascending cell order
    np.testing.assert_array_equal(got_f, ref_f)


def test_sharded_4x2_matches_jax(world):
    import jax
    from ros_gpu_depthmap_fusion_tpu.core.config import FusionConfig as JCfg
    from ros_gpu_depthmap_fusion_tpu.core.grid import VoxelGrid as JGrid
    from ros_gpu_depthmap_fusion_tpu.parallel import (
        make_mesh as jmake_mesh, build_sharded_fusion_step as jbuild,
        sharded_initial_state as jinit, input_shardings)
    from ros_gpu_depthmap_fusion_tpu.pipeline.engine import (
        FrameInputs as JInputs, SequenceBatch as JBatch)
    cfg = _cfg(4)
    jcfg = JCfg(**{f: getattr(cfg, f) for f in cfg.__dataclass_fields__})
    jgrid = JGrid.from_config(jcfg)
    n_stream, n_space = AVG_MESH
    mesh = jmake_mesh(num_stream=n_stream, num_space=n_space)
    step = jbuild(jcfg, jgrid, mesh)
    st = jinit(jcfg, jgrid, mesh)
    for s in range(N_FRAMES):
        f = _frame(cfg, seed=s)
        inp = JInputs(*f[:4], JBatch(*f.seq_batch), *f[5:])
        st, out = step(st, jax.device_put(inp, input_shardings(mesh)))
    occ, raw, fused = _avg_views(world, n_stream, n_space)
    np.testing.assert_array_equal(occ, np.asarray(out.occupancy_u8))
    np.testing.assert_array_equal(
        np.concatenate([world[j]["avg"]["occupancy_bits"]
                        for j in range(n_space)]),
        np.asarray(out.occupancy_bits))
    local_cap = raw_cap = world[0]["avg"]["raw_points"].shape[0]
    jraw = np.asarray(out.raw_points).reshape(n_stream, raw_cap, 4)
    jrc = np.asarray(out.raw_counts)
    for t in range(n_stream):
        assert raw[t].shape[0] == jrc[t], (t, raw[t].shape, jrc[t])
        np.testing.assert_allclose(raw[t], jraw[t, :jrc[t]], rtol=0,
                                   atol=1e-5)
    assert local_cap == cfg.depth_pixels_per_stream + 128 // n_stream
    jfc = np.asarray(out.fused_counts)
    jf = np.asarray(out.fused_points).reshape(len(jfc), -1, 4)
    step_q = np.array([0.5 / 1024, 0.5 / 1024, 0.5 / 4096, 0.0])
    moved = 0
    for b, rows in enumerate(fused):
        assert rows.shape[0] == jfc[b], (b, rows.shape, jfc[b])
        diff = np.abs(rows - jf[b, :jfc[b]])
        assert (diff <= step_q * (1 + 1e-6)).all(), (b, diff.max(0))
        moved += int((diff > 0).any(axis=1).sum())
    print(f"fused rows moved by the jitted JAX step's contraction: {moved} "
          f"of {sum(len(f) for f in fused)}")


def test_sharded_2x4_occupied_mode_and_decay(world):
    cfg = _cfg(2).replace(voxel_enable_average=False)
    n_stream, n_space = OCC_MESH
    first = [w["occ_first"] for w in world]
    occ = np.concatenate([first[j]["occupancy_u8"] for j in range(n_space)])
    occupied = np.flatnonzero(occ > 0)
    assert len(occupied)
    fused = np.concatenate([first[j]["fused_points"][
        :int(first[j]["fused_counts"][0])] for j in range(n_space)])
    assert len(fused) == len(occupied)
    # equal, in order, to the single engine's occupied cell corners
    ref = _single(cfg, [_frame(cfg, seed=7)])
    np.testing.assert_array_equal(
        fused, ref.fused_points.numpy()[:int(ref.fused_count)])
    np.testing.assert_array_equal(occ[:ref.occupancy_u8.shape[0]],
                                  ref.occupancy_u8.numpy())
    for w in world:
        assert not w["occ_last"]["occupancy_u8"].any()
        assert int(w["occ_last"]["fused_counts"][0]) == 0


def test_mesh_layout_and_errors(world):
    for rank, w in enumerate(world):
        shape, t, j, r, stream_ranks, space_ranks = w["layout"]
        assert shape == {"stream": 4, "space": 2}
        assert (t, j, r) == (rank // 2, rank % 2, rank)
        assert stream_ranks == [k * 2 + j for k in range(4)]
        assert space_ranks == [t * 2 + s for s in range(2)]
        assert w["shape_8x1"] == {"stream": 8, "space": 1}
        assert all(e is not None and "does not" in e for e in w["errors"])
    with pytest.raises(RuntimeError, match="process group"):
        make_mesh(1, 1, device="cpu")


def test_sharded_ba_matches_solve_window_and_jax(world):
    import jax.numpy as jnp
    from ros_gpu_depthmap_fusion_tpu.parallel.mesh import (
        make_mesh as jmake_mesh)
    from ros_gpu_depthmap_fusion_tpu.slam.ba import (
        build_sharded_ba_step as jbuild)
    whole, sh, lps, ops = _ba_problem()
    got = [w["ba"] for w in world]
    poses, chi2s, cands = got[0][0], got[0][2], got[0][3]
    for g in got[1:]:
        np.testing.assert_array_equal(g[0], poses)
        np.testing.assert_array_equal(g[2], chi2s)
    lms = np.concatenate([g[1] for g in got])
    # the port's single-window BA on the whole problem
    prob = ba.BAProblem(*map(torch.from_numpy, whole))
    p1, l1, c1, k1 = ba._iterate(prob, BA_ITERS, 1e-4)
    # JAX's sharded BA on its 8 virtual devices
    jstep = jbuild(jmake_mesh(num_stream=WORLD, num_space=1), "stream",
                   num_poses=4, landmarks_per_shard=lps, obs_per_shard=ops,
                   iterations=BA_ITERS)
    jp, jl, jc = jstep(jnp.asarray(whole[0]), jnp.asarray(whole[1]),
                       *(jnp.asarray(sh[k].reshape((-1,) + sh[k].shape[2:]))
                         for k in ("obs_pose", "obs_lm", "obs_pt",
                                   "obs_valid")))
    acc = (cands <= chi2s).tolist()
    tie = (np.abs(cands - chi2s) <= 1e-5 * chi2s + 1e-9).tolist()
    assert sum(not t for t in tie) >= 2
    acc1 = (k1 <= c1).tolist()
    assert all(a == b or t for a, b, t in zip(acc, acc1, tie))
    for ref_p, ref_c in ((p1.numpy(), c1.numpy()),
                         (np.asarray(jp), np.asarray(jc))):
        np.testing.assert_allclose(poses, ref_p, rtol=0, atol=1e-4)
        np.testing.assert_allclose(chi2s[-1], ref_c[-1], rtol=1e-3,
                                   atol=1e-6)
    np.testing.assert_allclose(lms, l1.numpy(), rtol=0, atol=1e-4)
    np.testing.assert_allclose(lms, np.asarray(jl), rtol=0, atol=1e-4)
    assert chi2s[-1] < chi2s[0] * 1e-3


def test_sharded_1x1_matches_single_engine(tmp_path):
    outs = spawn(_world_1x1, 1, "gloo",
                 init_method=f"file://{tmp_path / 'store'}", timeout=60,
                 join_timeout=180, threads=1)[0]
    cfg = _cfg(4)
    grid = VoxelGrid.from_config(cfg)
    ref = _single(cfg, [_frame(cfg, seed=s) for s in range(N_FRAMES)])
    last = outs[-1]
    np.testing.assert_array_equal(last["occupancy_u8"][:grid.num_cells],
                                  ref.occupancy_u8.numpy())
    np.testing.assert_array_equal(
        last["raw_points"][:int(last["raw_counts"][0])],
        ref.raw_points.numpy()[:int(ref.raw_count)])
    np.testing.assert_array_equal(
        last["fused_points"][:int(last["fused_counts"][0])],
        ref.fused_points.numpy()[:int(ref.fused_count)])


def test_sharded_builder_refuses_unsupported_configs():
    grid = VoxelGrid.from_config(_cfg(2))
    mesh = _local_mesh()
    with pytest.raises(ValueError, match="depth_link_codec"):
        build_sharded_fusion_step(
            _cfg(2).replace(depth_link_codec="dpcm_temporal"), grid, mesh)
    with pytest.raises(ValueError, match="stream_shapes"):
        build_sharded_fusion_step(
            _cfg(2).replace(stream_shapes=((16, 24), (8, 16))), grid, mesh)
    with pytest.raises(ValueError, match="rollbuffer_point_capacity"):
        sharded_initial_state(
            _cfg(2), grid, Mesh(shape={STREAM_AXIS: 3, SPACE_AXIS: 1},
                                stream_id=0, space_id=0, groups={},
                                device=torch.device("cpu"), backend="gloo"))
