"""The port's ``ShardedFusionEngine`` on gloo CPU ranks against the port's
single engine: ``tests/test_sharded_engine.py``'s five tests, and a coded
frame with DPCM exceptions in every stream shard. One 8-rank world (a
4 x 2 mesh) runs the engine cases; the refusals need no world.

Bound, stated before the code: every output bit-equal to the single
engine at ``voxel_mean_mode="packed"`` (where the JAX tests allow 1e-5 and
1e-4 between their two engines), the host views equal on every rank, and
the objects and tracks of the mapping equal.
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
    spawn)
from ros_gpu_depthmap_fusion_tpu_torch.parallel.engine import (
    ShardedFusionEngine)
from ros_gpu_depthmap_fusion_tpu_torch.pipeline.engine import FusionEngine
from ros_gpu_depthmap_fusion_tpu_torch.utils import native

WORLD, MESH = 8, (4, 2)


def _cfg(**kw):
    return FusionConfig(
        num_depth_streams=4, depth_height=16, depth_width=24,
        crop_min=(-6, -6, -6), crop_max=(6, 6, 6),
        voxel_min=(-6, -6, -6), voxel_max=(6, 6, 6),
        voxel_size=(0.5, 0.5, 0.5), voxel_occupancy_lifetime=3,
        rollbuffer_point_capacity=64, rollbuffer_seq_capacity=8,
        max_points_per_sequence=32, depth_link_codec="none",
        voxel_mean_mode="packed").replace(**kw)


def _midsize_cfg():
    return FusionConfig(
        num_depth_streams=4, depth_height=128, depth_width=160,
        crop_min=(0, 0, 0), crop_max=(19.2, 19.2, 11.2),
        voxel_min=(0, 0, 0), voxel_max=(19.2, 19.2, 11.2),
        voxel_size=(0.2, 0.2, 0.2),   # 96 x 96 x 56 = 516,096 cells
        voxel_occupancy_lifetime=3,
        rollbuffer_point_capacity=64, rollbuffer_seq_capacity=8,
        max_points_per_sequence=32, voxel_mean_mode="packed")


def _cases():
    """(name, cfg, engine keywords, frames) of each engine case; a frame is
    (per-camera depth, intrinsics, per-camera transform, live filter
    change or None). Seeds and scenes of ``tests/test_sharded_engine.py``.
    """
    eye = np.eye(4, dtype=np.float32)
    intr = PinholeIntrinsics.default_for(24, 16)
    rng = np.random.default_rng(0)
    random = rng.integers(500, 4000, size=(4, 16, 24), dtype=np.uint16)
    cases = [("match", _cfg(), {}, [(random, intr, [eye] * 4, None)] * 2)]
    # smooth depth, so each stream's points survive the flying-pixel filter
    # at their own metric scale
    u = np.arange(24)[None, :] + np.zeros((16, 1))
    smooth = np.stack([(2000 + 40 * u + 100 * i).astype(np.uint16)
                       for i in range(4)])
    cases.append(("scales",
                  _cfg(depth_scales=(0.001, 0.0005, 0.002, 0.001)), {},
                  [(smooth, intr, [eye] * 4, None)] * 2))
    if not native.available():
        return cases
    # the coded link on random depth: 2-bit codes and exceptions in every
    # camera, so every stream rank rebases and drops its share
    cases.append(("exceptions", _cfg(depth_link_codec="dpcm"), {},
                  [(random, intr, [eye] * 4, None)] * 2))
    # two blobs: two objects in the 0.5 m grid
    blobs = np.zeros((4, 16, 24), np.uint16)
    blobs[:, 2:6, 2:8] = 2000
    blobs[:, 10:14, 14:22] = 4000
    cases.append(("mapping", _cfg(object_min_area=0.0),
                  dict(enable_mapping=True),
                  [(blobs, intr, [eye] * 4, None)] * 3))
    # mid-size, coded link, pipelined, a live filter change at frame 1
    rng = np.random.default_rng(1)
    tf = transforms.make_se3(transforms.rot_x(-np.pi / 2),
                             np.array([9.6, 1.0, 5.0])).astype(np.float32)
    base = 4000 + 800 * np.sin(np.arange(160) / 20.0)
    frames = []
    for f in range(3):
        d = (base[None, :] + 500 * np.sin(np.arange(128) / 15.0)[:, None]
             + 30 * rng.standard_normal((4, 128, 160))).astype(np.uint16)
        d[rng.random((4, 128, 160)) < 0.02] = 0
        frames.append((d, PinholeIntrinsics.default_for(160, 128), [tf] * 4,
                       dict(fp_threshold=0.3, fp_max_distance=9.0)
                       if f == 1 else None))
    cases.append(("midsize", _midsize_cfg(), dict(pipeline_depth=1),
                  frames))
    return cases


def _drive(eng, frames, on_out):
    """Feed ``frames`` to ``eng`` (``flush`` when pipelined), calling
    ``on_out`` on every frame's outputs."""
    for f, (depth, intr, tfs, filters) in enumerate(frames):
        for i in range(depth.shape[0]):
            eng.add_depthmap(i, depth[i], intr, tfs[i], tfs[i])
        if filters:
            eng.set_runtime_filters(**filters)
        out = eng.process(1.0 + f * 0.1)
        if out is not None:
            on_out(out)
    if eng.pipeline_depth:
        on_out(eng.flush())
    eng.close()


def _objects(res):
    return (sorted(tuple(np.round(o.centroid, 5)) for o in res.objects),
            sorted(round(t.score, 4) for t in res.tracks))


def _world(rank):
    mesh = make_mesh(*MESH, device="cpu")
    res = {}
    for name, cfg, kw, frames in _cases():
        eng = ShardedFusionEngine(cfg, mesh, **kw)
        views = []

        def on_out(out, eng=eng, views=views):
            v = dict(occ=eng.occupancy_host(out),
                     bits=eng.occupancy_grid_from_bits(out),
                     raw=eng.raw_points_host(out),
                     fused=eng.fused_points_host(out))
            if eng.mapping is not None:
                v["objects"] = _objects(eng.segment_and_track(out))
            views.append(v)
        _drive(eng, frames, on_out)
        res[name] = dict(views=views, last_bits=eng._last_bits)
    return res


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    native.available()      # build the native library once, before the ranks
    store = tmp_path_factory.mktemp("world") / "store"
    res = spawn(_world, WORLD, "gloo", init_method=f"file://{store}",
                timeout=60, join_timeout=420, threads=1)
    singles = {}
    for name, cfg, kw, frames in _cases():
        eng = FusionEngine(cfg, "cpu", enable_mapping="mapping" in name)
        outs = []

        def on_out(out, eng=eng, outs=outs):
            o = dict(occ=out.occupancy_u8.numpy(),
                     raw=out.raw_points.numpy()[:int(out.raw_count)],
                     fused=out.fused_points.numpy()[:int(out.fused_count)])
            if eng.mapping is not None:
                o["objects"] = _objects(eng.segment_and_track(out))
            outs.append(o)
        _drive(eng, frames, on_out)
        singles[name] = outs
    return res, singles


def _sorted(rows):
    return rows[np.lexsort(rows.T)]


def _check_case(world, name):
    res, singles = world
    ref = singles[name]
    for rank in range(WORLD):
        views = res[rank][name]["views"]
        assert len(views) == len(ref)
        for v, r in zip(views, ref):
            np.testing.assert_array_equal(v["occ"], r["occ"])
            np.testing.assert_array_equal(v["bits"].reshape(-1),
                                          (r["occ"] > 0).astype(np.uint8))
            assert v["raw"].shape == r["raw"].shape
            np.testing.assert_array_equal(_sorted(v["raw"]),
                                          _sorted(r["raw"]))
            # the fused blocks come in ascending cell order
            np.testing.assert_array_equal(v["fused"], r["fused"])
    return res[0][name]["views"]


def test_sharded_engine_matches_single(world):
    views = _check_case(world, "match")
    assert len(views[-1]["fused"]) > 0


def test_sharded_engine_midsize_pipelined_codec(world):
    if "midsize" not in world[0][0]:
        pytest.skip("native library not built")
    views = _check_case(world, "midsize")
    assert len(views) == 3
    assert world[0][0]["midsize"]["last_bits"] > 0   # the codec engaged


def test_sharded_engine_per_stream_depth_scales(world):
    views = _check_case(world, "scales")
    zs = np.unique(np.round(views[-1]["raw"][:, 2], 4))
    assert len(zs) > 4


def test_sharded_engine_exceptions_in_every_stream_shard(world):
    """DPCM exceptions carry global pixel indices; each stream rank keeps
    those of its own camera (``parallel/sharded.py:263-276``). Here every
    camera, so every one of the 4 stream ranks, has some."""
    if "exceptions" not in world[0][0]:
        pytest.skip("native library not built")
    from ros_gpu_depthmap_fusion_tpu_torch.ops.depth_codec import B_BUCKETS
    depth = _cases()[0][3][0][0]
    enc, bits = native.depth_encode(depth, 8192, allowed_bits=B_BUCKETS)
    n = int(enc["exc_count"])
    pix = depth.shape[1] * depth.shape[2]
    assert bits > 0 and set(enc["exc_idx"][:n] // pix) == {0, 1, 2, 3}
    assert world[0][0]["exceptions"]["last_bits"] == bits
    _check_case(world, "exceptions")


def test_sharded_engine_refuses_unsupported_configs():
    mesh = Mesh(shape={STREAM_AXIS: 2, SPACE_AXIS: 4}, stream_id=0,
                space_id=0, groups={}, device=torch.device("cpu"),
                backend="gloo")
    cfg_h = FusionConfig(
        num_depth_streams=2, depth_height=16, depth_width=24,
        stream_shapes=((16, 24), (8, 16)),
        crop_min=(-6, -6, -6), crop_max=(6, 6, 6),
        voxel_min=(-6, -6, -6), voxel_max=(6, 6, 6),
        voxel_size=(0.5, 0.5, 0.5))
    with pytest.raises(ValueError, match="stream_shapes"):
        ShardedFusionEngine(cfg_h, mesh)
    cfg_t = _cfg(num_depth_streams=2, depth_link_codec="dpcm_temporal")
    with pytest.raises(ValueError, match="depth_link_codec"):
        ShardedFusionEngine(cfg_t, mesh)
    with pytest.raises(ValueError, match="depth_link_codec"):
        build_sharded_fusion_step(cfg_t, VoxelGrid.from_config(cfg_t), mesh)
    with pytest.raises(ValueError, match="num_depth_streams"):
        ShardedFusionEngine(_cfg(num_depth_streams=3), mesh)


def test_sharded_mapping_matches_single(world):
    if "mapping" not in world[0][0]:
        pytest.skip("native library not built")
    res, singles = world
    _check_case(world, "mapping")
    ref = [s["objects"] for s in singles["mapping"]]
    assert len(ref[-1][0]) > 0 and len(ref[-1][1]) > 0
    for rank in range(WORLD):
        assert [v["objects"] for v in res[rank]["mapping"]["views"]] == ref
