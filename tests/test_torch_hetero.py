"""Heterogeneous rigs on the port: the six tests of ``tests/test_hetero.py``
run on the port's engine and voxelize, then the port's heterogeneous
engine against the JAX package's (its step under ``jax.disable_jit()``),
on the raw link and on ``"dpcm"``, synchronous and pipelined.

Oracle of the first group: a smaller stream embedded top-left in a
zero-padded buffer of the larger shape unprojects to the same points (a
zero depth is a hole; pixel coordinates are absolute), so a padded
homogeneous engine gives the heterogeneous engine's cloud and occupancy.
Against JAX every output is bit-equal except ``vox_partials_count``: at
``voxel_mean_mode="auto"`` the JAX package on the CPU runs "packed" and
the port "rle" (``core/config.py``).
"""

import jax
import numpy as np
import pytest
import torch

from ros_gpu_depthmap_fusion_tpu.core.camera import (
    PinholeIntrinsics as JIntrinsics)
from ros_gpu_depthmap_fusion_tpu.core.config import FusionConfig as JCfg
from ros_gpu_depthmap_fusion_tpu.pipeline.engine import (
    FusionEngine as JEngine)

from ros_gpu_depthmap_fusion_tpu_torch.core.camera import PinholeIntrinsics
from ros_gpu_depthmap_fusion_tpu_torch.core.config import FusionConfig
from ros_gpu_depthmap_fusion_tpu_torch.core.grid import VoxelGrid
from ros_gpu_depthmap_fusion_tpu_torch.ops.voxelize import (
    voxelize_average_rle, voxelize_average_rle_domains)
from ros_gpu_depthmap_fusion_tpu_torch.pipeline.engine import FusionEngine
from ros_gpu_depthmap_fusion_tpu_torch.utils import native

from test_torch_engine import ALL_FIELDS, assert_outputs_equal

H0, W0 = 48, 64
H1, W1 = 32, 40

BOX = dict(crop_min=(-3.0, -3.0, 0.0), crop_max=(3.0, 3.0, 2.5),
           voxel_min=(-3.0, -3.0, 0.0), voxel_max=(3.0, 3.0, 2.5),
           voxel_size=(0.1, 0.1, 0.1))


@pytest.fixture
def need_native():
    if not native.available():
        pytest.skip(f"native host library did not build: {native._error}")


def _scene(rng):
    u0, v0 = np.meshgrid(np.arange(W0), np.arange(H0))
    d0 = (1500 + 300 * np.sin(u0 / 9.0) + 200 * np.cos(v0 / 7.0)
          + rng.integers(0, 3, (H0, W0))).astype(np.uint16)
    d0[rng.random((H0, W0)) < 0.05] = 0
    u1, v1 = np.meshgrid(np.arange(W1), np.arange(H1))
    d1 = (2400 + 500 * np.cos(u1 / 8.0) + 300 * np.sin(v1 / 6.0)
          + rng.integers(0, 3, (H1, W1))).astype(np.uint16)
    d1[rng.random((H1, W1)) < 0.05] = 0
    tf0 = np.eye(4, dtype=np.float32)
    tf0[:3, 3] = [0.0, 0.0, 0.3]
    tf1 = np.eye(4, dtype=np.float32)
    tf1[:3, 3] = [0.5, -0.2, 0.4]
    return d0, d1, tf0, tf1


def _point_set(out):
    pts = out.fused_points.numpy()[: int(out.fused_count)]
    return set(map(tuple, np.round(pts, 5).tolist()))


def _stage(eng, d0, d1, tf0, tf1, f, pad=False, intr_cls=PinholeIntrinsics):
    i0 = intr_cls.default_for(W0, H0)
    i1 = intr_cls.default_for(W1, H1)
    if pad:
        d1p = np.zeros((H0, W0), np.uint16)
        d1p[:H1, :W1] = d1
        d1 = d1p
    eng.add_depthmap(0, d0 + np.uint16(f), i0, tf0, tf0)
    eng.add_depthmap(1, d1, i1, tf1, tf1)
    return 10.0 + f / 30.0


def _run(eng, scene, pad=False, frames=3):
    out = None
    for f in range(frames):
        out = eng.process(_stage(eng, *scene, f % 2, pad=pad))
    return out


def _cfg_hetero(cls=FusionConfig, **kw):
    return cls(num_depth_streams=2, stream_shapes=((H0, W0), (H1, W1)),
               depth_scales=(0.001, 0.0005), depth_height=H0, depth_width=W0,
               voxel_occupancy_lifetime=3, **BOX, **kw)


def _cfg_padded(**kw):
    return FusionConfig(num_depth_streams=2, depth_height=H0, depth_width=W0,
                        depth_scales=(0.001, 0.0005),
                        voxel_occupancy_lifetime=3, **BOX, **kw)


def test_config_groups():
    cfg = _cfg_hetero()
    assert cfg.is_heterogeneous
    assert cfg.stream_groups == (((0,), H0, W0), ((1,), H1, W1))
    assert cfg.depthmaps_total_elements == H0 * W0 + H1 * W1
    same = FusionConfig(num_depth_streams=3, stream_shapes=((H0, W0),) * 3)
    assert not same.is_heterogeneous
    assert same.stream_groups == (((0, 1, 2), H0, W0),)


@pytest.mark.parametrize("codec", ["none", "dpcm"])
def test_hetero_engine_matches_padded_oracle(codec):
    if codec == "dpcm" and not native.available():
        pytest.skip("native host library did not build")
    scene = _scene(np.random.default_rng(3))
    het = FusionEngine(_cfg_hetero(depth_link_codec=codec), "cpu")
    ref = FusionEngine(_cfg_padded(depth_link_codec="none"), "cpu")
    out_h = _run(het, scene)
    out_r = _run(ref, scene, pad=True)
    assert int(out_h.raw_count) == int(out_r.raw_count)
    assert torch.equal(out_h.occupancy_u8, out_r.occupancy_u8)
    assert _point_set(out_h) == _point_set(out_r)
    assert int(out_h.fused_count) > 0
    if codec == "dpcm":
        assert all(b is not None and b > 0 for b in het.last_frame_bits)


def test_per_stream_depth_scale_homogeneous():
    """``depth_scales`` on a homogeneous rig: stream 1 at half scale lands
    at half the depth of an identical stream 0."""
    d = np.full((H0, W0), 1000, np.uint16)
    i0 = PinholeIntrinsics.default_for(W0, H0)
    tf = np.eye(4, dtype=np.float32)
    cfg = FusionConfig(num_depth_streams=2, depth_height=H0, depth_width=W0,
                       depth_scales=(0.001, 0.0005), depth_link_codec="none",
                       enable_voxel_filter=False,
                       enable_flyingpixels_filter=False, **BOX)
    eng = FusionEngine(cfg, "cpu")
    eng.add_depthmap(0, d, i0, tf, tf)
    eng.add_depthmap(1, d, i0, tf, tf)
    out = eng.process(10.0)
    pts = out.raw_points.numpy()[: int(out.raw_count)]
    assert set(np.unique(np.round(pts[:, 2], 6))) == {0.5, 1.0}


def _random_points(rng, n):
    return torch.from_numpy(np.concatenate([
        rng.uniform(-3, 3, (n, 2)), rng.uniform(0, 2.5, (n, 1)),
        np.ones((n, 1))], axis=1).astype(np.float32))


def test_voxelize_domains_matches_concat():
    """Splitting the input into domains gives the one-domain result bit
    for bit (integer partial sums commute)."""
    grid = VoxelGrid.from_config(FusionConfig(**BOX))
    rng = np.random.default_rng(11)
    n1, n2 = 3000, 1700
    pts = _random_points(rng, n1 + n2)
    mask = torch.from_numpy(rng.random(n1 + n2) > 0.1)
    ids = grid.cell_index_clamped(pts[:, :3])
    one = voxelize_average_rle(pts, ids, mask, grid, 4096,
                               return_occupancy=True,
                               return_partials_count=True)
    two = voxelize_average_rle_domains(
        [(pts[:n1], ids[:n1], mask[:n1]), (pts[n1:], ids[n1:], mask[n1:])],
        grid, 4096)
    assert int(one[1]) == int(two[1])
    assert torch.equal(one[0], two[0])
    occ = torch.zeros(grid.num_cells, dtype=torch.int32)
    occ[two[2][0][two[2][1]].long()] = 1
    assert torch.equal(one[2], occ)


def test_voxelize_domains_skewed_overflow_observable():
    """A domain that overflows its own capacity share reports above
    ``partials_capacity`` although the summed true run count stays below
    it."""
    grid = VoxelGrid.from_config(FusionConfig(**BOX))
    rng = np.random.default_rng(3)
    n_a, n_b = 5000, 45000
    pts_a = _random_points(rng, n_a)
    pts_b = torch.tensor([[0.05, 0.05, 1.0, 1.0]]).repeat(n_b, 1)
    cap = 8192
    res = voxelize_average_rle_domains(
        [(pts_a, grid.cell_index_clamped(pts_a[:, :3]),
          torch.ones(n_a, dtype=torch.bool)),
         (pts_b, grid.cell_index_clamped(pts_b[:, :3]),
          torch.ones(n_b, dtype=torch.bool))],
        grid, 4096, partials_capacity=cap)
    assert int(res[-1]) > cap, int(res[-1])


def test_hetero_pipelined_matches_sync(need_native):
    """``pipeline_depth=1`` (per-group encode on the worker thread, the
    widths tuple through the packet) equals the synchronous engine."""
    scene = _scene(np.random.default_rng(9))
    sync = FusionEngine(_cfg_hetero(depth_link_codec="dpcm"), "cpu")
    pipe = FusionEngine(_cfg_hetero(depth_link_codec="dpcm"), "cpu",
                        pipeline_depth=1)
    outs_s, outs_p = [], []
    for f in range(4):
        outs_s.append(sync.process(_stage(sync, *scene, f % 2)))
        o = pipe.process(_stage(pipe, *scene, f % 2))
        if o is not None:
            outs_p.append(o)
    outs_p.append(pipe.flush())
    pipe.close()
    assert len(outs_p) == 4
    for a, b in zip(outs_s, outs_p):
        for k in a._fields:
            assert torch.equal(getattr(a, k), getattr(b, k)), k
    assert _point_set(outs_s[-1]) == _point_set(outs_p[-1])


@pytest.mark.parametrize("codec", ["none", "dpcm"])
def test_hetero_engine_matches_jax(codec):
    """Three frames through the JAX and the port's heterogeneous engines at
    ``FusionConfig()``'s defaults (raw cloud emitted): every output
    bit-equal but the partials count; the same widths chosen per group;
    and the port's pipelined engine equal to its synchronous one."""
    if codec == "dpcm" and not native.available():
        pytest.skip("native host library did not build")
    scene = _scene(np.random.default_rng(4))
    j = JEngine(_cfg_hetero(JCfg, depth_link_codec=codec))
    t = FusionEngine(_cfg_hetero(depth_link_codec=codec), "cpu")
    p = FusionEngine(_cfg_hetero(depth_link_codec=codec), "cpu",
                     pipeline_depth=1)
    assert t.layout._asdict() == j.layout._asdict()
    t_outs, p_outs = [], []
    for f in range(3):
        now = _stage(j, *scene, f, intr_cls=JIntrinsics)
        with jax.disable_jit():
            j_out = j.process(now)
        t_out = t.process(_stage(t, *scene, f))
        assert t.last_frame_bits == j.last_frame_bits
        assert_outputs_equal(t_out, j_out, ALL_FIELDS)
        t_outs.append(t_out)
        o = p.process(_stage(p, *scene, f))
        if o is not None:
            p_outs.append(o)
    p_outs.append(p.flush())
    p.close()
    for a, b in zip(t_outs, p_outs):
        for k in a._fields:
            assert torch.equal(getattr(a, k), getattr(b, k)), k
    assert int(t_outs[-1].fused_count) > 0
    assert tuple(t_outs[-1].raw_points.shape) == (
        H0 * W0 + H1 * W1 + t.cfg.rollbuffer_point_capacity, 4)
