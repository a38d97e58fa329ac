"""Parity of the PyTorch port's core and op modules with the JAX package
(CPU backends, small shapes). The same numpy inputs, made from a seed, go
through the JAX function and its port; outputs must be bit-equal."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ros_gpu_depthmap_fusion_tpu.core import transforms as jtf
from ros_gpu_depthmap_fusion_tpu.core.grid import VoxelGrid as JGrid
from ros_gpu_depthmap_fusion_tpu.ops import mask_ops as jmask
from ros_gpu_depthmap_fusion_tpu.ops import stencil as jstencil
from ros_gpu_depthmap_fusion_tpu.ops import voxel as jvoxel
from ros_gpu_depthmap_fusion_tpu.ops.unproject import (
    unproject_depthmaps as j_unproject)

from ros_gpu_depthmap_fusion_tpu_torch.core import timeutil as ttime
from ros_gpu_depthmap_fusion_tpu_torch.core import transforms as ttf
from ros_gpu_depthmap_fusion_tpu_torch.core.grid import VoxelGrid as TGrid
from ros_gpu_depthmap_fusion_tpu_torch.ops import mask_ops as tmask
from ros_gpu_depthmap_fusion_tpu_torch.ops import stencil as tstencil
from ros_gpu_depthmap_fusion_tpu_torch.ops import voxel as tvoxel
from ros_gpu_depthmap_fusion_tpu_torch.ops.unproject import (
    unproject_depthmaps as t_unproject)


def T(a):
    return torch.from_numpy(np.array(a))


def eq(a, b):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _poses(rng, c):
    out = []
    for _ in range(c):
        r = (ttf.rot_z(rng.uniform(-3, 3)) @ ttf.rot_x(rng.uniform(-2, 2))
             @ ttf.rot_y(rng.uniform(-1, 1)))
        out.append(ttf.make_se3(r, rng.uniform(-4, 4, 3)))
    return np.stack(out).astype(np.float32)


@pytest.mark.parametrize("per_camera_scale", [False, True])
def test_unproject_bit_equal(per_camera_scale):
    rng = np.random.default_rng(0)
    c, h, w = 3, 24, 32
    depth = rng.integers(300, 6000, (c, h, w)).astype(np.uint16)
    depth[rng.random((c, h, w)) < 0.1] = 0
    intr = np.stack([[rng.uniform(20, 40), rng.uniform(20, 40),
                      rng.uniform(10, 20), rng.uniform(8, 14)]
                     for _ in range(c)]).astype(np.float32)
    tw, tc = _poses(rng, c), _poses(rng, c)
    scale = (0.001, 0.00025, 0.002) if per_camera_scale else 0.001
    ref = j_unproject(jnp.asarray(depth), jnp.asarray(intr), jnp.asarray(tw),
                      jnp.asarray(tc),
                      jnp.asarray(scale, jnp.float32)
                      if per_camera_scale else scale)
    got = t_unproject(T(depth.astype(np.int32)), T(intr), T(tw), T(tc),
                      scale)
    for r, g in zip(ref, got):
        eq(g, r)


def test_transforms_bit_equal():
    rng = np.random.default_rng(1)
    n, s = 3000, 8
    pts = np.concatenate([rng.normal(0, 5, (n, 3)), np.ones((n, 1))],
                         -1).astype(np.float32)
    tfs = _poses(rng, s)
    idx = rng.integers(0, s, n).astype(np.int32)
    mask = rng.random(n) < 0.8
    move = _poses(rng, 1)[0]
    eq(ttf.transform_points_indirect(T(pts), T(tfs), T(idx), T(mask)),
       jtf.transform_points_indirect(jnp.asarray(pts), jnp.asarray(tfs),
                                     jnp.asarray(idx), jnp.asarray(mask)))
    eq(ttf.compose_seq_transforms(T(move), T(tfs)),
       jtf.compose_seq_transforms(jnp.asarray(move), jnp.asarray(tfs)))
    eq(ttf.transform_points(T(pts), T(move)),
       jtf.transform_points(jnp.asarray(pts), jnp.asarray(move)))


def test_fma_is_correctly_rounded():
    """The port's fused multiply-add equals XLA:CPU's contracted a*b+c,
    including products whose float64 sum lands halfway between floats."""
    rng = np.random.default_rng(2)
    a, b, c = (rng.standard_normal(200000).astype(np.float32)
               for _ in range(3))
    # near-halfway cases: c in [1, 2) (ulp 2^-23) plus a*b = 2^-24 *
    # (1 - 2^-40), just below half an ulp of c; a float64 sum rounds to
    # the halfway point and a second rounding to float32 can go up
    k = 1000
    c[:k] = rng.uniform(1, 2, k).astype(np.float32)
    sign = np.where(rng.random(k) < 0.5, -1.0, 1.0).astype(np.float32)
    a[:k] = np.float32(2.0 ** -24 * (1 + 2.0 ** -20)) * sign
    b[:k] = np.float32(1 - 2.0 ** -20)
    c[:k] *= sign
    ref = np.asarray(jax.jit(lambda x, y, z: x * y + z)(a, b, c))
    eq(ttf.fma(T(a), T(b), T(c)), ref)
    twice = (a.astype(np.float64) * b + c).astype(np.float32)
    assert (twice != ref).sum() > 100   # the cases do need the nudge


def test_grid_conversions_bit_equal():
    lo, hi, cs = (-2.0, -1.5, 0.0), (2.0, 1.5, 1.0), (0.1, 0.1, 0.12)
    jg, tg = JGrid(lo, hi, cs), TGrid(lo, hi, cs)
    assert jg.grid_size == tg.grid_size and jg.num_cells == tg.num_cells
    rng = np.random.default_rng(3)
    pts = rng.uniform(-3, 3, (4000, 3)).astype(np.float32)
    # points exactly on cell boundaries and on the upper bound
    pts[:40] = (np.asarray(lo) + np.asarray(cs)
                * rng.integers(0, 20, (40, 3))).astype(np.float32)
    pts[40:50] = np.asarray(hi, np.float32)
    cells = np.asarray(jg.cell_index_clamped(jnp.asarray(pts)))
    eq(tg.cell_index_clamped(T(pts)), cells)
    eq(tg.grid_coord_of_index(T(cells)),
       jg.grid_coord_of_index(jnp.asarray(cells)))
    eq(tg.world_coord_of_index(T(cells)),
       jg.world_coord_of_index(jnp.asarray(cells)))


def test_crop_points_bit_equal():
    rng = np.random.default_rng(4)
    pts = np.concatenate([rng.uniform(-2, 2, (2000, 3)),
                          np.ones((2000, 1))], -1).astype(np.float32)
    pts[:20, :3] = 1.0                      # on the upper face
    mask = rng.random(2000) < 0.9
    lo, hi = (-1.0, -1.5, -0.5), (1.0, 1.0, 1.0)
    eq(tmask.crop_points(T(pts), T(mask), lo, hi),
       jmask.crop_points(jnp.asarray(pts), jnp.asarray(mask), lo, hi))


@pytest.mark.parametrize("n,cap,p", [(500, 400, 0.3), (300, 512, 0.0),
                                     (1000, 100, 0.5), (256, 256, 1.0)])
def test_compact_and_compact_multi_bit_equal(n, cap, p):
    rng = np.random.default_rng(n + cap)
    vals = rng.standard_normal((n, 4)).astype(np.float32)
    ids = rng.integers(-2 ** 31, 2 ** 31 - 1, n).astype(np.int32)
    mask = rng.random(n) < p
    out, cnt = tmask.compact(T(vals), T(mask), cap)
    rout, rcnt = jmask.compact(jnp.asarray(vals), jnp.asarray(mask), cap)
    eq(out, rout)
    assert int(cnt) == int(rcnt)
    (o1, o2), cnt, true = tmask.compact_multi((T(vals), T(ids)), T(mask),
                                              cap)
    (r1, r2), rcnt = jmask.compact_multi(
        (jnp.asarray(vals), jnp.asarray(ids)), jnp.asarray(mask), cap)
    eq(o1, r1)
    eq(o2, r2)
    assert int(cnt) == int(rcnt) and int(true) == int(mask.sum())


def test_voxel_ops_bit_equal():
    rng = np.random.default_rng(5)
    num_cells = 3000
    cells = rng.integers(0, num_cells, 700).astype(np.int32)
    mask = rng.random(700) < 0.7
    fresh = tvoxel.scatter_occupancy(T(cells), T(mask), num_cells)
    eq(fresh, jvoxel.scatter_occupancy(jnp.asarray(cells),
                                       jnp.asarray(mask), num_cells))
    hist = rng.integers(0, 12, num_cells).astype(np.int32)
    upd = tvoxel.update_historic_occupancy(T(hist), fresh, 10)
    eq(upd, jvoxel.update_historic_occupancy(jnp.asarray(hist),
                                             jnp.asarray(fresh.numpy()), 10))
    big = rng.integers(-5, 400, num_cells).astype(np.int32)
    eq(tvoxel.occupancy_to_u8(T(big)), jvoxel.occupancy_to_u8(
        jnp.asarray(big)))
    eq(tvoxel.occupancy_bitmap(upd), jvoxel.occupancy_bitmap(
        jnp.asarray(upd.numpy())))


def test_historic_decay_to_zero():
    hist = torch.tensor([3, 1, 0], dtype=torch.int32)
    fresh = torch.zeros(3, dtype=torch.int32)
    jhist = jnp.asarray([3, 1, 0], dtype=jnp.int32)
    for expect in ([2, 0, 0], [1, 0, 0], [0, 0, 0], [0, 0, 0]):
        hist = tvoxel.update_historic_occupancy(hist, fresh, lifetime=10)
        jhist = jvoxel.update_historic_occupancy(
            jhist, jnp.zeros(3, jnp.int32), lifetime=10)
        eq(hist, expect)
        eq(hist, jhist)


@pytest.mark.parametrize("capacity", [64, 5])
def test_occupancy_bitmap_sparse_bit_equal(capacity):
    """Sparse 128-bit blocks, including an overflowing capacity (the true
    count then exceeds the clamped count)."""
    rng = np.random.default_rng(6)
    grid = np.zeros(5000, np.int32)
    grid[rng.integers(0, 5000, 60)] = rng.integers(1, 9, 60)
    got = tvoxel.occupancy_bitmap_sparse(T(grid), capacity)
    ref = jvoxel.occupancy_bitmap_sparse(jnp.asarray(grid), capacity)
    for g, r in zip(got, ref):
        eq(g, r)
    assert int(got[3]) > capacity or capacity == 64


def test_filter_point_sequence_bit_equal():
    rng = np.random.default_rng(7)
    t = np.linspace(0, np.pi, 300)
    pts = np.stack([3 * np.cos(t), 3 * np.sin(t), 0.5 + 0.2 * np.sin(9 * t),
                    np.ones_like(t)], -1).astype(np.float32)
    pts[::17, :3] *= rng.uniform(0.5, 1.5, (len(pts[::17]), 1))
    pts[5, :3] = 0.0                         # |p| < 1e-3 is rejected
    mask = rng.random(300) < 0.95
    for size, thr, count in [(1, 0.5, 280), (3, 0.2, 300), (2, 0.05, 150)]:
        ref = jstencil.filter_point_sequence(
            jnp.asarray(pts), jnp.asarray(mask), jnp.int32(count), size,
            jnp.float32(thr))
        got = tstencil.filter_point_sequence(
            T(pts), T(mask), torch.tensor(count, dtype=torch.int32), size,
            torch.tensor(thr, dtype=torch.float32))
        eq(got, ref)


def test_timeutil_encode_compare():
    sec = torch.tensor([1, 2, 2, 5], dtype=torch.int32)
    nsec = torch.tensor([5, 0, 7, 999999999], dtype=torch.int32)
    enc = ttime.encode(sec, nsec)
    assert enc.dtype == torch.int64
    eq(enc, np.array([ttime.encode(int(s), int(n))
                      for s, n in zip(sec, nsec)]))
    eq(ttime.compare(sec, nsec, 2, 0), [-1, 0, 1, 1])
    assert ttime.compare(1, 5, 1, 6) == -1 and ttime.compare(3, 0, 2, 9) == 1
    assert ttime.decode(ttime.from_seconds(2.5)) == (2, 500000000)
