"""Kernel 4's plain twin (``unproject_voxelize_l1_plain``, what the CUDA
kernel is held to on the card) against the JAX package.

- Bit for bit against the JAX kernel's front as written
  (``ops/pallas/fused_unproject_rle.py:69-103``, transcribed in jnp below
  and run op by op under ``jax.disable_jit()``) reduced by the JAX
  package's own Pallas run-length kernel in interpret mode.
- Within ``tests/test_fused_unproject.py``'s bound (equal cell sets and
  per-cell counts, sums within 1.0) against ``unproject_voxelize_l1``
  itself, jitted and under ``jax.disable_jit()``: in both, XLA:CPU
  compiles the interpret-mode kernel body, rewrites each division by a
  constant cell size into a multiplication by its rounded reciprocal and
  contracts the transforms' multiply-adds (visible in the compiled HLO),
  so a point now and then lands one quantization step away. The twin and
  the CUDA kernel round every operation as written.
- Its level-2 totals against the port's own unproject -> crop -> cell ->
  quantize -> level-1 chain.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ros_gpu_depthmap_fusion_tpu.core.grid import VoxelGrid as JGrid
from ros_gpu_depthmap_fusion_tpu.ops.pallas.fused_unproject_rle import (
    unproject_voxelize_l1 as j_fused)
from ros_gpu_depthmap_fusion_tpu.ops.pallas.segreduce import (
    rle_reduce_pallas)

from ros_gpu_depthmap_fusion_tpu_torch.core import transforms
from ros_gpu_depthmap_fusion_tpu_torch.core.grid import VoxelGrid
from ros_gpu_depthmap_fusion_tpu_torch.ops.kernels import (
    fused_unproject_rle as fk)
from ros_gpu_depthmap_fusion_tpu_torch.ops.kernels.segreduce import (
    segreduce_plain)
from ros_gpu_depthmap_fusion_tpu_torch.ops.mask_ops import crop_points
from ros_gpu_depthmap_fusion_tpu_torch.ops.unproject import (
    unproject_depthmaps)
from ros_gpu_depthmap_fusion_tpu_torch.ops.voxelize import _partial_rows

CROP = ((-4.0, -4.0, 0.0), (4.0, 4.0, 2.5))


def scene(c, h, w, seed=0, holes=0.07, voxel=((-4.0, -4.0, 0.0),
                                              (4.0, 4.0, 2.5)),
          cell=(0.25, 0.25, 0.25)):
    """Masked metric depth, intrinsics and transforms of a small rig;
    pixels beyond the crop box and (with a voxel box inside the crop box)
    cells clamped to the grid border are part of it."""
    rng = np.random.default_rng(seed)
    u, v = np.meshgrid(np.arange(w), np.arange(h))
    d0 = (1200 + 300 * np.sin(u / 7.0) + 200 * np.cos(v / 5.0)
          + rng.integers(0, 5, (h, w))).astype(np.float32)
    depth = np.stack([d0 * (1.0 + 0.3 * i) for i in range(c)]) * 0.001
    depth[:, :, w // 3] = 9.0                      # far: outside the crop
    depth[rng.random(depth.shape) < holes] = 0.0
    depth = depth.astype(np.float32)
    intr = np.tile(np.array([w * 0.8, w * 0.8, w / 2.0, h / 2.0],
                            np.float32), (c, 1))
    tfw = np.stack([transforms.make_se3(
        transforms.rot_z(0.3 * (i + 1)) @ transforms.rot_x(-0.7 * i),
        np.array([0.5 - i, -0.4 + 0.8 * i, 0.3 + 0.2 * i]))
        for i in range(c)]).astype(np.float32)
    tfc = np.stack([transforms.make_se3(transforms.rot_y(0.2 * i),
                                        np.array([0.1, 0.2 * i, 0.0]))
                    for i in range(c)]).astype(np.float32)
    grid = VoxelGrid(lower=voxel[0], upper=voxel[1], cell_size=cell)
    return depth, intr, tfw, tfc, grid


def run_jax(depth, intr, tfw, tfc, grid, cap, op_by_op=True):
    jg = JGrid(lower=grid.lower, upper=grid.upper, cell_size=grid.cell_size)
    args = (jnp.asarray(depth), jnp.asarray(intr), jnp.asarray(tfw),
            jnp.asarray(tfc), jg, CROP[0], CROP[1], cap)
    if op_by_op:
        with jax.disable_jit():
            out = j_fused.__wrapped__(*args, interpret=True)
    else:
        out = j_fused(*args, interpret=True)
    return [np.asarray(o) for o in out]


def run_jax_as_written(depth, intr, tfw, tfc, grid, cap, force_break=128):
    """The JAX kernel's front (``fused_unproject_rle.py:56-106``) in jnp,
    op by op, over the padded stream, reduced by ``rle_reduce_pallas``."""
    c, h, w = depth.shape
    wp = -(-w // 128) * 128
    glo, gcs = grid.lower, grid.cell_size
    gs = tuple(float(v) for v in grid.grid_size)
    with jax.disable_jit():
        d = jnp.pad(jnp.asarray(depth), ((0, 0), (0, 0), (0, wp - w)))
        col = jnp.arange(wp, dtype=jnp.float32)[None, None, :]
        vpix = jnp.arange(h, dtype=jnp.float32)[None, :, None]
        prm = jnp.concatenate([jnp.asarray(intr),
                               jnp.asarray(tfw)[:, :3, :].reshape(c, 12),
                               jnp.asarray(tfc)[:, :3, :].reshape(c, 12)],
                              axis=1)[:, :, None, None]
        x = (col - prm[:, 2]) / prm[:, 0] * d
        y = (vpix - prm[:, 3]) / prm[:, 1] * d

        def apply_tf(base):
            return [prm[:, base + 4 * r] * x + prm[:, base + 4 * r + 1] * y
                    + prm[:, base + 4 * r + 2] * d + prm[:, base + 4 * r + 3]
                    for r in range(3)]
        wx, wy, wz = apply_tf(4)
        px, py, pz = apply_tf(16)
        lo, hi = CROP
        inside = ((px >= lo[0]) & (px <= hi[0]) & (py >= lo[1])
                  & (py <= hi[1]) & (pz >= lo[2]) & (pz <= hi[2]))
        m = ((d > 0.0) & inside).astype(jnp.float32)
        gx = jnp.floor(jnp.clip((wx - glo[0]) / gcs[0], 0.0, gs[0] - 1.0))
        gy = jnp.floor(jnp.clip((wy - glo[1]) / gcs[1], 0.0, gs[1] - 1.0))
        gz = jnp.floor(jnp.clip((wz - glo[2]) / gcs[2], 0.0, gs[2] - 1.0))
        cell = gx + gy * gs[0] + gz * (gs[0] * gs[1])
        key = jnp.where(m > 0.0, cell, jnp.float32(grid.num_cells))
        qx = jnp.clip(jnp.floor((wx - (glo[0] + gx * gcs[0]))
                                / gcs[0] * 1024.0), 0.0, 1023.0)
        qy = jnp.clip(jnp.floor((wy - (glo[1] + gy * gcs[1]))
                                / gcs[1] * 1024.0), 0.0, 1023.0)
        qz = jnp.clip(jnp.floor((wz - (glo[2] + gz * gcs[2]))
                                / gcs[2] * 4096.0), 0.0, 4095.0)
        vals = jnp.stack([qx * m, qy * m, qz * m, m], -1).reshape(-1, 4)
        keys = key.astype(jnp.int32).reshape(-1)
        out = rle_reduce_pallas(keys, vals, cap, grid.num_cells,
                                interpret=True, force_break=force_break)
        valid = jnp.sum(m).astype(jnp.int32)
    return [np.asarray(o) for o in out[:4]] + [np.asarray(valid)]


def run_twin(depth, intr, tfw, tfc, grid, cap, force_break=128):
    return [o.numpy() for o in fk.unproject_voxelize_l1(
        torch.from_numpy(depth), torch.from_numpy(intr),
        torch.from_numpy(tfw), torch.from_numpy(tfc), grid, CROP[0],
        CROP[1], cap, force_break)]


def l2(keys, sums, count):
    """cell -> (qx, qy, qz, n) totals of partial rows."""
    agg = {}
    for k, row in zip(keys[:count], sums[:count]):
        agg.setdefault(int(k), np.zeros(4))
        agg[int(k)] += row
    return agg


@pytest.mark.parametrize("c,h,w,cap_frac,voxel,cell", [
    (2, 16, 40, 1.0, None, None),    # W < 128: one padded block a row
    (2, 8, 150, 1.0, None, None),    # W > 128, not a multiple of it
    (2, 8, 150, 1.0, None, (0.1, 0.1, 0.12)),   # bench.py's cell sizes
    (3, 16, 40, 0.3, None, None),    # capacity below the run count
    (2, 16, 40, 1.0, ((-1.0, -1.0, 0.5), (1.0, 1.0, 1.5)), None),  # clamped
])
def test_twin_equals_jax_kernel_as_written(c, h, w, cap_frac, voxel, cell):
    depth, intr, tfw, tfc, grid = scene(
        c, h, w, voxel=voxel or ((-4.0, -4.0, 0.0), (4.0, 4.0, 2.5)),
        cell=cell or (0.25, 0.25, 0.25))
    cap = max(1, int(cap_frac * c * h * w))
    ref = run_jax_as_written(depth, intr, tfw, tfc, grid, cap)
    got = run_twin(depth, intr, tfw, tfc, grid, cap)
    for name, a, b in zip(("keys", "sums", "count", "true_count", "valid"),
                          got, ref):
        np.testing.assert_array_equal(a, b, err_msg=name)
    n, true_n, valid = int(got[2]), int(got[3]), int(got[4])
    assert 0 < valid < c * h * w                    # holes, crop misses
    assert n == min(true_n, cap)
    if cap_frac < 1.0:
        assert true_n > cap
    assert (got[0][n:] == grid.num_cells).all() and not got[1][n:].any()
    if voxel is not None:                           # border cells hold
        gs = grid.grid_size                         # clamped points
        gx = got[0][:n] % gs[0]
        assert ((gx == 0) | (gx == gs[0] - 1)).any()


@pytest.mark.parametrize("c,h,w,cap_frac,cell", [
    (2, 6, 256, 1.0, None),              # W == Wp, two blocks a row
    (2, 6, 256, 1.0, (1.0, 1.0, 1.25)),  # ... long runs, in 1 m cells
    (2, 6, 128, 0.05, None),             # capacity below the run count
    (1, 3, 256, 0.2, (0.1, 0.1, 0.12)),  # ... at bench.py's cell sizes
])
def test_twin_equals_jax_kernel_as_written_without_forced_breaks(
        c, h, w, cap_frac, cell):
    """``force_break=0`` on a stream without padding columns (``W == Wp``):
    nothing but a key change or an invalid pixel ends a run, so runs pass
    the 128th columns (and, on the card, the kernel's tile edges). Exact in
    all five outputs, the valid count included."""
    depth, intr, tfw, tfc, grid = scene(c, h, w, seed=5,
                                        cell=cell or (0.25, 0.25, 0.25))
    cap = max(1, int(cap_frac * c * h * w))
    ref = run_jax_as_written(depth, intr, tfw, tfc, grid, cap, force_break=0)
    got = run_twin(depth, intr, tfw, tfc, grid, cap, force_break=0)
    for name, a, b in zip(("keys", "sums", "count", "true_count", "valid"),
                          got, ref):
        np.testing.assert_array_equal(a, b, err_msg=name)
    n, true_n, valid = int(got[2]), int(got[3]), int(got[4])
    assert 0 < valid < c * h * w and n == min(true_n, cap)
    if cap_frac < 1.0:
        assert true_n > cap
    else:
        # fewer runs than with a break at every 128th position
        forced = run_twin(depth, intr, tfw, tfc, grid, cap)
        assert true_n < int(forced[3]) and valid == int(forced[4])
    assert (got[0][n:] == grid.num_cells).all() and not got[1][n:].any()


@pytest.mark.parametrize("op_by_op", [True, False])
def test_twin_within_bound_of_jax_call(op_by_op):
    """``tests/test_fused_unproject.py``'s bound against the JAX call:
    equal cell sets and per-cell counts, sums within 1.0, and the same
    valid-point count."""
    depth, intr, tfw, tfc, grid = scene(2, 16, 40, seed=3)
    cap = 2 * 16 * 40
    ref = run_jax(depth, intr, tfw, tfc, grid, cap, op_by_op=op_by_op)
    got = run_twin(depth, intr, tfw, tfc, grid, cap)
    assert int(got[4]) == int(ref[4])
    a, b = l2(got[0], got[1], int(got[2])), l2(ref[0], ref[1], int(ref[2]))
    assert set(a) == set(b)
    for k in b:
        np.testing.assert_allclose(a[k], b[k], atol=1.0, err_msg=f"cell {k}")
        assert a[k][3] == b[k][3]


def test_level2_totals_match_the_chain():
    """Per-cell totals equal those of the port's unproject -> crop -> cell
    -> quantize -> level-1 chain (whose run breaks differ), counts exactly
    and sums within 1.0 (the chain's pairwise transform rounds the last
    ulp differently)."""
    c, h, w = 2, 16, 40
    rng = np.random.default_rng(1)
    depth_u16 = (1200 + 300 * np.sin(np.arange(w) / 7.0)[None, None, :]
                 + rng.integers(0, 5, (c, h, w))).astype(np.int32)
    depth_u16[rng.random((c, h, w)) < 0.07] = 0
    _, intr, tfw, tfc, grid = scene(c, h, w)
    ti, tw, tc = (torch.from_numpy(a) for a in (intr, tfw, tfc))
    _, pw, pc, mask = unproject_depthmaps(torch.from_numpy(depth_u16), ti,
                                          tw, tc, 0.001)
    n = c * h * w
    pts = pw.reshape(n, 4)
    m = crop_points(pc.reshape(n, 4), mask.reshape(n), *CROP)
    key, vals = _partial_rows(pts, grid.cell_index_clamped(pts[:, :3]), m,
                              grid.num_cells, grid)
    ck, cs, cc, _ = segreduce_plain(key, vals, n, grid.num_cells, 128)
    depth_m = depth_u16.astype(np.float32) * np.float32(0.001)
    got = run_twin(depth_m, intr, tfw, tfc, grid, n)
    assert int(got[4]) == int(m.sum())
    a = l2(got[0], got[1], int(got[2]))
    b = l2(ck.numpy(), cs.numpy(), int(cc))
    assert set(a) == set(b)
    for k in b:
        np.testing.assert_allclose(a[k], b[k], atol=1.0, err_msg=f"cell {k}")
        assert a[k][3] == b[k][3]


def test_cpu_tensors_take_the_twin():
    depth, intr, tfw, tfc, grid = scene(1, 8, 20)
    before = fk.launches
    out = fk.unproject_voxelize_l1(
        torch.from_numpy(depth), torch.from_numpy(intr),
        torch.from_numpy(tfw), torch.from_numpy(tfc), grid, CROP[0],
        CROP[1], 64)
    assert fk.launches == before
    assert [tuple(o.shape) for o in out] == [(64,), (64, 4), (), (), ()]
    assert [o.dtype for o in out] == [torch.int32, torch.float32] \
        + [torch.int32] * 3
