"""The port's voxelize against the JAX package's: the RLE path
(``voxelize_average_rle_domains`` and ``voxelize_average_rle``, Pallas
kernels in interpret mode), ``voxelize_average_packed``,
``voxelize_average`` ("exact"), ``voxelize_occupied``, the partial sums
and their dequantization, and the sort / group helpers, bit-equal in every
output (means, counts, cells, occupancy, partials count); then the cases
of ``tests/test_ops_voxel.py`` on the port, against the same numpy
oracles and bounds."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ros_gpu_depthmap_fusion_tpu.core.grid import VoxelGrid as JGrid
from ros_gpu_depthmap_fusion_tpu.ops import voxelize as jvox

from ros_gpu_depthmap_fusion_tpu_torch.core.grid import VoxelGrid as TGrid
from ros_gpu_depthmap_fusion_tpu_torch.ops import voxel as tvoxel
from ros_gpu_depthmap_fusion_tpu_torch.ops import voxelize as tvox

import oracles

BOUNDS = ((-2, -2, 0), (2, 2, 1), (0.1, 0.1, 0.12))


def T(a):
    return torch.from_numpy(np.array(a))


def _walk(rng, n):
    """Raster-coherent points: a slow random walk (long same-cell runs)."""
    pts = np.clip(np.cumsum(rng.standard_normal((n, 3)) * 0.01, axis=0)
                  * 0.5, [-1.9, -1.9, 0.01], [1.9, 1.9, 0.95])
    return np.concatenate([pts, np.ones((n, 1))], -1).astype(np.float32)


def _section(rng, n, p, grid):
    pts = _walk(rng, n)
    mask = rng.random(n) < p
    cells = np.asarray(grid.cell_index_clamped(jnp.asarray(pts[:, :3])))
    return pts, cells, mask


@pytest.mark.parametrize("n_domains,extra,partials_capacity", [
    (1, 0, 0), (1, 700, 0), (2, 500, 0), (1, 700, 600)])
def test_voxelize_rle_domains_matches_jax(n_domains, extra,
                                          partials_capacity):
    """Single and split domains, lidar-like extra rows, and a partials
    capacity small enough to overflow (the partials count reports it)."""
    jg, tg = JGrid(*BOUNDS), TGrid(*BOUNDS)
    rng = np.random.default_rng(10 * n_domains + extra + partials_capacity)
    secs = [_section(rng, 4000, 0.9, jg) for _ in range(n_domains)]
    ex = None
    if extra:
        e = rng.uniform([-1.9, -1.9, 0.01], [1.9, 1.9, 0.95], (extra, 3))
        e4 = np.concatenate([e, np.ones((extra, 1))], -1).astype(np.float32)
        ex = (e4, np.asarray(jg.cell_index_clamped(jnp.asarray(e))),
              rng.random(extra) < 0.8)
    cap = 4096
    ref = jvox.voxelize_average_rle_domains(
        [tuple(jnp.asarray(a) for a in s) for s in secs], jg, cap,
        return_occupancy="cells", partials_capacity=partials_capacity,
        interpret=True, return_partials_count=True,
        **(dict(extra_points=jnp.asarray(ex[0]),
                extra_cell_indices=jnp.asarray(ex[1]),
                extra_mask=jnp.asarray(ex[2])) if ex else {}))
    got = tvox.voxelize_average_rle_domains(
        [tuple(T(a) for a in s) for s in secs], tg, cap,
        partials_capacity=partials_capacity,
        **(dict(extra_points=T(ex[0]), extra_cell_indices=T(ex[1]),
                extra_mask=T(ex[2])) if ex else {}))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
    assert int(got[1]) == int(ref[1]) > 0
    np.testing.assert_array_equal(got[2][0].numpy(), np.asarray(ref[2][0]))
    np.testing.assert_array_equal(got[2][1].numpy(), np.asarray(ref[2][1]))
    assert int(got[3]) == int(ref[3])
    if partials_capacity:
        assert int(got[3]) > partials_capacity


def test_voxelize_rle_matches_packed():
    """The RLE path equals the JAX package's full-sort packed path (the one
    its engine runs off the TPU), dense occupancy included."""
    jg, tg = JGrid(*BOUNDS), TGrid(*BOUNDS)
    rng = np.random.default_rng(3)
    pts, cells, mask = _section(rng, 6000, 0.9, jg)
    cap = 4096
    pp, pc, pocc = jvox.voxelize_average_packed(
        jnp.asarray(pts), jnp.asarray(cells), jnp.asarray(mask), jg, cap,
        return_occupancy=True)
    pts_t, count, (cells_t, live), _ = tvox.voxelize_average_rle_domains(
        [(T(pts), T(cells), T(mask))], tg, cap)
    np.testing.assert_array_equal(pts_t.numpy(), np.asarray(pp))
    assert int(count) == int(pc)
    occ = np.zeros(tg.num_cells, np.int32)
    occ[cells_t.numpy()[live.numpy()]] = 1
    np.testing.assert_array_equal(occ, np.asarray(pocc))


def test_pack_partials_roundtrip():
    rng = np.random.default_rng(4)
    ps = np.stack([rng.integers(0, 1 << 17, 500),
                   rng.integers(0, 1 << 17, 500),
                   rng.integers(0, 1 << 20, 500),
                   rng.integers(0, 129, 500)], -1).astype(np.float32)
    w0, w1 = tvox._pack_partials(T(ps))
    jw0, jw1 = jvox._pack_partials(jnp.asarray(ps))
    np.testing.assert_array_equal(w0.numpy(), np.asarray(jw0))
    np.testing.assert_array_equal(w1.numpy(), np.asarray(jw1))
    np.testing.assert_array_equal(tvox._unpack_partials(w0, w1).numpy(), ps)


# -- the other modes, each against the JAX package's function ------------

def _cloud(rng, n, grid, p=0.85, walk=True):
    """Points in ``BOUNDS`` (a raster-like walk, or scattered), their
    clamped cells and a mask; numpy."""
    pts = (_walk(rng, n) if walk else np.concatenate(
        [rng.uniform([-2.2, -2.2, -0.1], [2.2, 2.2, 1.1], (n, 3)),
         np.ones((n, 1))], -1).astype(np.float32))
    cells = np.asarray(grid.cell_index_clamped(jnp.asarray(pts[:, :3])))
    return pts, cells, rng.random(n) < p


def _max_cell_sum_ok(cells, mask, grid):
    """The packed sums are exact integers (so order-free) while a cell's
    z-sum, at most 4095 a member, stays below 2^24."""
    counts = np.bincount(cells[mask], minlength=grid.num_cells)
    assert counts.max() * 4095 < (1 << 24), counts.max()


@pytest.mark.parametrize("occ", [False, True])
@pytest.mark.parametrize("seed,n,walk,cap", [
    (0, 3000, True, 4096), (1, 5000, False, 4096), (2, 3000, False, 64)])
def test_voxelize_average_exact_matches_jax(seed, n, walk, cap, occ):
    """Exact float means: stable sort + the log-doubling pass for pass
    give the JAX bits, ties (many points a cell, scattered or in runs)
    and a capacity below the cell count included."""
    jg, tg = JGrid(*BOUNDS), TGrid(*BOUNDS)
    pts, cells, mask = _cloud(np.random.default_rng(seed), n, jg, walk=walk)
    ref = jvox.voxelize_average(jnp.asarray(pts), jnp.asarray(cells),
                                jnp.asarray(mask), jg, cap,
                                return_occupancy=occ)
    got = tvox.voxelize_average(T(pts), T(cells), T(mask), tg, cap,
                                return_occupancy=occ)
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    assert int(got[1]) > 0


@pytest.mark.parametrize("occ", [False, True])
@pytest.mark.parametrize("seed,n,walk,cap", [
    (3, 4000, True, 4096), (4, 5000, False, 4096), (5, 3000, True, 32)])
def test_voxelize_average_packed_matches_jax(seed, n, walk, cap, occ):
    """Packed: one reduction over the sorted stream against JAX's
    log-doubling, bit-equal while every cell's sum is below 2^24."""
    jg, tg = JGrid(*BOUNDS), TGrid(*BOUNDS)
    pts, cells, mask = _cloud(np.random.default_rng(seed), n, jg, walk=walk)
    _max_cell_sum_ok(cells, mask, jg)
    ref = jvox.voxelize_average_packed(jnp.asarray(pts), jnp.asarray(cells),
                                       jnp.asarray(mask), jg, cap,
                                       return_occupancy=occ)
    got = tvox.voxelize_average_packed(T(pts), T(cells), T(mask), tg, cap,
                                       return_occupancy=occ)
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


@pytest.mark.parametrize("occ", [False, True, "cells"])
def test_voxelize_average_rle_matches_jax(occ):
    """The single-domain form in its three occupancy forms, with and
    without the partials count, lidar-like extra rows included."""
    jg, tg = JGrid(*BOUNDS), TGrid(*BOUNDS)
    rng = np.random.default_rng(6)
    pts, cells, mask = _cloud(rng, 4000, jg)
    e, ec, em = _cloud(rng, 500, jg, walk=False)
    for count in (False, True):
        ref = jvox.voxelize_average_rle(
            jnp.asarray(pts), jnp.asarray(cells), jnp.asarray(mask), jg,
            4096, return_occupancy=occ, interpret=True,
            return_partials_count=count, extra_points=jnp.asarray(e),
            extra_cell_indices=jnp.asarray(ec), extra_mask=jnp.asarray(em))
        got = tvox.voxelize_average_rle(
            T(pts), T(cells), T(mask), tg, 4096, return_occupancy=occ,
            return_partials_count=count, extra_points=T(e),
            extra_cell_indices=T(ec), extra_mask=T(em))
        assert len(got) == len(ref) == 2 + bool(occ) + count
        flat = [x for v in got for x in (v if isinstance(v, tuple) else (v,))]
        want = [x for v in ref for x in (v if isinstance(v, tuple) else (v,))]
        for g, r in zip(flat, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(r))


@pytest.mark.parametrize("cap", [4096, 40])
def test_voxelize_occupied_matches_jax(cap):
    """Cell corners of the occupied cells, zero rows past the count (and
    past a capacity below the occupied count)."""
    jg, tg = JGrid(*BOUNDS), TGrid(*BOUNDS)
    pts, cells, mask = _cloud(np.random.default_rng(7), 3000, jg,
                              walk=False)
    occ = np.zeros(jg.num_cells, np.int32)
    occ[cells[mask]] = 1
    ref = jvox.voxelize_occupied(jnp.asarray(occ), jg, cap)
    got = tvox.voxelize_occupied(T(occ), tg, cap)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    assert int(got[1]) == min(cap, int(occ.sum()))


def test_voxelize_partial_sums_and_dequantize_match_jax():
    """The packed path cut in two: per-cell integer sums, and the means
    from sums of two halves added (what the sharded step does)."""
    jg, tg = JGrid(*BOUNDS), TGrid(*BOUNDS)
    pts, cells, mask = _cloud(np.random.default_rng(8), 4000, jg)
    ref = jvox.voxelize_partial_sums(jnp.asarray(pts), jnp.asarray(cells),
                                     jnp.asarray(mask), jg, 4096)
    got = tvox.voxelize_partial_sums(T(pts), T(cells), T(mask), tg, 4096)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    c, q, k, _ = got
    np.testing.assert_array_equal(
        tvox.dequantize_cell_means(c, q, k, tg).numpy(),
        np.asarray(jvox.dequantize_cell_means(*ref[:3], jg)))
    # the means of the whole equal the packed path's
    packed = tvox.voxelize_average_packed(T(pts), T(cells), T(mask), tg,
                                          4096)[0]
    np.testing.assert_array_equal(
        tvox.dequantize_cell_means(c, q, k, tg).numpy(), packed.numpy())


def test_sort_group_bincount_match_jax():
    rng = np.random.default_rng(9)
    keys = rng.integers(0, 50, 700).astype(np.int32)
    mask = rng.random(700) < 0.8
    pay = rng.standard_normal(700).astype(np.float32)
    ref = jvox.sort_by_key(jnp.asarray(keys), jnp.asarray(pay),
                           jnp.arange(700, dtype=jnp.int32))
    got = tvox.sort_by_key(T(keys), T(pay),
                           torch.arange(700, dtype=torch.int32))
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    for cap in (64, 10):
        ref = jvox.group_by_key(jnp.asarray(keys), jnp.asarray(mask), cap)
        got = tvox.group_by_key(T(keys), T(mask), cap)
        assert got.keys() == ref.keys()
        for k in ref:
            np.testing.assert_array_equal(got[k].numpy(),
                                          np.asarray(ref[k]), err_msg=k)
    ref = jvox.bincount_group(jnp.asarray(keys), jnp.asarray(mask), 50)
    got = tvox.bincount_group(T(keys), T(mask), 50)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


# -- the cases of tests/test_ops_voxel.py, on the port --------------------

OGRID = TGrid(lower=(-1, -1, 0), upper=(1, 1, 1), cell_size=(0.25, 0.25, 0.5))


def _ops_points(seed=0, n=500):
    rng = np.random.default_rng(seed)
    xyz = rng.uniform(-1.3, 1.3, size=(n, 3)).astype(np.float32)
    mask = rng.random(n) < 0.85
    return (np.concatenate([xyz, np.ones((n, 1), np.float32)], -1), mask)


def test_ops_cell_index_and_scatter_occupancy():
    pts, mask = _ops_points(1)
    ids = OGRID.cell_index_clamped(T(pts[:, :3]))
    want, gsize = oracles.voxel_coords_oracle(
        pts, OGRID.lower, OGRID.upper, OGRID.cell_size)
    assert tuple(gsize) == OGRID.grid_size
    np.testing.assert_array_equal(ids.numpy(), want)
    occ = tvoxel.scatter_occupancy(ids, T(mask), OGRID.num_cells).numpy()
    ref = np.zeros(OGRID.num_cells, np.int32)
    ref[np.unique(ids.numpy()[mask])] = 1
    np.testing.assert_array_equal(occ, ref)
    # grid_coord_of_index inverts cell_index_of_coord
    np.testing.assert_array_equal(
        OGRID.cell_index_of_coord(OGRID.grid_coord_of_index(ids)).numpy(),
        ids.numpy())


def test_ops_historic_update_and_decay():
    rng = np.random.default_rng(2)
    hist = rng.integers(0, 12, size=64).astype(np.int32)
    fresh = (rng.random(64) < 0.3).astype(np.int32)
    got = tvoxel.update_historic_occupancy(T(hist), T(fresh), lifetime=10)
    np.testing.assert_array_equal(
        got.numpy(), oracles.occupancy_update_oracle(hist, fresh, 10))
    h = torch.tensor([3, 1, 0], dtype=torch.int32)
    for expect in ([2, 0, 0], [1, 0, 0], [0, 0, 0], [0, 0, 0]):
        h = tvoxel.update_historic_occupancy(
            h, torch.zeros(3, dtype=torch.int32), lifetime=10)
        np.testing.assert_array_equal(h.numpy(), expect)


def test_ops_occupancy_u8_and_layers():
    g = TGrid(lower=(0, 0, 0), upper=(4, 3, 2), cell_size=(1, 1, 1))
    u8 = tvoxel.occupancy_to_u8(
        torch.arange(g.num_cells, dtype=torch.int32) * 20)
    assert int(u8[13]) == 255
    layers = tvoxel.occupancy_layers(u8, g.grid_size)
    assert tuple(layers.shape) == (2, 3, 4)
    assert int(layers[1, 2, 1]) == int(u8[21])


def test_ops_voxelize_average_matches_oracle():
    pts, mask = _ops_points(3, n=300)
    ids = OGRID.cell_index_clamped(T(pts[:, :3]))
    out, count = tvox.voxelize_average(T(pts), ids, T(mask), OGRID, 300)
    want, _ = oracles.voxelize_average_oracle(pts, ids.numpy(), mask)
    assert int(count) == want.shape[0]
    np.testing.assert_allclose(out.numpy()[: int(count)], want, rtol=1e-5,
                               atol=1e-5)


def test_ops_voxelize_average_packed_error_bound():
    """In-bounds points: the packed means within the half-step bound of the
    exact oracle (cell/2048 in x and y, cell/8192 in z)."""
    rng = np.random.default_rng(7)
    xyz = rng.uniform(0, 1, size=(500, 3)).astype(np.float32)
    xyz[:, :2] = xyz[:, :2] * 2 - 1
    pts = np.concatenate([xyz, np.ones((500, 1), np.float32)], -1)
    mask = rng.random(500) < 0.85
    ids = OGRID.cell_index_clamped(T(pts[:, :3]))
    out, count = tvox.voxelize_average_packed(T(pts), ids, T(mask), OGRID,
                                              500)
    want, _ = oracles.voxelize_average_oracle(pts, ids.numpy(), mask)
    assert int(count) == want.shape[0]
    got = out.numpy()[: int(count)]
    bound = np.asarray(OGRID.cell_size) / np.array([2048.0, 2048.0,
                                                    8192.0]) + 1e-6
    assert (np.abs(got[:, :3] - want[:, :3]) <= bound).all()
    np.testing.assert_array_equal(got[:, 3], want[:, 3])


def test_ops_voxelize_occupied_centers():
    g = TGrid(lower=(0, 0, 0), upper=(2, 2, 1), cell_size=(1, 1, 1))
    out, count = tvox.voxelize_occupied(
        torch.tensor([0, 1, 0, 1], dtype=torch.int32), g, 4)
    assert int(count) == 2
    np.testing.assert_array_equal(out.numpy(), [[1, 0, 0, 1], [1, 1, 0, 1],
                                                [0, 0, 0, 0], [0, 0, 0, 0]])


def test_ops_group_by_key_and_bincount():
    keys = torch.tensor([5, 3, 5, 7, 3, 3, 9, 5], dtype=torch.int32)
    mask = torch.tensor([1, 1, 1, 1, 1, 0, 1, 1], dtype=torch.bool)
    g = tvox.group_by_key(keys, mask, group_capacity=8)
    assert int(g["num_groups"]) == 4
    np.testing.assert_array_equal(g["group_values"].numpy()[:4],
                                  [3, 5, 7, 9])
    np.testing.assert_array_equal(g["group_sizes"].numpy()[:4],
                                  [2, 3, 1, 1])
    si = g["sorted_indices"].numpy()
    assert list(si[:2]) == [1, 4] and list(si[2:5]) == [0, 2, 7]
    counts, starts, gidx = tvox.bincount_group(
        torch.tensor([2, 0, 2, 1, 0, 2], dtype=torch.int32),
        torch.ones(6, dtype=torch.bool), 3)
    np.testing.assert_array_equal(counts.numpy(), [2, 1, 3])
    np.testing.assert_array_equal(starts.numpy(), [0, 2, 3])
    np.testing.assert_array_equal(gidx.numpy(), [1, 4, 3, 0, 2, 5])


@pytest.mark.parametrize("members", [3000, 12000])
def test_voxelize_dense_cell_exactness_bound(members):
    """One dense cell among background points. At 3,000 members (z-sum
    below 2^24) packed and rle are bit-identical on the port and equal to
    the JAX package's packed; at 12,000 members (beyond the bound) both
    sides round, each in its own order: the means agree within 1e-4, as
    ``tests/test_ops_voxel.py`` bounds the JAX package's two paths, and
    the counts and occupancy exactly."""
    jg = JGrid((-2, -2, 0), (2, 2, 1), (0.5, 0.5, 0.5))
    tg = TGrid((-2, -2, 0), (2, 2, 1), (0.5, 0.5, 0.5))
    rng = np.random.default_rng(3)
    pts = np.concatenate([
        np.concatenate([rng.uniform(0.0, 0.5, (members, 2)),
                        rng.uniform(0.5, 1.0, (members, 1)),
                        np.ones((members, 1))], 1),
        np.concatenate([rng.uniform(-2, 0, (500, 2)),
                        rng.uniform(0, 0.5, (500, 1)),
                        np.ones((500, 1))], 1)]).astype(np.float32)
    mask = np.ones(len(pts), bool)
    ids = np.asarray(jg.cell_index_clamped(jnp.asarray(pts[:, :3])))
    jp = jvox.voxelize_average_packed(jnp.asarray(pts), jnp.asarray(ids),
                                      jnp.asarray(mask), jg, 256,
                                      return_occupancy=True)
    tp = tvox.voxelize_average_packed(T(pts), T(ids), T(mask), tg, 256,
                                      return_occupancy=True)
    tr = tvox.voxelize_average_rle(T(pts), T(ids), T(mask), tg, 256,
                                   return_occupancy=True)
    for got in (tp, tr):
        assert int(got[1]) == int(jp[1])
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(jp[2]))
    if members * 4095 < (1 << 24):
        np.testing.assert_array_equal(tp[0].numpy(), np.asarray(jp[0]))
        np.testing.assert_array_equal(tr[0].numpy(), tp[0].numpy())
    else:
        np.testing.assert_allclose(tp[0].numpy(), np.asarray(jp[0]),
                                   atol=1e-4)
        np.testing.assert_allclose(tr[0].numpy(), tp[0].numpy(), atol=1e-4)
