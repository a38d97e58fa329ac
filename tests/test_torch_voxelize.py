"""The port's RLE voxelize against the JAX package's
``voxelize_average_rle_domains`` (Pallas kernels in interpret mode) and
``voxelize_average_packed``: bit-equal means, counts, cells and partials
count."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ros_gpu_depthmap_fusion_tpu.core.grid import VoxelGrid as JGrid
from ros_gpu_depthmap_fusion_tpu.ops import voxelize as jvox

from ros_gpu_depthmap_fusion_tpu_torch.core.grid import VoxelGrid as TGrid
from ros_gpu_depthmap_fusion_tpu_torch.ops import voxelize as tvox

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
