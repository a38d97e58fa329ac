"""The plain twins of the port's kernels against the JAX package on the
edge cases of the single-pass kernel designs (``csrc/reduce_by_key.cuh``,
``csrc/lookback.cuh``; 2,048-position segreduce tiles of 256 threads x 8,
1,024-flag compact tiles; and the flying-pixel stencil on 128 x 8 pixel
neighbourhoods, for its redesign): runs across and
on tile edges, all-sentinel streams, capacity overflow inside a tile,
forced breaks that do not divide the tile, every column count; images
narrower or shorter than a tile, holes on tile edges, every ring count.
The Pallas kernels run in interpret mode, as the JAX package's own tests
run them; ``tests/test_torch_cuda.py`` holds the CUDA kernels to these
twins on the card. (On a CPU tensor a wrapper is its twin, so these tests
call the twins.)"""

import zlib

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ros_gpu_depthmap_fusion_tpu.ops.pallas.compact import compact_rows_pallas
from ros_gpu_depthmap_fusion_tpu.ops.pallas.flying_pixels import (
    filter_flying_pixels_pallas)
from ros_gpu_depthmap_fusion_tpu.ops.pallas.segreduce import rle_reduce_pallas
from ros_gpu_depthmap_fusion_tpu.ops.stencil import filter_flying_pixels

from ros_gpu_depthmap_fusion_tpu_torch.ops.kernels.compact import (
    compact_plain)
from ros_gpu_depthmap_fusion_tpu_torch.ops.kernels.flying_pixels import (
    filter_flying_pixels_plain)
from ros_gpu_depthmap_fusion_tpu_torch.ops.kernels.segreduce import (
    segreduce_plain)

from test_torch_kernels_plain import _cos_margin  # noqa: E402

SENT = 1 << 22
TILE = 4096


def T(a):
    return torch.from_numpy(np.array(a))


def runs_of(lengths, rng, sentinel_every=0):
    """Keys in runs of the given lengths, neighbouring runs distinct; every
    ``sentinel_every``-th run is sentinel."""
    keys, prev = [], -1
    for j, n in enumerate(lengths):
        if sentinel_every and j % sentinel_every == sentinel_every - 1:
            k = SENT
        else:
            k = int(rng.integers(0, 1000))
            while k == prev:
                k = int(rng.integers(0, 1000))
        keys += [k] * int(n)
        prev = k
    return np.array(keys, np.int32)


def seg_case(name, rng):
    """(keys, capacity, force_break) of one edge case."""
    if name == "run_over_two_tiles":
        keys = runs_of([300, 2 * TILE + 700, 50, 40], rng)
        return keys, 64, 0
    if name == "runs_end_on_tile_edges":
        keys = runs_of([512] * 8 + [TILE, 100, TILE - 100, 7], rng)
        return keys, 64, 0
    if name == "all_sentinel":
        return np.full(TILE + 321, SENT, np.int32), 16, 0
    if name == "overflow_mid_tile":
        # the capacity-th run starts at ~1,950, inside the first tile
        keys = runs_of(rng.integers(1, 9, 2000), rng, sentinel_every=7)
        return keys, 400, 0
    if name.startswith("force_break_"):
        fb = int(name.rsplit("_", 1)[1])
        keys = runs_of(rng.integers(1, 400, 60), rng, sentinel_every=11)
        return keys, 4096, fb
    raise KeyError(name)


@pytest.mark.parametrize("d", [1, 4, 7])
@pytest.mark.parametrize("name", [
    "run_over_two_tiles", "runs_end_on_tile_edges", "all_sentinel",
    "overflow_mid_tile", "force_break_100", "force_break_3000",
    "force_break_5000", "force_break_2048"])
def test_segreduce_twin_edges_match_pallas(name, d):
    rng = np.random.default_rng(zlib.crc32(f"{name}/{d}".encode()))
    keys, cap, fb = seg_case(name, rng)
    n = keys.shape[0]
    vals = rng.integers(0, 100, (n, d)).astype(np.float32)
    # the Pallas kernel breaks at block lanes divisible by force_break
    # (ops/pallas/segreduce.py:99); with a block that is a multiple of it
    # those are the stream positions divisible by it, as the port counts
    bn = 4096 if not fb or 4096 % fb == 0 else int(np.lcm(fb, 128))
    ref = rle_reduce_pallas(jnp.asarray(keys), jnp.asarray(vals), cap, SENT,
                            interpret=True, bn=bn, force_break=fb)
    got = segreduce_plain(T(keys), T(vals), cap, SENT, fb)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    if name == "all_sentinel":
        assert int(got[3]) == 0 and bool((got[0] == SENT).all())
    if name == "overflow_mid_tile":
        assert int(got[3]) > cap and int(got[2]) == cap


@pytest.mark.parametrize("n,cap,p,d", [
    (3000, 700, 0.5, 5),      # overflow inside the second tile
    (2 * 1024 + 5, 4096, 1.0, 1),
    (1500, 64, 0.0, 8),
    (1024, 1024, 1.0, 4)])   # exactly one full tile
def test_compact_twin_edges_match_pallas(n, cap, p, d):
    rng = np.random.default_rng(n + cap + d)
    vals = rng.standard_normal((n, d)).astype(np.float32)
    mask = rng.random(n) < p
    ref, rcnt = compact_rows_pallas(jnp.asarray(vals), jnp.asarray(mask),
                                    cap, interpret=True)
    out, cnt, true = compact_plain(T(vals), T(mask), cap)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    assert int(cnt) == int(rcnt) and int(true) == int(mask.sum())


def _points(h, w, c, seed, holes=0.05):
    """Camera-frame points of a sloped surface with a depth step, holes
    on the 128 x 8 tile edges and random holes."""
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    z = 1.5 + 0.01 * xx + 0.02 * yy + 0.002 * rng.standard_normal((c, h, w))
    z[:, :, w // 2:] += 0.9
    x = (xx - (w - 1) / 2) / 40.0 * z
    y = (yy - (h - 1) / 2) / 40.0 * z
    pts = np.stack([x, y, z, np.ones_like(z)], -1).astype(np.float32)
    mask = rng.random((c, h, w)) >= holes
    mask[:, :, [k for k in (127, 128) if k < w]] = False
    mask[:, [k for k in (7, 8) if k < h], :] = False
    return pts.reshape(c, h * w, 4), mask.reshape(c, h * w)


@pytest.mark.parametrize("size,rot45", [(1, False), (1, True), (2, False),
                                        (2, True), (3, False), (3, True)])
@pytest.mark.parametrize("h,w", [(5, 37), (3, 4), (13, 133)])
def test_flying_pixels_twin_edges_match_jax(h, w, size, rot45):
    """Equal to the JAX stencil run op by op, and to the Pallas kernel in
    interpret mode except on pixels whose cos(view) lies within 1e-5 of the
    threshold (the kernel normalizes with rsqrt: another rounding)."""
    pc, m = _points(h, w, 2, seed=h * w + size)
    thr, maxd = 0.4, 10.0
    got = filter_flying_pixels_plain(T(pc), T(m), h, w, size, thr, rot45,
                                     maxd)
    with jax.disable_jit():
        ref = np.asarray(filter_flying_pixels(
            jnp.asarray(pc), jnp.asarray(m), h, w, size, thr, rot45, maxd))
    np.testing.assert_array_equal(got.numpy(), ref)
    pallas = np.asarray(filter_flying_pixels_pallas(
        jnp.asarray(pc), jnp.asarray(m), h, w, size, thr, rot45, maxd,
        interpret=True))
    band = _cos_margin(pc, m, h, w, size, rot45, thr) < 1e-5
    assert not ((got.numpy() != pallas) & ~band).any()
    # rings reaching past the border reject; the larger image keeps some
    g = got.numpy().reshape(2, h, w)
    assert not (g[:, :size].any() or g[:, h - size:].any()
                or g[:, :, :size].any() or g[:, :, w - size:].any())
    if (h, w) == (13, 133):
        assert 0 < g.sum() < m.sum()


@pytest.mark.parametrize("h,w,size,rot45", [
    # h = w = 2 * filter_size: every pixel is within the ring of a border
    (2, 2, 1, False), (2, 2, 1, True), (4, 4, 2, True), (6, 6, 3, False),
    (6, 6, 3, True),
    # one pixel more: only the centre pixel passes the border rule
    (3, 3, 1, True), (5, 5, 2, True),
    # narrower than the four pixels the CUDA kernel stores as one word
    (9, 3, 1, False), (9, 3, 1, True), (9, 2, 1, True), (11, 1, 1, True)])
def test_flying_pixels_twin_small_images_match_jax(h, w, size, rot45):
    """Images smaller than ``2 * filter_size + 1`` or narrower than four
    pixels: equal to the JAX stencil run op by op, and to the Pallas kernel
    in interpret mode outside 1e-5 of the cos threshold."""
    pc, m = _points(h, w, 2, seed=17 * h + w + size, holes=0.0)
    thr, maxd = 0.4, 10.0
    got = filter_flying_pixels_plain(T(pc), T(m), h, w, size, thr, rot45,
                                     maxd)
    with jax.disable_jit():
        ref = np.asarray(filter_flying_pixels(
            jnp.asarray(pc), jnp.asarray(m), h, w, size, thr, rot45, maxd))
    np.testing.assert_array_equal(got.numpy(), ref)
    pallas = np.asarray(filter_flying_pixels_pallas(
        jnp.asarray(pc), jnp.asarray(m), h, w, size, thr, rot45, maxd,
        interpret=True))
    band = _cos_margin(pc, m, h, w, size, rot45, thr) < 1e-5
    assert not ((got.numpy() != pallas) & ~band).any()
    g = got.numpy().reshape(2, h, w)
    inner = g[:, size:h - size, size:w - size]
    assert g.sum() == inner.sum()          # nothing within size of a border
    if min(h, w) <= 2 * size:
        assert not g.any()
