"""The port's CUDA kernels against their plain PyTorch twins on the card,
at edge-case shapes (empty and ragged tiles, sentinels, forced breaks,
capacity overflow, every column count, several rings, images that cross,
fill or are smaller than the flying-pixel kernel's tiles; for the fused
front, widths below, at and above 128, clamped cells, points outside the
crop and runs across many tiles; compact at the raw cloud's shape and
segreduce on a sorted full stream), small engines card == CPU on the raw
and the coded link, in every mode of the non-split step and on
heterogeneous rigs, and the
mapping on the card == CPU (device segmentation up to ``bench.py``'s
400x400x21 grid, the sparse mapping cycle, the component with mapping
on), and the launch-file presets on small rigs card == CPU. They need an
NVIDIA GPU and nvcc and skip elsewhere; on a GPU
machine run

    python -m pytest -q -p no:cacheprovider --noconftest tests/test_torch_cuda.py

(``--noconftest``: the suite's conftest configures JAX, which this file
does not use). ``chip_smoke.py`` checks the same kernels at the main
path's shapes.

:func:`assert_same` (recursive equality of nested results) also serves the
CPU parity tests of the mapping and the component, which import it.
"""

import dataclasses
import zlib

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def assert_same(a, b, path="result"):
    """Recursive equality of nested results (a JAX-package value and its
    port counterpart, or two port values: dataclasses, NamedTuples, plain
    objects, arrays): same class names, same fields (the second value's,
    for dataclasses), arrays of equal dtype and shape bit for bit, floats
    exactly equal."""
    assert type(a).__name__ == type(b).__name__, (path, type(a), type(b))
    if isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, (path, a, b)
        np.testing.assert_array_equal(a, b, err_msg=path)
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for k, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{path}[{k}]")
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            assert_same(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, (float, np.floating)):
        assert a == b or (a != a and b != b), (path, a, b)
    elif isinstance(a, (int, bool, str, type(None), np.generic)):
        assert a == b, (path, a, b)
    else:
        names = list(getattr(a, "__dict__", {}))
        for cls in type(a).__mro__:
            names += [s for s in getattr(cls, "__slots__", ())
                      if s not in names]
        if dataclasses.is_dataclass(a):
            names = [f.name for f in dataclasses.fields(b)]
        assert names, (path, type(a))
        for n in names:
            assert_same(getattr(a, n), getattr(b, n), f"{path}.{n}")


def _keys(rng, n, sentinel):
    keys = []
    while len(keys) < n:
        k = sentinel if rng.random() < 0.15 else int(rng.integers(0, 50))
        keys += [k] * int(1 + rng.geometric(0.05))
    return np.array(keys[:n], np.int32)


@pytest.mark.parametrize("n", [0, 1, 4095, 4096, 4097, 100003])
@pytest.mark.parametrize("d,force_break,cap", [(4, 0, 1 << 20), (1, 128, 64),
                                               (7, 128, 1 << 20)])
def test_segreduce_kernel_equals_twin(dev, n, d, force_break, cap):
    from ros_gpu_depthmap_fusion_tpu_torch.ops.kernels import segreduce as m
    rng = np.random.default_rng(n + d)
    sent = 1 << 20
    keys = torch.from_numpy(_keys(rng, n, sent)).to(dev)
    vals = torch.from_numpy(
        rng.integers(0, 1024, (n, d)).astype(np.float32)).to(dev)
    before = m.launches
    got = m.segreduce(keys, vals, cap, sent, force_break)
    ref = m.segreduce_plain(keys, vals, cap, sent, force_break)
    torch.cuda.synchronize()
    assert m.launches == before + 1
    for g, r in zip(got, ref):
        assert torch.equal(g, r)


@pytest.mark.parametrize("n,d,cap,p", [
    (0, 5, 16, 0.5), (4097, 5, 4096, 0.3), (50000, 1, 100, 0.5),
    (10000, 8, 20000, 1.0), (10000, 3, 512, 0.0),
    # the single-pass design's edges: 1,024-flag tiles, overflow inside a
    # tile, many tiles, the main path's shape
    (1024, 5, 4096, 1.0), (1023, 4, 512, 1.0), (1025, 1, 4096, 0.5),
    (26250, 5, 4096, 0.117), (26250, 5, 1000, 0.5),
    (1_000_003, 3, 1 << 20, 0.1), (5000, 8, 16, 0.0), (7, 2, 3, 1.0)])
def test_compact_kernel_equals_twin(dev, n, d, cap, p):
    """Equal to the twin, and the same bits on a second launch."""
    from ros_gpu_depthmap_fusion_tpu_torch.ops.kernels import compact as m
    rng = np.random.default_rng(n + d)
    words = torch.from_numpy(
        rng.integers(-2 ** 31, 2 ** 31 - 1, (n, d)).astype(np.int32)).to(dev)
    mask = torch.from_numpy(rng.random(n) < p).to(dev)
    got = m.compact_rows(words, mask, cap)
    again = m.compact_rows(words, mask, cap)
    ref = m.compact_plain(words, mask, cap)
    torch.cuda.synchronize()
    for g, a, r in zip(got, again, ref):
        assert torch.equal(g, r) and torch.equal(a, r)


@pytest.mark.parametrize("size,rot45", [(1, False), (1, True), (2, True),
                                        (3, True)])
def test_flying_pixels_kernel_equals_twin(dev, size, rot45):
    from ros_gpu_depthmap_fusion_tpu_torch.ops.kernels import (
        flying_pixels as m)
    from ros_gpu_depthmap_fusion_tpu_torch.ops.unproject import (
        unproject_depthmaps)
    rng = np.random.default_rng(size)
    c, h, w = 3, 37, 53
    depth = (1500 + 300 * np.sin(np.arange(w) / 3.0)[None, None, :]
             + 20 * rng.standard_normal((c, h, w))).astype(np.int32)
    depth[rng.random((c, h, w)) < 0.05] = 0
    eye = torch.eye(4, device=dev).repeat(c, 1, 1)
    intr = torch.tensor([[40.0, 40.0, 26.0, 18.0]] * c, device=dev)
    pc, _, _, mask = unproject_depthmaps(torch.from_numpy(depth).to(dev),
                                         intr, eye, eye, 0.001)
    thr = torch.tensor(0.3, device=dev)
    maxd = torch.tensor(1.9, device=dev)
    got = m.filter_flying_pixels(pc, mask, h, w, size, thr, rot45, maxd)
    ref = m.filter_flying_pixels_plain(pc, mask, h, w, size, thr, rot45,
                                       maxd)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)
    assert 0 < int(got.sum()) < int(mask.sum())


def _surface(rng, c, h, w, holes):
    """Camera-frame points of a sloped surface with a depth step and noise,
    and a mask with the given share of holes."""
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    z = 1.5 + 0.01 * xx + 0.02 * yy + 0.002 * rng.standard_normal((c, h, w))
    z[:, :, w // 2:] += 0.9
    x = (xx - (w - 1) / 2) / 40.0 * z
    y = (yy - (h - 1) / 2) / 40.0 * z
    pts = np.stack([x, y, z, np.ones_like(z)], -1).astype(np.float32)
    mask = rng.random((c, h, w)) >= holes
    return pts.reshape(c, h * w, 4), mask.reshape(c, h * w)


@pytest.mark.parametrize("c,h,w,size,rot45,holes", [
    # across the 32 x 8 tiles, every ring count, rot45 on and off
    (1, 133, 300, 0, False, 0.05), (1, 133, 300, 0, True, 0.05),
    (1, 133, 300, 1, False, 0.05), (1, 133, 300, 1, True, 0.05),
    (1, 133, 300, 2, False, 0.05), (1, 133, 300, 2, True, 0.05),
    (1, 133, 300, 3, False, 0.05), (1, 133, 300, 3, True, 0.05),
    (2, 480, 848, 1, True, 0.02),          # the main path's image
    (3, 21, 131, 2, True, 0.05),           # w % 4 != 0: unaligned rows
    (2, 16, 66, 1, True, 0.05),            # w % 4 == 2: a ragged last word
    (2, 5, 7, 1, True, 0.0),               # smaller than a tile
    (1, 2, 2, 1, True, 0.0), (1, 4, 4, 2, True, 0.0),   # h = w = 2 size:
    (1, 6, 6, 3, False, 0.0),              # every pixel is on a border
    (1, 3, 3, 1, True, 0.0),               # one pixel passes the border
    (2, 40, 100, 2, True, 1.0),            # all invalid
    (2, 40, 100, 2, True, 0.0),            # all valid
    (1, 64, 200, 8, True, 0.0),            # the widest halo the kernel takes
])
def test_flying_pixels_kernel_tiles_equal_twin(dev, c, h, w, size, rot45,
                                               holes):
    """The shared-memory tile kernel equals its twin bit for bit where
    images cross, fill or are smaller than its tiles."""
    from ros_gpu_depthmap_fusion_tpu_torch.ops.kernels import (
        flying_pixels as m)
    rng = np.random.default_rng(zlib.crc32(f"{c}/{h}/{w}/{size}".encode()))
    pts, mask = _surface(rng, c, h, w, holes)
    pts_t = torch.from_numpy(pts).to(dev)
    mask_t = torch.from_numpy(mask).to(dev)
    before = m.launches
    got = m.filter_flying_pixels(pts_t, mask_t, h, w, size, 0.4, rot45, 6.0)
    ref = m.filter_flying_pixels_plain(pts_t, mask_t, h, w, size, 0.4, rot45,
                                       6.0)
    torch.cuda.synchronize()
    assert m.launches == before + 1
    assert torch.equal(got, ref)
    if holes == 1.0 or min(h, w) <= 2 * size:
        assert not bool(got.any())
    elif (h, w) == (133, 300):
        assert 0 < int(got.sum()) < int(mask.sum())


def test_flying_pixels_kernel_refuses_wider_halo(dev):
    from ros_gpu_depthmap_fusion_tpu_torch.ops.kernels import (
        flying_pixels as m)
    pts, mask = _surface(np.random.default_rng(0), 1, 32, 32, 0.0)
    before = m.launches
    with pytest.raises(ValueError, match="filter_size"):
        m.filter_flying_pixels(torch.from_numpy(pts).to(dev),
                               torch.from_numpy(mask).to(dev), 32, 32,
                               m.MAX_FILTER_SIZE + 1, 0.4, True, 3.0)
    assert m.launches == before


def test_engine_on_card_equals_cpu(dev):
    """Four frames of a small rig: every output equal on the card and on
    the CPU (whose twins the CPU parity tests hold to the JAX package)."""
    from ros_gpu_depthmap_fusion_tpu_torch.core.camera import (
        PinholeIntrinsics)
    from ros_gpu_depthmap_fusion_tpu_torch.core.config import FusionConfig
    from ros_gpu_depthmap_fusion_tpu_torch.pipeline.engine import (
        FusionEngine)
    cfg = FusionConfig(
        num_depth_streams=2, depth_height=24, depth_width=32,
        num_point_sequences=1, crop_min=(-5, -5, -5), crop_max=(5, 5, 5),
        voxel_min=(-5, -5, -5), voxel_max=(5, 5, 5),
        voxel_size=(0.5, 0.5, 0.5), rollbuffer_point_capacity=256,
        rollbuffer_seq_capacity=16, max_points_per_sequence=64,
        voxel_occupancy_lifetime=3, depth_link_codec="none",
        lidar_link_quant_step=0.002, occupancy_sparse_capacity=64,
        emit_occupancy_u8=True, emit_raw_points=False)
    engines = [FusionEngine(cfg, device=dev), FusionEngine(cfg, device="cpu")]
    intr = PinholeIntrinsics.default_for(32, 24)
    eye = np.eye(4, dtype=np.float32)
    rng = np.random.default_rng(11)
    u = np.arange(32)[None, :] + np.zeros((24, 1))
    t = np.linspace(0, np.pi, 200)
    arc = np.stack([0.8 * np.cos(t), 0.8 * np.sin(t),
                    1 + 0.1 * np.sin(5 * t)], -1).astype(np.float32)
    for f in range(4):
        d = (2000 + 40 * u + 6 * rng.standard_normal((2, 24, 32))) \
            .astype(np.uint16)
        outs = []
        for e in engines:
            for i in range(2):
                e.add_depthmap(i, d[i], intr, eye, eye)
            e.add_point_sequence(arc, sec=1, nsec=f * 33000000, tf_move=eye)
            outs.append(e.process(1.0 + f / 30.0))
        for k in outs[1]._fields:
            assert torch.equal(getattr(outs[0], k).cpu(),
                               getattr(outs[1], k)), k


def _runs_of(rng, lengths, sentinel, sentinel_every=0):
    """Keys in runs of the given lengths, neighbouring runs distinct; every
    ``sentinel_every``-th run is sentinel."""
    ks = rng.integers(0, 1000, len(lengths))
    ks[1:] += (ks[1:] == ks[:-1])          # neighbours differ
    if sentinel_every:
        ks[sentinel_every - 1::sentinel_every] = sentinel
    return np.repeat(ks, lengths).astype(np.int32)


def _seg_edge_case(name, rng, sent):
    """(keys, capacity, force_break) of an edge case of the single-pass
    design (reduce_by_key.cuh: 2,048-position tiles, 8 consecutive
    positions per thread; the runs below also cover twice that tile)."""
    tile = 4096
    if name == "run_over_two_tiles":
        return _runs_of(rng, [300, 2 * tile + 700, 50, 40], sent), 64, 0
    if name == "runs_end_on_tile_and_warp_edges":
        lengths = [512] * 8 + [tile, 100, tile - 100, 32, 480, 7]
        return _runs_of(rng, lengths, sent), 64, 0
    if name == "all_sentinel":
        return np.full(3 * tile + 321, sent, np.int32), 16, 0
    if name == "overflow_mid_tile":
        keys = _runs_of(rng, rng.integers(1, 9, 20000), sent, 7)
        return keys, 5000, 0          # the cut falls inside a tile
    if name == "long_runs_many_tiles":   # look-back past 32 head-less tiles
        keys = _runs_of(rng, rng.integers(1, 200000, 40), sent, 9)
        return keys, 1 << 20, 0
    if name == "level2_like":         # sorted partials: ~34 rows a cell
        keys = _runs_of(rng, rng.geometric(1 / 34, 60000), sent)
        return keys, 16384, 0
    if name.startswith("force_break_"):
        fb = int(name.rsplit("_", 1)[1])
        keys = _runs_of(rng, rng.integers(1, 400, 2000), sent, 11)
        return keys, 1 << 20, fb
    raise KeyError(name)


@pytest.mark.parametrize("d", [1, 4, 7])
@pytest.mark.parametrize("name", [
    "run_over_two_tiles", "runs_end_on_tile_and_warp_edges", "all_sentinel",
    "overflow_mid_tile", "long_runs_many_tiles", "level2_like",
    "force_break_100", "force_break_3000", "force_break_5000",
    "force_break_128", "force_break_2048"])
def test_segreduce_kernel_edges_equal_twin(dev, name, d):
    """The single-pass kernel equals its twin bit for bit on the edges of
    its tiles, warps and look-back, and gives the same bits twice."""
    from ros_gpu_depthmap_fusion_tpu_torch.ops.kernels import segreduce as m
    rng = np.random.default_rng(zlib.crc32(f"{name}/{d}".encode()))
    sent = 1 << 22
    keys, cap, fb = _seg_edge_case(name, rng, sent)
    n = keys.shape[0]
    vals = rng.integers(0, 64, (n, d)).astype(np.float32)
    k_t, v_t = torch.from_numpy(keys).to(dev), torch.from_numpy(vals).to(dev)
    got = m.segreduce(k_t, v_t, cap, sent, fb)
    again = m.segreduce(k_t, v_t, cap, sent, fb)
    ref = m.segreduce_plain(k_t, v_t, cap, sent, fb)
    torch.cuda.synchronize()
    for g, a, r in zip(got, again, ref):
        assert torch.equal(g, r) and torch.equal(a, r)


def test_segreduce_kernel_unaligned_rows_equal_twin(dev):
    """D = 4 rows that are not 16-byte aligned take the scalar loads."""
    from ros_gpu_depthmap_fusion_tpu_torch.ops.kernels import segreduce as m
    rng = np.random.default_rng(3)
    sent = 1 << 20
    keys = torch.from_numpy(_runs_of(rng, rng.integers(1, 50, 3000), sent,
                                     5)).to(dev)
    n = keys.shape[0]
    flat = torch.from_numpy(rng.integers(0, 64, 4 * n + 1).astype(
        np.float32)).to(dev)
    vals = flat[1:].view(n, 4)
    assert vals.data_ptr() % 16 != 0
    got = m.segreduce(keys, vals, 1 << 16, sent, 0)
    ref = m.segreduce_plain(keys, vals, 1 << 16, sent, 0)
    torch.cuda.synchronize()
    for g, r in zip(got, ref):
        assert torch.equal(g, r)


def _front_inputs(rng, c, h, w, dev):
    from ros_gpu_depthmap_fusion_tpu_torch.core import transforms as tr
    u = np.arange(w)[None, None, :]
    depth = (2.0 + 0.4 * np.sin(u / 9.0) + 0.01 * rng.standard_normal(
        (c, h, w))).astype(np.float32)
    depth[rng.random((c, h, w)) < 0.05] = 0.0
    depth[:, :, ::17] = 30.0                        # outside the crop box
    intr = np.tile(np.array([w * 0.7, w * 0.7, w / 2.0, h / 2.0],
                            np.float32), (c, 1))
    tfs = np.stack([tr.make_se3(tr.rot_z(0.7 * i) @ tr.rot_x(-1.8),
                                np.array([np.cos(i), np.sin(i), 1.5]))
                    for i in range(c)]).astype(np.float32)
    return tuple(torch.from_numpy(a).to(dev) for a in (depth, intr, tfs))


@pytest.mark.parametrize("c,h,w,cap,force_break,voxel", [
    (1, 1, 1, 16, 128, 0.1),
    (2, 16, 40, 1 << 16, 128, 0.1),
    (3, 8, 256, 1 << 16, 0, 0.1),     # W == Wp, no forced breaks
    (2, 16, 150, 50, 128, 0.1),       # capacity below the run count
    (2, 9, 130, 1 << 16, 100, 0.05),  # odd force_break; clamped cells
    (8, 48, 200, 1 << 16, 128, 0.1),
])
def test_fused_unproject_kernel_equals_twin(dev, c, h, w, cap, force_break,
                                            voxel):
    from ros_gpu_depthmap_fusion_tpu_torch.core.grid import VoxelGrid
    from ros_gpu_depthmap_fusion_tpu_torch.ops.kernels import (
        fused_unproject_rle as m)
    rng = np.random.default_rng(c * 1000 + w)
    depth, intr, tfs = _front_inputs(rng, c, h, w, dev)
    half = 100 * voxel                  # a 0.05 cell gives a 5 m grid
    grid = VoxelGrid(lower=(-half, -half, 0.0), upper=(half, half, 2.5),
                     cell_size=(voxel, voxel, 0.12))
    crop = ((-8.0, -8.0, -1.0), (8.0, 8.0, 3.0))
    before = m.launches
    got = m.unproject_voxelize_l1(depth, intr, tfs, tfs, grid, *crop, cap,
                                  force_break)
    ref = m.unproject_voxelize_l1_plain(depth, intr, tfs, tfs, grid, *crop,
                                        cap, force_break)
    torch.cuda.synchronize()
    assert m.launches == before + 1
    for g, r in zip(got, ref):
        assert torch.equal(g, r)
    if c > 1:
        assert 0 < int(got[4]) < c * h * w


def _fused_edge_case(name, dev):
    """(depth, intr, tfs, grid, crop, capacity, force_break) of an edge
    case of kernel 4 on the single-pass reduce-by-key (2,048-position
    tiles)."""
    from ros_gpu_depthmap_fusion_tpu_torch.core.grid import VoxelGrid
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    grid = VoxelGrid(lower=(-10.0, -10.0, 0.0), upper=(10.0, 10.0, 2.5),
                     cell_size=(0.1, 0.1, 0.12))
    crop = ((-8.0, -8.0, -1.0), (8.0, 8.0, 3.0))
    if name == "runs_cross_tiles":
        # W == Wp and no forced breaks: runs cross rows and tiles, 75 tiles
        c, h, w, cap, fb = 2, 300, 256, 1 << 17, 0
    elif name == "long_runs_cross_tiles":
        # 1 m cells: runs of tens of pixels, many of them across a tile edge
        c, h, w, cap, fb = 2, 300, 256, 1 << 17, 0
        grid = VoxelGrid(lower=(-10.0, -10.0, 0.0), upper=(10.0, 10.0, 2.5),
                         cell_size=(1.0, 1.0, 1.25))
    elif name == "one_run_over_many_tiles":
        # one 1,000 m cell, no holes but two: the carry look-back passes
        # more than 32 tiles without a run head (the sums stay below 2^24:
        # every point lies within 16/1024 of the cell's lower corner)
        c, h, w, cap, fb = 2, 300, 256, 64, 0
        grid = VoxelGrid(lower=(-8.0, -8.0, -1.0), upper=(992.0, 992.0, 999.0),
                         cell_size=(1000.0, 1000.0, 1000.0))
    elif name == "overflow_in_a_later_tile":
        c, h, w, cap, fb = 4, 64, 256, 3000, 128
    elif name == "all_invalid":
        c, h, w, cap, fb = 3, 40, 200, 512, 128
    else:
        raise KeyError(name)
    depth, intr, tfs = _front_inputs(rng, c, h, w, dev)
    if name == "one_run_over_many_tiles":
        depth = torch.full_like(depth, 2.0)
        depth.view(-1)[[70000, 140000]] = 0.0
    if name == "all_invalid":
        depth = torch.zeros_like(depth)
    return depth, intr, tfs, grid, crop, cap, fb


@pytest.mark.parametrize("name", [
    "runs_cross_tiles", "long_runs_cross_tiles", "one_run_over_many_tiles",
    "overflow_in_a_later_tile", "all_invalid"])
def test_fused_unproject_kernel_edges_equal_twin(dev, name):
    """Kernel 4 equals its twin in all five outputs, the valid count
    included, on the edges of its tiles and look-back, and gives the same
    bits twice."""
    from ros_gpu_depthmap_fusion_tpu_torch.ops.kernels import (
        fused_unproject_rle as m)
    depth, intr, tfs, grid, crop, cap, fb = _fused_edge_case(name, dev)
    got = m.unproject_voxelize_l1(depth, intr, tfs, tfs, grid, *crop, cap, fb)
    again = m.unproject_voxelize_l1(depth, intr, tfs, tfs, grid, *crop, cap,
                                    fb)
    ref = m.unproject_voxelize_l1_plain(depth, intr, tfs, tfs, grid, *crop,
                                        cap, fb)
    torch.cuda.synchronize()
    for g, a, r in zip(got, again, ref):
        assert torch.equal(g, r) and torch.equal(a, r)
    runs, valid = int(ref[3]), int(ref[4])
    if name.endswith("runs_cross_tiles"):
        assert depth.numel() > 32 * 2048 and 0 < runs < cap
    if name == "one_run_over_many_tiles":
        assert runs == 3 and valid == depth.numel() - 2
        assert float(ref[1].max()) < 2 ** 24
    if name == "overflow_in_a_later_tile":
        assert runs > cap and int(ref[2]) == cap
        # the cut falls past the first tile
        first = m.unproject_voxelize_l1_plain(
            depth[:1, :8].contiguous(), intr[:1], tfs[:1], tfs[:1], grid,
            *crop, cap, fb)
        assert int(first[3]) < cap
    if name == "all_invalid":
        assert runs == 0 and valid == 0


def test_link_engine_on_card_equals_cpu(dev):
    """``bench.py``'s link combination (p4 with hysteresis, delta-coded
    lidar) on a small pipelined rig: every output equal on the card and on
    the CPU."""
    from ros_gpu_depthmap_fusion_tpu_torch.core.camera import (
        PinholeIntrinsics)
    from ros_gpu_depthmap_fusion_tpu_torch.core.config import FusionConfig
    from ros_gpu_depthmap_fusion_tpu_torch.pipeline.engine import (
        FusionEngine)
    from ros_gpu_depthmap_fusion_tpu_torch.utils import native
    if not native.available():
        pytest.skip("native library not built")
    cfg = FusionConfig(
        num_depth_streams=2, depth_height=24, depth_width=32,
        num_point_sequences=1, crop_min=(-5, -5, -5), crop_max=(5, 5, 5),
        voxel_min=(-5, -5, -5), voxel_max=(5, 5, 5),
        voxel_size=(0.5, 0.5, 0.5), rollbuffer_point_capacity=256,
        rollbuffer_seq_capacity=16, max_points_per_sequence=64,
        voxel_occupancy_lifetime=3, depth_link_codec="dpcm_temporal",
        depth_codec_quant_shift=3, depth_codec_hysteresis=2,
        depth_codec_p4_budget=16, depth_codec_keyframe_interval=4,
        depth_codec_max_exceptions=2048, lidar_link_quant_step=0.002,
        lidar_link_delta=True, occupancy_sparse_capacity=64,
        emit_occupancy_u8=True, emit_raw_points=False)
    engines = [FusionEngine(cfg, device=dev, pipeline_depth=1),
               FusionEngine(cfg, device="cpu", pipeline_depth=1)]
    intr = PinholeIntrinsics.default_for(32, 24)
    eye = np.eye(4, dtype=np.float32)
    rng = np.random.default_rng(11)
    u = np.arange(32)[None, :] + np.zeros((24, 1))
    t = np.linspace(0, np.pi, 60)
    arc = np.stack([0.8 * np.cos(t), 0.8 * np.sin(t),
                    1 + 0.1 * np.sin(5 * t)], -1).astype(np.float32)
    outs = ([], [])
    for f in range(7):
        d = (2000 + 40 * u + 6 * rng.standard_normal((2, 24, 32))) \
            .astype(np.uint16)
        d[:, 5:9, 3 * f:3 * f + 6] -= 300
        for e, o in zip(engines, outs):
            for i in range(2):
                e.add_depthmap(i, d[i], intr, eye, eye)
            e.add_point_sequence(arc, sec=1, nsec=f * 33000000, tf_move=eye)
            out = e.process(1.0 + f / 30.0)
            if out is not None:
                o.append((out, e.last_frame_bits))
    for e, o in zip(engines, outs):
        o.append((e.flush(), e.last_frame_bits))
    assert [b for _, b in outs[0]] == [b for _, b in outs[1]]
    assert "p4" in [b for _, b in outs[0]]
    for (a, _), (b, _) in zip(*outs):
        for k in b._fields:
            assert torch.equal(getattr(a, k).cpu(), getattr(b, k)), k


def _bench_like_grid(rng, z, y, x):
    """A noisy two-layer floor, 60 boxes and speckle."""
    occ = np.zeros((z, y, x), bool)
    occ[0:2] = rng.random((2, y, x)) < 0.5
    for _ in range(60):
        x0, y0 = rng.integers(0, x - 30), rng.integers(0, y - 30)
        w, h = rng.integers(3, 30, 2)
        z0 = rng.integers(0, max(1, z - 5))
        occ[z0:z0 + int(rng.integers(1, 8)), y0:y0 + h, x0:x0 + w] = True
    return occ | (rng.random((z, y, x)) < 0.002)


@pytest.mark.parametrize("shape", [(7, 40, 48), (21, 400, 400)])
def test_segment_on_card_equals_cpu(dev, shape):
    """The device segmentation on the card equals the CPU run in every
    field, the centroid included (int64 sums: order-free)."""
    from ros_gpu_depthmap_fusion_tpu_torch.mapping.segmentation import (
        segment)
    occ = torch.from_numpy(_bench_like_grid(np.random.default_rng(3),
                                            *shape))
    got = segment(occ.to(dev), 256, 64)
    ref = segment(occ, 256, 64)
    for f in ref._fields:
        if f == "iterations":
            assert got.iterations == ref.iterations
        else:
            assert torch.equal(getattr(got, f).cpu(), getattr(ref, f)), f
    assert int(ref.num_merged) > 2


def _mapping_rig(emit_u8):
    from ros_gpu_depthmap_fusion_tpu_torch.core.config import FusionConfig
    return FusionConfig(
        num_depth_streams=2, depth_height=24, depth_width=32,
        num_point_sequences=1, crop_min=(-5, -5, -5), crop_max=(5, 5, 5),
        voxel_min=(-5, -5, -5), voxel_max=(5, 5, 5),
        voxel_size=(0.5, 0.5, 0.5), rollbuffer_point_capacity=256,
        rollbuffer_seq_capacity=16, max_points_per_sequence=64,
        voxel_occupancy_lifetime=3, depth_link_codec="none",
        lidar_link_quant_step=0.002, occupancy_sparse_capacity=64,
        emit_occupancy_u8=emit_u8, emit_raw_points=False,
        mapping_detail_min_area=-1.0)


@pytest.mark.parametrize("backend", ["host", "device"])
def test_mapping_sparse_on_card_equals_cpu(dev, backend):
    """A small pipelined engine on the card and on the CPU: each frame's
    ``process_sparse`` cycle (from the card's outputs on the card's
    pipeline) equals the CPU's, tracks included."""
    from ros_gpu_depthmap_fusion_tpu_torch.core.camera import (
        PinholeIntrinsics)
    from ros_gpu_depthmap_fusion_tpu_torch.pipeline.engine import (
        FusionEngine)
    from ros_gpu_depthmap_fusion_tpu_torch.utils import native
    if backend == "host" and not native.available():
        pytest.skip("native library not built")
    cfg = _mapping_rig(False).replace(segmentation_backend=backend)
    engines = [FusionEngine(cfg, device=d, pipeline_depth=1,
                            enable_mapping=True) for d in (dev, "cpu")]
    intr = PinholeIntrinsics.default_for(32, 24)
    eye = np.eye(4, dtype=np.float32)
    rng = np.random.default_rng(5)
    u = np.arange(32)[None, :] + np.zeros((24, 1))
    t = np.linspace(0, np.pi, 60)
    arc = np.stack([0.8 * np.cos(t), 0.8 * np.sin(t),
                    1 + 0.1 * np.sin(5 * t)], -1).astype(np.float32)
    results = ([], [])
    for f in range(6):
        d = (2000 + 40 * u + 6 * rng.standard_normal((2, 24, 32))) \
            .astype(np.uint16)
        d[:, 5:12, 3 * f:3 * f + 8] -= 600
        for e, r in zip(engines, results):
            for i in range(2):
                e.add_depthmap(i, d[i], intr, eye, eye)
            e.add_point_sequence(arc, sec=1, nsec=f * 33000000, tf_move=eye)
            out = e.process(1.0 + f / 30.0)
            if out is not None:
                r.append(e.mapping.process_sparse(
                    (out.occupancy_sparse_idx, out.occupancy_sparse_words,
                     out.occupancy_sparse_count, out.occupancy_sparse_true,
                     out.occupancy_bits)))
    for e in engines:
        e.close()
    assert len(results[0]) == len(results[1]) == 5
    for k, (a, b) in enumerate(zip(*results)):
        assert_same(b, a, f"cycle {k}")
    assert results[0][-1].num_merged >= 2


def test_component_with_mapping_on_card_equals_cpu(dev):
    """``FusionComponent`` with mapping on, one stream plus lidar, on the
    card and on the CPU: equal ``on_points`` and ``on_mapping`` payloads."""
    from ros_gpu_depthmap_fusion_tpu_torch.core.camera import (
        PinholeIntrinsics)
    from ros_gpu_depthmap_fusion_tpu_torch.pipeline.component import (
        FusionComponent)
    cfg = _mapping_rig(True).replace(num_depth_streams=1, resample_rate=0.0,
                                     segmentation_backend="device")
    got = {d: ([], []) for d in ("card", "cpu")}
    comps = {d: FusionComponent(cfg, dv, on_points=got[d][0].append,
                                on_mapping=got[d][1].append,
                                enable_mapping=True)
             for d, dv in (("card", dev), ("cpu", "cpu"))}
    intr = PinholeIntrinsics.default_for(32, 24)
    eye = np.eye(4, dtype=np.float32)
    s = np.linspace(0, 1, 40)
    for f in range(4):
        depth = np.full((24, 32), 2200, np.uint16)
        depth[6:14, 4 + 2 * f:14 + 2 * f] = 1500
        arc = np.stack([2 * np.cos(s + f), 2 * np.sin(s + f), 0 * s + 1],
                       -1)
        for c in comps.values():
            c.callback_point_sequence(1.0 + f / 30 - 0.01, arc)
            c.callback_depthmap(0, 1.0 + f / 30, depth, intr, eye)
    (cp, cm), (hp, hm) = got["card"], got["cpu"]
    assert len(cp) == len(hp) == 4 and len(cm) == len(hm) == 4
    for a, b in zip(cp, hp):
        for k in b._fields:
            assert torch.equal(getattr(a, k).cpu(), getattr(b, k)), k
    for k, (a, b) in enumerate(zip(hm, cm)):
        assert_same(a, b, f"on_mapping[{k}]")
    assert hm[-1].num_merged >= 2


# -- the non-split step, every mode, and heterogeneous rigs ---------------

def _publish_rig(**kw):
    """A small rig at ``FusionConfig()``'s defaults (raw cloud emitted,
    ``voxel_mean_mode="auto"``, dense occupancy), with lidar."""
    from ros_gpu_depthmap_fusion_tpu_torch.core.config import FusionConfig
    base = dict(
        num_depth_streams=2, depth_height=24, depth_width=32,
        num_point_sequences=1, crop_min=(-5, -5, -5), crop_max=(5, 5, 5),
        voxel_min=(-5, -5, -5), voxel_max=(5, 5, 5),
        voxel_size=(0.5, 0.5, 0.5), rollbuffer_point_capacity=256,
        rollbuffer_seq_capacity=16, max_points_per_sequence=64,
        voxel_occupancy_lifetime=3, depth_link_codec="none")
    base.update(kw)
    return FusionConfig(**base)


@pytest.mark.parametrize("case", [
    "auto", "rle", "packed", "exact", "auto_no_raw", "packed_no_raw",
    "occupied", "no_voxel_filter", "radius", "sparse_exact", "hetero",
    "hetero_dpcm", "hetero_dpcm_pipelined"])
def test_publish_engine_on_card_equals_cpu(dev, case):
    """Five frames of a small rig in each mode and branch of the non-split
    step, and on a heterogeneous rig (raw and ``"dpcm"``, synchronous and
    pipelined): every output equal on the card and on the CPU."""
    from ros_gpu_depthmap_fusion_tpu_torch.core.camera import (
        PinholeIntrinsics)
    from ros_gpu_depthmap_fusion_tpu_torch.pipeline.engine import (
        FusionEngine)
    from ros_gpu_depthmap_fusion_tpu_torch.utils import native
    kw = {"auto": {}, "rle": dict(voxel_mean_mode="rle"),
          "packed": dict(voxel_mean_mode="packed"),
          "exact": dict(voxel_mean_mode="exact"),
          "auto_no_raw": dict(emit_raw_points=False),
          "packed_no_raw": dict(emit_raw_points=False,
                                voxel_mean_mode="packed"),
          "occupied": dict(voxel_enable_average=False),
          "no_voxel_filter": dict(enable_voxel_filter=False),
          "radius": dict(enable_radius_filter=True,
                         radius_filter_radius=0.06,
                         radius_min=(-2, -2, 0), radius_max=(2, 2, 4)),
          "sparse_exact": dict(voxel_mean_mode="exact",
                               occupancy_sparse_capacity=64)}.get(case, {})
    hetero = case.startswith("hetero")
    if hetero:
        kw = dict(stream_shapes=((24, 32), (16, 20)),
                  depth_link_codec="dpcm" if "dpcm" in case else "none")
        if "dpcm" in case and not native.available():
            pytest.skip("native library not built")
    cfg = _publish_rig(**kw)
    depth_ = 1 if case.endswith("pipelined") else 0
    engines = [FusionEngine(cfg, device=dev, pipeline_depth=depth_),
               FusionEngine(cfg, device="cpu", pipeline_depth=depth_)]
    eye = np.eye(4, dtype=np.float32)
    tf1 = eye.copy()
    tf1[:3, 3] = (0.3, -0.2, 0.1)
    rng = np.random.default_rng(13)
    u = np.arange(32)[None, :] + np.zeros((24, 1))
    t = np.linspace(0, np.pi, 200)
    arc = np.stack([0.8 * np.cos(t), 0.8 * np.sin(t),
                    1 + 0.1 * np.sin(5 * t)], -1).astype(np.float32)
    outs = ([], [])
    for f in range(5):
        d = (2000 + 40 * u + 6 * rng.standard_normal((2, 24, 32))) \
            .astype(np.uint16)
        d[rng.random((2, 24, 32)) < 0.01] = 0
        for e, o in zip(engines, outs):
            e.add_depthmap(0, d[0], PinholeIntrinsics.default_for(32, 24),
                           eye, eye)
            if hetero:
                e.add_depthmap(1, d[1, :16, :20],
                               PinholeIntrinsics.default_for(20, 16), tf1,
                               tf1)
            else:
                e.add_depthmap(1, d[1], PinholeIntrinsics.default_for(32, 24),
                               tf1, tf1)
            e.add_point_sequence(arc + np.float32(0.01 * f), sec=1,
                                 nsec=f * 33000000, tf_move=eye)
            out = e.process(1.0 + f / 30.0)
            if out is not None:
                o.append((out, e.last_frame_bits))
    for e, o in zip(engines, outs):
        if depth_:
            o.append((e.flush(), e.last_frame_bits))
        e.close()
    assert len(outs[0]) == len(outs[1]) == 5
    assert [b for _, b in outs[0]] == [b for _, b in outs[1]]
    for (a, _), (b, _) in zip(*outs):
        for k in b._fields:
            assert torch.equal(getattr(a, k).cpu(), getattr(b, k)), k
    last = outs[1][-1][0]
    assert int(last.fused_count) > 0 and int(last.raw_count) > 0


# the launch-file presets' small rigs (also ``tests/test_torch_presets.py``):
# each preset's grid, crop and lifetime, cameras at PRESET_HW; by preset,
# (cameras, ring slots, ring radius m) of bench.py-like rigs looking at the
# grid's centre: the first 6 of 8 on an 8 m ring (Hafen), 2 facing each
# other from the edge of the 8 x 8 m crop (Office)
PRESET_HW = (48, 64)
PRESET_RIGS = {"PRESET_HAFEN": (6, 8, 8.0), "PRESET_OFFICE": (2, 2, 4.0)}


def preset_poses(name, f):
    """The camera poses of preset ``name``'s rig at frame ``f``: on a ring
    2 m up, looking at its centre 0.3 rad down, swaying with the frame."""
    from ros_gpu_depthmap_fusion_tpu_torch.core import transforms as tr
    n, slots, radius = PRESET_RIGS[name]
    yaw0 = 0.02 * np.sin(2 * np.pi * f / 60.0)
    out = []
    for i in range(n):
        ang = i * 2 * np.pi / slots + yaw0
        pos = np.array([radius * np.cos(ang), radius * np.sin(ang), 2.0])
        out.append(tr.make_se3(tr.rot_z(ang + np.pi)
                               @ tr.rot_x(-np.pi / 2 - 0.3), pos)
                   .astype(np.float32))
    return out


def preset_depths(name, n_frames, seed=7):
    """Frames of u16 millimetre depth for preset ``name``'s cameras:
    smooth surfaces 2.2-2.9 m away with pattern noise, persistent holes
    and a moving blob."""
    h, w = PRESET_HW
    n = PRESET_RIGS[name][0]
    rng = np.random.default_rng(seed)
    u, v = np.meshgrid(np.arange(w), np.arange(h))
    base = 2500 + 200 * np.sin(u / 15.0) + 150 * np.cos(v / 12.0)
    holes = rng.random((n, h, w)) < 0.01
    for f in range(n_frames):
        blob = 300 * np.exp(-(((u - w * 0.5 - 4 * np.cos(f)) / 6.0) ** 2
                             + ((v - h * 0.5) / 5.0) ** 2))
        d = (base - blob + rng.normal(0, 6, (n, h, w))).astype(np.uint16)
        d[holes] = 0
        yield d


def stage_preset(eng, name, f, depth):
    from ros_gpu_depthmap_fusion_tpu_torch.core.camera import (
        PinholeIntrinsics)
    intr = PinholeIntrinsics.default_for(PRESET_HW[1], PRESET_HW[0])
    for i, pose in enumerate(preset_poses(name, f)):
        eng.add_depthmap(i, depth[i], intr, pose, pose)


@pytest.mark.parametrize("name", list(PRESET_RIGS))
def test_preset_engine_on_card_equals_cpu(dev, name):
    """Each launch-file preset as written (the "dpcm" link, raw cloud,
    dense occupancy, "auto" = rle) with its cameras cut to 64x48: five
    frames, every output equal on the card and on the CPU."""
    from ros_gpu_depthmap_fusion_tpu_torch.core import config
    from ros_gpu_depthmap_fusion_tpu_torch.pipeline.engine import (
        FusionEngine)
    from ros_gpu_depthmap_fusion_tpu_torch.utils import native
    if not native.available():
        pytest.skip("native library not built")
    cfg = getattr(config, name).replace(depth_height=PRESET_HW[0],
                                        depth_width=PRESET_HW[1])
    engines = [FusionEngine(cfg, device=dev), FusionEngine(cfg, "cpu")]
    for f, d in enumerate(preset_depths(name, 5)):
        outs = []
        for e in engines:
            stage_preset(e, name, f, d)
            outs.append(e.process(1.0 + f / 30.0))
        assert engines[0].last_frame_bits == engines[1].last_frame_bits
        for k in outs[1]._fields:
            assert torch.equal(getattr(outs[0], k).cpu(),
                               getattr(outs[1], k)), (f, k)
        assert int((outs[1].occupancy_u8 > 0).sum()) >= 500
    for e in engines:
        e.close()


# the raw cloud of the bench rig: 8 x 480 x 848 pixels + 98,304 lidar rows
RAW_CLOUD_ROWS = 8 * 480 * 848 + 98304


@pytest.mark.parametrize("p", [0.0, 0.3, 1.0])
def test_compact_kernel_raw_cloud_shape_equals_twin(dev, p):
    """Kernel 3 at the raw cloud's shape, ``[N, 4]`` into capacity N: an
    empty mask, a partial one and all rows."""
    from ros_gpu_depthmap_fusion_tpu_torch.ops.kernels import compact as m
    n = RAW_CLOUD_ROWS
    gen = torch.Generator(device=dev).manual_seed(7)
    words = torch.randint(-2 ** 31, 2 ** 31 - 1, (n, 4), generator=gen,
                          device=dev, dtype=torch.int32)
    mask = torch.rand(n, generator=gen, device=dev) < p
    got = m.compact_rows(words, mask, n)
    ref = m.compact_plain(words, mask, n)
    torch.cuda.synchronize()
    for g, r in zip(got, ref):
        assert torch.equal(g, r)
    assert int(got[1]) == int(mask.sum())


@pytest.mark.parametrize("p", [0.0, 0.25, 1.0])
def test_segreduce_kernel_sorted_full_stream_equals_twin(dev, p):
    """Kernel 1 on a stably sorted full stream (packed mode's call: the
    raw cloud's cells sorted, sentinels last) into 262,144 rows: no valid
    row, some, and every row valid."""
    from ros_gpu_depthmap_fusion_tpu_torch.ops.kernels import segreduce as m
    n, cells, cap = RAW_CLOUD_ROWS, 3_360_000, 262_144
    gen = torch.Generator(device=dev).manual_seed(9)
    # clustered cells: about 40k occupied, a few hundred points each
    keys = (torch.randint(0, 40_000, (n,), generator=gen, device=dev)
            * 83).to(torch.int32)
    keys = torch.where(torch.rand(n, generator=gen, device=dev) < p, keys,
                       cells)
    keys = torch.sort(keys, stable=True)[0].contiguous()
    vals = torch.cat([
        torch.randint(0, 1 << 10, (n, 2), generator=gen, device=dev),
        torch.randint(0, 1 << 12, (n, 1), generator=gen, device=dev),
        torch.ones((n, 1), device=dev, dtype=torch.int64)], 1) \
        .to(torch.float32)
    got = m.segreduce(keys, vals, cap, cells)
    ref = m.segreduce_plain(keys, vals, cap, cells)
    torch.cuda.synchronize()
    for g, r in zip(got, ref):
        assert torch.equal(g, r)
    assert int(got[3]) == int(torch.unique(keys[keys < cells]).numel())


# --- SLAM (slam/, no kernel of its own: plain PyTorch on the card) ---------

def _slam_frames(w=320, h=240, n=2):
    """``n`` rendered views of a textured scene: (intrinsics, [(pose,
    integer-valued intensity, depth in metres)])."""
    from ros_gpu_depthmap_fusion_tpu_torch.core import transforms
    from ros_gpu_depthmap_fusion_tpu_torch.core.camera import (
        PinholeIntrinsics)
    from ros_gpu_depthmap_fusion_tpu_torch.pipeline.datasets import (
        Box, Sphere, SyntheticRigDataset)
    intr = PinholeIntrinsics.default_for(w, h)
    rng = np.random.default_rng(9)
    ds = SyntheticRigDataset(
        intr, spheres=[Sphere(rng.uniform(-2, 2, 3) + [0, 0, 3.5],
                              rng.uniform(0.2, 0.5)) for _ in range(8)],
        boxes=[Box(np.array([-0.5, -0.5, 4.0]), np.array([0.8, 0.6, 5.0]))],
        ground_z=None)
    out = []
    for f in range(n):
        pose = transforms.make_se3(transforms.rot_y(0.02 * f),
                                   np.array([0.04 * f, 0.02 * f, 0.0]))
        d, img = ds.render(pose)
        out.append((pose, np.clip(np.round(img), 0, 255).astype(np.float32),
                    (d * 0.001).astype(np.float32)))
    return intr, out


def test_tf32_is_off_after_import():
    import ros_gpu_depthmap_fusion_tpu_torch  # noqa: F401
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


def test_slam_features_and_match_on_card_equal_cpu(dev):
    """FAST, the stable top-K, BRIEF steered by IEEE division and square
    root, and the SWAR Hamming distances round the same on the card: the
    keypoints, descriptors and matches equal the CPU port's (the angle,
    from ``arctan2``, within 1e-6)."""
    from ros_gpu_depthmap_fusion_tpu_torch.slam import features as feat
    _, frames = _slam_frames()
    kps = []
    for _, img, _ in frames:
        k_c = feat.detect_and_describe(torch.from_numpy(img).to(dev), 512)
        k_h = feat.detect_and_describe(torch.from_numpy(img), 512)
        for f in ("xy", "score", "valid", "desc"):
            assert torch.equal(getattr(k_c, f).cpu(), getattr(k_h, f)), f
        assert float((k_c.angle.cpu() - k_h.angle).abs().max()) <= 1e-6
        assert int(k_h.valid.sum()) > 100
        kps.append((k_c, k_h))
    m_c = feat.match(kps[0][0], kps[1][0])
    m_h = feat.match(kps[0][1], kps[1][1])
    for f in m_h._fields:
        assert torch.equal(getattr(m_c, f).cpu(), getattr(m_h, f)), f
    assert int(m_h.valid.sum()) > 50


def test_slam_ransac_with_fixed_draws_on_card_matches_cpu(dev, monkeypatch):
    """The same 64 sampled triples on both devices: equal inlier counts,
    the transform within 1e-5 (cuSOLVER's and LAPACK's singular vectors
    may differ in sign; R does not depend on it)."""
    from ros_gpu_depthmap_fusion_tpu_torch.slam import pose_estimation as pe
    rng = np.random.default_rng(4)
    n = 300
    src = (rng.normal(size=(n, 3)) * 2).astype(np.float32)
    c, s = np.cos(0.4), np.sin(0.4)
    rot = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
    dst = (src @ rot.T + [0.3, 0.1, -0.2]).astype(np.float32)
    out = rng.random(n) < 0.4
    dst[out] += rng.normal(size=(out.sum(), 3)).astype(np.float32)
    valid = torch.from_numpy(rng.random(n) > 0.1)
    probs = valid.float() / valid.float().sum()
    idx = pe._sample_hypotheses(torch.Generator().manual_seed(3), probs, 64)
    monkeypatch.setattr(pe, "_sample_hypotheses",
                        lambda g, p, it: idx.to(p.device))
    res = {}
    for d in (dev, torch.device("cpu")):
        res[d.type] = pe.ransac_pose(
            torch.from_numpy(src).to(d), torch.from_numpy(dst).to(d),
            valid.to(d), torch.Generator(d).manual_seed(0), iterations=64,
            inlier_threshold=0.08)
    c, h = res["cuda"], res["cpu"]
    assert int(c.num_inliers) == int(h.num_inliers) > 100
    assert torch.equal(c.inliers.cpu(), h.inliers)
    assert float((c.transform.cpu() - h.transform).abs().max()) <= 1e-5


def _slam_window(dev):
    """A BA window from the port's odometry over 8 frames on ``dev``."""
    from ros_gpu_depthmap_fusion_tpu_torch.slam.frontend import RgbdOdometry
    intr, frames = _slam_frames(160, 120, 8)
    odo = RgbdOdometry(intr, dev, max_keypoints=256, min_inliers=8,
                       keyframe_translation=0.08, inlier_threshold=0.1)
    for f, (_, img, depth) in enumerate(frames):
        odo.process(f / 30.0, img, depth)
    return odo, odo.build_ba_window(8)[0]


def test_slam_solve_window_on_card_matches_cpu(dev):
    """4 iterations on the same window: the same accept decisions outside
    rounding ties, poses within 1e-4 m and 1e-4 rad when every decision
    agrees, the same final chi2 when a tie went the other way (the card's
    scatter-adds are atomics in no fixed order; ``chip_smoke.py
    ba_card_vs_cpu`` says why a tie can move poses further)."""
    from chip_smoke import ba_card_vs_cpu
    from ros_gpu_depthmap_fusion_tpu_torch.slam import ba
    _, prob = _slam_window(dev)
    out = ba_card_vs_cpu(torch, prob)
    assert out["ba_accepts"][1][0]        # the first step improves chi2
    got, _ = ba.solve_window(prob, iterations=4)
    assert got.poses.device.type == "cuda"


def test_slam_pose_graph_on_card_matches_cpu(dev):
    from ros_gpu_depthmap_fusion_tpu_torch.core import transforms
    from ros_gpu_depthmap_fusion_tpu_torch.slam import pose_graph as pg
    rng = np.random.default_rng(7)
    n = 6
    poses = [np.eye(4, dtype=np.float32)]
    for _ in range(1, n):
        poses.append((poses[-1] @ transforms.make_se3(
            transforms.rot_z(2 * np.pi / n), np.array([1.0, 0, 0])))
            .astype(np.float32))
    poses = np.stack(poses)
    noisy = poses.copy()
    noisy[1:, :3, 3] += (rng.normal(size=(n - 1, 3)) * 0.1).astype(np.float32)
    ei, ej = list(range(n - 1)) + [n - 1], list(range(1, n)) + [0]
    ez = np.stack([np.linalg.inv(poses[i]) @ poses[j]
                   for i, j in zip(ei, ej)]).astype(np.float32)
    arrays = (noisy, np.array(ei, np.int32), np.array(ej, np.int32), ez,
              np.ones(len(ei), np.float32))
    got, gchi = pg.optimize(pg.PoseGraph(*(torch.from_numpy(a).to(dev)
                                           for a in arrays)))
    ref, rchi = pg.optimize(pg.PoseGraph(*map(torch.from_numpy, arrays)))
    assert float((got.poses.cpu() - ref.poses).abs().max()) <= 1e-4
    assert float(gchi[-1]) < float(gchi[0]) * 1e-4


def test_slam_modules_keep_tensors_on_their_device(dev):
    """The odometry's keypoints, generator and BA window, and the loop
    closer's generator, live on the device they were given."""
    from ros_gpu_depthmap_fusion_tpu_torch.slam.loop_closure import (
        LoopCloser)
    odo, prob = _slam_window(dev)
    assert odo.generator.device.type == "cuda"
    for kf in odo.keyframes:
        assert all(t.device.type == "cuda" for t in kf.kps)
    assert all(t.device.type == "cuda" for t in prob)
    assert LoopCloser(dev).generator.device.type == "cuda"


def _sharded_card_rank(rank, shape):
    """One rank of a small sharded engine on ``cuda:0`` (the publish-like
    small rig, raw link, "packed"), 3 frames: its host views and the
    launches of each kernel."""
    from ros_gpu_depthmap_fusion_tpu_torch.ops.kernels import (
        compact, flying_pixels, segreduce)
    from ros_gpu_depthmap_fusion_tpu_torch.parallel import make_mesh
    from ros_gpu_depthmap_fusion_tpu_torch.parallel.engine import (
        ShardedFusionEngine)
    mesh = make_mesh(*shape, device=torch.device("cuda", 0))
    eng = ShardedFusionEngine(_sharded_cfg(), mesh)
    mods = (segreduce, flying_pixels, compact)
    for m in mods:
        m.launches = 0
    views = []
    for f, (depth, intr, tfs, arc) in enumerate(_sharded_frames()):
        for i in range(depth.shape[0]):
            eng.add_depthmap(i, depth[i], intr, tfs[i], tfs[i])
        eng.add_point_sequence(arc, sec=5, nsec=int(f * 33e6),
                               tf_move=np.eye(4, dtype=np.float32))
        out = eng.process(5.0 + f / 30.0)
        views.append((eng.occupancy_host(out), eng.raw_points_host(out),
                      eng.fused_points_host(out)))
    return views, [m.launches for m in mods]


def _sharded_cfg():
    from ros_gpu_depthmap_fusion_tpu_torch.core.config import FusionConfig
    return FusionConfig(
        num_depth_streams=4, depth_height=48, depth_width=64,
        num_point_sequences=1,
        crop_min=(-6, -6, 0), crop_max=(6, 6, 2.5),
        voxel_min=(-6, -6, 0), voxel_max=(6, 6, 2.5),
        voxel_size=(0.25, 0.25, 0.25), voxel_occupancy_lifetime=5,
        rollbuffer_point_capacity=512, rollbuffer_seq_capacity=16,
        max_points_per_sequence=256, depth_link_codec="none",
        voxel_mean_mode="packed")


def _sharded_frames():
    from ros_gpu_depthmap_fusion_tpu_torch.core import transforms
    from ros_gpu_depthmap_fusion_tpu_torch.core.camera import (
        PinholeIntrinsics)
    rng = np.random.default_rng(7)
    u = np.arange(64)[None, :] + np.zeros((48, 1))
    tfs = [transforms.make_se3(
        transforms.rot_z(i * np.pi / 2 + np.pi) @ transforms.rot_x(-np.pi / 2),
        np.array([3 * np.cos(i * np.pi / 2), 3 * np.sin(i * np.pi / 2), 1.5]))
        for i in range(4)]
    frames = []
    for f in range(3):
        d = np.stack([(2000 + 10 * u + 50 * i + rng.normal(0, 3, u.shape))
                      .astype(np.uint16) for i in range(4)])
        t = np.linspace(0, np.pi, 64)
        arc = np.stack([2 * np.cos(t + f * 0.1), 2 * np.sin(t + f * 0.1),
                        1 + 0 * t], axis=-1).astype(np.float32)
        frames.append((d, PinholeIntrinsics.default_for(64, 48), tfs, arc))
    return frames


@pytest.mark.parametrize("backend,shape", [("nccl", (1, 1)),
                                           ("gloo", (2, 2))])
def test_sharded_engine_on_card_equals_cpu_single(dev, tmp_path, backend,
                                                  shape):
    """The sharded engine on the card (one rank on NCCL; four ranks
    sharing the card on gloo) equal frame by frame to the single engine on
    the CPU, each rank launching segreduce once, flying_pixels once and
    compact four times a frame."""
    from ros_gpu_depthmap_fusion_tpu_torch.parallel import spawn
    from ros_gpu_depthmap_fusion_tpu_torch.pipeline.engine import (
        FusionEngine)
    n = shape[0] * shape[1]
    res = spawn(_sharded_card_rank, n, backend,
                init_method=f"file://{tmp_path / 'store'}", timeout=60,
                join_timeout=240, args=(shape,))
    single = FusionEngine(_sharded_cfg(), "cpu")
    for f, (depth, intr, tfs, arc) in enumerate(_sharded_frames()):
        for i in range(depth.shape[0]):
            single.add_depthmap(i, depth[i], intr, tfs[i], tfs[i])
        single.add_point_sequence(arc, sec=5, nsec=int(f * 33e6),
                                  tf_move=np.eye(4, dtype=np.float32))
        out = single.process(5.0 + f / 30.0)
        raw = out.raw_points.numpy()[:int(out.raw_count)]
        for views, launches in res:
            occ, s_raw, fused = views[f]
            np.testing.assert_array_equal(occ, out.occupancy_u8.numpy())
            np.testing.assert_array_equal(
                s_raw[np.lexsort(s_raw.T)], raw[np.lexsort(raw.T)])
            np.testing.assert_array_equal(
                fused, out.fused_points.numpy()[:int(out.fused_count)])
            assert launches == [3, 3, 12]
    assert int(out.fused_count) > 0
