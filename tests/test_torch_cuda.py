"""The port on the card: every check of its CUDA kernels and of its paths
on an NVIDIA GPU lives here (``chip_smoke.py`` only measures).

The kernels against their plain PyTorch twins at edge-case shapes (empty
and ragged tiles, sentinels, forced breaks, capacity overflow, every
column count, several rings, images that cross, fill or are smaller than
the flying-pixel kernel's tiles; for the fused front, widths below, at and
above 128, clamped cells, points outside the crop and runs across many
tiles; compact at the raw cloud's shape and segreduce on a sorted full
stream; the lidar pair's and the segmentation chain's edge cases); small
engines card == CPU on the raw and the coded link, in every mode of the
non-split step, on heterogeneous rigs and for the launch-file presets;
the mapping on the card == CPU; SLAM card == CPU; the sharded engine; and
the main path's configurations at full size on ``portbench/pb/scene.py``'s
scene: each path's launches a step, every step equal to its plain-twin
replay, pipelined == synchronous, "packed" == rle, sparse == packed
mapping, the lidar pair over every link step, and the TUM runner's ATE on
the hard synthetic sequence. They need an NVIDIA GPU and nvcc and skip
elsewhere; on a GPU machine run

    python -m pytest -q -p no:cacheprovider --noconftest tests/test_torch_cuda.py

(``--noconftest``: the suite's conftest configures JAX, which this file
does not use); the NCCL worlds across four cards run with ``-k nccl`` on a
four-card machine and skip below four devices.

:func:`assert_same` (recursive equality of nested results) also serves the
CPU parity tests of the mapping and the component, which import it.
"""

import dataclasses
import hashlib
import json
import sys
import time
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.append(str(ROOT))
from operating_point import (  # noqa: E402
    HETERO_SHAPES, LINK_FIELDS, PRESETS, RAW_FIELDS, RECORD_FRAME, config,
    kernel_modules, scene, stage)

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def assert_same(a, b, path="result"):
    """Recursive equality of nested results (a JAX-package value and its
    port counterpart, or two port values: dataclasses, NamedTuples, plain
    objects, arrays): same class names, same fields (the second value's,
    for dataclasses; for NamedTuples, the first value's fields lead the
    second's, which may go on past them, as the port's ``MappingResult.dt``
    goes on past the JAX package's, and the first value's are compared),
    arrays of equal dtype and shape bit for bit, floats exactly equal."""
    assert type(a).__name__ == type(b).__name__, (path, type(a), type(b))
    if isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, (path, a, b)
        np.testing.assert_array_equal(a, b, err_msg=path)
    elif isinstance(a, tuple) and hasattr(a, "_fields"):
        assert b._fields[:len(a._fields)] == a._fields, (
            path, a._fields, b._fields)
        for n in a._fields:
            assert_same(getattr(a, n), getattr(b, n), f"{path}.{n}")
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


def _link_rig():
    """``bench.py``'s link combination (p4 with hysteresis, delta-coded
    lidar) on a small rig: its config and ``run(engines)``, which feeds
    each pipelined engine the same 7 frames and returns each one's
    ``(outputs, last_frame_bits)`` list."""
    from ros_gpu_depthmap_fusion_tpu_torch.core.camera import (
        PinholeIntrinsics)
    from ros_gpu_depthmap_fusion_tpu_torch.core.config import FusionConfig
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

    def run(engines):
        intr = PinholeIntrinsics.default_for(32, 24)
        eye = np.eye(4, dtype=np.float32)
        rng = np.random.default_rng(11)
        u = np.arange(32)[None, :] + np.zeros((24, 1))
        t = np.linspace(0, np.pi, 60)
        arc = np.stack([0.8 * np.cos(t), 0.8 * np.sin(t),
                        1 + 0.1 * np.sin(5 * t)], -1).astype(np.float32)
        outs = tuple([] for _ in engines)
        for f in range(7):
            d = (2000 + 40 * u + 6 * rng.standard_normal((2, 24, 32))) \
                .astype(np.uint16)
            d[:, 5:9, 3 * f:3 * f + 6] -= 300
            for e, o in zip(engines, outs):
                for i in range(2):
                    e.add_depthmap(i, d[i], intr, eye, eye)
                e.add_point_sequence(arc, sec=1, nsec=f * 33000000,
                                     tf_move=eye)
                out = e.process(1.0 + f / 30.0)
                if out is not None:
                    o.append((out, e.last_frame_bits))
        for e, o in zip(engines, outs):
            o.append((e.flush(), e.last_frame_bits))
            e.close()
        return outs
    return cfg, run


def test_link_engine_on_card_equals_cpu(dev):
    """``bench.py``'s link combination (p4 with hysteresis, delta-coded
    lidar) on a small pipelined rig: every output equal on the card and on
    the CPU."""
    from ros_gpu_depthmap_fusion_tpu_torch.pipeline.engine import (
        FusionEngine)
    cfg, run = _link_rig()
    outs = run([FusionEngine(cfg, device=dev, pipeline_depth=1),
                FusionEngine(cfg, device="cpu", pipeline_depth=1)])
    assert [b for _, b in outs[0]] == [b for _, b in outs[1]]
    assert "p4" in [b for _, b in outs[0]]
    for (a, _), (b, _) in zip(*outs):
        for k in b._fields:
            assert torch.equal(getattr(a, k).cpu(), getattr(b, k)), k


def test_traced_link_engine_on_card(dev):
    """The tracer on over the same rig pipelined on the card: every engine
    span, the wait on a staging slot's copy event among them, the link's
    frame counters adding up to the frames, every step's lidar stages on
    the kernel pair, and the outputs of an untraced run."""
    from ros_gpu_depthmap_fusion_tpu_torch.pipeline.engine import (
        FusionEngine)
    from ros_gpu_depthmap_fusion_tpu_torch.utils import profiling
    cfg, run = _link_rig()
    plain = run([FusionEngine(cfg, device=dev, pipeline_depth=1)])[0]
    profiling.reset()
    profiling.enable()
    try:
        traced = run([FusionEngine(cfg, device=dev, pipeline_depth=1)])[0]
        snap = profiling.snapshot()
    finally:
        profiling.enable(False)
        profiling.reset()
    assert {"fusion.engine.stage", "fusion.engine.encode",
            "fusion.engine.put", "fusion.engine.wait_encode",
            "fusion.engine.wait_slot", "fusion.step", "fusion.step.unpack",
            "fusion.step.lidar", "fusion.step.depth",
            "fusion.step.voxelize", "fusion.step.occupancy"} \
        <= set(snap["spans"])
    c = snap["counters"]
    assert c["fusion.frames"] == 7
    assert c["fusion.lidar.kernel_steps"] == 7
    assert sum(c.get("fusion.link." + k, 0) for k in (
        "iframes", "pframes", "p4frames", "raw_frames")) == 7
    for (a, _), (b, _) in zip(traced, plain):
        for k in b._fields:
            assert torch.equal(getattr(a, k), getattr(b, k)), k


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
    """The device segmentation on the card (the CUDA chain) equals the CPU
    run (the plain twin) in every field, the centroid included (int64
    sums: order-free); the chain runs no fixpoint on the host and reports
    ``iterations`` (0, 0)."""
    from ros_gpu_depthmap_fusion_tpu_torch.mapping.segmentation import (
        segment)
    occ = torch.from_numpy(_bench_like_grid(np.random.default_rng(3),
                                            *shape))
    got = segment(occ.to(dev), 256, 64)
    ref = segment(occ, 256, 64)
    for f in ref._fields:
        if f == "iterations":
            assert got.iterations == (0, 0) and min(ref.iterations) >= 1
        else:
            assert torch.equal(getattr(got, f).cpu(), getattr(ref, f)), f
    assert int(ref.num_merged) > 2


def _spiral(y, x):
    """A one-pixel square spiral, each ring one pixel inside the last: one
    component whose smallest index needs many propagation steps to reach
    the far end."""
    g = np.zeros((y, x), bool)
    r = c = 0
    dr, dc = 0, 1
    g[0, 0] = True

    def ok(a, b):
        return 0 <= a < y and 0 <= b < x and not g[a, b]
    turns = 0
    while turns < 2:
        nr, nc = r + dr, c + dc
        fr, fc = nr + dr, nc + dc
        if ok(nr, nc) and not (0 <= fr < y and 0 <= fc < x and g[fr, fc]):
            r, c, turns = nr, nc, 0
            g[r, c] = True
        else:
            dr, dc, turns = dc, -dr, turns + 1
    return g


def _segment_grid(name):
    """(occupancy [Z, Y, X] bool, max_labels, max_objects) of a named
    edge case of the segmentation chain."""
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    if name == "bench":
        return _bench_like_grid(np.random.default_rng(3), 21, 400, 400), \
            256, 64
    if name == "spiral":            # and its complement, and a snake
        s = _spiral(400, 400)
        snake = np.zeros((400, 400), bool)
        snake[::4] = True
        for k in (1, 2, 3):
            snake[k::8, -1] = snake[k + 4::8, 0] = True
        return np.stack([s, ~s, snake, s]), 256, 64
    if name == "full":              # a fully occupied layer between noise
        occ = rng.random((3, 123, 77)) < 0.3
        occ[1] = True
        return occ, 256, 64
    if name == "empty":
        return np.zeros((4, 64, 96), bool), 256, 64
    if name == "labels_folded":     # 40,000 components in layer 1
        occ = rng.random((3, 400, 400)) < 0.01
        occ[1] = False
        occ[1, ::2, ::2] = True
        return occ, 256, 64
    if name == "objects_folded":    # ~900 two-layer pillars, 64 slots
        occ = np.zeros((5, 120, 130), bool)
        occ[1:3, ::4, ::4] = True
        occ[4] = rng.random((120, 130)) < 0.05
        return occ, 256, 64
    if name == "ragged":            # tiles cut at every edge
        return rng.random((5, 37, 53)) < 0.45, 16, 8
    if name == "wide_row":          # coordinates up to 2^27 - 1, the limit
        occ = np.zeros((2, 1, 2 ** 27), bool)
        occ[0] = True
        occ[1, ::3] = True
        return occ, 256, 64
    if name == "table_at_limit":    # Z * max_labels at the chain's limit
        table = _segment_chain_limits()[0]
        assert table % 512 == 0
        return rng.random((table // 512, 24, 40)) < 0.3, 512, 64
    raise KeyError(name)


def _segment_chain_limits():
    """The largest merge table and object slots the CUDA chain takes on
    this card."""
    from ros_gpu_depthmap_fusion_tpu_torch.mapping.segmentation import (
        chain_limits)
    return chain_limits(
        torch.cuda.get_device_properties(0).shared_memory_per_block_optin)


SEGMENT_GRIDS = ("bench", "spiral", "full", "empty", "labels_folded",
                 "objects_folded", "ragged", "wide_row", "table_at_limit")


@pytest.mark.parametrize("name", SEGMENT_GRIDS)
def test_segment_chain_equals_twin(dev, name):
    """The CUDA chain against its plain twin on the card, every field but
    ``iterations`` bit for bit, on the cell's grid and the edge cases:
    many propagation steps, a full layer, an empty grid, labels and
    objects beyond their capacities (folded into the last id and slot),
    ragged tiles, a row as wide as the chain takes (every warp of its
    full layer sums 32 coordinates near 2^27), and the merge table at the
    shared-memory limit. Eight launches a call, one
    ``segment_kernel_cycles`` with the tracer on."""
    from ros_gpu_depthmap_fusion_tpu_torch.mapping import segmentation
    from ros_gpu_depthmap_fusion_tpu_torch.utils import profiling
    occ, lab, objs = _segment_grid(name)
    occ = torch.from_numpy(occ).to(dev)
    before = segmentation.launches
    profiling.reset()
    profiling.enable()
    try:
        got = segmentation.segment(occ, lab, objs)
        counters = profiling.snapshot()["counters"]
    finally:
        profiling.enable(False)
        profiling.reset()
    assert segmentation.launches - before == segmentation.CHAIN_LAUNCHES
    assert counters == {"fusion.mapping.segment_kernel_cycles": 1}
    ref = segmentation.segment_plain(occ, lab, objs)
    assert got.iterations == (0, 0)
    for f in ref._fields[:-1]:
        a, b = getattr(got, f), getattr(ref, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        assert torch.equal(a, b), f
    nl, nm = got.num_labels.cpu(), int(got.num_merged)
    if name == "labels_folded":
        assert int(nl[1]) == lab and int(got.labels[1].max()) == lab - 1
    if name == "objects_folded":
        assert nm > objs and int(got.voxel_count[-1]) > 2
    if name == "empty":
        assert nm == 1 and int(got.voxel_count.sum()) == 0
    if name == "spiral":
        assert int(nl[0]) == 2 and int(ref.iterations[0]) > 5
    if name == "wide_row":
        assert nm == 3 and int(got.vmax[1, 0]) == 2 ** 27 - 1


def test_segment_chain_refuses_what_it_does_not_take(dev):
    """On the card ``segment`` launches the chain or raises ``ValueError``:
    a merge table one layer past the shared-memory limit, too many object
    slots, a float or non-contiguous occupancy. It never runs the twin."""
    from ros_gpu_depthmap_fusion_tpu_torch.mapping import segmentation
    table, slots = _segment_chain_limits()
    lim = table // 512
    cases = [
        (torch.zeros((lim + 1, 8, 8), dtype=torch.bool, device=dev), 512, 64,
         "merge table"),
        (torch.zeros((2, 8, 8), dtype=torch.bool, device=dev), 256,
         slots + 1, "max_objects"),
        (torch.zeros((2, 8, 8), dtype=torch.float32, device=dev), 256, 64,
         "bool or uint8"),
        (torch.zeros((2, 8, 8), dtype=torch.uint8, device=dev)
         .transpose(1, 2), 256, 64, "contiguous")]
    before = segmentation.launches
    for occ, lab, objs, what in cases:
        with pytest.raises(ValueError, match=what):
            segmentation.segment(occ, lab, objs)
    assert segmentation.launches == before


# -- the foreground grouping (csrc/group.cu) and the object assembly ------

#: the mapping tests' grid, [Z, Y, X]
ZYX = (7, 40, 48)


def mapping_scene(n=5, seed=5):
    """``n`` frames of ``[Z, Y, X]`` occupancy: boxes drifting a cell a
    frame, one growing, plus fresh speckle (the mapping tests' scene)."""
    rng = np.random.default_rng(seed)
    z, y, x = ZYX
    boxes = [(int(rng.integers(0, x - 16)), int(rng.integers(0, y - 14)),
              int(rng.integers(3, 9)), int(rng.integers(3, 9)),
              int(rng.integers(0, z - 3)), int(rng.integers(1, 4)))
             for _ in range(6)]
    for f in range(n):
        occ = np.zeros(ZYX, bool)
        for k, (x0, y0, w, h, z0, d) in enumerate(boxes):
            w = w + f if k == 0 else w
            occ[z0:z0 + d, y0 + f // 2:y0 + f // 2 + h, x0 + f:x0 + f + w] = 1
        occ |= rng.random(ZYX) < 0.01
        yield occ


GROUPING_GRIDS = ("scene0", "scene1", "scene2", "scene3", "scene4", "empty",
                  "single_cells", "edges", "many_components",
                  "objects_folded", "labels_at_capacity")


def grouping_grid(name):
    """(occupancy ``[Z, Y, X]`` bool, max_labels, max_objects) of a named
    case of the foreground grouping and the object assembly: the frames of
    :func:`mapping_scene`, and edge cases on its grid."""
    if name.startswith("scene"):
        return list(mapping_scene())[int(name[5:])], 64, 32
    occ = np.zeros(ZYX, bool)
    if name == "single_cells":      # one-cell objects, never in one column
        occ[::2, 1::6, 1::6] = True  # of adjacent layers
    elif name == "edges":           # objects along all four edges, corners
        occ[0, 0, :] = occ[1, -1, 1:-1] = True
        occ[2, 1:-1, 0] = occ[3, :, -1] = True
        occ[4, [0, 0, -1, -1], [0, -1, 0, -1]] = True
        occ[6, [0, -1], :] = occ[6, :, [0, -1]] = True
    elif name == "many_components":  # one object, 238 components a layer
        occ[0, 2:-2, 2:-2] = True
        occ[1:3, 3:-3:2, 3:-3:3] = True
        return occ, 256, 32
    elif name == "objects_folded":  # 120 merged objects, 4 stats slots
        occ[1:3, ::4, ::4] = True
        return occ, 64, 4
    elif name == "labels_at_capacity":  # 480 components, 16 labels
        occ[2, ::2, ::2] = True
        occ[4, 5:9, 5:30] = True
        return occ, 16, 32
    elif name != "empty":
        raise KeyError(name)
    return occ, 64, 32


def node_grid(seed=1234, frame=9):
    """The node cell's occupancy after ``frame`` (``hafen_node.stream``,
    ``portbench/reference/fusion.py``'s history, on the card) as a
    ``[Z, Y, X]`` bool CPU tensor, its labels a layer and objects."""
    if str(ROOT / "portbench") not in sys.path:
        sys.path.append(str(ROOT / "portbench"))
    from pb import spec
    from pb.scene import Scene
    from reference.fusion import Reference
    cell = spec.cell("hafen_node.stream")
    cfg = cell.config["fusion"]
    ref = Reference(cfg, Scene.for_cell(seed, cell, "cuda"), "cuda")
    occ = (ref.history(frame) > 0).reshape(ref.grid.size[::-1]).cpu()
    return occ, cfg["cc_max_labels_per_layer"], cfg["max_objects"]


def _group_case(name):
    if name == "node":
        return node_grid()
    if name in SEGMENT_GRIDS:
        occ, lab, objs = _segment_grid(name)
    else:
        occ, lab, objs = grouping_grid(name)
    return torch.from_numpy(occ), lab, objs


@pytest.mark.parametrize("name", ("node",) + GROUPING_GRIDS + (
    "bench", "spiral", "full", "empty", "labels_folded", "objects_folded",
    "ragged"))
def test_group_kernels_equal_twin(dev, name):
    """The foreground grouping on the card (csrc/group.cu) against its
    plain twin on the card, counts and every row they size bit for bit, on
    the node cell's scene, the CPU tests' grids and the segmentation
    chain's edge cases; its launches a call by its counter and, on the
    node's grid, by the profiler (the kernels and one memset). On the
    node's grid and the scene's frames the host geometry over the card's
    grouping equals the native assembly over the labels, and
    ``build_objects`` with it equals ``build_objects`` without (a detail
    mask keeping two objects in three)."""
    from ros_gpu_depthmap_fusion_tpu_torch.mapping import segmentation
    from ros_gpu_depthmap_fusion_tpu_torch.mapping.objects import (
        build_objects)
    from ros_gpu_depthmap_fusion_tpu_torch.utils import native
    occ, lab, objs = _group_case(name)
    seg = segmentation.segment(occ.to(dev), lab, objs)
    z = occ.shape[0]
    launches = segmentation.group_launches_per_call(z, lab)
    before = segmentation.group_launches
    got = segmentation.group_foreground(seg)
    torch.cuda.synchronize()
    assert segmentation.group_launches - before == launches
    ref = segmentation.group_foreground_plain(seg)
    assert torch.equal(got.counts.cpu(), ref.counts.cpu())
    fg, nc = ref.counts.tolist()
    nm = int(seg.num_merged)
    used = segmentation.group_rows_used(fg, nc, nm, z)
    assert torch.equal(got.rows[:used].cpu(), ref.rows[:used].cpu())
    # the cells of merged ids in [1, M): the occupied ones, and a layer's
    # background where no column joins it to the layer below (spiral)
    mm = seg.merged_map
    assert fg == int(((mm >= 1) & (mm < nm)).sum()) >= int(occ.sum())
    if name == "node":
        assert launches == 8 and nm > 3 and fg > 1000
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile
        acts = 0
        for _ in range(3):      # the fullest of three traces
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                segmentation.group_foreground(seg)
                torch.cuda.synchronize()
            acts = max(acts, sum(ev.device_type == DeviceType.CUDA
                                 for ev in prof.events()))
        assert acts == launches + 1
    if name != "node" and not name.startswith("scene"):
        return
    grouping = segmentation.grouping_arrays(
        fg, nc, nm, z, got.rows[:used].cpu().numpy())
    labels = seg.labels.cpu().numpy().astype(np.uint16)
    mol = seg.merged_of_label.cpu().numpy()
    cs, lo = (0.1, 0.1), (-20.0, -20.0)
    assert_same(native.assemble_objects(labels, mol, nm, cs, lo),
                native.assemble_grouped(labels, grouping, nm, cs, lo),
                "assembly")
    from ros_gpu_depthmap_fusion_tpu_torch.core.config import FusionConfig
    from ros_gpu_depthmap_fusion_tpu_torch.core.grid import VoxelGrid
    zz, yy, xx = occ.shape
    grid = VoxelGrid.from_config(FusionConfig(
        voxel_min=(0.0, 0.0, 0.0), voxel_max=(xx * 0.1, yy * 0.1, zz * 0.2),
        voxel_size=(0.1, 0.1, 0.2)))
    kw = dict(labels=labels, num_labels=seg.num_labels.cpu().numpy(),
              merged_of_label=mol, num_merged=nm,
              voxel_count=seg.voxel_count.cpu().numpy(),
              centroid=seg.centroid.cpu().numpy(),
              vmin=seg.vmin.cpu().numpy(), vmax=seg.vmax.cpu().numpy(),
              grid=grid, detail_mask=np.arange(nm) % 3 != 1)
    assert_same(build_objects(**kw), build_objects(grouping=grouping, **kw),
                "objects")


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


def _sparse_of(out):
    """A frame's sparse occupancy with its dense fallback (as
    ``chip_smoke.py`` and ``bench.py`` hand it to the mapping worker)."""
    return (out.occupancy_sparse_idx, out.occupancy_sparse_words,
            out.occupancy_sparse_count, out.occupancy_sparse_true,
            out.occupancy_bits)


@pytest.mark.parametrize("backend", ["device", "host"])
def test_mapping_worker_on_card_equals_cpu(dev, backend, tmp_path):
    """``AsyncMappingWorker(packed=True)`` over a small pipelined engine on
    the card, every frame's sparse tuple submitted with ``block=True``,
    against a CPU engine's synchronous ``process_sparse`` at the worker's
    dts: objects and tracks bit for bit, the device backend's submissions
    left on the card (``OnDevice``) and the host backend's prefetched as
    before. The step hands out fresh outputs, not views of buffers it
    keeps; and cycles run alone under the profiler make no host-to-device
    copy."""
    from ros_gpu_depthmap_fusion_tpu_torch.core.camera import (
        PinholeIntrinsics)
    from ros_gpu_depthmap_fusion_tpu_torch.mapping import pipeline as mp
    from ros_gpu_depthmap_fusion_tpu_torch.pipeline.engine import (
        FusionEngine)
    from ros_gpu_depthmap_fusion_tpu_torch.utils import native
    if backend == "host" and not native.available():
        pytest.skip("native library not built")
    cfg = _mapping_rig(False).replace(segmentation_backend=backend)
    card, cpu = (FusionEngine(cfg, device=d, pipeline_depth=1,
                              enable_mapping=True) for d in (dev, "cpu"))
    assert (card.mapping.card_stream is not None) == (backend == "device")
    handed = []
    hand_off = mp.AsyncMappingWorker._hand_off

    def spy(self, item):
        sub = hand_off(self, item)
        handed.append(type(sub).__name__)
        return sub
    w = mp.AsyncMappingWorker(card.mapping, packed=True)
    w._hand_off = spy.__get__(w)
    intr = PinholeIntrinsics.default_for(32, 24)
    eye = np.eye(4, dtype=np.float32)
    rng = np.random.default_rng(5)
    u = np.arange(32)[None, :] + np.zeros((24, 1))
    t = np.linspace(0, np.pi, 60)
    arc = np.stack([0.8 * np.cos(t), 0.8 * np.sin(t),
                    1 + 0.1 * np.sin(5 * t)], -1).astype(np.float32)

    def wait_cycles(n):
        t0 = time.monotonic()
        while w.cycles < n and time.monotonic() - t0 < 30:
            time.sleep(0.002)
        assert w.cycles == n

    prev, cycles = None, 0
    try:
        for f in range(7):
            d = (2000 + 40 * u + 6 * rng.standard_normal((2, 24, 32))) \
                .astype(np.uint16)
            d[:, 5:12, 3 * f:3 * f + 8] -= 600
            outs = []
            for e in (card, cpu):
                for i in range(2):
                    e.add_depthmap(i, d[i], intr, eye, eye)
                e.add_point_sequence(arc, sec=1, nsec=f * 33000000,
                                     tf_move=eye)
                outs.append(e.process(1.0 + f / 30.0))
            out, ref_out = outs
            if out is None:
                continue
            if prev is not None:
                for a, b in zip(_sparse_of(out), _sparse_of(prev)):
                    assert a.data_ptr() != b.data_ptr()
            w.submit(_sparse_of(out), block=True, timeout=30)
            cycles += 1
            wait_cycles(cycles)
            res = w.latest()
            assert_same(cpu.mapping.process_sparse(_sparse_of(ref_out),
                                                   dt=res.dt),
                        res, f"cycle {cycles}")
            prev = out
            time.sleep(0.01)
        assert res.num_merged >= 2 and res.dt > cfg.tracking_dt
        torch.cuda.synchronize()
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                w.submit(_sparse_of(prev), block=True, timeout=30)
                cycles += 1
            wait_cycles(cycles)
            torch.cuda.synchronize()
        path = tmp_path / "trace.json"
        prof.export_chrome_trace(str(path))
    finally:
        w.close()
        card.close()
        cpu.close()
    with open(path) as fh:
        events = json.load(fh)
    if isinstance(events, dict):
        events = events["traceEvents"]
    dev_ev = [e for e in events if e.get("ph") == "X" and str(
        e.get("cat", "")).lower() in ("kernel", "gpu_memcpy")]
    assert [e["name"] for e in dev_ev if "HtoD" in e["name"]] == []
    if backend == "device":
        assert sum(1 for e in dev_ev if str(e["cat"]).lower()
                   == "kernel") >= 3 * 8, "no cycle ran on the card"
    assert handed == [("OnDevice" if backend == "device" else "HostCopy")
                      ] * cycles


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


# --- the main path's configurations at full size -------------------------
#
# bench.py's rig (8 cameras at 848x480 on an 8-slot ring, 2 lidar streams
# of 8,192 points) into its 400x400x21 grid, on portbench/pb/scene.py's
# moving scene from seed 0, drawn on the CPU (operating_point.py)


def _launches(segreduce, flying_pixels, compact, lidar_stages=2):
    return {"segreduce": segreduce, "flying_pixels": flying_pixels,
            "compact": compact, "fused_unproject_rle": 0,
            "lidar_stages": lidar_stages}


# Launches of each kernel in one engine step, by path (kernel 4 is on
# none; the lidar pair, 2, on every path that runs the engine step, not in
# the sharded engine, which keeps its own calls). Split-domain step: level
# 1 + level 2, one filter, the sparse blocks. Non-split step: the raw
# cloud's compaction, then rle (level 1 + level 2), packed (one reduction
# of the sorted stream), exact (the run ends compacted) or occupied (the
# occupied ids compacted); a heterogeneous rig filters each of its two
# resolution groups. A rank of the sharded engine (publish at "packed"):
# its cameras' filter, one reduction of its sorted stream, and four
# compactions (its sequence records, its staged points, its raw cloud,
# its fused sub-slab).
EXPECTED = {
    "link": _launches(2, 1, 1), "link_sync": _launches(2, 1, 1),
    "raw": _launches(2, 1, 1), "mapping": _launches(2, 1, 1),
    "publish": _launches(2, 1, 1), "publish_sync": _launches(2, 1, 1),
    "publish_packed": _launches(1, 1, 1),
    "publish_exact": _launches(0, 1, 2),
    "publish_occupied": _launches(0, 1, 2),
    "hetero": _launches(2, 2, 1), "hetero_sync": _launches(2, 2, 1),
    # the launch-file presets: the non-split step at "auto" = rle, no lidar
    "hafen": _launches(2, 1, 1), "office": _launches(2, 1, 1),
    # the TUM runner's engine: one 640x480 camera, raw cloud, a 320^3 grid
    # (at least 2^24 cells: "auto" runs "packed")
    "tum": _launches(1, 1, 1), "tum_gt": _launches(1, 1, 1),
    "sharded_1x1": _launches(1, 1, 4, 0),
    "sharded_1x1_pipelined": _launches(1, 1, 4, 0),
    "sharded_2x2": _launches(1, 1, 4, 0),
    "sharded_4x1": _launches(1, 1, 4, 0),
}
# path -> (configuration fields or preset, pipeline_depth, frames)
FULL_RUNS = {
    "link": (LINK_FIELDS, 1, 24), "link_sync": (LINK_FIELDS, 0, 24),
    "raw": (RAW_FIELDS, 0, 8), "mapping": (LINK_FIELDS, 1, 12),
    "publish": ({}, 1, 8), "publish_sync": ({}, 0, 8),
    "publish_packed": (dict(voxel_mean_mode="packed"), 1, 8),
    # a second frame, after the first one's history
    "publish_exact": (dict(voxel_mean_mode="exact"), 0, 2),
    "publish_occupied": (dict(voxel_enable_average=False), 0, 2),
    "hetero": (dict(stream_shapes=HETERO_SHAPES), 1, 6),
    "hetero_sync": (dict(stream_shapes=HETERO_SHAPES), 0, 6),
    "hafen": ("hafen", 0, 10), "office": ("office", 0, 10),
}
_FULL = {}


def _digest(t):
    a = t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    a = np.ascontiguousarray(a)
    return f"{a.dtype}{a.shape}" + hashlib.sha256(a.tobytes()).hexdigest()


def _lidar_pair_equal(rb, inp, cfg):
    """The lidar kernel pair against its twin on a step's buffer and
    inputs, bit for bit (new buffer, gathered rows, selection). Returns
    the window's (sequences, points)."""
    from ros_gpu_depthmap_fusion_tpu_torch.state import rollbuffer as rbm
    kw = dict(seq_batch=inp.seq_batch, ps_threshold=inp.ps_threshold,
              roll_min=(inp.roll_min_sec, inp.roll_min_nsec),
              now=(inp.now_sec, inp.now_nsec),
              tf_world_move=inp.tf_world_move,
              tf_crop_move=inp.tf_crop_move,
              filter_size=cfg.point_sequence_filter_size,
              capacity=cfg.rollbuffer_point_capacity)
    got = rbm.advance_and_gather(rb, **kw)
    ref = rbm.advance_and_gather(rb, plain=True, **kw)
    for part, a, b in zip(("buffer", "gathered", "selection"), got, ref):
        for k, (x, y) in enumerate(zip(a, b)):
            assert x.dtype == y.dtype and torch.equal(x, y), (part, k)
    return int(got[2].seq_count), int(got[2].point_count)


def _full_run(path):
    """Run ``path`` of :data:`FULL_RUNS` (``"mapping"``: the link with the
    mapping pipeline set) on the card through the user entry points, once
    a process: every step's launches (counted from 0), every step replayed
    with the plain twins from the same state and compared, the path's own
    checks; returns (launches a step, fields differing from the replay a
    step, depth_bits and field digests an output)."""
    from ros_gpu_depthmap_fusion_tpu_torch.core import config as config_mod
    from ros_gpu_depthmap_fusion_tpu_torch.mapping.pipeline import (
        MappingPipeline)
    from ros_gpu_depthmap_fusion_tpu_torch.pipeline import engine as engmod
    if path in _FULL:
        return _FULL[path]
    fields, depth, frames = FULL_RUNS[path]
    preset = isinstance(fields, str)
    if preset:
        name, rig = PRESETS[fields]
        cfg, sc = getattr(config_mod, name), scene(rig)
    else:
        cfg, sc = config(fields), scene()
    eng = engmod.FusionEngine(cfg, device="cuda", pipeline_depth=depth)
    if path == "mapping":
        eng.enable_mapping = True
        eng.mapping = MappingPipeline(
            cfg.replace(mapping_detail_min_area=-1.0), eng.grid, "cuda")
    kmods = kernel_modules()
    for m in kmods.values():
        m.launches = 0
    steps, replay, windows = [], [], []
    step = eng.step

    def checked(inp, bits=None):
        state = eng.state
        before = {n: m.launches for n, m in kmods.items()}
        out = step(inp, bits)
        steps.append({n: m.launches - before[n] for n, m in kmods.items()})
        if path == "link_sync":
            windows.append(_lidar_pair_equal(state.rollbuffer, inp, cfg))
        _, ref = engmod.fusion_step(state, inp, bits, cfg=cfg, grid=eng.grid,
                                    output_capacity=eng.output_capacity,
                                    plain=True)
        replay.append([k for k in ref._fields
                       if not torch.equal(getattr(out, k), getattr(ref, k))])
        return out
    eng.step = checked
    exceptions = []
    encode = eng._encode

    def counted(pkt, depth_host, scalars):
        words, b = encode(pkt, depth_host, scalars)
        exceptions.append(int(pkt.buf[0]))
        return words, b
    if fields is LINK_FIELDS:
        eng._encode = counted
    outs, bits = [], []
    for f in range(frames):
        out = eng.process(stage(eng, sc, f))
        if out is not None:
            outs.append(out)
            bits.append(eng.last_frame_bits)
    if depth:
        outs.append(eng.flush())
        bits.append(eng.last_frame_bits)
    eng.close()
    assert len(outs) == frames
    for f, o in enumerate(outs):
        assert int(o.vox_partials_count) <= eng.partials_capacity, f
        n = int(o.fused_count)
        assert 0 < n < cfg.voxelize_output_capacity, f
        fp = o.fused_points
        assert fp.shape == (eng.output_capacity, 4)
        assert bool(torch.isfinite(fp).all()) and not bool(fp[n:].any())
        assert bool((fp[:n, 3] == 1).all()), f
        if cfg.num_point_sequences and f >= 1:
            assert int(o.seq_selected_count) > 0, f
        if cfg.emit_raw_points:
            r = o.raw_points
            nr = int(o.raw_count)
            assert r.shape == (cfg.total_point_capacity, 4) and nr > 0, f
            assert bool((r[:nr, 3] == 1).all()) and not bool(r[nr:].any())
        if cfg.emit_occupancy_u8:
            assert o.occupancy_u8.shape == (eng.grid.num_cells,)
            assert int((o.occupancy_u8 > 0).sum()) > 0, f
        if path in ("publish_packed", "publish_exact", "publish_occupied"):
            assert int(o.vox_partials_count) == 0, f
    if fields is LINK_FIELDS:              # an I-keyframe, then p4 frames
        assert isinstance(bits[0], int) and bits[0] > 0
        assert all(b == "p4" for b in bits[1:]), bits
        assert max(exceptions) <= cfg.depth_codec_max_exceptions
    elif cfg.stream_shapes:                # dpcm widths per group
        assert all(isinstance(b, tuple) and len(b) == 2
                   and all(isinstance(g, int) and g > 0 for g in b)
                   for b in bits), bits
    elif cfg.depth_link_codec == "dpcm":   # lossless I-frames
        assert all(isinstance(b, int) and b > 0 for b in bits), bits
    if path == "link_sync":
        assert min(p for _, p in windows[RECORD_FRAME:]) > 0, windows
    if preset:
        assert engmod.resolve_mean_mode(cfg, eng.grid) == "rle"
        assert min(int((o.occupancy_u8 > 0).sum()) for o in outs) >= 1000
    if path == "mapping":
        res = eng.mapping.process_sparse((
            outs[-1].occupancy_sparse_idx, outs[-1].occupancy_sparse_words,
            outs[-1].occupancy_sparse_count, outs[-1].occupancy_sparse_true,
            outs[-1].occupancy_bits))
        fresh = MappingPipeline(cfg.replace(mapping_detail_min_area=-1.0),
                                eng.grid, "cuda")
        assert_same(res, fresh.process_packed(outs[-1].occupancy_bits))
        assert eng.mapping.backend == "host" and res.num_merged >= 2
    digests = [(b, {k: _digest(getattr(o, k)) for k in o._fields})
               for o, b in zip(outs, bits)]
    _FULL[path] = steps, replay, digests
    return _FULL[path]


@pytest.mark.parametrize("path", list(FULL_RUNS))
def test_full_size_path_on_card(dev, path):
    """The path at bench.py's size: each step launches each kernel as
    :data:`EXPECTED` says and equals its replay with the plain twins from
    the same state; capacities hold and outputs are well formed; the
    path's own checks (:func:`_full_run`: frame kinds, occupied cells, the
    lidar pair over every link step, sparse == packed mapping)."""
    steps, replay, _ = _full_run(path)
    assert steps == [EXPECTED[path]] * FULL_RUNS[path][2]
    assert replay == [[]] * FULL_RUNS[path][2]


# pairs of full-size runs equal frame by frame: (run, run, fields to skip)
FULL_PAIRS = {
    "link_pipelined_vs_sync": ("link", "link_sync", ()),
    "publish_pipelined_vs_sync": ("publish", "publish_sync", ()),
    "hetero_pipelined_vs_sync": ("hetero", "hetero_sync", ()),
    # mode "rle" reports its level-1 runs, "packed" 0
    "publish_packed_vs_rle": ("publish_packed", "publish",
                              ("vox_partials_count",)),
}


@pytest.mark.parametrize("pair", list(FULL_PAIRS))
def test_full_size_runs_agree_on_card(dev, pair):
    """Pipelined == synchronous, and "packed" == rle, at bench.py's size:
    the same frame kinds and every output equal."""
    a, b, skip = FULL_PAIRS[pair]
    da, db = _full_run(a)[2], _full_run(b)[2]
    assert len(da) == len(db)
    for f, ((bits_a, x), (bits_b, y)) in enumerate(zip(da, db)):
        assert bits_a == bits_b, f
        assert {k: v for k, v in x.items() if k not in skip} == \
            {k: v for k, v in y.items() if k not in skip}, f


@pytest.fixture(scope="module")
def tum_hard(dev, tmp_path_factory):
    """The hard synthetic TUM sequence (640x480, 150 frames, one closing
    orbit), rendered by the port's writer on the host."""
    from ros_gpu_depthmap_fusion_tpu_torch.pipeline import tum_runner
    root = str(tmp_path_factory.mktemp("tum_hard"))
    tum_runner.write_hard_synthetic_tum_sequence(root)
    return root


@pytest.mark.parametrize("poses", ["slam", "groundtruth"])
def test_tum_runner_on_card(dev, tum_hard, monkeypatch, poses):
    """``run_tum_sequence`` on the card on the hard sequence. SLAM poses
    (BA every 8 keyframes, loop closure): 150 frames, ATE below 10 cm, a
    loop-closed ATE, BA run, occupied cells. Groundtruth poses, 20 frames:
    every step equal to its plain-twin replay, ATE 0. Launches a frame as
    :data:`EXPECTED` (``tum``, ``tum_gt``)."""
    from ros_gpu_depthmap_fusion_tpu_torch.pipeline import engine as engmod
    from ros_gpu_depthmap_fusion_tpu_torch.pipeline import tum_runner
    from ros_gpu_depthmap_fusion_tpu_torch.slam import frontend
    kmods = kernel_modules()
    for m in kmods.values():
        m.launches = 0
    if poses == "slam":
        windows = []
        solve = frontend.solve_window
        monkeypatch.setattr(frontend, "solve_window", lambda p, **kw: (
            windows.append(p), solve(p, **kw))[1])
        res = tum_runner.run_tum_sequence(
            tum_hard, pose_source="slam", ba_every=8, loop_close=True,
            device="cuda")
        assert res.frames == 150 and windows
        assert res.ate_rmse_m is not None and res.ate_rmse_m < 0.10
        assert res.ate_rmse_loop_closed_m is not None
        path = "tum"
    else:
        replay = []
        step = engmod.FusionEngine.step

        def checked(self, inp, depth_bits=None):
            state = self.state
            out = step(self, inp, depth_bits)
            _, ref = engmod.fusion_step(
                state, inp, depth_bits, cfg=self.cfg, grid=self.grid,
                output_capacity=self.output_capacity, plain=True)
            replay.append([k for k in ref._fields if not torch.equal(
                getattr(out, k), getattr(ref, k))])
            return out
        monkeypatch.setattr(engmod.FusionEngine, "step", checked)
        res = tum_runner.run_tum_sequence(
            tum_hard, pose_source="groundtruth", max_frames=20,
            device="cuda")
        assert res.frames == 20 and replay == [[]] * 20
        assert res.ate_rmse_m <= 1e-6
        path = "tum_gt"
    assert res.occupied_cells > 0
    assert {n: m.launches for n, m in kmods.items()} == {
        n: c * res.frames for n, c in EXPECTED[path].items()}


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


def _rot_err(a, b):
    """Largest rotation angle (rad) between the [N, 3, 3] rotations of two
    pose stacks, from the skew part of a^T b."""
    rel = np.swapaxes(a[:, :3, :3], 1, 2).astype(np.float64) @ b[:, :3, :3]
    sk = rel - np.swapaxes(rel, 1, 2)
    return float(np.linalg.norm(np.stack([sk[:, 2, 1], sk[:, 0, 2],
                                          sk[:, 1, 0]], -1), axis=-1).max()
                 / 2)


def ba_agree(a, b, tie=1e-5):
    """Two runs of the same BA iterations, each (poses, chi2 before each
    step, each step's candidate chi2) on any device. A step whose
    candidate changes chi2 by at most ``tie`` relative is a rounding tie:
    its accept decision rests on float32 summation order, which the card's
    atomic scatter-adds leave open, and a flat direction can move poses by
    more than 1e-4 for no chi2 (seen on the hard synthetic: 1.7e-4 m at a
    1e-7 change). So: every step outside a tie takes the same decision in
    both runs; with every decision equal the poses agree within 1e-4 m and
    1e-4 rad; where a tie went the other way, the final chi2 agree within
    ``tie``. Returns both runs' accept decisions."""
    (pc, cc, kc), (ph, ch, kh) = [
        (p.cpu().numpy(), c.cpu().double(), k.cpu().double())
        for p, c, k in (a, b)]
    acc_c, acc_h = (kc <= cc).tolist(), (kh <= ch).tolist()
    ties = [bool(abs(a - b) <= tie * b) or bool(abs(x - y) <= tie * y)
            for a, b, x, y in zip(kc.tolist(), cc.tolist(), kh.tolist(),
                                  ch.tolist())]
    assert not any(a != b and not t for a, b, t in zip(acc_c, acc_h, ties)), \
        (acc_c, acc_h, ties)
    if acc_c == acc_h:
        assert float(np.abs(pc[:, :3, 3] - ph[:, :3, 3]).max()) <= 1e-4
        assert _rot_err(pc, ph) <= 1e-4
    else:
        final = [float(k[-1] if a[-1] else c[-1]) for k, c, a in
                 ((kc, cc, acc_c), (kh, ch, acc_h))]
        assert abs(final[0] - final[1]) <= tie * final[1], final
    return acc_c, acc_h


def test_slam_solve_window_on_card_matches_cpu(dev):
    """4 iterations on the same window: the same accept decisions outside
    rounding ties, poses within 1e-4 m and 1e-4 rad when every decision
    agrees, the same final chi2 when a tie went the other way (the card's
    scatter-adds are atomics in no fixed order; :func:`ba_agree` says why
    a tie can move poses further)."""
    from ros_gpu_depthmap_fusion_tpu_torch.slam import ba
    _, prob = _slam_window(dev)
    res = [ba._iterate(w, 4, 1e-4)
           for w in (prob, ba.BAProblem(*(t.cpu() for t in prob)))]
    accepts = ba_agree(*[(p, c, k) for p, _, c, k in res])
    assert accepts[1][0]                  # the first step improves chi2
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


def _sharded_setup(full):
    """(configuration, frames, stage(engine, f) -> stamp) of the sharded
    engine's runs: at full size the publish configuration at "packed" on
    the bench scene, 8 frames; else the small rig, 3 frames."""
    if full:
        sc = scene()
        return (config(voxel_mean_mode="packed"), 8,
                lambda eng, f: stage(eng, sc, f))
    frames = _sharded_frames()

    def stage_small(eng, f):
        depth, intr, tfs, arc = frames[f]
        for i in range(depth.shape[0]):
            eng.add_depthmap(i, depth[i], intr, tfs[i], tfs[i])
        eng.add_point_sequence(arc, sec=5, nsec=int(f * 33e6),
                               tf_move=np.eye(4, dtype=np.float32))
        return 5.0 + f / 30.0
    return _sharded_cfg(), len(frames), stage_small


def _view_digests(occ, raw, fused):
    """Digests of a frame's host views: the occupancy, the raw rows sorted
    by their bits (their order follows the stream shards), the fused
    rows."""
    raw = np.ascontiguousarray(raw)
    return (_digest(occ), _digest(raw[np.lexsort(raw.view(np.int32).T)]),
            _digest(fused))


def _shard_window(window, n_shards):
    """A BA window (numpy poses, landmarks, obs_pose, obs_lm, obs_pt,
    obs_valid) sharded landmark-major over ``n_shards``: the landmarks
    padded with unobserved zeros to a multiple of ``n_shards`` (such a
    landmark's block is the damping alone and its step 0, so the poses'
    system is unchanged), each shard's observations with landmark indices
    local to it, padded invalid. Returns (per shard (landmarks, obs_pose,
    obs_lm, obs_pt, obs_valid), landmarks a shard, observations a
    shard)."""
    _, lms, op, ol, pt, valid = window
    lps = -(-len(lms) // n_shards)
    lms = np.pad(lms, ((0, lps * n_shards - len(lms)), (0, 0)))
    members = [np.flatnonzero(ol // lps == d) for d in range(n_shards)]
    ops = max(len(i) for i in members)
    shards = []
    for d, idx in enumerate(members):
        pad = (0, ops - len(idx))
        shards.append((lms[d * lps:(d + 1) * lps], np.pad(op[idx], pad),
                       np.pad(ol[idx] - d * lps, pad),
                       np.pad(pt[idx], (pad, (0, 0))),
                       np.pad(valid[idx], pad)))
    return shards, lps, ops


def _sharded_ba(mesh, window, iterations=8):
    """``build_sharded_ba_step`` on this rank's landmark shard of
    ``window`` over the stream axis, held to ``solve_window``'s iterations
    on the whole window on this rank's card by :func:`ba_agree`, the last
    chi2 within 1e-3 relative (``tests/test_slam.py:175-211``)."""
    from ros_gpu_depthmap_fusion_tpu_torch.parallel import STREAM_AXIS
    from ros_gpu_depthmap_fusion_tpu_torch.slam import ba
    shards, lps, ops = _shard_window(window, mesh.shape[STREAM_AXIS])

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(mesh.device)
    step = ba.build_sharded_ba_step(mesh, STREAM_AXIS, len(window[0]), lps,
                                    ops, iterations=iterations)
    poses, _, chi2s, cands = step(t(window[0]),
                                  *map(t, shards[mesh.stream_id]))
    ref = ba._iterate(ba.BAProblem(*map(t, window)), iterations, 1e-4)
    ba_agree((poses, chi2s, cands), (ref[0], ref[2], ref[3]))
    last = float(ref[2][-1])
    assert abs(float(chi2s[-1]) - last) <= 1e-3 * last


def _sharded_card_rank(rank, shape, depth, cards, full, window):
    """One rank of the sharded engine (:func:`_sharded_setup`) on a
    ``shape`` mesh, rank r on ``cuda:r % cards``, at ``pipeline_depth``
    ``depth``, with mapping on: each frame's host-view digests (the bits
    equal to occupancy > 0), the launches of each kernel, and
    ``segment_and_track`` of the last frame; then the sharded BA on
    ``window`` (:func:`_sharded_ba`)."""
    from ros_gpu_depthmap_fusion_tpu_torch.parallel import make_mesh
    from ros_gpu_depthmap_fusion_tpu_torch.parallel.engine import (
        ShardedFusionEngine)
    mesh = make_mesh(*shape, device=torch.device("cuda", rank % cards))
    cfg, frames, stage_frame = _sharded_setup(full)
    eng = ShardedFusionEngine(cfg, mesh, pipeline_depth=depth,
                              enable_mapping=True)
    kmods = kernel_modules()
    for m in kmods.values():
        m.launches = 0
    outs = []
    for f in range(frames):
        out = eng.process(stage_frame(eng, f))
        if out is not None:
            outs.append(out)
    if depth:
        outs.append(eng.flush())
    launches = {n: m.launches for n, m in kmods.items()}
    views = []
    for o in outs:
        occ = eng.occupancy_host(o)
        np.testing.assert_array_equal(
            eng.occupancy_grid_from_bits(o).reshape(-1),
            (occ > 0).astype(np.uint8))
        views.append(_view_digests(occ, eng.raw_points_host(o),
                                   eng.fused_points_host(o)))
    mapped = eng.segment_and_track(outs[-1])
    eng.close()
    _sharded_ba(mesh, window)
    return views, launches, mapped


def _check_sharded(res, device, full, path):
    """Every rank of a world against the single engine on ``device`` over
    the same frames: each frame's host views, ``segment_and_track`` of the
    last, and the launches a frame of :data:`EXPECTED`'s ``path``."""
    from ros_gpu_depthmap_fusion_tpu_torch.pipeline.engine import (
        FusionEngine)
    cfg, frames, stage_frame = _sharded_setup(full)
    single = FusionEngine(cfg, device, enable_mapping=True)
    views = []
    for f in range(frames):
        out = single.process(stage_frame(single, f))
        views.append(_view_digests(
            out.occupancy_u8.cpu().numpy(),
            out.raw_points[:int(out.raw_count)].cpu().numpy(),
            out.fused_points[:int(out.fused_count)].cpu().numpy()))
    mapped = single.segment_and_track(out)
    single.close()
    assert int(out.fused_count) > 0
    for r, (r_views, launches, r_mapped) in enumerate(res):
        assert r_views == views, r
        assert launches == {n: c * frames for n, c in EXPECTED[path].items()}
        assert_same(r_mapped, mapped, f"rank {r} segment_and_track")


@pytest.fixture(scope="module")
def tum_window(dev, tmp_path_factory):
    """The first BA window of the SLAM run on the hard sequence
    (:func:`test_tum_runner_on_card`'s), as numpy: the sequence's first
    24 frames, rendered at its 150-frame orbit rate (so the same frames),
    through ``run_tum_sequence``'s SLAM poses on the card."""
    from ros_gpu_depthmap_fusion_tpu_torch.pipeline import tum_runner
    from ros_gpu_depthmap_fusion_tpu_torch.slam import frontend
    root = str(tmp_path_factory.mktemp("tum_window"))
    tum_runner.write_hard_synthetic_tum_sequence(root, n_frames=24,
                                                 orbit_frames=150)
    windows, solve = [], frontend.solve_window
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(frontend, "solve_window", lambda p, **kw: (
            windows.append(p), solve(p, **kw))[1])
        tum_runner.run_tum_sequence(root, pose_source="slam", ba_every=8,
                                    device="cuda")
    assert windows, "no BA window in 24 frames"
    return tuple(t.cpu().numpy() for t in windows[0])


def _prepare_ranks():
    """The kernels and the native library built before any rank starts."""
    from ros_gpu_depthmap_fusion_tpu_torch.ops.kernels import _build
    from ros_gpu_depthmap_fusion_tpu_torch.utils import native
    _build.build_info()
    native.require()


@pytest.mark.parametrize("backend,shape,depth", [
    ("nccl", (1, 1), 0), ("nccl", (1, 1), 1), ("gloo", (2, 2), 0)])
def test_sharded_engine_on_card_equals_cpu_single(dev, tmp_path, tum_window,
                                                  backend, shape, depth):
    """The sharded engine on the card (one rank on NCCL, synchronous and
    pipelined; four ranks sharing the card on gloo) equal frame by frame to
    the single engine on the CPU, ``segment_and_track`` too, each rank
    launching segreduce once, flying_pixels once and compact four times a
    frame; the sharded BA on the hard sequence's first BA window held to
    ``solve_window``."""
    from ros_gpu_depthmap_fusion_tpu_torch.parallel import spawn
    _prepare_ranks()
    res = spawn(_sharded_card_rank, shape[0] * shape[1], backend,
                init_method=f"file://{tmp_path / 'store'}", timeout=60,
                join_timeout=240, args=(shape, depth, 1, False, tum_window))
    _check_sharded(res, "cpu", False, f"sharded_{shape[0]}x{shape[1]}"
                   + ("_pipelined" if depth else ""))


@pytest.mark.parametrize("shape", [(2, 2), (4, 1)])
def test_sharded_nccl_on_four_cards_equals_single(dev, tmp_path, monkeypatch,
                                                  tum_window, shape):
    """Four ranks over NCCL, one a card, meshes stream 2 x space 2 and
    stream 4 x space 1, at bench.py's size (the publish configuration at
    "packed", 8 frames of the bench scene): every rank's frames and
    ``segment_and_track`` equal to the single engine's on ``cuda:0``,
    launches a frame as :data:`EXPECTED`, and the sharded BA on the hard
    sequence's first BA window held to ``solve_window`` on each rank's
    card."""
    from ros_gpu_depthmap_fusion_tpu_torch.parallel import spawn
    if torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA devices")
    # one host: NCCL's bootstrap on the loopback
    monkeypatch.setenv("NCCL_SOCKET_IFNAME", "lo")
    _prepare_ranks()
    res = spawn(_sharded_card_rank, 4, "nccl",
                init_method=f"file://{tmp_path / 'store'}", timeout=120,
                join_timeout=400, args=(shape, 0, 4, True, tum_window))
    _check_sharded(res, dev, True, f"sharded_{shape[0]}x{shape[1]}")


# The lidar stages' edge cases (state/rollbuffer.py advance_and_gather):
# name -> (point capacity, sequence capacity, staged points, staged
# sequence records, filter size, rows gathered, frames); a frame is (its
# sequences as (points, stamp s), now s), with the window [now - span,
# now], LIDAR_SPAN s wide
LIDAR_SPAN = 0.25
LIDAR_CASES = {
    # no lidar (the launch-file presets): an empty batch on an empty buffer
    "empty": (64, 8, 32, 1, 1, 64,
              [([], 10.0 + 0.1 * f) for f in range(4)]),
    # stamps behind the buffer's last, clamped forward
    "late_stamp": (256, 16, 64, 4, 2, 128, [
        ([(9, 10.0), (12, 10.01)], 10.0),
        ([(11, 10.1)], 10.1),
        ([(9, 10.2), (5, 10.21)], 10.2),
        ([(9, 9.85), (12, 10.3)], 10.3),
        ([(7, 10.2)], 10.4),
        ([(6, 10.5), (6, 10.5)], 10.5)]),
    # a sequence cut by the point capacity drops whole, with the ones after
    "point_overflow": (40, 16, 48, 4, 1, 40, [
        ([(12, 10.0), (12, 10.0)], 10.0),
        ([(10, 10.1), (14, 10.1), (5, 10.1)], 10.1),
        ([(3, 10.2)], 10.2),
        ([(20, 10.3), (19, 10.3)], 10.3),
        ([(8, 10.4)], 10.4)]),
    # more sequences than free slots
    "seq_overflow": (512, 6, 64, 4, 1, 512, [
        ([(5, 10.0 + 0.1 * f)] * 4, 10.0 + 0.1 * f) for f in range(5)]),
    # everything expires; a batch stamped before the window expires at once
    "all_expire": (128, 8, 32, 4, 1, 128, [
        ([(10, 10.0), (8, 10.0)], 10.0),
        ([(6, 10.1)], 10.1),
        ([], 15.0),
        ([(5, 14.0), (4, 14.0)], 15.1),
        ([(7, 15.2)], 15.2)]),
    # sequences stamped after now: kept, never selected until now passes
    "empty_window": (128, 8, 32, 4, 1, 128, [
        ([(10, 10.5)], 10.0),
        ([(6, 10.6)], 10.1),
        ([(4, 10.05)], 10.2),
        ([], 10.7),
        ([(3, 10.8)], 10.8)]),
    # a batch that fills both capacities exactly, then one with no room
    "full": (60, 5, 60, 5, 3, 60, [
        ([(12, 10.0)] * 5, 10.0),
        ([(4, 10.1)], 10.1),
        ([(3, 10.2)], 10.2),
        ([(60, 10.3)], 10.3),
        ([(1, 10.4)], 10.4)]),
}


def _stamp(t):
    sec = int(np.floor(t))
    nsec = int(round((t - sec) * 1e9))
    if nsec >= 10 ** 9:
        sec, nsec = sec + 1, nsec - 10 ** 9
    return np.int32(sec), np.int32(nsec)


def lidar_case(name, device, seed=0):
    """Case ``name`` of :data:`LIDAR_CASES` on ``device``: (empty buffer,
    rows gathered, filter size, frames), a frame the keyword arguments of
    ``advance_and_gather`` but the buffer: scan arcs with points on their
    neighbour's view ray (the filter drops them) and one at the origin."""
    from ros_gpu_depthmap_fusion_tpu_torch.core import transforms as tr
    from ros_gpu_depthmap_fusion_tpu_torch.pipeline.engine import (
        SequenceBatch)
    from ros_gpu_depthmap_fusion_tpu_torch.state import rollbuffer as rbm
    p_cap, s_cap, sp, ss, size, cap, frames = LIDAR_CASES[name]
    rng = np.random.default_rng(seed)

    def t(x, dtype):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)

    out = []
    for f, (seqs, now) in enumerate(frames):
        pts = np.zeros((sp, 4), np.float32)
        idx = np.zeros(sp, np.int32)
        sec, nsec, cnt = (np.zeros(ss, np.int32) for _ in range(3))
        tfs = np.tile(np.eye(4, dtype=np.float32), (ss, 1, 1))
        off = 0
        for i, (k, stamp) in enumerate(seqs):
            ang = np.linspace(0.0, 1.5, k) + rng.uniform(0, 6)
            r = rng.uniform(2, 8) + 0.05 * rng.standard_normal(k)
            xyz = np.stack([r * np.cos(ang), r * np.sin(ang),
                            0.3 * rng.standard_normal(k)], -1)
            xyz[2::7] = xyz[1:-1:7][:len(xyz[2::7])] * 1.05
            if k > 4:
                xyz[4] = 0.0
            pts[off:off + k, :3] = xyz
            pts[off:off + k, 3] = 1.0
            idx[off:off + k] = i
            sec[i], nsec[i] = _stamp(stamp)
            cnt[i] = k
            tfs[i] = tr.make_se3(tr.rot_z(rng.uniform(-1, 1)),
                                 rng.uniform(-2, 2, 3))
            off += k
        i32, f32 = torch.int32, torch.float32
        out.append(dict(
            seq_batch=SequenceBatch(
                points=t(pts, f32), seq_idx=t(idx, i32), seq_sec=t(sec, i32),
                seq_nsec=t(nsec, i32), seq_count=t(cnt, i32),
                seq_tf_move=t(tfs, f32), num_points=t(off, i32),
                num_seqs=t(len(seqs), i32)),
            ps_threshold=t(0.05, f32),
            roll_min=tuple(t(v, i32) for v in _stamp(now - LIDAR_SPAN)),
            now=tuple(t(v, i32) for v in _stamp(now)),
            tf_world_move=t(tr.make_se3(tr.rot_z(0.3 * f),
                                        (1.0, -2.0, 0.5)), f32),
            tf_crop_move=t(tr.make_se3(tr.rot_x(0.1), (0.0, 0.2, -0.1)),
                           f32)))
    return rbm.make_rollbuffer(p_cap, s_cap, device), cap, size, out


@pytest.mark.parametrize("name", list(LIDAR_CASES))
def test_lidar_stages_kernels_equal_twin(dev, name):
    """The lidar kernel pair against its plain twin on the card, frame by
    frame from the kernels' own state: the new buffer, the gathered
    world and crop rows and validity, and the selection, bit for bit; two
    launches a step."""
    from ros_gpu_depthmap_fusion_tpu_torch.state import rollbuffer as rbm
    rb, cap, size, frames = lidar_case(name, dev)
    for f, kw in enumerate(frames):
        n = rbm.launches
        got = rbm.advance_and_gather(rb, filter_size=size, capacity=cap,
                                     **kw)
        assert rbm.launches - n == 2
        ref = rbm.advance_and_gather(rb, filter_size=size, capacity=cap,
                                     plain=True, **kw)
        assert rbm.launches - n == 2
        for path, a, b in (("rb", got[0], ref[0]), ("gathered", got[1],
                                                    ref[1]),
                           ("selection", got[2], ref[2])):
            for k, (x, y) in enumerate(zip(a, b)):
                assert x.dtype == y.dtype and x.shape == y.shape, (f, path, k)
                assert torch.equal(x, y), (name, f, path, k)
        rb = got[0]


def check_lidar_refusals(dev):
    """On CUDA tensors ``advance_and_gather`` raises, before any launch,
    for a wrong dtype, a wrong shape, a batch on another device or a
    capacity above the buffer's."""
    from ros_gpu_depthmap_fusion_tpu_torch.state import rollbuffer as rbm
    rb, cap, size, frames = lidar_case("late_stamp", dev)
    kw = dict(frames[0], filter_size=size, capacity=cap)
    sb = kw["seq_batch"]
    n = rbm.launches
    for bad_rb, bad_kw in (
            (rb._replace(points=rb.points.double()), {}),
            (rb._replace(seq_tf_move=rb.seq_tf_move.reshape(-1, 16)), {}),
            (rb._replace(mask=rb.mask.to(torch.uint8)), {}),
            (rb, dict(seq_batch=sb._replace(points=sb.points.cpu()))),
            (rb, dict(seq_batch=sb._replace(seq_idx=sb.seq_idx.long()))),
            (rb, dict(tf_world_move=kw["tf_world_move"][:3])),
            (rb, dict(capacity=rb.point_capacity + 1))):
        with pytest.raises(ValueError, match="advance_and_gather"):
            rbm.advance_and_gather(bad_rb, **dict(kw, **bad_kw))
    assert rbm.launches == n


def test_lidar_stages_kernels_refuse_bad_inputs(dev):
    check_lidar_refusals(dev)
