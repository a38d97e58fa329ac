"""The port's CUDA kernels against their plain PyTorch twins on the card,
at edge-case shapes (empty and ragged tiles, sentinels, forced breaks,
capacity overflow, every column count, several rings). They need an
NVIDIA GPU and nvcc and skip elsewhere; on a GPU machine run

    python -m pytest -q -p no:cacheprovider --noconftest tests/test_torch_cuda.py

(``--noconftest``: the suite's conftest configures JAX, which this file
does not use). ``chip_smoke.py`` checks the same kernels at the main
path's shapes.
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


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


@pytest.mark.parametrize("n,d,cap,p", [(0, 5, 16, 0.5), (4097, 5, 4096, 0.3),
                                       (50000, 1, 100, 0.5),
                                       (10000, 8, 20000, 1.0),
                                       (10000, 3, 512, 0.0)])
def test_compact_kernel_equals_twin(dev, n, d, cap, p):
    from ros_gpu_depthmap_fusion_tpu_torch.ops.kernels import compact as m
    rng = np.random.default_rng(n + d)
    words = torch.from_numpy(
        rng.integers(-2 ** 31, 2 ** 31 - 1, (n, d)).astype(np.int32)).to(dev)
    mask = torch.from_numpy(rng.random(n) < p).to(dev)
    got = m.compact_rows(words, mask, cap)
    ref = m.compact_plain(words, mask, cap)
    torch.cuda.synchronize()
    for g, r in zip(got, ref):
        assert torch.equal(g, r)


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
