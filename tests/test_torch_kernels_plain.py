"""The plain PyTorch twins of the port's three CUDA kernels against the
JAX package's Pallas kernels (interpret mode on the CPU, as the JAX
package's own tests run them) and the plain JAX formulation. A CPU tensor
passed to a kernel wrapper runs the twin, so these are also the wrappers'
CPU paths."""

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
from ros_gpu_depthmap_fusion_tpu.ops.unproject import unproject_depthmaps

from ros_gpu_depthmap_fusion_tpu_torch.ops.kernels.compact import (
    compact_plain, compact_rows)
from ros_gpu_depthmap_fusion_tpu_torch.ops.kernels.flying_pixels import (
    filter_flying_pixels as t_filter, filter_flying_pixels_plain)
from ros_gpu_depthmap_fusion_tpu_torch.ops.kernels.segreduce import (
    segreduce, segreduce_plain)


def T(a):
    return torch.from_numpy(np.array(a))


def _keys(rng, n, sentinel):
    keys = []
    while len(keys) < n:
        k = sentinel if rng.random() < 0.15 else int(rng.integers(0, 1000))
        keys += [k] * (1 + rng.geometric(0.08))
    return np.array(keys[:n], np.int32)


@pytest.mark.parametrize("n,cap,force_break", [
    (5000, 4096, 0), (2048, 512, 0), (100, 256, 0), (5000, 4096, 128),
    (3000, 300, 128)])
def test_segreduce_plain_matches_pallas(n, cap, force_break):
    """Runs, sentinels, forced breaks and capacity overflow (true count
    past the capacity) — exact."""
    rng = np.random.default_rng(n + cap + force_break)
    sent = 1 << 22
    keys = _keys(rng, n, sent)
    vals = rng.integers(0, 100, (n, 4)).astype(np.float32)
    ref = rle_reduce_pallas(jnp.asarray(keys), jnp.asarray(vals), cap, sent,
                            interpret=True, bn=4096, force_break=force_break)
    got = segreduce_plain(T(keys), T(vals), cap, sent, force_break)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    # the wrapper takes the twin for a CPU tensor
    for g, w in zip(got, segreduce(T(keys), T(vals), cap, sent,
                                   force_break)):
        assert torch.equal(g, w)


def test_segreduce_overflow_clamps():
    keys = np.repeat(np.arange(100, dtype=np.int32), 3)
    ko, so, cnt, true_cnt = segreduce_plain(
        T(keys), torch.ones((300, 1)), 16, 1 << 20)
    assert int(cnt) == 16 and int(true_cnt) == 100
    np.testing.assert_array_equal(ko.numpy(), np.arange(16))
    np.testing.assert_array_equal(so.numpy()[:, 0], np.full(16, 3.0))


def _scene(h, w, c=2, seed=0):
    rng = np.random.default_rng(seed)
    depth = (1500 + 40 * np.sin(np.arange(w) / 5.0)[None, None, :]
             + 30 * np.cos(np.arange(h) / 4.0)[None, :, None]
             + 5 * rng.standard_normal((c, h, w))).astype(np.uint16)
    depth[rng.random((c, h, w)) < 0.05] = 0
    # a step edge: flying pixels between two depth layers
    depth[:, :, w // 2:] = np.where(depth[:, :, w // 2:] > 0,
                                    depth[:, :, w // 2:] + 900, 0)
    eye = np.tile(np.eye(4, dtype=np.float32), (c, 1, 1))
    intr = np.tile(np.array([[60.0, 60.0, (w - 1) / 2, (h - 1) / 2]],
                            np.float32), (c, 1))
    pc, _, _, m = unproject_depthmaps(jnp.asarray(depth), jnp.asarray(intr),
                                      jnp.asarray(eye), jnp.asarray(eye),
                                      0.001)
    return np.asarray(pc), np.asarray(m)


def _cos_margin(pc, m, h, w, size, rot45, thr):
    """Per pixel, the smallest |cos(view) - threshold| over the rings it
    is tested on, in float64 (inf where no ring reaches the cos test)."""
    c = pc.shape[0]
    p = pc.reshape(c, h, w, 4)[..., :3].astype(np.float64)
    mm = m.reshape(c, h, w)
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    view = -p / np.maximum(np.linalg.norm(p, axis=-1, keepdims=True), 1e-30)
    margin = np.full((c, h, w), np.inf)
    for d in range(1, size + 1):
        for rot in ([False, True] if rot45 else [False]):
            offs = ([(-d, -d), (d, d), (d, -d), (-d, d)] if rot
                    else [(-d, 0), (d, 0), (0, -d), (0, d)])
            ok = ((xx - d >= 0) & (xx + d <= w - 1) & (yy - d >= 0)
                  & (yy + d <= h - 1))[None] & mm
            sh = []
            for dy, dx in offs:
                ok = ok & np.roll(mm, (-dy, -dx), axis=(1, 2))
                sh.append(np.roll(p, (-dy, -dx), axis=(1, 2)))
            n = np.cross(sh[1] - sh[0], sh[3] - sh[2])
            n = n / np.maximum(np.linalg.norm(n, axis=-1, keepdims=True),
                               1e-30)
            cos = np.sum(n * view, axis=-1)
            margin = np.where(ok, np.minimum(margin, np.abs(cos - thr)),
                              margin)
    return margin.reshape(c, h * w)


@pytest.mark.parametrize("size,rot45", [(1, False), (1, True), (2, False),
                                        (2, True)])
def test_flying_pixels_plain_matches_jax(size, rot45):
    """Equal to the JAX package's plain stencil run op by op. Against the
    Pallas kernel (and the jitted stencil, where XLA:CPU contracts
    multiply-adds) masks may differ only on pixels whose cos(view) lies
    within 1e-5 of the threshold: those compute the normal with another
    rounding (rsqrt; fused multiply-adds)."""
    h, w = 40, 48
    pc, m = _scene(h, w, seed=size)
    thr, maxd = 0.4, 10.0
    got = filter_flying_pixels_plain(T(pc), T(m), h, w, size, thr, rot45,
                                     maxd).numpy()
    assert torch.equal(t_filter(T(pc), T(m), h, w, size, thr, rot45, maxd),
                       torch.from_numpy(got))
    assert 0 < got.sum() < m.sum()
    with jax.disable_jit():
        ref = np.asarray(filter_flying_pixels(
            jnp.asarray(pc), jnp.asarray(m), h, w, size, thr, rot45, maxd))
    np.testing.assert_array_equal(got, ref)
    band = _cos_margin(pc, m, h, w, size, rot45, thr) < 1e-5
    for other in (
            filter_flying_pixels(jnp.asarray(pc), jnp.asarray(m), h, w, size,
                                 thr, rot45, maxd),
            filter_flying_pixels_pallas(jnp.asarray(pc), jnp.asarray(m), h,
                                        w, size, thr, rot45, maxd,
                                        interpret=True)):
        diff = got != np.asarray(other)
        assert not (diff & ~band).any()


def test_flying_pixels_range_gate():
    h, w = 16, 16
    pc, m = _scene(h, w)
    near = filter_flying_pixels_plain(T(pc), T(m), h, w, 1, -2.0, False,
                                      torch.tensor(1.0))
    far = filter_flying_pixels_plain(T(pc), T(m), h, w, 1, -2.0, False, 10.0)
    assert not near.any() and far.any()


@pytest.mark.parametrize("n,cap,p", [(5000, 4096, 0.3), (2048, 2048, 1.0),
                                     (300, 512, 0.0), (6000, 1024, 0.5)])
def test_compact_plain_matches_pallas(n, cap, p):
    rng = np.random.default_rng(n + cap)
    vals = rng.standard_normal((n, 4)).astype(np.float32)
    mask = rng.random(n) < p
    ref, rcnt = compact_rows_pallas(jnp.asarray(vals), jnp.asarray(mask),
                                    cap, interpret=True)
    out, cnt, true = compact_plain(T(vals), T(mask), cap)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    assert int(cnt) == int(rcnt) and int(true) == int(mask.sum())
    words = T(vals).view(torch.int32)
    wout, wcnt, _ = compact_rows(words, T(mask), cap)
    assert torch.equal(wout.view(torch.float32), out)
    assert int(wcnt) == int(cnt)


@pytest.mark.parametrize("wrapper,args", [
    (segreduce, (torch.zeros(4, dtype=torch.int32), torch.zeros((4, 1)),
                 4, 9)),
    (compact_rows, (torch.zeros((4, 2), dtype=torch.int32),
                    torch.ones(4, dtype=torch.bool), 4)),
    (t_filter, (torch.zeros((1, 4, 4)), torch.ones((1, 4), dtype=torch.bool),
                2, 2, 1, 0.5, True))])
def test_wrapper_refuses_other_devices(wrapper, args):
    """Only a CPU tensor takes the twin; any other non-CUDA device raises
    (there is no silent fallback)."""
    meta = tuple(a.to("meta") if isinstance(a, torch.Tensor) else a
                 for a in args)
    with pytest.raises(ValueError, match="unsupported device"):
        wrapper(*meta)
