"""The port's depth-link decoders against the JAX package's, on frames
coded by the numpy reference encoders (every width of ``B_BUCKETS``,
classic P-frames at several widths, p4 P-frames at several budgets) and
by the native encoders. All decoders are integer code: equal means equal
bit for bit."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ros_gpu_depthmap_fusion_tpu.ops import depth_codec as JDC

from ros_gpu_depthmap_fusion_tpu_torch.ops import depth_codec as TDC
from ros_gpu_depthmap_fusion_tpu_torch.utils import native

CAP = 4096


@pytest.fixture
def native_lib():
    if not native.available():
        pytest.skip("native library not built")


def _padded(a, cap):
    out = np.zeros(cap, np.uint32)
    out[:len(a)] = a
    return out


def _pair(enc, cap=CAP):
    """(JAX EncodedDepth, port EncodedDepth) of one encoder output."""
    n = int(enc.get("exc_count", len(enc["exc_idx"])))
    ei = _padded(np.asarray(enc["exc_idx"])[:n], cap)
    ez = _padded(np.asarray(enc["exc_zz"])[:n], cap)
    words = np.ascontiguousarray(enc["words"], np.uint32)
    rf = np.asarray(enc["row_first"], np.uint16)
    j = JDC.EncodedDepth(jnp.asarray(words), jnp.asarray(rf),
                         jnp.asarray(ei.view(np.int32)),
                         jnp.asarray(ez.view(np.int32)), jnp.int32(n))
    t = TDC.EncodedDepth(torch.from_numpy(words.view(np.int32)),
                         torch.from_numpy(rf.astype(np.int32)),
                         torch.from_numpy(ei.view(np.int32)),
                         torch.from_numpy(ez.view(np.int32)),
                         torch.tensor(n, dtype=torch.int32))
    return j, t


def _pair_p4(enc, cap=CAP):
    n = int(enc.get("exc_count", len(enc["exc_idx"])))
    ei = _padded(np.asarray(enc["exc_idx"])[:n], cap).view(np.int32)
    ez = _padded(np.asarray(enc["exc_zz"])[:n], cap).view(np.int32)
    flags = np.ascontiguousarray(enc["flags"], np.uint32).view(np.int32)
    lits = np.asarray(enc["lits"])
    if lits.dtype == np.uint8:   # native: bytes -> LE words
        lits = lits.reshape(flags.shape[0], -1).view("<u4")
    lits = np.ascontiguousarray(lits, np.uint32).view(np.int32)
    j = JDC.EncodedDepthP4(jnp.asarray(flags), jnp.asarray(lits),
                           jnp.asarray(ei), jnp.asarray(ez), jnp.int32(n))
    t = TDC.EncodedDepthP4(torch.from_numpy(flags), torch.from_numpy(lits),
                           torch.from_numpy(ei), torch.from_numpy(ez),
                           torch.tensor(n, dtype=torch.int32))
    return j, t


def _eq(t, j, what):
    np.testing.assert_array_equal(t.numpy(), np.asarray(j).astype(np.int64),
                                  err_msg=what)


def _scene(rng, c=2, h=6, w=37, noise=3.0, holes=0.05):
    u = np.arange(w)[None, None, :]
    d = (2000 + 30 * np.sin(u / 5.0) + noise * rng.standard_normal((c, h, w)))
    d = d.astype(np.uint16)
    d[rng.random((c, h, w)) < holes] = 0
    d[0, 0, :3] = 0                     # a row starting with holes
    d[-1, -1, :] = 0                    # an all-hole row
    return d


def test_buckets_and_row_words_match_jax():
    assert TDC.B_BUCKETS == JDC.B_BUCKETS
    for b in range(1, 20):
        assert TDC.bucket_bits(b) == JDC.bucket_bits(b)
        for w in (1, 37, 848):
            assert TDC.words_per_row(w, b) == JDC.words_per_row(w, b)


@pytest.mark.parametrize("bits", JDC.B_BUCKETS)
@pytest.mark.parametrize("shift", [0, 3])
def test_decode_depth_every_width(bits, shift):
    """I-frames at every bucket width (odd widths straddle words), with
    exceptions, holes and quantization: depth and series equal JAX's."""
    rng = np.random.default_rng(bits * 10 + shift)
    d = _scene(rng, noise=40.0)
    d[1, 2, 10] = 60000                 # a wide jump -> exception list
    enc, b = TDC.encode_depth_reference(d, 10 ** 6, allowed_bits=(bits,),
                                        quant_shift=shift)
    assert b == bits
    assert len(enc["exc_idx"]) > 0 or bits == 17
    j, t = _pair(enc, cap=d.size)
    jd, jq = JDC.decode_depth(j, 6, 37, bits, shift, return_series=True)
    td, tq = TDC.decode_depth(t, 6, 37, bits, shift, return_series=True)
    _eq(td, jd, "depth")
    _eq(tq, jq, "series")
    _eq(TDC.decode_depth(t, 6, 37, bits, shift), jd, "depth only")
    if shift == 0:
        np.testing.assert_array_equal(td.numpy(), d)


@pytest.mark.parametrize("bits", [2, 3, 6, 17])
def test_decode_depth_temporal(bits):
    rng = np.random.default_rng(bits)
    shift = 2
    d0 = _scene(rng)
    d1 = d0.copy()
    d1[d0 > 0] += rng.integers(0, 30, int((d0 > 0).sum())).astype(np.uint16)
    d1[0, 1, 5] = 0                      # value -> hole
    d1[0, 2, 7] = 2100                   # hole -> value (exception)
    prev = TDC.quantize_reference(d0, shift)
    res = TDC.encode_depth_temporal_reference(
        d1, prev, 10 ** 6, allowed_bits=(bits,), quant_shift=shift)
    assert res is not None and res[1] == bits
    enc, _, cq = res
    j, t = _pair(enc, cap=d1.size)
    jd, jq = JDC.decode_depth_temporal(j, jnp.asarray(prev), 6, 37, bits,
                                       shift)
    td, tq = TDC.decode_depth_temporal(
        t, torch.from_numpy(prev.astype(np.int32)), 6, 37, bits, shift)
    _eq(td, jd, "depth")
    _eq(tq, jq, "curr_q")
    np.testing.assert_array_equal(tq.numpy(), cq)


@pytest.mark.parametrize("budget", [4, 16, 48])
def test_decode_depth_p4(budget):
    """p4 frames; budget 4 spills groups to the exception list."""
    rng = np.random.default_rng(budget)
    shift, hyst = 3, 2
    d = _scene(rng, c=2, h=8, w=41)
    pq = TDC.quantize_reference(d, shift)
    for k in range(3):
        d = d.copy()
        moving = rng.random(d.shape) < 0.2
        d[moving & (d > 0)] += rng.integers(
            10, 120, int((moving & (d > 0)).sum())).astype(np.uint16)
        d[rng.random(d.shape) < 0.02] = 0
        d[(d == 0) & (rng.random(d.shape) < 0.3)] = 2200
        res = TDC.encode_depth_p4_reference(d, pq, budget, 4096, shift,
                                            hyst)
        assert res is not None
        enc, cq = res
        j, t = _pair_p4(enc)
        jd, jq = JDC.decode_depth_p4(j, jnp.asarray(pq), 8, 41, budget,
                                     shift)
        td, tq = TDC.decode_depth_p4(
            t, torch.from_numpy(pq.astype(np.int32)), 8, 41, budget, shift)
        _eq(td, jd, f"depth, frame {k}")
        _eq(tq, jq, f"curr_q, frame {k}")
        np.testing.assert_array_equal(tq.numpy(), cq)
        pq = cq


def test_p4_literal_past_capacity_reads_zero():
    """A flag set past the row's literal capacity reads literal 0, as the
    one-hot product of the JAX decoder gives."""
    rows, w, budget = 1, 40, 4               # 10 groups, 2 literal slots
    flags = np.array([[0b111]], np.uint32).view(np.int32)
    lits = np.array([[0x00210012]], np.uint32).view(np.int32)
    z = np.zeros(8, np.int32)
    pq = np.full((1, rows, w), 100, np.int32)
    j = JDC.EncodedDepthP4(jnp.asarray(flags), jnp.asarray(lits),
                           jnp.asarray(z), jnp.asarray(z), jnp.int32(0))
    t = TDC.EncodedDepthP4(*(torch.from_numpy(a) for a in
                             (flags, lits, z, z)), torch.tensor(0))
    jd, jq = JDC.decode_depth_p4(j, jnp.asarray(pq.astype(np.uint16)), 1,
                                 w, budget)
    td, tq = TDC.decode_depth_p4(t, torch.from_numpy(pq), 1, w, budget)
    _eq(tq, jq, "curr_q")
    assert tq[0, 0, 8:12].tolist() == [100] * 4


def test_exceptions_past_count_are_ignored():
    rng = np.random.default_rng(5)
    d = _scene(rng)
    enc, bits = TDC.encode_depth_reference(d, 10 ** 6, allowed_bits=(3,))
    j, t = _pair(enc, cap=d.size)
    junk = torch.arange(t.exc_idx.shape[0], dtype=torch.int32)
    n = int(t.exc_count)
    t.exc_idx[n:] = junk[n:]
    t.exc_zz[n:] = 7
    _eq(TDC.decode_depth(t, 6, 37, bits), JDC.decode_depth(j, 6, 37, bits),
        "depth")


@pytest.mark.parametrize("shift", [0, 4])
def test_native_encoders_decode_like_jax(native_lib, shift):
    """Frames from the native encoders (I, classic P, p4) at the bench's
    settings, decoded by both packages."""
    rng = np.random.default_rng(shift)
    c, h, w = 2, 16, 52
    u = np.arange(w)[None, :]
    base = 2500 + 200 * np.sin(u / 15.0) + np.zeros((h, 1))
    pattern = rng.normal(0, 6, (c, h, w))
    frames = []
    for k in range(3):
        d = (base + pattern + rng.standard_normal((c, h, w))).astype(
            np.uint16)
        d[:, 4:8, 10 + 3 * k:20 + 3 * k] -= 300    # moving object
        d[rng.random((c, h, w)) < 0.01] = 0
        frames.append(d)
    res = native.depth_encode(frames[0], 8192, quant_shift=shift)
    assert res is not None
    enc, bits = res
    j, t = _pair(enc, cap=8192)
    jd, jq = JDC.decode_depth(j, h, w, bits, shift, return_series=True)
    td, tq = TDC.decode_depth(t, h, w, bits, shift, return_series=True)
    _eq(td, jd, "I depth")
    _eq(tq, jq, "I series")
    prev = np.asarray(jq).astype(np.uint16)
    res = native.depth_encode_temporal(frames[1], prev, 8192,
                                       quant_shift=shift)
    assert res is not None
    enc, pbits, cq = res
    j, t = _pair(enc, cap=8192)
    jd, jq = JDC.decode_depth_temporal(j, jnp.asarray(prev), h, w, pbits,
                                       shift)
    td, tq = TDC.decode_depth_temporal(
        t, torch.from_numpy(prev.astype(np.int32)), h, w, pbits, shift)
    _eq(td, jd, "P depth")
    _eq(tq, jq, "P curr_q")
    np.testing.assert_array_equal(tq.numpy(), cq)
    prev = cq.copy()
    res = native.depth_encode_p4(frames[2], prev, 16, 8192,
                                 quant_shift=shift, hysteresis=2 * bool(shift))
    assert res is not None
    enc, cq = res
    j, t = _pair_p4(enc, cap=8192)
    jd, jq = JDC.decode_depth_p4(j, jnp.asarray(prev), h, w, 16, shift)
    td, tq = TDC.decode_depth_p4(t, torch.from_numpy(prev.astype(np.int32)),
                                 h, w, 16, shift)
    _eq(td, jd, "p4 depth")
    _eq(tq, jq, "p4 curr_q")
    np.testing.assert_array_equal(tq.numpy(), cq)
