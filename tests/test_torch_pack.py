"""The port's ``ops/pack.py`` against the JAX package's: the six bit-cast
helpers on the same words, bit-equal (values compared; the port carries
u32 in int64 and u16 in int32)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ros_gpu_depthmap_fusion_tpu.ops import pack as jpack
from ros_gpu_depthmap_fusion_tpu_torch.ops import pack as tpack

RNG = np.random.default_rng(17)
U32 = np.concatenate([RNG.integers(0, 1 << 32, 997, dtype=np.uint64),
                      [0, 1, 0xFFFF, 0x10000, 0x7FFFFFFF, 0x80000000,
                       0xFFFFFFFF]]).astype(np.uint32)
U16 = RNG.integers(0, 1 << 16, 1000, dtype=np.uint64).astype(np.uint16)
U8 = RNG.integers(0, 256, 1000, dtype=np.uint64).astype(np.uint8)


def _as_int(a):
    """The port's carrier of an unsigned numpy array."""
    return torch.from_numpy(a.astype(np.int64))


@pytest.mark.parametrize("name,data", [
    ("unpack_depth_pairs", U32), ("pack_depth_pairs", U16),
    ("uints_to_chars", U32), ("chars_to_uints", U8),
    ("uints_to_words", U32), ("words_to_uints", U16)])
def test_pack_helper_matches_jax(name, data):
    want = np.asarray(getattr(jpack, name)(jnp.asarray(data)))
    got = getattr(tpack, name)(
        torch.from_numpy(data) if data.dtype == np.uint8 else _as_int(data))
    np.testing.assert_array_equal(got.numpy().astype(np.int64),
                                  want.astype(np.int64))


def test_pack_helpers_invert_and_take_int32_bit_patterns():
    words = _as_int(U32)
    np.testing.assert_array_equal(
        tpack.pack_depth_pairs(tpack.unpack_depth_pairs(words)).numpy(),
        U32.astype(np.int64))
    np.testing.assert_array_equal(
        tpack.chars_to_uints(tpack.uints_to_chars(words)).numpy(),
        U32.astype(np.int64))
    np.testing.assert_array_equal(
        tpack.words_to_uints(tpack.uints_to_words(words)).numpy(),
        U32.astype(np.int64))
    # an int32 tensor holding the same bits reads as the same words
    bits = torch.from_numpy(U32.view(np.int32))
    np.testing.assert_array_equal(tpack.uints_to_chars(bits).numpy(),
                                  tpack.uints_to_chars(words).numpy())
