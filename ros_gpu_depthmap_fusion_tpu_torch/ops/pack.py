"""Bit-packing layout conversions (the reference's SSBO layout converters).

- depth pairs: two u16 depths a u32 word, the even element in the low half
  (``shader/convert_depthmap_to_points.glsl:100-101``);
- ``uints_to_chars`` / ``chars_to_uints``: u32 <-> 4 x u8, little-endian;
- ``uints_to_words`` / ``words_to_uints``: u32 <-> 2 x u16
  (``gpu_depthmap_fusion.cpp:2041-2046``).

Counterparts of the JAX package's ``ops/pack.py``. Torch has no unsigned
32- or 16-bit arithmetic on every device, so a u32 word is carried in
int64 masked to 32 bits and a u16 value in int32; u8 is ``torch.uint8``.
The inputs may be any integer dtype holding those values (an int32 tensor
holding u32 bit patterns is read as its unsigned value).
"""

from __future__ import annotations

import torch

_M32 = 0xFFFFFFFF


def _u32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.int64) & _M32


def unpack_depth_pairs(pairs_u32: torch.Tensor) -> torch.Tensor:
    """``[N]`` u32 words -> ``[2N]`` u16 depths (int32); element ``i``
    comes from bits ``16 * (i % 2)`` up of word ``i // 2``."""
    v = _u32(pairs_u32)
    return torch.stack([v & 0xFFFF, v >> 16], dim=-1).reshape(-1) \
        .to(torch.int32)


def pack_depth_pairs(depth_u16: torch.Tensor) -> torch.Tensor:
    """``[2N]`` u16 depths -> ``[N]`` u32 pair words (int64); the inverse
    of :func:`unpack_depth_pairs`."""
    d = depth_u16.reshape(-1, 2).to(torch.int64) & 0xFFFF
    return d[:, 0] | (d[:, 1] << 16)


def uints_to_chars(values_u32: torch.Tensor) -> torch.Tensor:
    """``[N]`` u32 -> ``[4N]`` u8, little-endian byte order."""
    v = _u32(values_u32)
    return torch.stack([(v >> (8 * i)) & 0xFF for i in range(4)], dim=-1) \
        .reshape(-1).to(torch.uint8)


def chars_to_uints(values_u8: torch.Tensor) -> torch.Tensor:
    """``[4N]`` u8 -> ``[N]`` u32 (int64); the inverse of
    :func:`uints_to_chars`."""
    b = values_u8.reshape(-1, 4).to(torch.int64) & 0xFF
    return b[:, 0] | (b[:, 1] << 8) | (b[:, 2] << 16) | (b[:, 3] << 24)


def uints_to_words(values_u32: torch.Tensor) -> torch.Tensor:
    """``[N]`` u32 -> ``[2N]`` u16 (int32), low half first."""
    return unpack_depth_pairs(values_u32)


def words_to_uints(values_u16: torch.Tensor) -> torch.Tensor:
    """``[2N]`` u16 -> ``[N]`` u32 (int64); the inverse of
    :func:`uints_to_words`."""
    return pack_depth_pairs(values_u16)
