"""Kernel 3: stable stream compaction of flagged rows of 32-bit words
(``csrc/compact.cu``).

Counterpart of the JAX package's ``ops/pallas/compact.py:268
compact_rows_pallas``: rows ``[0, count)`` of the output are the flagged
input rows in input order, the rest zero. The port's
:func:`ops.mask_ops.compact_multi` (and so the sparse occupancy output)
runs on it. Rows move as raw words, so int32 and float32 payloads of any
value move bit for bit.
"""

from __future__ import annotations

import ctypes

import torch

#: launches of the CUDA kernel by :func:`compact_rows` in this process
launches = 0

_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p)


def compact_plain(words: torch.Tensor, mask: torch.Tensor, capacity: int):
    """Plain PyTorch twin of :func:`compact_rows` (``nonzero`` and
    index); same contract, any device."""
    idx = torch.nonzero(mask).squeeze(1)[:capacity]
    out = torch.zeros((capacity,) + tuple(words.shape[1:]),
                      dtype=words.dtype, device=words.device)
    out[:idx.shape[0]] = words[idx]
    true_count = mask.sum(dtype=torch.int32)
    return out, torch.clamp_max(true_count, capacity), true_count


def compact_rows(words: torch.Tensor, mask: torch.Tensor, capacity: int):
    """Stable masked row extraction.

    Args:
        words: ``[N, D]`` int32 rows (float32 payloads ride as their bits).
        mask: ``[N]`` bool.
        capacity: static output rows; flagged rows past it are dropped.

    Returns:
        (out ``[capacity, D]`` int32, count int32 0-d clamped to capacity,
        true count int32 0-d).

    A CPU tensor runs :func:`compact_plain`; a CUDA tensor launches the
    kernel (built on first use) or raises.
    """
    if words.device.type == "cpu":
        return compact_plain(words, mask, capacity)
    if words.device.type != "cuda":
        raise ValueError(f"compact_rows: unsupported device {words.device}")
    if words.dtype != torch.int32 or words.ndim != 2 \
            or not words.is_contiguous():
        raise ValueError("compact_rows: words must be a contiguous [N, D] "
                         f"int32 tensor, got {words.dtype} "
                         f"{tuple(words.shape)}")
    n, d = words.shape
    if mask.dtype != torch.bool or mask.shape != (n,) \
            or not mask.is_contiguous() or mask.device != words.device:
        raise ValueError("compact_rows: mask must be a contiguous [N] bool "
                         "tensor on the words' device")
    if d < 1 or capacity < 1 or n * d >= 2 ** 31:
        raise ValueError(f"compact_rows: unsupported D={d}, "
                         f"capacity={capacity}, N={n}")
    from ros_gpu_depthmap_fusion_tpu_torch.ops.kernels import _build
    fn = _build.function("fusion_compact", _ARGTYPES)
    dev = words.device
    out = torch.zeros((capacity, d), dtype=torch.int32, device=dev)
    tiles = max(_build.scan_tiles(n), 1)
    scratch = torch.empty((2, tiles), dtype=torch.int32, device=dev)
    counts = torch.empty((2,), dtype=torch.int32, device=dev)
    p = _build.ptr
    status = fn(p(words), p(mask.view(torch.uint8)), n, d, capacity,
                p(scratch[0]), p(scratch[1]), p(counts), p(out),
                _build.stream_ptr(words))
    _build.check(status, "compact_rows")
    global launches
    launches += 1
    return out, counts[0], counts[1]
