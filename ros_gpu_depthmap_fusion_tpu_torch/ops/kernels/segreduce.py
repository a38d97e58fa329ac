"""Kernel 1: run-length segmented reduction (``csrc/segreduce.cu``).

For every run of CONSECUTIVE equal keys it emits one compacted row, the
key plus the run's column sums, in stream order. Because it only needs
runs to be consecutive, it reduces the raw raster stream of a depth frame
(level 1, where neighbouring pixels mostly share a voxel cell) as well as
the sorted partials (level 2) of
:func:`ops.voxelize.voxelize_average_rle_domains`.

Counterpart of the JAX package's
``ops/pallas/segreduce.py:233 rle_reduce_pallas``, with the same contract.
"""

from __future__ import annotations

import ctypes

import torch

#: launches of the CUDA kernel by :func:`segreduce` in this process
launches = 0

_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_void_p)
MAX_COLS = 7


def segreduce_plain(keys: torch.Tensor, vals: torch.Tensor, capacity: int,
                    sentinel: int, force_break: int = 0):
    """Plain PyTorch twin of :func:`segreduce` (start flags, ``cumsum``,
    ``index_add_``); same contract, any device."""
    n, d = vals.shape
    dev = keys.device
    valid = keys != sentinel
    start = valid.clone()            # element 0 starts a run if valid
    start[1:] &= keys[1:] != keys[:-1]
    if force_break:
        pos = torch.arange(n, device=dev)
        start |= valid & (pos % force_break == 0)
    rid = torch.cumsum(start.to(torch.int32), 0, dtype=torch.int32) - 1
    true_count = start.sum(dtype=torch.int32)
    keep = valid & (rid < capacity)
    dump = torch.full_like(rid, capacity)
    out_keys = torch.full((capacity + 1,), sentinel, dtype=torch.int32,
                          device=dev)
    out_keys.scatter_(0, torch.where(start & keep, rid, dump).long(),
                      keys.to(torch.int32))
    out_sums = torch.zeros((capacity + 1, d), dtype=torch.float32,
                           device=dev)
    # exact in any order: integer-valued addends, run sums < 2^24
    out_sums.index_add_(0, torch.where(keep, rid, dump).long(),
                        vals.to(torch.float32))
    count = torch.clamp_max(true_count, capacity)
    return out_keys[:capacity], out_sums[:capacity], count, true_count


def segreduce(keys: torch.Tensor, vals: torch.Tensor, capacity: int,
              sentinel: int, force_break: int = 0):
    """Reduce runs of consecutive equal keys to (key, sum) rows.

    Args:
        keys: ``[N]`` int32 in ``[0, sentinel]``; sentinel rows are
            ignored and end runs.
        vals: ``[N, D]`` float32, ``D <= 7``. REQUIRED: non-negative and
            integer-valued, with every run sum below 2^24 (then every sum
            is exact in any order).
        capacity: static number of output rows; runs past it are dropped.
        sentinel: the ignored key, and the fill of ``out_keys`` past the
            count.
        force_break: ``k > 0`` starts a run at every stream position
            divisible by ``k`` (bounds run sums).

    Returns:
        (out_keys ``[capacity]`` int32, out_sums ``[capacity, D]`` float32
        — zeros past the count, count int32 0-d clamped to capacity, true
        count int32 0-d — ``> capacity`` means rows were dropped).

    A CPU tensor runs :func:`segreduce_plain`; a CUDA tensor launches the
    kernel (built on first use) or raises.
    """
    if keys.device.type == "cpu":
        return segreduce_plain(keys, vals, capacity, sentinel, force_break)
    if keys.device.type != "cuda":
        raise ValueError(f"segreduce: unsupported device {keys.device}")
    n = keys.shape[0]
    if keys.dtype != torch.int32 or keys.ndim != 1 \
            or not keys.is_contiguous():
        raise ValueError("segreduce: keys must be a contiguous [N] int32 "
                         f"tensor, got {keys.dtype} {tuple(keys.shape)}")
    if vals.dtype != torch.float32 or vals.ndim != 2 \
            or vals.shape[0] != n or not vals.is_contiguous() \
            or vals.device != keys.device:
        raise ValueError("segreduce: vals must be a contiguous [N, D] "
                         "float32 tensor on the keys' device, got "
                         f"{vals.dtype} {tuple(vals.shape)} {vals.device}")
    d = vals.shape[1]
    if not 1 <= d <= MAX_COLS or capacity < 1 or n >= 2 ** 31:
        raise ValueError(f"segreduce: unsupported D={d}, "
                         f"capacity={capacity}, N={n}")
    from ros_gpu_depthmap_fusion_tpu_torch.ops.kernels import _build
    fn = _build.function("fusion_segreduce", _ARGTYPES)
    dev = keys.device
    out_keys = torch.full((capacity,), sentinel, dtype=torch.int32,
                          device=dev)
    out_sums = torch.zeros((capacity, d), dtype=torch.float32, device=dev)
    tiles = max(_build.scan_tiles(n), 1)
    scratch = torch.empty((2, tiles), dtype=torch.int32, device=dev)
    counts = torch.empty((2,), dtype=torch.int32, device=dev)
    p = _build.ptr
    status = fn(p(keys), p(vals), n, d, int(sentinel), int(force_break),
                capacity, p(scratch[0]), p(scratch[1]), p(counts),
                p(out_keys), p(out_sums), _build.stream_ptr(keys))
    _build.check(status, "segreduce")
    global launches
    launches += 1
    return out_keys, out_sums, counts[0], counts[1]
