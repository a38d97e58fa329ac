"""Peaks and the work a kernel call needs, for its roofline share.

The peaks are NVIDIA's published H100 SXM figures (data sheet, dense, at
the full 700 W): HBM3 at 3.35 TB/s and 67 TFLOP/s of float32 outside the
tensor cores. A call's bound is the larger of its bytes over the first
and its float32 operations over the second.

The work is what the call's inputs need, whatever implements it: each
byte that must be read once and each byte of the result written once,
counted from the inputs and from the true counts the call reports, not
the static capacities an implementation writes. These functions take the
arguments the port's kernel wrappers are called with, so a kernel's
roofline reads the same work whichever implementation runs it.
"""

from __future__ import annotations

import torch

HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12


def bound_s(nbytes: float, ops: float) -> float:
    return max(nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S)


def segreduce(args, out):
    """Runs of equal keys reduced to (key, column sums) rows. Every key
    is read (a run ends where the key changes); only the value rows of
    valid (non-sentinel) keys are; one (key, sums) row a true run, and
    the two counts, are written; one add per valid value."""
    keys, vals, capacity, sentinel = args[:4]
    d = vals.shape[1]
    valid = int((keys != sentinel).sum())
    runs = min(int(out[3]), capacity)
    return (keys.numel() * 4 + valid * 4 * d + runs * 4 * (1 + d) + 8,
            valid * d)


def flying_pixels(args, out):
    """The flying-pixel mask. The mask of every pixel is read and written;
    the xyz of a valid pixel is read. Operations: 46 a valid pixel (the
    range gate and the view ray, an IEEE division counted as 11 and a
    square root as 6) and 66 a ring test of a pixel within the range
    gate; below the bytes at these sizes."""
    pts, mask, _, _, size, _, rot45, dmax = args[:8]
    pix = mask.numel()
    p = pts.reshape(-1, 4)[:, :3]
    valid = mask.reshape(-1)
    n_valid = int(valid.sum())
    dmax = float(dmax)
    gated = int((valid & ((p * p).sum(-1) <= dmax * dmax)).sum())
    rings = size * (2 if rot45 else 1)
    return (2 * pix + 12 * n_valid, 46 * n_valid + 66 * rings * gated)


def compact(args, out):
    """Stable compaction of flagged rows: every flag read, each flagged
    row read and written once (up to the capacity), the counts written."""
    words, mask, capacity = args[:3]
    d = words.shape[1]
    moved = min(int(out[2]), capacity)
    return mask.numel() + 2 * moved * 4 * d + 8, 0


WORK = {"segreduce": segreduce, "flying_pixels": flying_pixels,
        "compact": compact}


def call_bound_s(name: str, args, out) -> float:
    """The least time the card could take for one recorded call."""
    with torch.no_grad():
        nbytes, ops = WORK[name](args, out)
    return bound_s(nbytes, ops)
