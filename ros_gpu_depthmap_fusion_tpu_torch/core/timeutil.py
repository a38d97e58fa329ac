"""ROS-style (sec, nsec) timestamps.

The reference compares per-sequence (sec, nsec) pairs lexicographically
(``shader/rollbuffer_count_discarded_points.glsl:49-56``). ``encode`` packs
a pair into one int64 nanosecond count, for numpy values and torch
tensors alike.
"""

from __future__ import annotations

import numpy as np
import torch

NSEC_PER_SEC = 1_000_000_000


def encode(sec, nsec):
    """(sec, nsec) pair -> int64 nanoseconds (torch tensors or numpy)."""
    if isinstance(sec, torch.Tensor):
        return (sec.to(torch.int64) * NSEC_PER_SEC
                + torch.as_tensor(nsec, device=sec.device).to(torch.int64))
    return np.int64(sec) * NSEC_PER_SEC + np.int64(nsec)


def decode(t_ns):
    """int64 nanoseconds -> (sec, nsec)."""
    sec = t_ns // NSEC_PER_SEC
    nsec = t_ns - sec * NSEC_PER_SEC
    return sec, nsec


def from_seconds(t: float) -> np.int64:
    """Float seconds -> int64 nanoseconds (host-side convenience)."""
    return np.int64(round(t * NSEC_PER_SEC))


def compare(a_sec, a_nsec, b_sec, b_nsec):
    """Lexicographic compare, the reference's compareTime: -1 if a < b, 0 if
    equal, +1 if a > b. Python scalars give an int; tensors give an
    elementwise int32 tensor."""
    if isinstance(a_sec, torch.Tensor) or isinstance(b_sec, torch.Tensor):
        a = encode(torch.as_tensor(a_sec), a_nsec)
        b = encode(torch.as_tensor(b_sec), b_nsec)
        return torch.sign(a - b).to(torch.int32)
    if a_sec != b_sec:
        return -1 if a_sec < b_sec else 1
    if a_nsec != b_nsec:
        return -1 if a_nsec < b_nsec else 1
    return 0
