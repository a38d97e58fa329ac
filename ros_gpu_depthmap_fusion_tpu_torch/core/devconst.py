"""Small constant tensors cached per device.

Two reasons to keep configuration constants (grid bounds, cell sizes,
crop boxes) as cached tensors on the data's device rather than Python
floats or fresh ``torch.tensor`` calls:

- ``torch.tensor(..., device="cuda")`` copies from pageable host memory
  and waits for the stream: one such call per frame would stall the host
  behind all queued device work.
- On CUDA, PyTorch divides by a CPU scalar as a multiplication by its
  reciprocal, which is not the IEEE quotient the reference computes. A
  divisor that lives on the device gets a true division.

The cached tensors are shared: callers must not modify them in place.
"""

from __future__ import annotations

import functools

import torch


@functools.lru_cache(maxsize=None)
def _cached(values: tuple, device: str, dtype: torch.dtype) -> torch.Tensor:
    return torch.tensor(values, dtype=dtype, device=device)


def scalar_f32(x, device) -> torch.Tensor:
    """A runtime scalar (Python number or 0-d tensor) as a float32 0-d
    tensor on ``device``, without a host sync."""
    if isinstance(x, torch.Tensor):
        return x.reshape(()).to(device=device, dtype=torch.float32)
    return const(float(x), device)


def const(values, device, dtype: torch.dtype = torch.float32
          ) -> torch.Tensor:
    """``torch.tensor(values)`` on ``device``, built once per (values,
    device, dtype). ``values`` is a number or a flat sequence."""
    key = tuple(values) if isinstance(values, (tuple, list)) else values
    return _cached(key, str(torch.device(device)), dtype)
