"""Kernel 2: the flying-pixel filter (``csrc/flying_pixels.cu``).

Per depth pixel: the range gate ``|p|^2 <= max_distance^2``, then for each
ring ``d = 1..filter_size`` (and its 45-degree-rotated twin when enabled)
all four neighbours valid and in bounds, the surface normal
``cross(down - up, right - left)``, and keep the pixel if
``cos(normal, -p) >= threshold`` (``shader/filter_flying_pixels.glsl``).

Counterpart of the JAX package's ``ops/pallas/flying_pixels.py:130
filter_flying_pixels_pallas``. The arithmetic is that of the JAX package's
plain formulation (``ops/stencil.py:38-115``), operation for operation.

Border semantics: pixels within the ring radius of any image border are
rejected (the reference's unsigned left/top checks wrapped to the previous
row; this is the evidently intended check, as in the JAX package).
"""

from __future__ import annotations

import ctypes

import torch

from ros_gpu_depthmap_fusion_tpu_torch.core.devconst import scalar_f32

#: launches of the CUDA kernel by :func:`filter_flying_pixels`
launches = 0

_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p)
#: rings the CUDA kernel takes (``kFpMaxFilter`` in the source: its
#: shared-memory tile carries a halo of this many pixels at most)
MAX_FILTER_SIZE = 8


def filter_flying_pixels_plain(points_cam: torch.Tensor,
                               mask: torch.Tensor,
                               height: int,
                               width: int,
                               filter_size: int,
                               threshold,
                               enable_rot45: bool,
                               max_distance=10.0) -> torch.Tensor:
    """Plain PyTorch twin of :func:`filter_flying_pixels` (the stencil as
    shifted whole-image tensors); same contract, any device."""
    c = points_cam.shape[0]
    dev = points_cam.device
    thr = scalar_f32(threshold, dev)
    maxd = scalar_f32(max_distance, dev)
    p = points_cam.reshape(c, height, width, 4)[..., :3]
    px, py, pz = p[..., 0], p[..., 1], p[..., 2]
    m = mask.reshape(c, height, width)

    dist2 = (px * px + py * py) + pz * pz
    out = m & (dist2 <= maxd * maxd)

    vx, vy, vz = -px, -py, -pz
    vlen = torch.clamp_min(torch.sqrt((vx * vx + vy * vy) + vz * vz), 1e-30)
    vx, vy, vz = vx / vlen, vy / vlen, vz / vlen

    yy = torch.arange(height, device=dev)[None, :, None]
    xx = torch.arange(width, device=dev)[None, None, :]

    def shifted(a, dy, dx):
        # value at (y, x) = a[y + dy, x + dx]; wrapped values are unused
        # because out-of-bounds pixels are masked separately
        return torch.roll(a, shifts=(-dy, -dx), dims=(1, 2))

    def ring_check(d: int, rot45: bool) -> torch.Tensor:
        if not rot45:
            offs = {"up": (-d, 0), "down": (d, 0),
                    "left": (0, -d), "right": (0, d)}
        else:
            offs = {"up": (-d, -d), "down": (d, d),
                    "left": (d, -d), "right": (-d, d)}
        ok = ((xx - d >= 0) & (xx + d <= width - 1)
              & (yy - d >= 0) & (yy + d <= height - 1)) & m
        sh = {}
        for name, (dy, dx) in offs.items():
            ok = ok & shifted(m, dy, dx)
            sh[name] = [shifted(q, dy, dx) for q in (px, py, pz)]
        a = [sh["down"][k] - sh["up"][k] for k in range(3)]
        b = [sh["right"][k] - sh["left"][k] for k in range(3)]
        n0 = a[1] * b[2] - a[2] * b[1]
        n1 = a[2] * b[0] - a[0] * b[2]
        n2 = a[0] * b[1] - a[1] * b[0]
        nlen = torch.clamp_min(
            torch.sqrt((n0 * n0 + n1 * n1) + n2 * n2), 1e-30)
        n0, n1, n2 = n0 / nlen, n1 / nlen, n2 / nlen
        cos_view = (n0 * vx + n1 * vy) + n2 * vz
        return ok & (cos_view >= thr)

    for d in range(1, filter_size + 1):
        out = out & ring_check(d, rot45=False)
        if enable_rot45:
            out = out & ring_check(d, rot45=True)
    return out.reshape(c, height * width)


def filter_flying_pixels(points_cam: torch.Tensor,
                         mask: torch.Tensor,
                         height: int,
                         width: int,
                         filter_size: int,
                         threshold,
                         enable_rot45: bool,
                         max_distance=10.0) -> torch.Tensor:
    """Flying-pixel rejection on camera-frame points.

    Args:
        points_cam: ``[C, H*W, 4]`` float32 camera-frame points.
        mask: ``[C, H*W]`` bool input validity.
        filter_size: number of rings (neighbour offsets 1..filter_size).
        threshold: minimum cos(view angle); a float or a 0-d tensor (a
            device tensor costs no host sync).
        enable_rot45: also test the 45-degree-rotated neighbourhood.
        max_distance: range gate on ``|p|``; float or 0-d tensor.

    Returns:
        ``[C, H*W]`` bool output mask.

    A CPU tensor runs :func:`filter_flying_pixels_plain`; a CUDA tensor
    launches the kernel (built on first use) or raises: the kernel takes
    ``filter_size`` up to :data:`MAX_FILTER_SIZE`, at most 65,535 cameras
    and 8 * 65,535 rows, and fewer than 2^31 pixels in all.
    """
    if points_cam.device.type == "cpu":
        return filter_flying_pixels_plain(
            points_cam, mask, height, width, filter_size, threshold,
            enable_rot45, max_distance)
    if points_cam.device.type != "cuda":
        raise ValueError("filter_flying_pixels: unsupported device "
                         f"{points_cam.device}")
    c = points_cam.shape[0]
    if points_cam.dtype != torch.float32 \
            or points_cam.shape != (c, height * width, 4) \
            or not points_cam.is_contiguous():
        raise ValueError("filter_flying_pixels: points_cam must be a "
                         "contiguous [C, H*W, 4] float32 tensor, got "
                         f"{points_cam.dtype} {tuple(points_cam.shape)}")
    if mask.dtype != torch.bool or mask.shape != (c, height * width) \
            or not mask.is_contiguous() or mask.device != points_cam.device:
        raise ValueError("filter_flying_pixels: mask must be a contiguous "
                         "[C, H*W] bool tensor on the points' device")
    if not 0 <= filter_size <= MAX_FILTER_SIZE:
        raise ValueError("filter_flying_pixels: the kernel takes "
                         f"filter_size 0..{MAX_FILTER_SIZE}, got "
                         f"{filter_size}")
    if c * height * width >= 2 ** 31 or c > 65535 or height > 8 * 65535:
        raise ValueError("filter_flying_pixels: unsupported size "
                         f"{c} x {height} x {width}")
    if points_cam.data_ptr() % 16:
        raise ValueError("filter_flying_pixels: points_cam must be "
                         "16-byte aligned (read as float4)")
    from ros_gpu_depthmap_fusion_tpu_torch.ops.kernels import _build
    fn = _build.function("fusion_flying_pixels", _ARGTYPES)
    dev = points_cam.device
    params = torch.stack([scalar_f32(threshold, dev),
                          scalar_f32(max_distance, dev)])
    out = torch.empty((c, height * width), dtype=torch.bool, device=dev)
    p = _build.ptr
    status = fn(p(points_cam), p(mask.view(torch.uint8)),
                p(out.view(torch.uint8)), c, height, width, filter_size,
                int(bool(enable_rot45)), p(params),
                _build.stream_ptr(points_cam))
    _build.check(status, "filter_flying_pixels")
    global launches
    launches += 1
    return out
