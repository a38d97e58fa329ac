"""ctypes binding of the native host runtime (``native/libfusionhost.so``):
the three depth-link encoders, the lidar point staging copy, the mapping's
host segmentation (per-layer connected components, cross-layer merge,
voxel stats), object assembly and contour tracing, and the host helpers
(depth-pair packing, the OpenMP LSD radix sort and the grouping of a
sorted key array).

A copy of the JAX package's ``utils/native.py`` (the port cannot import
it: importing anything of that package imports jax). Both packages load
the same library, which ``make -C native`` builds from
``native/src/fusionhost.cpp`` at first use (gcc with OpenMP; the library
is git-ignored).

Differences from the JAX copy: the library is built under a private name
and renamed into place (test workers may build it at once); the encoders'
zigzag scratch buffer is per thread (the pipelined engine encodes on a
worker thread, and two engines may encode at once); and the encoders, the
mapping entry points and the host helpers raise (through :func:`require`)
when the library is missing, where the JAX copy returns ``None`` or falls
back to numpy (only the staging copy, the same either way, keeps its numpy
path), so that a configured codec never silently becomes the raw link and
the host segmentation backend never silently becomes another.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "libfusionhost.so")

_lib: Optional[ctypes.CDLL] = None
_tried = False
_error = ""
_load_lock = threading.Lock()
_scratch = threading.local()


def _build() -> bool:
    """``make -C native`` under a private name, renamed into place, so
    processes that build at once never load a half-written file. Tries the
    environment's C++ compiler (``$CXX``, the Makefile's default), then
    ``g++`` on the PATH (an environment may set ``CXX`` to a compiler that
    lacks OpenMP)."""
    global _error
    tmp = f"libfusionhost.so.tmp{os.getpid()}"
    errors = []
    for extra in ([], ["CXX=g++"]):
        try:
            proc = subprocess.run(["make", "-C", _NATIVE_DIR, f"LIB={tmp}",
                                   *extra], capture_output=True, text=True,
                                  timeout=300)
        except (OSError, subprocess.TimeoutExpired) as e:
            errors.append(repr(e))
            continue
        if proc.returncode == 0:
            os.replace(os.path.join(_NATIVE_DIR, tmp), _LIB_PATH)
            return True
        errors.append(f"make {' '.join(extra)} -> {proc.returncode}: "
                      f"{proc.stderr.strip()[-400:]}")
    _error = f"building it in {_NATIVE_DIR} failed: " + " | ".join(errors)
    return False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried, _error
    with _load_lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if not os.path.exists(_LIB_PATH) and not _build():
            return None
        try:
            lib = ctypes.CDLL(_LIB_PATH)
        except OSError as e:
            _error = f"cannot load {_LIB_PATH}: {e}"
            return None

        u16p = np.ctypeslib.ndpointer(np.uint16, flags="C_CONTIGUOUS")
        u32p = np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")
        u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
        i64 = ctypes.c_int64
        i32 = ctypes.c_int32
        f64 = ctypes.c_double

        lib.fh_pack_depth_pairs.argtypes = [u16p, u32p, i64]
        lib.fh_pack_depth_pairs.restype = None
        lib.fh_unpack_depth_pairs.argtypes = [u32p, u16p, i64]
        lib.fh_unpack_depth_pairs.restype = None
        lib.fh_radix_sort_u32.argtypes = [u32p, u32p, u32p, i64]
        lib.fh_radix_sort_u32.restype = None
        lib.fh_group_sorted_u32.argtypes = [u32p, i64, i64p, i64p, u32p,
                                            i64]
        lib.fh_group_sorted_u32.restype = i64
        lib.fh_stage_points_xyz.argtypes = [f32p, i64, i64, f32p, i64]
        lib.fh_stage_points_xyz.restype = i64
        lib.fh_depth_encode2.argtypes = [u16p, i32, i32, i32, i64, i32p, i32,
                                         i32, i32, u32p, u32p, u16p, u32p,
                                         u32p, i64p]
        lib.fh_depth_encode2.restype = i32
        lib.fh_depth_encode_temporal.argtypes = [
            u16p, u16p, i32, i32, i32, i64, i32p, i32, i32, i32, u32p, u32p,
            u16p, u32p, u32p, i64p]
        lib.fh_depth_encode_temporal.restype = i32
        lib.fh_depth_encode_p4.argtypes = [
            u16p, u16p, i32, i32, i32, i32, i32, i32, i64, u32p, u8p,
            u16p, u32p, u32p, i64p]
        lib.fh_depth_encode_p4.restype = i32
        lib.fh_cc_label_u8.argtypes = [u8p, u16p, i32, i32, i32p, f64p, i32]
        lib.fh_cc_label_u8.restype = i32
        lib.fh_trace_contour.argtypes = [u8p, i32, i32, i32, i32, i32p, i64]
        lib.fh_trace_contour.restype = i64
        lib.fh_assemble_count.argtypes = [u16p, i32, i32, i32, i32p, i32,
                                          i32, i64p]
        lib.fh_assemble_count.restype = None
        lib.fh_assemble_objects.argtypes = [
            u16p, i32, i32, i32, i32p, i32, i32, f64, f64, f64, f64,
            i64p, i32p,          # group_start, pts_xy
            i64p, i32p, f64p,    # hull_start, hull_xy, layer_shapes
            i64p, i32p,          # tv_start, tv_xy
            i64p, i32p, f64p,    # tv_hull_start, tv_hull_xy, tv_shapes
            i32p, i64p, i32p, i64, f64p]  # comps, contours, cap, shapes
        lib.fh_assemble_objects.restype = i32
        lib.fh_segment_grid.argtypes = [u8p, i32, i32, i32, i32, i32, u16p,
                                        i32p, i32p, i64p, f64p, i32p, i32p]
        lib.fh_segment_grid.restype = i32
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def require() -> ctypes.CDLL:
    """The library, or ``RuntimeError`` saying why it did not load."""
    lib = _load()
    if lib is None:
        raise RuntimeError(
            "the native host library (native/libfusionhost.so) did not "
            "load, and the depth-link encoders and the host mapping need "
            f"it: {_error}")
    return lib


def _zz_scratch(n: int) -> np.ndarray:
    buf = getattr(_scratch, "buf", None)
    if buf is None or buf.size < n:
        buf = _scratch.buf = np.empty(n, np.uint32)
    return buf[:n]


def pack_depth_pairs(depth_u16: np.ndarray) -> np.ndarray:
    """Two u16 depths a u32 word, the first in the low half
    (``fh_pack_depth_pairs``); an odd last pixel is dropped."""
    lib = require()
    d = np.ascontiguousarray(np.asarray(depth_u16).reshape(-1), np.uint16)
    n = d.size // 2
    out = np.empty(n, np.uint32)
    lib.fh_pack_depth_pairs(d, out, n)
    return out


def unpack_depth_pairs(pairs_u32: np.ndarray) -> np.ndarray:
    """The inverse of :func:`pack_depth_pairs` (``fh_unpack_depth_pairs``):
    ``[2 N]`` u16."""
    lib = require()
    p = np.ascontiguousarray(pairs_u32, np.uint32)
    out = np.empty(p.size * 2, np.uint16)
    lib.fh_unpack_depth_pairs(p, out, p.size)
    return out


def radix_sort_u32(keys: np.ndarray):
    """Stable ascending sort (``fh_radix_sort_u32``); returns
    ``(sorted_keys, original_indices)``, both u32."""
    lib = require()
    k = np.ascontiguousarray(keys, np.uint32)
    out_k = np.empty_like(k)
    out_i = np.empty(k.size, np.uint32)
    lib.fh_radix_sort_u32(k, out_k, out_i, k.size)
    return out_k, out_i


def group_sorted_u32(sorted_keys: np.ndarray, cap: Optional[int] = None):
    """The runs of equal keys of a sorted u32 array
    (``fh_group_sorted_u32``): ``(starts, sizes, values, num_groups)``, the
    first three of length ``cap`` (default: the key count), int64, int64
    and u32, zero past ``num_groups``; at most ``cap`` groups are kept."""
    lib = require()
    k = np.ascontiguousarray(sorted_keys, np.uint32)
    cap = cap or k.size
    starts = np.zeros(cap, np.int64)
    sizes = np.zeros(cap, np.int64)
    values = np.zeros(cap, np.uint32)
    if not k.size:
        return starts, sizes, values, 0
    n = int(lib.fh_group_sorted_u32(k, k.size, starts, sizes, values, cap))
    return starts, sizes, values, n


def _bucket_list(allowed_bits):
    from ros_gpu_depthmap_fusion_tpu_torch.ops.depth_codec import B_BUCKETS
    return np.asarray(sorted(B_BUCKETS if allowed_bits is None
                             else allowed_bits), np.int32)


def depth_encode(depth_u16: np.ndarray, max_exceptions: int = 8192,
                 allowed_bits=None, out=None, guess_bits: int = -1,
                 quant_shift: int = 0):
    """Compress a ``[C, H, W]`` u16 depth block with the native escape-zero
    row-DPCM encoder (format and decoder: :mod:`ops.depth_codec`).

    ``quant_shift`` > 0 quantizes nonzero depths to multiples of
    ``2**quant_shift`` first (error <= ``2**(quant_shift-1)``; holes
    exact); the decoder takes the same shift. ``out`` optionally gives
    C-contiguous destinations ``dict(words u32[rows*wpr_max], row_first
    u16[rows], exc_idx u32[cap], exc_zz u32[cap])`` (packet views).

    Returns ``(dict(words, row_first, exc_idx, exc_zz, exc_count), bits)``,
    or ``None`` when every allowed width overflows the exception budget
    (the caller ships raw depth). Raises when the library is missing.
    """
    lib = require()
    d = np.ascontiguousarray(depth_u16, np.uint16)
    c, h, w = d.shape
    rows = c * h
    allowed = _bucket_list(allowed_bits)
    wpr_max = (w * int(allowed[-1]) + 31) // 32
    if out is None:
        out = dict(words=np.zeros(rows * wpr_max, np.uint32),
                   row_first=np.zeros(rows, np.uint16),
                   exc_idx=np.zeros(max_exceptions, np.uint32),
                   exc_zz=np.zeros(max_exceptions, np.uint32))
    meta = np.zeros(2, np.int64)
    bits = int(lib.fh_depth_encode2(
        d.reshape(-1), c, h, w, max_exceptions, allowed, len(allowed),
        int(guess_bits), int(quant_shift), _zz_scratch(rows * w),
        out["words"], out["row_first"], out["exc_idx"], out["exc_zz"],
        meta))
    if bits < 0:
        return None
    wpr = max(1, int(meta[1]))
    return dict(
        words=out["words"][: rows * wpr].reshape(c, h, wpr),
        row_first=out["row_first"].reshape(c, h),
        exc_idx=out["exc_idx"], exc_zz=out["exc_zz"],
        exc_count=np.int32(meta[0])), bits


def depth_encode_temporal(depth_u16: np.ndarray, prev_q: np.ndarray,
                          max_exceptions: int = 8192, allowed_bits=None,
                          out=None, guess_bits: int = -1,
                          quant_shift: int = 0, curr_q_out=None):
    """P-frame encoder (``fh_depth_encode_temporal``): per-pixel
    ``zigzag(curr_q - prev_q)`` with escape-zero holes against the previous
    frame's quantized series ``prev_q`` (same shape, holes = 0).

    Returns ``(dict(words, row_first (zeros), exc_idx, exc_zz, exc_count),
    bits, curr_q)``, or ``None`` when every allowed width overflows the
    exception budget (the caller sends an I-frame).
    """
    lib = require()
    d = np.ascontiguousarray(depth_u16, np.uint16)
    p = np.ascontiguousarray(prev_q, np.uint16)
    c, h, w = d.shape
    rows = c * h
    allowed = _bucket_list(allowed_bits)
    wpr_max = (w * int(allowed[-1]) + 31) // 32
    if out is None:
        out = dict(words=np.zeros(rows * wpr_max, np.uint32),
                   row_first=np.zeros(rows, np.uint16),
                   exc_idx=np.zeros(max_exceptions, np.uint32),
                   exc_zz=np.zeros(max_exceptions, np.uint32))
    curr_q = (curr_q_out if curr_q_out is not None
              else np.empty((c, h, w), np.uint16))
    meta = np.zeros(2, np.int64)
    bits = int(lib.fh_depth_encode_temporal(
        d.reshape(-1), p.reshape(-1), c, h, w, max_exceptions, allowed,
        len(allowed), int(guess_bits), int(quant_shift),
        _zz_scratch(rows * w), out["words"], curr_q.reshape(-1),
        out["exc_idx"], out["exc_zz"], meta))
    if bits < 0:
        return None
    wpr = max(1, int(meta[1]))
    out["row_first"][:] = 0  # P-frames carry no row bases
    return dict(
        words=out["words"][: rows * wpr].reshape(c, h, wpr),
        row_first=out["row_first"].reshape(c, h),
        exc_idx=out["exc_idx"], exc_zz=out["exc_zz"],
        exc_count=np.int32(meta[0])), bits, curr_q


def depth_encode_p4(depth_u16: np.ndarray, prev_q: np.ndarray,
                    budget: int, max_exceptions: int = 8192,
                    out=None, quant_shift: int = 0, hysteresis: int = 0,
                    curr_q_out=None):
    """p4 P-frame encoder (``fh_depth_encode_p4``): 4-pixel-group flags +
    per-row byte-budgeted literals with hysteresis quantization (format:
    :mod:`ops.depth_codec`). ``out`` optionally gives C-contiguous
    ``dict(flags u32[rows*fw], lits u8[rows*budget], exc_idx u32[cap],
    exc_zz u32[cap])`` destinations (packet views).

    Returns ``(dict(flags, lits, exc_idx, exc_zz, exc_count, lit_total,
    spilled), curr_q)``, or ``None`` on exception overflow (the caller
    sends an I-frame)."""
    lib = require()
    d = np.ascontiguousarray(depth_u16, np.uint16)
    p = np.ascontiguousarray(prev_q, np.uint16)
    c, h, w = d.shape
    rows = c * h
    gw = -(-w // 4)
    fw = -(-gw // 32)
    if out is None:
        out = dict(flags=np.zeros(rows * fw, np.uint32),
                   lits=np.zeros(rows * budget, np.uint8),
                   exc_idx=np.zeros(max_exceptions, np.uint32),
                   exc_zz=np.zeros(max_exceptions, np.uint32))
    curr_q = (curr_q_out if curr_q_out is not None
              else np.empty((c, h, w), np.uint16))
    meta = np.zeros(3, np.int64)
    rc = int(lib.fh_depth_encode_p4(
        d.reshape(-1), p.reshape(-1), c, h, w, int(quant_shift),
        int(hysteresis), int(budget), max_exceptions, out["flags"],
        out["lits"], curr_q.reshape(-1), out["exc_idx"], out["exc_zz"],
        meta))
    if rc < 0:
        return None
    return dict(
        flags=out["flags"][: rows * fw].reshape(rows, fw),
        lits=out["lits"][: rows * budget],
        exc_idx=out["exc_idx"], exc_zz=out["exc_zz"],
        exc_count=np.int32(meta[0]), lit_total=int(meta[1]),
        spilled=int(meta[2])), curr_q


def stage_points_xyz(xyz: np.ndarray, out: np.ndarray) -> int:
    """Copy ``[N, >=3]`` float32 points into an ``[cap, 4]`` staging buffer
    with w = 1; returns the number staged (numpy when the library is
    missing: the copy is the same)."""
    src = np.ascontiguousarray(xyz, np.float32)
    lib = _load()
    cap = out.shape[0]
    if lib is not None and out.flags["C_CONTIGUOUS"]:
        return int(lib.fh_stage_points_xyz(
            src.reshape(src.shape[0], -1), src.shape[0], src.shape[1]
            if src.ndim > 1 else 3, out.reshape(-1), cap))
    n = min(len(src), cap)
    out[:n, :3] = src[:n, :3]
    out[:n, 3] = 1.0
    return n


def cc_label(img: np.ndarray, max_labels: int = 65535):
    """8-connected labeling of a ``[H, W]`` binary image
    (``fh_cc_label_u8``). Returns ``(labels u16, num_labels incl.
    background, stats [num, 5] (x, y, w, h, area), centroids [num, 2])``."""
    lib = require()
    m = np.ascontiguousarray((np.asarray(img) != 0).astype(np.uint8))
    h, w = m.shape
    labels = np.zeros((h, w), np.uint16)
    cap = min(max_labels, h * w + 1)
    stats = np.zeros((cap, 5), np.int32)
    cents = np.zeros((cap, 2), np.float64)
    num = int(lib.fh_cc_label_u8(m, labels.reshape(-1), h, w,
                                 stats.reshape(-1), cents.reshape(-1), cap))
    return labels, num, stats[:num], cents[:num]


def trace_contour(mask: np.ndarray, sy: int, sx: int) -> np.ndarray:
    """Moore contour of the component whose first raster pixel is
    ``(sy, sx)`` (``fh_trace_contour``); ``[K, 2]`` (x, y)."""
    lib = require()
    m = np.ascontiguousarray((np.asarray(mask) != 0).astype(np.uint8))
    h, w = m.shape
    cap = 4 * (h + w) + 8 * max(h, w)
    out = np.zeros(2 * cap, np.int32)
    n = int(lib.fh_trace_contour(m, h, w, sy, sx, out, cap))
    if n >= cap:    # retry with the worst-case bound
        cap = 4 * h * w + 4
        out = np.zeros(2 * cap, np.int32)
        n = int(lib.fh_trace_contour(m, h, w, sy, sx, out, cap))
    return out[:2 * n].reshape(-1, 2)


def assemble_objects(labels: np.ndarray, merged_of_label: np.ndarray,
                     num_merged: int, cell_size_xy, lower_xy):
    """Per-frame object assembly (``fh_assemble_count`` +
    ``fh_assemble_objects``): groups the labeled voxels by (merged object,
    layer) and computes convex hulls, min-area rects and min enclosing
    circles in voxel and world xy, per-object topviews and per-component
    Moore contours. Returns a dict of flat arrays (the JAX copy's layout),
    or ``None`` when the native call reports an overflow."""
    lib = require()
    lab = np.ascontiguousarray(labels, np.uint16)
    z, h, w = lab.shape
    lut = np.ascontiguousarray(merged_of_label, np.int32)
    nl = lut.shape[1]
    m = max(int(num_merged), 1)
    sizes = np.zeros(2, np.int64)
    lib.fh_assemble_count(lab.reshape(-1), z, h, w, lut.reshape(-1), nl, m,
                          sizes)
    fg, ncomp = int(sizes[0]), int(sizes[1])
    ng = m * z
    pts = max(2 * fg, 2)
    a = dict(group_start=np.zeros(ng + 1, np.int64),
             pts_xy=np.zeros(pts, np.int32),
             hull_start=np.zeros(ng + 1, np.int64),
             hull_xy=np.zeros(pts, np.int32),
             layer_shapes=np.zeros(16 * ng, np.float64),
             tv_start=np.zeros(m + 1, np.int64),
             tv_xy=np.zeros(pts, np.int32),
             tv_hull_start=np.zeros(m + 1, np.int64),
             tv_hull_xy=np.zeros(pts, np.int32),
             tv_shapes=np.zeros(16 * m, np.float64),
             comp_zlm=np.zeros(max(3 * ncomp, 3), np.int32),
             contour_start=np.zeros(ncomp + 1, np.int64))
    contour_cap = 4 * fg + 16 * ncomp + 64
    a["contour_xy"] = np.zeros(2 * contour_cap, np.int32)
    a["comp_shapes"] = np.zeros(max(16 * ncomp, 16), np.float64)
    nc = int(lib.fh_assemble_objects(
        lab.reshape(-1), z, h, w, lut.reshape(-1), nl, m,
        float(cell_size_xy[0]), float(cell_size_xy[1]),
        float(lower_xy[0]), float(lower_xy[1]),
        a["group_start"], a["pts_xy"], a["hull_start"], a["hull_xy"],
        a["layer_shapes"], a["tv_start"], a["tv_xy"], a["tv_hull_start"],
        a["tv_hull_xy"], a["tv_shapes"], a["comp_zlm"], a["contour_start"],
        a["contour_xy"], contour_cap, a["comp_shapes"]))
    if nc < 0:
        return None
    return dict(
        num_merged=m, num_layers=z,
        group_start=a["group_start"], pts_xy=a["pts_xy"].reshape(-1, 2),
        hull_start=a["hull_start"], hull_xy=a["hull_xy"].reshape(-1, 2),
        layer_shapes=a["layer_shapes"].reshape(ng, 16),
        tv_start=a["tv_start"], tv_xy=a["tv_xy"].reshape(-1, 2),
        tv_hull_start=a["tv_hull_start"],
        tv_hull_xy=a["tv_hull_xy"].reshape(-1, 2),
        tv_shapes=a["tv_shapes"].reshape(m, 16),
        comp_zlm=a["comp_zlm"].reshape(-1, 3)[:nc],
        contour_start=a["contour_start"][:nc + 1],
        contour_xy=a["contour_xy"].reshape(-1, 2),
        comp_shapes=a["comp_shapes"].reshape(-1, 16)[:nc])


def segment_grid(occ_zyx: np.ndarray, max_labels: int, max_objects: int):
    """Host segmentation (``fh_segment_grid``): per-layer 8-connected
    components, cross-layer merge to fixpoint and per-object voxel stats,
    equal to :func:`mapping.segmentation.segment` on labels, merge ids,
    counts and boxes (centroids in float64). Object ids clamp to
    ``max_objects - 1`` as on the device. Returns a dict."""
    lib = require()
    occ = np.ascontiguousarray((np.asarray(occ_zyx) != 0).astype(np.uint8))
    z, h, w = occ.shape
    labels = np.zeros((z, h, w), np.uint16)
    num_labels = np.zeros(z, np.int32)
    merged = np.zeros((z, max_labels), np.int32)
    count = np.zeros(max_objects, np.int64)
    cen = np.zeros((max_objects, 3), np.float64)
    vmin = np.zeros((max_objects, 3), np.int32)
    vmax = np.zeros((max_objects, 3), np.int32)
    nm = int(lib.fh_segment_grid(
        occ.reshape(-1), z, h, w, max_labels, max_objects,
        labels.reshape(-1), num_labels, merged.reshape(-1), count,
        cen.reshape(-1), vmin.reshape(-1), vmax.reshape(-1)))
    return dict(labels=labels, num_labels=num_labels, merged_of_label=merged,
                num_merged=nm, voxel_count=count, centroid=cen,
                vmin=vmin, vmax=vmax)
