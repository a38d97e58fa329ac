"""ctypes binding of the native host runtime (``native/libfusionhost.so``),
the part the port's engine uses: the three depth-link encoders and the
lidar point staging copy.

A copy of the JAX package's ``utils/native.py`` (the port cannot import
it: importing anything of that package imports jax). Both packages load
the same library, which ``make -C native`` builds from
``native/src/fusionhost.cpp`` at first use (gcc with OpenMP; the library
is git-ignored).

Differences from the JAX copy: the library is built under a private name
and renamed into place (test workers may build it at once); the encoders'
zigzag scratch buffer is per thread (the pipelined engine encodes on a
worker thread, and two engines may encode at once); and :func:`require`
raises instead of the encoders returning ``None`` when the library is
missing, so that a configured codec never silently becomes the raw link.
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
        i64 = ctypes.c_int64
        i32 = ctypes.c_int32

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
            f"load, and the configured depth-link codec needs it: {_error}")
    return lib


def _zz_scratch(n: int) -> np.ndarray:
    buf = getattr(_scratch, "buf", None)
    if buf is None or buf.size < n:
        buf = _scratch.buf = np.empty(n, np.uint32)
    return buf[:n]


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
