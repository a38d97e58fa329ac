"""Build the package's CUDA kernels with ``nvcc`` at first use and bind
them with ``ctypes``.

All ``csrc/*.cu`` files compile into one shared library with a plain C
interface, under ``ros_gpu_depthmap_fusion_tpu_torch/_build/``, named by a
hash of the sources, the flags and the compiler. A later call in the same
or another process loads the cached library. Nothing outside the checkout
is used except the CUDA toolkit (``$CUDA_HOME/bin/nvcc``, ``nvcc`` on the
``PATH``, or ``/usr/local/cuda/bin/nvcc``).

This module is imported only by the CUDA branch of a kernel wrapper, so the
package imports, and its CPU paths run, on machines without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"

# sm_90a: Hopper. --fmad=false keeps every a*b+c as two rounded
# operations, as the plain PyTorch twins compute them (a contracted
# multiply-add changes the last ulp of coordinates, which moves points on
# cell and crop boundaries). No fast-math: division and sqrt stay IEEE.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_lock = threading.Lock()
_lib = None
_info: dict = {}


def find_nvcc() -> str:
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    cands += [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH and "
        "/usr/local/cuda/bin): the CUDA kernels of "
        "ros_gpu_depthmap_fusion_tpu_torch cannot be built")


def _sources():
    return sorted(CSRC_DIR.glob("*.cu")), sorted(CSRC_DIR.glob("*.cuh"))


def _build() -> ctypes.CDLL:
    nvcc = find_nvcc()
    cu, headers = _sources()
    h = hashlib.sha256()
    for p in cu + headers:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    h.update(os.path.realpath(nvcc).encode())
    tag = h.hexdigest()[:16]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib_path = BUILD_DIR / f"libfusion_kernels_{tag}.so"
    log_path = BUILD_DIR / f"libfusion_kernels_{tag}.log"
    t0 = time.perf_counter()
    built = False
    if not lib_path.exists():
        tmp = BUILD_DIR / f".tmp_{tag}_{os.getpid()}.so"
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC_DIR), "-o", str(tmp),
               *map(str, cu)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        log_path.write_text(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}) building the CUDA "
                f"kernels:\n{proc.stderr}")
        os.replace(tmp, lib_path)
        built = True
    lib = ctypes.CDLL(str(lib_path))
    lib.fusion_scan_tiles.argtypes = [ctypes.c_int]
    lib.fusion_scan_tiles.restype = ctypes.c_int
    lib.fusion_error_string.argtypes = [ctypes.c_int]
    lib.fusion_error_string.restype = ctypes.c_char_p
    _info.update(path=str(lib_path), log=str(log_path), built=built,
                 seconds=time.perf_counter() - t0, nvcc=nvcc)
    return lib


def library() -> ctypes.CDLL:
    """The kernel library, built on the first call."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = _build()
        return _lib


def build_info() -> dict:
    """Path, build log, whether this process compiled it, and seconds."""
    library()
    return dict(_info)


@functools.lru_cache(maxsize=None)
def function(name: str, argtypes: tuple):
    """A C entry of the library with its argument types declared; every
    entry returns a ``cudaError_t`` as ``int``."""
    fn = getattr(library(), name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def check(status: int, name: str) -> None:
    """Raise if a C entry reported a CUDA error (a refused launch never
    runs, and a later synchronize would not report it)."""
    if status != 0:
        msg = library().fusion_error_string(status).decode()
        raise RuntimeError(f"{name}: CUDA error {status} ({msg})")


def stream_ptr(t) -> ctypes.c_void_p:
    """The current CUDA stream of ``t``'s device, for a C entry."""
    import torch
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def scan_tiles(n: int) -> int:
    """Scratch entries per tile-count array for an ``n``-element scan."""
    return library().fusion_scan_tiles(n)
