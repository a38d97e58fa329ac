"""The ``(stream, space)`` mesh of the distributed engine, on
``torch.distributed``.

The JAX package runs its sharded step as one ``shard_map`` program over a
device mesh (its ``parallel/mesh.py``). PyTorch has no single-controller
counterpart, so here the mesh is SPMD: one process a rank, each rank
owning one ``(stream, space)`` coordinate and one device.

- ``stream``: data parallelism over depth cameras and lidar streams.
- ``space``: the historic voxel grid block-partitioned along its linear
  cell index.

Ranks are laid out as the JAX package lays out devices
(``devices.reshape(num_stream, num_space)``): ``rank = stream_id *
num_space + space_id``. The stream group of space column ``s`` holds the
ranks ``k * num_space + s`` in ascending order, so a rank's place in it is
its stream id (which fixes the chunk a reduce-scatter hands it); the space
group of stream row ``t`` holds ``t * num_space + j``.

The collectives of the JAX step map one for one: ``lax.pmax`` ->
:func:`all_reduce` with ``MAX``, ``lax.psum`` -> :func:`all_reduce` with
``SUM``, ``lax.psum_scatter(tiled=True)`` -> :func:`reduce_scatter`, each on
the group of its axis. NCCL serves ranks on distinct GPUs and gloo ranks
on the CPU. Gloo also serves several ranks that share one GPU (NCCL
refuses two ranks on one device); its support for CUDA tensors differs
from collective to collective and release to release, so for a gloo
group every helper here copies a CUDA tensor to the host, runs the
collective there and copies the result back. The choice is made from the
backend, not from an error.

:func:`spawn` starts a world of ranks in fresh processes (the counterpart
of ``jax.distributed.initialize`` plus the virtual-device mesh); every
process group it makes has a timeout, and the parent waits for the ranks
with a deadline, so a hung collective fails in seconds.
"""

from __future__ import annotations

import dataclasses
import datetime
import multiprocessing
import os
import queue as queue_mod
import tempfile
import time
import traceback
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

STREAM_AXIS = "stream"
SPACE_AXIS = "space"


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """This rank's view of the ``(stream, space)`` mesh."""
    #: ``{STREAM_AXIS: num_stream, SPACE_AXIS: num_space}``, as JAX's
    #: ``Mesh.shape``
    shape: Dict[str, int]
    stream_id: int
    space_id: int
    #: the process group of each axis that holds this rank
    groups: Dict[str, Any]
    #: this rank's device
    device: torch.device
    #: the default group's backend, ``"nccl"`` or ``"gloo"``
    backend: str

    @property
    def rank(self) -> int:
        return self.rank_of(self.stream_id, self.space_id)

    @property
    def size(self) -> int:
        return self.shape[STREAM_AXIS] * self.shape[SPACE_AXIS]

    def rank_of(self, stream_id: int, space_id: int) -> int:
        return stream_id * self.shape[SPACE_AXIS] + space_id

    def group(self, axis: str):
        return self.groups[axis]


def make_mesh(num_stream: Optional[int] = None, num_space: int = 1, *,
              device) -> Mesh:
    """This rank's ``(stream, space)`` mesh over the initialized default
    process group; ``num_stream=None`` gives the stream axis every rank
    the space axis leaves. ``device`` (no default) is this rank's device.

    Every rank must call this, with the same arguments: it creates every
    stream group, then every space group, in one order on all ranks.
    Raises ``ValueError`` where the JAX package asserts (an axis that does
    not divide the world)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized process group "
                           "(torch.distributed.init_process_group, or "
                           "parallel.mesh.spawn)")
    n = dist.get_world_size()
    if num_space < 1 or n % num_space:
        raise ValueError(f"num_space={num_space} does not divide the "
                         f"world of {n} ranks")
    if num_stream is None:
        num_stream = n // num_space
    if num_stream < 1 or num_stream * num_space != n:
        raise ValueError(f"mesh {num_stream} x {num_space} (stream x "
                         f"space) does not match the world of {n} ranks")
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    rank = dist.get_rank()
    stream_id, space_id = divmod(rank, num_space)
    groups = {}
    for s in range(num_space):
        g = dist.new_group([k * num_space + s for k in range(num_stream)])
        if s == space_id:
            groups[STREAM_AXIS] = g
    for t in range(num_stream):
        g = dist.new_group([t * num_space + j for j in range(num_space)])
        if t == stream_id:
            groups[SPACE_AXIS] = g
    return Mesh(shape={STREAM_AXIS: num_stream, SPACE_AXIS: num_space},
                stream_id=stream_id, space_id=space_id, groups=groups,
                device=device, backend=str(dist.get_backend()))


# ---------------------------------------------------------------------------
# Collectives (on a gloo group, CUDA tensors go through host memory)
# ---------------------------------------------------------------------------

def _staged(mesh: Mesh, t: torch.Tensor) -> bool:
    return mesh.backend == "gloo" and t.is_cuda


def all_reduce(t: torch.Tensor, op, mesh: Mesh, axis: str) -> torch.Tensor:
    """``t`` reduced with ``op`` (``dist.ReduceOp``) over ``axis``; ``t``
    itself is left as it was."""
    if _staged(mesh, t):
        h = t.cpu()
        dist.all_reduce(h, op=op, group=mesh.group(axis))
        return h.to(t.device)
    out = t.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, op=op, group=mesh.group(axis))
    return out


def reduce_scatter(t: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """``lax.psum_scatter(t, axis, scatter_dimension=0, tiled=True)``: the
    sum over ``axis`` of ``t``, and of it the chunk of dim 0 at this rank's
    coordinate on ``axis``."""
    n = mesh.shape[axis]
    if t.shape[0] % n:
        raise ValueError(f"reduce_scatter: {t.shape[0]} rows over {n} ranks")
    src = t.cpu() if _staged(mesh, t) else t.contiguous()
    out = src.new_empty((t.shape[0] // n,) + tuple(t.shape[1:]))
    dist.reduce_scatter_tensor(out, src, op=dist.ReduceOp.SUM,
                               group=mesh.group(axis))
    return out.to(t.device)


def all_gather(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``[world, *t.shape]``: every rank's ``t`` in rank order, on ``t``'s
    device."""
    src = t.cpu() if _staged(mesh, t) else t.contiguous()
    out = src.new_empty((mesh.size * t.shape[0],) + tuple(t.shape[1:]))
    dist.all_gather_into_tensor(out, src)
    return out.reshape((mesh.size,) + tuple(t.shape)).to(t.device)


def gather_rows(rows: torch.Tensor, count: torch.Tensor,
                mesh: Mesh) -> List:
    """Every rank's live rows ``rows[:count]`` as host numpy arrays, in
    rank order (the same list on every rank). Only the rows up to the
    largest count cross between ranks."""
    counts = all_gather(count.reshape(1).to(torch.int32), mesh).cpu()
    counts = [int(c) for c in counts.reshape(-1)]
    m = max(max(counts), 1)
    g = all_gather(rows[:m], mesh).cpu().numpy()
    return [g[r, :c] for r, c in enumerate(counts)]


# ---------------------------------------------------------------------------
# Launching a world of ranks
# ---------------------------------------------------------------------------

def _rank_main(rank, fn, world_size, backend, init_method, timeout, args,
               threads, results):
    try:
        torch.set_num_threads(threads)
        dist.init_process_group(
            backend, init_method=init_method, world_size=world_size,
            rank=rank, timeout=datetime.timedelta(seconds=timeout))
        try:
            value = fn(rank, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, value))
    except BaseException:   # noqa: BLE001 -- reported to the parent
        results.put((rank, False, traceback.format_exc()))


def spawn(fn: Callable, world_size: int, backend: str,
          init_method: Optional[str] = None, timeout: float = 60.0,
          join_timeout: float = 600.0, args: Sequence = (),
          threads: Optional[int] = None) -> List:
    """Run ``fn(rank, *args)`` on ``world_size`` ranks, one fresh process
    each (the ``spawn`` start method), every one joined to one default
    process group of ``backend`` (``"nccl"`` or ``"gloo"``) first. Returns
    the ranks' return values in rank order.

    ``fn`` and ``args`` must pickle (``fn`` a module-level function).
    ``init_method`` defaults to a file store in a new temporary directory
    (tests pass ``file://<tmp_path>/store``); ``timeout`` (seconds) bounds
    every collective of the group; ``join_timeout`` bounds the whole
    world: past it, or as soon as one rank fails, every rank still
    running is terminated and this raises. ``threads`` sets each rank's
    ``torch.set_num_threads`` (which also sets the OpenMP threads of the
    native encoders called from the rank's main thread); by default the
    host's cores split over the ranks, since ranks that each spin one
    thread a core slow a world on one host many times over.
    """
    if threads is None:
        threads = max(1, (os.cpu_count() or 1) // world_size)
    tmp = None
    if init_method is None:
        tmp = tempfile.mkdtemp(prefix="mesh_store_")
        init_method = "file://" + os.path.join(tmp, "store")
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, name=f"rank{r}",
                         args=(r, fn, world_size, backend, init_method,
                               timeout, tuple(args), threads, results))
             for r in range(world_size)]
    for p in procs:
        p.start()
    values: Dict[int, Any] = {}
    deadline = time.monotonic() + join_timeout
    try:
        while len(values) < world_size:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(
                    f"spawn: ranks {sorted(set(range(world_size)) - set(values))}"
                    f" did not finish within {join_timeout} s")
            try:
                rank, ok, value = results.get(timeout=min(left, 1.0))
            except queue_mod.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in values and p.exitcode is not None
                        and p.exitcode != 0]
                if dead:
                    raise RuntimeError(f"spawn: rank {dead[0]} exited with "
                                       f"code {procs[dead[0]].exitcode}")
                continue
            if not ok:
                raise RuntimeError(f"spawn: rank {rank} failed:\n{value}")
            values[rank] = value
        for p in procs:
            p.join(max(deadline - time.monotonic(), 1.0))
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(5)
            if p.is_alive():
                p.kill()
                p.join()
        results.close()
        if tmp is not None:
            for name in os.listdir(tmp):
                os.unlink(os.path.join(tmp, name))
            os.rmdir(tmp)
    return [values[r] for r in range(world_size)]
