"""2.5-D object segmentation on a torch device (the JAX package's
``mapping/segmentation.py``, an XLA program with no Pallas kernel).

:func:`segment` runs the full pass: on a CUDA tensor a chain of eight
hand-written kernels (``csrc/segment.cu``) on the current stream, with no
host synchronization; on a CPU tensor :func:`segment_plain`, the JAX
program in plain PyTorch, built from:

- :func:`label_layers` — per-layer 8-connected components by iterated
  min-label propagation + pointer jumping, labels densely renumbered in
  raster order of each component's first pixel (``cv::connectedComponents``
  numbering). All Z layers iterate as one ``[Z, Y, X]`` batch until none
  changes: JAX ``vmap``s a ``lax.while_loop``, which runs until every layer
  is fixed, and a propagation step leaves a fixed layer as it is, so the
  labels are identical.
- :func:`layer_connections` — label pairs sharing an (x, y) column between
  adjacent layers (shader/layers_connections.glsl:70-114).
- :func:`merge_labels` — cross-layer merge iterated to fixpoint (label 0
  merges only with label 0; merged ids dense in ascending order of their
  smallest global label, background = 0).

:func:`group_foreground` (port only: the JAX package assembles objects
from the dense labels on the host) groups the foreground cells of a
segmentation by (object, layer) on its device: ``csrc/group.cu`` on a
CUDA tensor, :func:`group_foreground_plain` on a CPU one.

Every step is integer and exact, so any device gives the JAX program's
labels, merge table and boxes, and the kernels give the twin's bit for
bit. The twin's fixpoint loops test for change on the host (one
synchronization per iteration). The JAX program's ``mode="drop"``
scatters target one extra slot that is sliced off. Centroid sums
accumulate in int64 (exact in any order, where CUDA's float atomics are
not), then ``centroid = float32(sum) / float32(count)``: bit-equal to the
JAX program's sequential float32 sums wherever every sum is below 2^24,
and closer to the native float64 centroid above.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Tuple

import numpy as np
import torch

from ros_gpu_depthmap_fusion_tpu_torch.utils import profiling

_NEIGHBORS8 = [(-1, -1), (-1, 0), (-1, 1), (0, -1),
               (0, 1), (1, -1), (1, 0), (1, 1)]
_I32 = torch.int32

#: launches of the CUDA kernels by :func:`segment` in this process
launches = 0
#: kernels the CUDA chain launches a call
CHAIN_LAUNCHES = 8
# csrc/segment.cu's dynamic shared memory: the merge kernel holds the
# Z x max_labels table (int32), the stats kernel an object slot of count,
# three int64 sums, three minimums and three maximums; beside it a kernel
# declares at most _STATIC_BYTES statically
_SLOT_BYTES = 4 + 3 * 8 + 6 * 4
_STATIC_BYTES = 1024


def chain_limits(shared_optin: int) -> Tuple[int, int]:
    """The largest ``Z * max_labels`` and ``max_objects`` the CUDA chain
    takes on a device whose blocks may opt in to ``shared_optin`` bytes of
    shared memory (232,448 on the H100: 57,856 and 4,450)."""
    room = shared_optin - _STATIC_BYTES
    return room // 4, room // _SLOT_BYTES


def _shift_along(a: torch.Tensor, s: int, dim: int, fill) -> torch.Tensor:
    """Shift so position i sees the value at i + s along ``dim`` (s may be
    negative); vacated positions get ``fill``."""
    n = a.shape[dim]
    if s == 0:
        return a
    if abs(s) >= n:
        return torch.full_like(a, fill)
    pad_shape = list(a.shape)
    pad_shape[dim] = abs(s)
    pad = torch.full(pad_shape, fill, dtype=a.dtype, device=a.device)
    if s > 0:
        return torch.cat([a.narrow(dim, s, n - s), pad], dim)
    return torch.cat([pad, a.narrow(dim, 0, n + s)], dim)


def _shift_with_fill(a: torch.Tensor, dy: int, dx: int, fill
                     ) -> torch.Tensor:
    """Shift a ``[..., Y, X]`` tensor so (y, x) sees (y + dy, x + dx);
    out-of-range positions get ``fill``."""
    return _shift_along(_shift_along(a, dy, a.ndim - 2, fill), dx,
                        a.ndim - 1, fill)


def _segmented_min_scan(lab: torch.Tensor, occ: torch.Tensor, big: int,
                        dim: int) -> torch.Tensor:
    """Min of ``lab`` over each maximal run of consecutive occupied pixels
    along ``dim``, by log2(n) doubling rounds of shift + min in each
    direction (JAX ``_segmented_min_scan``): a label crosses a whole
    straight run in one propagation step."""
    n = lab.shape[dim]
    val = torch.where(occ, lab, big)

    def one_direction(sign):
        m, c = val, occ
        s = 1
        while s < n:
            ms = _shift_along(m, sign * s, dim, big)
            cs = _shift_along(c, sign * s, dim, False)
            m = torch.minimum(m, torch.where(c, ms, big))
            c = c & cs
            s *= 2
        return m

    return torch.minimum(one_direction(1), one_direction(-1))


def _fixpoint(step, x: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """Apply ``step`` until the result stops changing (the JAX
    ``while_loop`` with its ``any(new != old)`` condition); returns the
    fixpoint and the number of steps, the last one unchanged."""
    iters = 0
    while True:
        new = step(x)
        iters += 1
        if torch.equal(new, x):
            return new, iters
        x = new


def _cc_roots(occ: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """8-connected components of every layer of a ``[Z, Y, X]`` bool stack:
    each occupied pixel's root flat index within its layer (int32), N = Y*X
    for background; and the iteration count.

    Per iteration: segmented min-scans along rows and columns, one
    8-neighbourhood min, and two pointer jumps."""
    z, y, x = occ.shape
    n = y * x
    idx = torch.arange(n, dtype=_I32, device=occ.device).reshape(1, y, x)
    lab0 = torch.where(occ, idx, n)

    def propagate(lab):
        best = torch.minimum(lab, _segmented_min_scan(lab, occ, n, dim=2))
        best = torch.minimum(best, _segmented_min_scan(best, occ, n, dim=1))
        best = torch.where(occ, best, n)
        for dy, dx in _NEIGHBORS8:
            sh = _shift_with_fill(best, dy, dx, n)
            # labels live only on occupied cells, so chained shifts
            # cannot bridge across background
            best = torch.where(occ, torch.minimum(best, sh), n)
        flat = best.reshape(z, n)
        for _ in range(2):      # follow the candidate root's label twice
            flat = torch.where(
                flat < n, torch.gather(flat, 1, flat.clamp_max(n - 1).long()),
                n)
        return flat.reshape(z, y, x)

    return _fixpoint(propagate, lab0)


def _label_layers(occ_layers: torch.Tensor, max_labels: int):
    z, y, x = occ_layers.shape
    n = y * x
    occ = occ_layers.bool()
    roots, iters = _cc_roots(occ)
    flat_roots = torch.where(occ, roots, n).reshape(z, n).long()
    present = torch.zeros((z, n + 1), dtype=_I32, device=occ.device)
    present.scatter_(1, flat_roots, 1)
    present = present[:, :n]
    rank = torch.cumsum(present, dim=1, dtype=_I32)  # 1-based id at a root
    dense = torch.gather(rank, 1, roots.reshape(z, n).clamp_max(n - 1).long())
    dense = torch.where(occ, dense.reshape(z, y, x), 0)
    labels = dense.clamp_max(max_labels - 1)
    num = (present.sum(dim=1, dtype=_I32) + 1).clamp_max(max_labels)
    return labels, num, iters


def label_layers(occ_layers: torch.Tensor, max_labels: int):
    """Label every ``[Y, X]`` layer of a ``[Z, Y, X]`` bool stack.

    Returns (labels ``[Z, Y, X]`` int32, dense per-layer ids, 0 =
    background; num_labels ``[Z]`` int32 including background). Components
    beyond ``max_labels - 1`` per layer fold into the last id."""
    labels, num, _ = _label_layers(occ_layers, max_labels)
    return labels, num


def layer_connections(labels: torch.Tensor, max_labels: int) -> torch.Tensor:
    """``[Z-1, L, L]`` bool: ``conn[z, a, b]`` = some (x, y) column has label
    a in layer z and label b in layer z+1 (cpp:2180-2188)."""
    z = labels.shape[0]
    l = max_labels
    n = labels[0].numel()
    a = labels[:-1].reshape(z - 1, n).long()
    b = labels[1:].reshape(z - 1, n).long()
    zz = torch.arange(z - 1, device=labels.device)[:, None]
    conn = torch.zeros(((z - 1) * l * l,), dtype=torch.bool,
                       device=labels.device)
    conn[(zz * (l * l) + a * l + b).reshape(-1)] = True
    return conn.reshape(z - 1, l, l)


class MergeResult(NamedTuple):
    merged_of_label: torch.Tensor  # [Z, L] int32 dense merged id (0 = bg)
    num_merged: torch.Tensor       # 0-d int32 (including background)


def _merge_labels(conn: torch.Tensor, num_labels: torch.Tensor,
                  max_labels: int):
    zm1, l, _ = conn.shape
    z = zm1 + 1
    t = z * l
    dev = conn.device
    lab_ids = torch.arange(l, dtype=_I32, device=dev)
    valid = lab_ids[None, :] < num_labels[:, None]             # [Z, L]
    ids = torch.arange(t, dtype=_I32, device=dev)
    glob0 = torch.where(valid, ids.reshape(z, l), t)
    # background only merges with background
    is_bg = lab_ids == 0
    allowed = conn & ~(is_bg[None, :, None] ^ is_bg[None, None, :])

    def propagate(glob):
        ga = glob[:-1][:, :, None]                              # [Z-1, L, 1]
        gb = glob[1:][:, None, :]                               # [Z-1, 1, L]
        pair_min = torch.where(allowed, torch.minimum(ga, gb), t)
        upd_a = pair_min.amin(dim=2)                            # [Z-1, L]
        upd_b = pair_min.amin(dim=1)
        ng = torch.cat([torch.minimum(glob[:-1], upd_a), glob[-1:]])
        ng = torch.cat([ng[:1], torch.minimum(ng[1:], upd_b)])
        flat = ng.reshape(-1)      # pointer jump through the flat table
        flat = torch.where(flat < t, flat[flat.clamp_max(t - 1).long()], t)
        return flat.reshape(z, l)

    glob, iters = _fixpoint(propagate, glob0)
    # dense renumber in ascending root order
    flat = glob.reshape(-1)
    is_root = valid.reshape(-1) & (flat == ids)
    rank = torch.cumsum(is_root.to(_I32), dim=0, dtype=_I32) - 1
    merged = torch.where(valid.reshape(-1), rank[flat.clamp_max(t - 1).long()],
                         0)
    return MergeResult(merged.reshape(z, l),
                       is_root.sum(dtype=_I32)), iters


def merge_labels(conn: torch.Tensor, num_labels: torch.Tensor,
                 max_labels: int) -> MergeResult:
    """Merge per-layer labels across layers to a global object id."""
    return _merge_labels(conn, num_labels, max_labels)[0]


class SegmentationResult(NamedTuple):
    labels: torch.Tensor           # [Z, Y, X] int32 per-layer dense labels
    num_labels: torch.Tensor       # [Z] int32
    merged_of_label: torch.Tensor  # [Z, L] int32
    merged_map: torch.Tensor       # [Z, Y, X] int32 merged id per voxel
    num_merged: torch.Tensor       # 0-d int32 (incl. background id 0)
    # per-object voxel statistics, index = merged id (0 = background):
    voxel_count: torch.Tensor      # [M] int32
    centroid: torch.Tensor         # [M, 3] float32 mean voxel (x, y, z)
    vmin: torch.Tensor             # [M, 3] int32 min voxel coordinate
    vmax: torch.Tensor             # [M, 3] int32 max voxel coordinate
    # port only: iterations of the labeling and the merge fixpoint loops
    iterations: Tuple[int, int] = (0, 0)


def segment_plain(occ_layers: torch.Tensor, max_labels: int,
            max_objects: int) -> SegmentationResult:
    """Full segmentation of a ``[Z, Y, X]`` occupancy stack (bool or
    integer; nonzero = occupied) in plain PyTorch on its device: the twin
    of :func:`segment`'s CUDA chain."""
    occ = occ_layers > 0
    z, y, x = occ.shape
    dev = occ.device
    labels, num_labels, cc_iters = _label_layers(occ, max_labels)
    conn = layer_connections(labels, max_labels)
    mr, merge_iters = _merge_labels(conn, num_labels, max_labels)

    l = max_labels
    flat_lab = (torch.arange(z, dtype=_I32, device=dev)[:, None, None] * l
                + labels)
    merged_map = mr.merged_of_label.reshape(-1)[flat_lab.long()]

    m = max_objects
    # stats over occupied voxels; the rest go to slot m, sliced off
    ids = torch.where(occ, merged_map.clamp_max(m - 1), m).reshape(-1).long()
    coords = [torch.arange(n, dtype=_I32, device=dev).reshape(shape)
              .expand(z, y, x).reshape(-1)
              for n, shape in ((x, (1, 1, x)), (y, (1, y, 1)),
                               (z, (z, 1, 1)))]
    count = torch.bincount(ids, minlength=m + 1)[:m].to(_I32)
    sums = torch.stack([torch.zeros(m + 1, dtype=torch.int64, device=dev)
                        .index_add_(0, ids, c.long())[:m] for c in coords], 1)
    centroid = (sums.to(torch.float32)
                / count.clamp_min(1).to(torch.float32)[:, None])
    big = torch.iinfo(_I32).max
    vmin = torch.stack([torch.full((m + 1,), big, dtype=_I32, device=dev)
                        .scatter_reduce_(0, ids, c, "amin")[:m]
                        for c in coords], 1)
    vmax = torch.stack([torch.full((m + 1,), -big, dtype=_I32, device=dev)
                        .scatter_reduce_(0, ids, c, "amax")[:m]
                        for c in coords], 1)
    seen = count[:, None] > 0
    return SegmentationResult(
        labels=labels, num_labels=num_labels,
        merged_of_label=mr.merged_of_label, merged_map=merged_map,
        num_merged=mr.num_merged, voxel_count=count, centroid=centroid,
        vmin=torch.where(seen, vmin, 0), vmax=torch.where(seen, vmax, -1),
        iterations=(cc_iters, merge_iters))


class _Args(ctypes.Structure):
    """``fusion::seg::Args`` of csrc/segment.cu."""
    _fields_ = [(name, ctypes.c_void_p) for name in (
        "occ", "labels", "num_labels", "merged_of_label", "num_merged",
        "merged_map", "voxel_count", "centroid", "vmin", "vmax", "parent",
        "rows", "conn", "acc_sum", "acc_int")] + [
        (name, ctypes.c_int) for name in ("Z", "Y", "X", "L", "M")]


def check_chain_input(occ_layers, max_labels: int, max_objects: int,
                      shared_optin: int) -> None:
    """Raise ``ValueError`` naming what the CUDA chain does not take, on a
    device whose blocks may opt in to ``shared_optin`` bytes of shared
    memory: it takes a contiguous bool or uint8 ``[Z, Y, X]`` tensor with
    Z <= 65535 and Y <= 65535 * 32 (the tile grid), X <= 2^27 (a warp sums
    32 coordinates in 32 bits) and fewer than 2^30 voxels (32-bit
    indices), every extent at least 1; ``max_labels`` and ``max_objects``
    at least 1 and within :func:`chain_limits`. csrc/segment.cu checks
    none of it."""
    t = occ_layers
    if not isinstance(t, torch.Tensor) or t.ndim != 3:
        raise ValueError(f"segment: the occupancy must be a [Z, Y, X] "
                         f"tensor, got {getattr(t, 'shape', type(t))}")
    if t.dtype not in (torch.bool, torch.uint8):
        raise ValueError(f"segment: the CUDA chain takes a bool or uint8 "
                         f"occupancy, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError("segment: the CUDA chain takes a contiguous "
                         "occupancy")
    z, y, x = t.shape
    if (min(z, y, x) < 1 or z > 65535 or y > 65535 * 32 or x > 2 ** 27
            or z * y * x >= 2 ** 30):
        raise ValueError(f"segment: the CUDA chain takes 1 <= Z <= 65535, "
                         f"1 <= Y <= {65535 * 32}, 1 <= X <= 2^27 and fewer "
                         f"than 2^30 voxels, got {tuple(t.shape)}")
    if max_labels < 1 or max_objects < 1:
        raise ValueError(f"segment: max_labels {max_labels} and max_objects "
                         f"{max_objects} must be at least 1")
    max_table, max_slots = chain_limits(shared_optin)
    if z * max_labels > max_table:
        raise ValueError(f"segment: the merge table Z x max_labels = {z} x "
                         f"{max_labels} exceeds the {max_table} labels one "
                         f"block's shared memory holds")
    if max_objects > max_slots:
        raise ValueError(f"segment: max_objects {max_objects} exceeds the "
                         f"{max_slots} slots one block's shared memory "
                         f"holds")


def segment(occ_layers: torch.Tensor, max_labels: int,
            max_objects: int) -> SegmentationResult:
    """Full segmentation of a ``[Z, Y, X]`` occupancy stack (nonzero =
    occupied) on its device.

    A CPU tensor (bool or integer) runs :func:`segment_plain`. A CUDA
    tensor (bool or uint8, contiguous: :func:`check_chain_input`) launches
    the kernel chain of csrc/segment.cu on the current stream, built on
    first use, or raises ``ValueError``; it never waits for the device.
    Every field equals the twin's bit for bit but ``iterations``, which
    the chain reports as ``(0, 0)``: it runs no fixpoint on the host.
    Components beyond ``max_labels - 1`` in a layer fold into the last
    label, objects beyond ``max_objects - 1`` into the last slot."""
    dev = occ_layers.device
    if dev.type == "cpu":
        return segment_plain(occ_layers, max_labels, max_objects)
    if dev.type != "cuda":
        raise ValueError(f"segment: unsupported device {dev}")
    check_chain_input(occ_layers, max_labels, max_objects,
                      torch.cuda.get_device_properties(dev)
                      .shared_memory_per_block_optin)
    from ros_gpu_depthmap_fusion_tpu_torch.ops.kernels import _build
    fn = _build.function("fusion_segment",
                         (ctypes.POINTER(_Args), ctypes.c_void_p))
    z, y, x = occ_layers.shape
    l, m = max_labels, max_objects

    def empty(shape, dtype=_I32):
        return torch.empty(shape, dtype=dtype, device=dev)

    # the kernels write every element of every output and initialize the
    # scratch they read
    labels, merged_map = empty((z, y, x)), empty((z, y, x))
    num_labels, mol, num_merged = empty((z,)), empty((z, l)), empty(())
    count, centroid = empty((m,)), empty((m, 3), torch.float32)
    vmin, vmax = empty((m, 3)), empty((m, 3))
    parent, rows = empty((z, y * x)), empty((z, y))
    conn = empty((max(z - 1, 1) * l * ((l + 31) // 32),))
    acc_sum, acc_int = empty((m, 3), torch.int64), empty((m, 7))
    p = torch.Tensor.data_ptr
    args = _Args(*map(p, (occ_layers, labels, num_labels, mol, num_merged,
                          merged_map, count, centroid, vmin, vmax, parent,
                          rows, conn, acc_sum, acc_int)), z, y, x, l, m)
    status = fn(ctypes.byref(args), _build.stream_ptr(occ_layers))
    _build.check(status, "segment")
    global launches
    launches += CHAIN_LAUNCHES
    profiling.count("fusion.mapping.segment_kernel_cycles")
    return SegmentationResult(
        labels=labels, num_labels=num_labels, merged_of_label=mol,
        merged_map=merged_map, num_merged=num_merged, voxel_count=count,
        centroid=centroid, vmin=vmin, vmax=vmax, iterations=(0, 0))


# --- the foreground grouping (csrc/group.cu) ---------------------------------

#: launches of the CUDA kernels by :func:`group_foreground` in this process
group_launches = 0


class ForegroundGroups(NamedTuple):
    """The foreground of a segmentation grouped by (object, layer): cells
    whose merged id m lies in ``[1, num_merged)``. ``rows`` holds, back to
    back with M = num_merged: ``group_start`` ``[M * Z + 1]`` (group
    (m, z)'s first row, groups in (m, z) order), ``xy`` ``[fg, 2]`` (each
    cell's (x, y), raster order within a group) and ``comps``
    ``[ncomp, 4]`` ((z, l, m, first raster index in the layer) of each
    component (z, l > 0) holding such a cell, in ascending (z, l)); past
    them its contents are unspecified. :func:`grouping_arrays` splits a
    host copy."""
    counts: torch.Tensor   # [2] int32: fg, ncomp
    rows: torch.Tensor     # [group_capacity(Z, Y, X, L)] int32


def group_capacity(z: int, y: int, x: int, l: int) -> int:
    """Rows :func:`group_foreground` may fill: group starts for up to
    ``Z * L`` merged ids, every cell's (x, y), every label's component."""
    return z * l * z + 1 + 2 * z * y * x + 4 * z * l


def group_rows_used(fg: int, ncomp: int, num_merged: int, z: int) -> int:
    """Rows of ``ForegroundGroups.rows`` that hold the grouping."""
    return num_merged * z + 1 + 2 * fg + 4 * ncomp


def group_launches_per_call(z: int, l: int) -> int:
    """Kernels :func:`group_foreground` launches on a CUDA device (after a
    memset): the compaction, three a radix pass over merged ids below
    ``Z * L`` (8 bits a pass, at least one), the finish."""
    return 2 + 3 * max(1, -(-(z * l - 1).bit_length() // 8))


def grouping_arrays(fg: int, ncomp: int, num_merged: int, z: int,
                    rows) -> dict:
    """The host copy of a grouping's used rows (numpy int32, at least
    :func:`group_rows_used`) as ``build_objects``' ``grouping``:
    ``group_start`` int64 ``[M * Z + 1]``, ``pts_xy`` int32 ``[fg, 2]``
    and ``comps`` int32 ``[ncomp, 4]``, views of ``rows`` but the
    first."""
    ng = num_merged * z + 1
    return dict(group_start=rows[:ng].astype(np.int64),
                pts_xy=rows[ng:ng + 2 * fg].reshape(fg, 2),
                comps=rows[ng + 2 * fg:ng + 2 * fg + 4 * ncomp]
                .reshape(ncomp, 4))


def group_foreground_plain(seg: SegmentationResult) -> ForegroundGroups:
    """Plain PyTorch twin of :func:`group_foreground` (a stable sort of
    the foreground's flat indices by (m, z)), on the segmentation's
    device; the rows past the grouping are zero."""
    mm = seg.merged_map
    z, y, x = mm.shape
    l = seg.merged_of_label.shape[1]
    dev = mm.device
    m_n = int(seg.num_merged)
    hw = y * x
    flat = mm.reshape(-1)
    g = torch.nonzero((flat >= 1) & (flat < m_n)).squeeze(1)
    layer, pix = g // hw, g % hw
    key, order = torch.sort(flat[g].long() * z + layer, stable=True)
    starts = torch.searchsorted(
        key, torch.arange(m_n * z + 1, dtype=torch.long, device=dev))
    p = pix[order]
    xy = torch.stack([p % x, p // x], 1)
    lab = seg.labels.reshape(-1)[g].long()
    has = (lab > 0) & (lab < l)
    first = torch.full((z * l,), hw, dtype=torch.long, device=dev)
    first.scatter_reduce_(0, (layer * l + lab)[has], pix[has], "amin")
    ci = torch.nonzero(first < hw).squeeze(1)
    comps = torch.stack([ci // l, ci % l,
                         seg.merged_of_label.reshape(-1)[ci].long(),
                         first[ci]], 1)
    used = torch.cat([starts, xy.reshape(-1), comps.reshape(-1)])
    rows = torch.zeros(group_capacity(z, y, x, l), dtype=_I32, device=dev)
    rows[:used.numel()] = used.to(_I32)
    return ForegroundGroups(
        torch.tensor([g.numel(), ci.numel()], dtype=_I32, device=dev), rows)


@functools.lru_cache(maxsize=None)
def _group_entries():
    """csrc/group.cu's scratch size and launch entries."""
    from ros_gpu_depthmap_fusion_tpu_torch.ops.kernels import _build
    size = _build.library().fusion_group_scratch_bytes
    size.argtypes = [ctypes.c_int] * 4
    size.restype = ctypes.c_longlong
    return size, _build.function("fusion_group", (ctypes.c_void_p,) * 4
                                 + (ctypes.c_int,) * 4
                                 + (ctypes.c_void_p,) * 4)


def group_foreground(seg: SegmentationResult) -> ForegroundGroups:
    """Group the foreground of ``seg`` (a :func:`segment` result) by
    (object, layer) on its device, for the host's object assembly.

    A CPU segmentation runs :func:`group_foreground_plain`. A CUDA one
    launches csrc/group.cu on the current stream (a memset and
    :func:`group_launches_per_call` kernels), built on first use; it never
    waits for the device. Raises ``ValueError`` on a grid whose rows
    would not fit 32-bit indices."""
    dev = seg.merged_map.device
    if dev.type == "cpu":
        return group_foreground_plain(seg)
    if dev.type != "cuda":
        raise ValueError(f"group_foreground: unsupported device {dev}")
    z, y, x = seg.merged_map.shape
    l = seg.merged_of_label.shape[1]
    cap = group_capacity(z, y, x, l)
    if cap >= 2 ** 31:
        raise ValueError(f"group_foreground: {cap} rows for a "
                         f"{(z, y, x)} grid of {l} labels a layer exceed "
                         f"32-bit indices")
    for name in ("labels", "merged_map", "merged_of_label", "num_merged"):
        t = getattr(seg, name)
        if t.dtype != _I32 or not t.is_contiguous() or t.device != dev:
            raise ValueError(f"group_foreground: {name} must be a "
                             f"contiguous int32 tensor on {dev}")
    from ros_gpu_depthmap_fusion_tpu_torch.ops.kernels import _build
    scratch_bytes, fn = _group_entries()
    scratch = torch.empty((scratch_bytes(z, y, x, l),), dtype=torch.uint8,
                          device=dev)
    counts = torch.empty((2,), dtype=_I32, device=dev)
    rows = torch.empty((cap,), dtype=_I32, device=dev)
    p = _build.ptr
    status = fn(p(seg.labels), p(seg.merged_map), p(seg.merged_of_label),
                p(seg.num_merged), z, y, x, l, p(scratch), p(counts),
                p(rows), _build.stream_ptr(seg.merged_map))
    _build.check(status, "group_foreground")
    global group_launches
    group_launches += group_launches_per_call(z, l)
    return ForegroundGroups(counts, rows)
