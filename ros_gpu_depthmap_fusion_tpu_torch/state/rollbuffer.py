"""Historic point-sequence rollbuffer.

Fixed-capacity form of the reference's rollbuffer SSBO group
(``gpu_depthmap_fusion.h:402-416``), with the reference's CPU paths as the
behavioural spec:

- insert:    ``insertNewPointSequencesInRollbuffer`` (cpp:979-1087)
- expiry:    ``rollPointSequenceRollbufferCPU``      (cpp:1098-1217)
- selection: ``selectPointSequenceTimespanCPU``      (cpp:1358-1416)
- transform: ``insertSelectedPointSequence`` + ``transformPointSequence``
             (cpp:1509-1581)

The engine step runs the whole chain, with the point-sequence filter of
the staged batch in front, through :func:`advance_and_gather`: two
launches of a hand-written CUDA kernel pair (``csrc/lidar_stages.cu``) for
CUDA tensors, and its plain twin :func:`advance_and_gather_plain`, the five
calls above, for CPU tensors.

Every array has a static capacity and the live extents are int32 0-d
tensors on the buffer's device, so no function here waits for the device.
Sequences are stored contiguous and time-ordered (inserts clamp a late
timestamp forward). Functions return new tensors; the input buffer is not
modified.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import torch

from ros_gpu_depthmap_fusion_tpu_torch.core import transforms
from ros_gpu_depthmap_fusion_tpu_torch.core.devconst import scalar_f32
from ros_gpu_depthmap_fusion_tpu_torch.ops.stencil import (
    filter_point_sequence)
from ros_gpu_depthmap_fusion_tpu_torch.utils import profiling

#: launches of the CUDA kernels by :func:`advance_and_gather` in this
#: process
launches = 0


def time_lt(a_sec, a_nsec, b_sec, b_nsec):
    """Lexicographic (sec, nsec) less-than (reference compareTime < 0)."""
    return (a_sec < b_sec) | ((a_sec == b_sec) & (a_nsec < b_nsec))


def time_le(a_sec, a_nsec, b_sec, b_nsec):
    return (a_sec < b_sec) | ((a_sec == b_sec) & (a_nsec <= b_nsec))


class RollBuffer(NamedTuple):
    """Point slots [0, num_points) and sequence slots [0, num_seqs) are
    live; sequence i owns points [seq_start[i], seq_start[i] +
    seq_count[i])."""

    points: torch.Tensor      # [P, 4] float32, sensor-frame homogeneous
    mask: torch.Tensor        # [P] bool (post sequence-filter validity)
    seq_idx: torch.Tensor     # [P] int32, owning sequence slot per point
    seq_sec: torch.Tensor     # [S] int32
    seq_nsec: torch.Tensor    # [S] int32
    seq_start: torch.Tensor   # [S] int32
    seq_count: torch.Tensor   # [S] int32
    seq_tf_move: torch.Tensor  # [S, 4, 4] float32, move <- capture frame
    num_points: torch.Tensor  # 0-d int32
    num_seqs: torch.Tensor    # 0-d int32

    @property
    def point_capacity(self) -> int:
        return self.points.shape[0]

    @property
    def seq_capacity(self) -> int:
        return self.seq_sec.shape[0]


def _take1(x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """``x[i]`` for a 0-d index tensor, without a host sync."""
    return x[i.reshape(1).long()].reshape(x.shape[1:])


def _shift_rows(x: torch.Tensor, shift, fill_value=0, length=None):
    """``out[i] = x[i + shift]`` for i < ``length`` (default len(x)), and
    ``fill_value`` past the end of ``x``."""
    n = x.shape[0]
    length = n if length is None else length
    src = (torch.arange(length, device=x.device)
           + torch.clamp(torch.as_tensor(shift, device=x.device), 0, n))
    inside = (src < n).reshape((length,) + (1,) * (x.ndim - 1))
    return torch.where(inside, x[torch.clamp_max(src, n - 1)], fill_value)


def _write_block(x: torch.Tensor, block: torch.Tensor, offset,
                 n_live) -> torch.Tensor:
    """``x`` with rows ``[offset, offset + n_live)`` replaced by
    ``block[:n_live]`` (rows past the end of ``x`` are dropped)."""
    cap, m = x.shape[0], block.shape[0]
    src = torch.arange(cap, device=x.device) - torch.clamp(
        torch.as_tensor(offset, device=x.device), 0, cap)
    take = (src >= 0) & (src < n_live) & (src < m)
    take = take.reshape((cap,) + (1,) * (x.ndim - 1))
    return torch.where(take, block[torch.clamp(src, 0, m - 1)].to(x.dtype),
                       x)


def _set_drop(x: torch.Tensor, idx: torch.Tensor,
              vals: torch.Tensor) -> torch.Tensor:
    """``x`` with ``x[idx] = vals``; indices equal to ``len(x)`` drop."""
    ext = torch.cat([x, x[:1]])
    ext[idx.long()] = vals.to(x.dtype)
    return ext[:-1]


def make_rollbuffer(point_capacity: int, seq_capacity: int,
                    device) -> RollBuffer:
    z = dict(dtype=torch.int32, device=device)
    return RollBuffer(
        points=torch.zeros((point_capacity, 4), dtype=torch.float32,
                           device=device),
        mask=torch.zeros((point_capacity,), dtype=torch.bool,
                         device=device),
        seq_idx=torch.zeros((point_capacity,), **z),
        seq_sec=torch.zeros((seq_capacity,), **z),
        seq_nsec=torch.zeros((seq_capacity,), **z),
        seq_start=torch.zeros((seq_capacity,), **z),
        seq_count=torch.zeros((seq_capacity,), **z),
        seq_tf_move=torch.eye(4, dtype=torch.float32, device=device)
        .repeat(seq_capacity, 1, 1),
        num_points=torch.zeros((), **z),
        num_seqs=torch.zeros((), **z),
    )


def insert_sequences(rb: RollBuffer,
                     new_points: torch.Tensor,
                     new_mask: torch.Tensor,
                     new_seq_idx: torch.Tensor,
                     new_seq_sec: torch.Tensor,
                     new_seq_nsec: torch.Tensor,
                     new_seq_count: torch.Tensor,
                     new_seq_tf_move: torch.Tensor,
                     num_new_points,
                     num_new_seqs) -> Tuple[RollBuffer, torch.Tensor]:
    """Append a staging batch of sequences (reference
    insertNewPointSequencesInRollbuffer, cpp:979-1087).

    ``new_seq_idx`` numbers each new point's sequence 0-based within the
    batch; ``new_seq_count`` gives points per new sequence; new points are
    concatenated in sequence order. A sequence that does not fit whole is
    dropped with all that follow it.

    Returns (buffer, overflowed — a bool 0-d tensor).
    """
    dev = rb.points.device
    p_cap, s_cap = rb.point_capacity, rb.seq_capacity
    i32 = torch.int32
    s_idx = torch.arange(new_seq_sec.shape[0], dtype=i32, device=dev)

    fit_seqs = torch.minimum(torch.as_tensor(num_new_seqs, device=dev),
                             s_cap - rb.num_seqs)
    new_counts_live = torch.where(s_idx < fit_seqs, new_seq_count, 0)
    fit_points_by_seq = new_counts_live.sum(dtype=i32)
    fit_points = torch.minimum(fit_points_by_seq, p_cap - rb.num_points)
    # a sequence cut by the point capacity is dropped whole
    cum = torch.cumsum(new_counts_live, 0, dtype=i32)
    fit_seqs = ((cum <= fit_points) & (s_idx < fit_seqs)).sum(dtype=i32)
    fit_points = torch.where(s_idx < fit_seqs, new_seq_count, 0).sum(
        dtype=i32)
    overflow = (fit_seqs < num_new_seqs) | (fit_points_by_seq > fit_points)

    points = _write_block(rb.points, new_points, rb.num_points, fit_points)
    mask = _write_block(rb.mask, new_mask, rb.num_points, fit_points)
    seq_idx = _write_block(rb.seq_idx, new_seq_idx + rb.num_seqs,
                           rb.num_points, fit_points)

    # monotone-time invariant: clamp each appended timestamp to at least
    # the buffer's latest (the reference relies on arrival order)
    last = torch.clamp_min(rb.num_seqs - 1, 0)
    has = rb.num_seqs > 0
    last_sec = torch.where(has, _take1(rb.seq_sec, last), -2 ** 31 + 1)
    last_nsec = torch.where(has, _take1(rb.seq_nsec, last), 0)
    behind = time_lt(new_seq_sec, new_seq_nsec, last_sec, last_nsec)
    eff_sec = torch.where(behind, last_sec, new_seq_sec)
    eff_nsec = torch.where(behind, last_nsec, new_seq_nsec)

    excl = torch.cumsum(new_seq_count, 0, dtype=i32) - new_seq_count
    stgt = torch.where(s_idx < fit_seqs, rb.num_seqs + s_idx, s_cap)
    return rb._replace(
        points=points, mask=mask, seq_idx=seq_idx,
        seq_sec=_set_drop(rb.seq_sec, stgt, eff_sec),
        seq_nsec=_set_drop(rb.seq_nsec, stgt, eff_nsec),
        seq_start=_set_drop(rb.seq_start, stgt, rb.num_points + excl),
        seq_count=_set_drop(rb.seq_count, stgt, new_seq_count),
        seq_tf_move=_set_drop(rb.seq_tf_move, stgt, new_seq_tf_move),
        num_points=(rb.num_points + fit_points).to(i32),
        num_seqs=(rb.num_seqs + fit_seqs).to(i32),
    ), overflow


def roll(rb: RollBuffer, min_sec, min_nsec) -> RollBuffer:
    """Expire sequences older than (min_sec, min_nsec) — reference
    rollPointSequenceRollbufferCPU (cpp:1098-1217): discard the leading
    expired sequences, shift the rest to the front and rebase point
    sequence indices and start offsets."""
    dev = rb.points.device
    i32 = torch.int32
    p_cap, s_cap = rb.point_capacity, rb.seq_capacity
    s_idx = torch.arange(s_cap, dtype=i32, device=dev)
    p_idx = torch.arange(p_cap, dtype=i32, device=dev)
    expired = (s_idx < rb.num_seqs) & time_lt(rb.seq_sec, rb.seq_nsec,
                                              min_sec, min_nsec)
    n_disc_seqs = expired.sum(dtype=i32)
    n_disc_pts = torch.where(expired, rb.seq_count, 0).sum(dtype=i32)

    num_points = rb.num_points - n_disc_pts
    num_seqs = rb.num_seqs - n_disc_seqs
    live_p = p_idx < num_points
    live_s = s_idx < num_seqs
    eye = torch.eye(4, dtype=torch.float32, device=dev)
    return rb._replace(
        points=torch.where(live_p[:, None],
                           _shift_rows(rb.points, n_disc_pts), 0.0),
        mask=_shift_rows(rb.mask, n_disc_pts, False) & live_p,
        seq_idx=torch.where(live_p,
                            _shift_rows(rb.seq_idx, n_disc_pts)
                            - n_disc_seqs, 0),
        seq_sec=torch.where(live_s, _shift_rows(rb.seq_sec, n_disc_seqs), 0),
        seq_nsec=torch.where(live_s, _shift_rows(rb.seq_nsec, n_disc_seqs),
                             0),
        seq_start=torch.where(live_s, _shift_rows(rb.seq_start, n_disc_seqs)
                              - n_disc_pts, 0),
        seq_count=torch.where(live_s, _shift_rows(rb.seq_count, n_disc_seqs),
                              0),
        seq_tf_move=torch.where(live_s[:, None, None],
                                _shift_rows(rb.seq_tf_move, n_disc_seqs),
                                eye),
        num_points=num_points, num_seqs=num_seqs,
    )


class Selection(NamedTuple):
    point_start: torch.Tensor
    point_count: torch.Tensor
    seq_start: torch.Tensor
    seq_count: torch.Tensor


def select_timespan(rb: RollBuffer, min_sec, min_nsec, max_sec, max_nsec
                    ) -> Selection:
    """Contiguous window of sequences with min <= t <= max (reference
    selectPointSequenceTimespanCPU, cpp:1358-1416)."""
    i32 = torch.int32
    s_idx = torch.arange(rb.seq_capacity, dtype=i32,
                         device=rb.points.device)
    inside = ((s_idx < rb.num_seqs)
              & ~time_lt(rb.seq_sec, rb.seq_nsec, min_sec, min_nsec)
              & time_le(rb.seq_sec, rb.seq_nsec, max_sec, max_nsec))
    any_inside = inside.any()
    first = torch.argmax(inside.to(i32))   # first True (0 if none)
    return Selection(
        point_start=torch.where(any_inside, _take1(rb.seq_start, first),
                                0).to(i32),
        point_count=torch.where(inside, rb.seq_count, 0).sum(dtype=i32),
        seq_start=torch.where(any_inside, first.to(i32), rb.num_seqs),
        seq_count=inside.sum(dtype=i32))


def gather_selection(rb: RollBuffer,
                     sel: Selection,
                     tf_world_move: torch.Tensor,
                     tf_crop_move: torch.Tensor,
                     capacity: int):
    """Materialize a selection window: per-point world/crop coordinates and
    mask (insertSelectedPointSequence + transformPointSequence,
    cpp:1509-1581). Per-sequence transforms are composed as
    ``T_frame<-move @ T_move<-seq``.

    Returns (points_world ``[capacity, 4]``, points_crop, mask, count).
    """
    if capacity > rb.point_capacity:
        raise ValueError(f"selection capacity {capacity} exceeds the "
                         f"buffer's {rb.point_capacity}")
    dev = rb.points.device
    s_cap = rb.seq_capacity
    live = torch.arange(capacity, device=dev) < sel.point_count
    pts = _shift_rows(rb.points, sel.point_start, length=capacity)
    msk = _shift_rows(rb.mask, sel.point_start, False, length=capacity) \
        & live
    tf_idx = torch.clamp(
        _shift_rows(rb.seq_idx, sel.point_start, length=capacity)
        - sel.seq_start, 0, s_cap - 1)
    win = torch.clamp(torch.arange(s_cap, device=dev) + sel.seq_start,
                      0, s_cap - 1)
    seq_tfs = rb.seq_tf_move[win]
    tfs_world = transforms.compose_seq_transforms(tf_world_move, seq_tfs)
    tfs_crop = transforms.compose_seq_transforms(tf_crop_move, seq_tfs)
    m4 = msk[:, None]
    pw = torch.where(m4, transforms.transform_points_indirect(
        pts, tfs_world, tf_idx, msk), 0.0)
    pc = torch.where(m4, transforms.transform_points_indirect(
        pts, tfs_crop, tf_idx, msk), 0.0)
    return pw, pc, msk, sel.point_count


def advance_and_gather_plain(rb: RollBuffer, seq_batch, ps_threshold,
                             filter_size: int, roll_min, now,
                             tf_world_move: torch.Tensor,
                             tf_crop_move: torch.Tensor, capacity: int):
    """Plain PyTorch twin of :func:`advance_and_gather`: the staged batch
    filtered (:func:`ops.stencil.filter_point_sequence`), then
    :func:`insert_sequences`, :func:`roll`, :func:`select_timespan` and
    :func:`gather_selection`; same contract, any device."""
    sb = seq_batch
    staged = torch.arange(sb.points.shape[0], dtype=torch.int32,
                          device=sb.points.device) < sb.num_points
    seq_mask = filter_point_sequence(sb.points, staged, sb.num_points,
                                     filter_size, ps_threshold)
    rb, _ = insert_sequences(
        rb, sb.points, seq_mask, sb.seq_idx, sb.seq_sec, sb.seq_nsec,
        sb.seq_count, sb.seq_tf_move, sb.num_points, sb.num_seqs)
    rb = roll(rb, *roll_min)
    sel = select_timespan(rb, *roll_min, *now)
    world, crop, valid, _ = gather_selection(rb, sel, tf_world_move,
                                             tf_crop_move, capacity)
    return rb, (world, crop, valid), sel


class _Args(ctypes.Structure):
    """``fusion::lidar::Args`` of ``csrc/lidar_stages.cu``."""
    _fields_ = [(name, ctypes.c_void_p) for name in (
        "points", "mask", "seq_idx", "seq_sec", "seq_nsec", "seq_start",
        "seq_count", "seq_tf", "num_points", "num_seqs",
        "st_points", "st_seq_idx", "st_sec", "st_nsec", "st_count", "st_tf",
        "st_num_points", "st_num_seqs",
        "threshold", "min_sec", "min_nsec", "max_sec", "max_nsec",
        "tf_world_move", "tf_crop_move",
        "o_points", "o_mask", "o_seq_idx", "o_sec", "o_nsec", "o_start",
        "o_count", "o_tf", "plan", "tfs", "g_world", "g_crop", "g_valid")] \
        + [(name, ctypes.c_int) for name in (
            "P", "S", "SP", "SS", "capacity", "filter_size")]


# ``enum Plan`` of csrc/lidar_stages.cu: the words of the plan record that
# the new state and the selection read, and the record's length (the
# staged batch's count prefix follows it)
_NUM_POINTS, _NUM_SEQS, _SEL_START, _PLAN_INTS = 7, 8, 9, 16


def _check(name: str, t, dtype, shape, dev) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor on ``dev`` of
    ``shape`` (a one-element tensor where ``shape`` is ``()``)."""
    ok = (isinstance(t, torch.Tensor) and t.dtype == dtype
          and t.device == dev and t.is_contiguous()
          and (t.numel() == 1 if shape == () else t.shape == shape))
    if not ok:
        got = (f"{t.dtype} {tuple(t.shape)} on {t.device}"
               if isinstance(t, torch.Tensor) else type(t).__name__)
        raise ValueError(f"advance_and_gather: {name} must be a contiguous "
                         f"{dtype} tensor of shape {shape} on {dev}, got "
                         f"{got}")


def advance_and_gather(rb: RollBuffer, seq_batch, ps_threshold,
                       filter_size: int, roll_min, now,
                       tf_world_move: torch.Tensor,
                       tf_crop_move: torch.Tensor, capacity: int,
                       plain: bool = False):
    """The engine step's lidar stages 1-5: filter the staged batch along
    its scan order, insert it, expire sequences older than ``roll_min``,
    select the window ``[roll_min, now]`` and gather it in world and crop
    coordinates.

    Args:
        rb: the buffer the step starts from (not modified).
        seq_batch: the staged batch (``pipeline.engine.SequenceBatch``:
            ``points [SP, 4]``, ``seq_idx [SP]``, ``seq_sec``,
            ``seq_nsec``, ``seq_count [SS]``, ``seq_tf_move [SS, 4, 4]``,
            ``num_points``, ``num_seqs``).
        ps_threshold: the filter's threshold (0-d float32 tensor).
        filter_size: the filter's neighbour span.
        roll_min, now: ``(sec, nsec)`` pairs of 0-d int32 tensors.
        tf_world_move, tf_crop_move: ``[4, 4]`` frame <- move transforms.
        capacity: rows gathered, at most the buffer's point capacity.
        plain: run the twin even on CUDA tensors.

    Returns:
        (new buffer, (points_world ``[capacity, 4]``, points_crop,
        valid ``[capacity]`` bool), :class:`Selection`).

    CPU tensors, or ``plain=True``, run :func:`advance_and_gather_plain`;
    CUDA tensors launch the kernel pair (built on first use), bit-equal to
    the twin, or raise. Every output is freshly allocated.
    """
    dev = rb.points.device
    if plain or dev.type == "cpu":
        return advance_and_gather_plain(rb, seq_batch, ps_threshold,
                                        filter_size, roll_min, now,
                                        tf_world_move, tf_crop_move,
                                        capacity)
    if dev.type != "cuda":
        raise ValueError(f"advance_and_gather: unsupported device {dev}")
    f32, i32, b8 = torch.float32, torch.int32, torch.bool
    p_cap, s_cap = rb.point_capacity, rb.seq_capacity
    sb = seq_batch
    sp, ss = sb.points.shape[0], sb.seq_sec.shape[0]
    if not 1 <= capacity <= p_cap or p_cap > 2 ** 29 or s_cap < 1 \
            or sp < 1 or ss < 1:
        raise ValueError(f"advance_and_gather: unsupported capacity "
                         f"{capacity}, buffer {p_cap} points / {s_cap} "
                         f"sequences, batch {sp} points / {ss} sequences")
    threshold = scalar_f32(ps_threshold, dev)
    for name, t, dtype, shape in (
            ("rb.points", rb.points, f32, (p_cap, 4)),
            ("rb.mask", rb.mask, b8, (p_cap,)),
            ("rb.seq_idx", rb.seq_idx, i32, (p_cap,)),
            ("rb.seq_sec", rb.seq_sec, i32, (s_cap,)),
            ("rb.seq_nsec", rb.seq_nsec, i32, (s_cap,)),
            ("rb.seq_start", rb.seq_start, i32, (s_cap,)),
            ("rb.seq_count", rb.seq_count, i32, (s_cap,)),
            ("rb.seq_tf_move", rb.seq_tf_move, f32, (s_cap, 4, 4)),
            ("rb.num_points", rb.num_points, i32, ()),
            ("rb.num_seqs", rb.num_seqs, i32, ()),
            ("seq_batch.points", sb.points, f32, (sp, 4)),
            ("seq_batch.seq_idx", sb.seq_idx, i32, (sp,)),
            ("seq_batch.seq_sec", sb.seq_sec, i32, (ss,)),
            ("seq_batch.seq_nsec", sb.seq_nsec, i32, (ss,)),
            ("seq_batch.seq_count", sb.seq_count, i32, (ss,)),
            ("seq_batch.seq_tf_move", sb.seq_tf_move, f32, (ss, 4, 4)),
            ("seq_batch.num_points", sb.num_points, i32, ()),
            ("seq_batch.num_seqs", sb.num_seqs, i32, ()),
            ("ps_threshold", threshold, f32, ()),
            ("roll_min[0]", roll_min[0], i32, ()),
            ("roll_min[1]", roll_min[1], i32, ()),
            ("now[0]", now[0], i32, ()),
            ("now[1]", now[1], i32, ()),
            ("tf_world_move", tf_world_move, f32, (4, 4)),
            ("tf_crop_move", tf_crop_move, f32, (4, 4))):
        _check(name, t, dtype, shape, dev)
    from ros_gpu_depthmap_fusion_tpu_torch.ops.kernels import _build
    fn = _build.function("fusion_lidar_stages",
                         (ctypes.POINTER(_Args), ctypes.c_void_p))

    def empty(shape, dtype):
        return torch.empty(shape, dtype=dtype, device=dev)

    # the kernels write every element of every output
    plan = empty((_PLAN_INTS + ss,), i32)
    new = RollBuffer(
        points=empty((p_cap, 4), f32), mask=empty((p_cap,), b8),
        seq_idx=empty((p_cap,), i32), seq_sec=empty((s_cap,), i32),
        seq_nsec=empty((s_cap,), i32), seq_start=empty((s_cap,), i32),
        seq_count=empty((s_cap,), i32),
        seq_tf_move=empty((s_cap, 4, 4), f32),
        num_points=plan[_NUM_POINTS], num_seqs=plan[_NUM_SEQS])
    tfs = empty((2, s_cap, 4, 4), f32)
    world, crop = empty((capacity, 4), f32), empty((capacity, 4), f32)
    valid = empty((capacity,), b8)
    p = torch.Tensor.data_ptr
    args = _Args(
        *map(p, (rb.points, rb.mask, rb.seq_idx, rb.seq_sec, rb.seq_nsec,
                 rb.seq_start, rb.seq_count, rb.seq_tf_move, rb.num_points,
                 rb.num_seqs, sb.points, sb.seq_idx, sb.seq_sec, sb.seq_nsec,
                 sb.seq_count, sb.seq_tf_move, sb.num_points, sb.num_seqs,
                 threshold, roll_min[0], roll_min[1], now[0], now[1],
                 tf_world_move, tf_crop_move, new.points, new.mask,
                 new.seq_idx, new.seq_sec, new.seq_nsec, new.seq_start,
                 new.seq_count, new.seq_tf_move, plan, tfs, world, crop,
                 valid)),
        p_cap, s_cap, sp, ss, capacity, filter_size)
    status = fn(ctypes.byref(args), _build.stream_ptr(rb.points))
    _build.check(status, "advance_and_gather")
    global launches
    launches += 2
    profiling.count("fusion.lidar.kernel_steps")
    sel = Selection(*(plan[_SEL_START + k] for k in range(4)))
    return new, (world, crop, valid), sel


def dump(rb: RollBuffer) -> dict:
    """Every rollbuffer field on the host as numpy, for inspection (the
    reference's debug inspector ``checkAllPointSequenceBuffers``,
    gpu_depthmap_fusion.cpp:859-926): the live extents as ints, the
    fields sliced to them, and the full-capacity point arrays under
    ``*_raw``. Waits for the device."""
    host = {f: getattr(rb, f).cpu().numpy() for f in RollBuffer._fields}
    n_pts, n_seqs = int(host["num_points"]), int(host["num_seqs"])
    out = {"num_points": n_pts, "num_seqs": n_seqs}
    for f in ("points", "mask", "seq_idx"):
        out[f] = host[f][:n_pts]
    for f in ("seq_sec", "seq_nsec", "seq_start", "seq_count",
              "seq_tf_move"):
        out[f] = host[f][:n_seqs]
    for f in ("points", "mask", "seq_idx"):
        out[f + "_raw"] = host[f]
    return out
