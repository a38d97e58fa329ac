"""Historic point-sequence rollbuffer.

Fixed-capacity form of the reference's rollbuffer SSBO group
(``gpu_depthmap_fusion.h:402-416``), with the reference's CPU paths as the
behavioural spec:

- insert:    ``insertNewPointSequencesInRollbuffer`` (cpp:979-1087)
- expiry:    ``rollPointSequenceRollbufferCPU``      (cpp:1098-1217)
- selection: ``selectPointSequenceTimespanCPU``      (cpp:1358-1416)
- transform: ``insertSelectedPointSequence`` + ``transformPointSequence``
             (cpp:1509-1581)

Every array has a static capacity and the live extents are int32 0-d
tensors on the buffer's device, so no function here waits for the device.
Sequences are stored contiguous and time-ordered (inserts clamp a late
timestamp forward). Functions return new tensors; the input buffer is not
modified.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ros_gpu_depthmap_fusion_tpu_torch.core import transforms


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
