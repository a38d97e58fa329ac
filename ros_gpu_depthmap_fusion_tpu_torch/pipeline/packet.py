"""Single-buffer frame transfer: every per-frame input packed into ONE
contiguous 32-bit word array, copied host -> device once a frame.

The layout is the JAX package's (``pipeline/packet.py``), word for word, so
the two engines stage identical bytes for the same frame (u32 words; all
offsets static per config)::

    [0]                exc_count
    [1..6]             now_sec, now_nsec, roll_min_sec, roll_min_nsec,
                       num_seq_points, num_seqs
    [7..9]             fp_threshold, fp_max_distance, ps_threshold (f32)
    [10]               lidar exception count
    intr               C*4   f32
    tf_world, tf_crop  C*16  f32 each
    tf_world_move      16    f32
    tf_crop_move       16    f32
    seq_sec/nsec/count S each, i32
    seq_tf_move        S*16  f32
    seq_points         P*4 f32, ceil(P*3/2) u16 pairs when quantized, or
                       ceil(P/2) u16 pairs of 3 x 4-bit zigzag deltas when
                       delta-coded; then (delta-coded only) seq_first
                       ceil(S*3/2) u16 pairs and lidar_exc 2*cap u32
    row_first          ceil(rows/2)  u16 pairs
    exc_idx, exc_zz    cap_e u32 each
    tail               depth payload: raw u16 depth pairs ceil(rows*W/2)
                       (bits None), the I- or P-frame's rows*wpr(B) words,
                       or p4's flag words then literal words

A heterogeneous rig (streams of several resolutions) lays its depth out
per resolution group, in group order: a G-word section at ``off_gmeta``
holds each group's exception count, each group has its slice of
row_first, its share ``group_exc_caps[g]`` of the exception sections (at
fixed offsets), and its own tail segment, raw or coded at its own width.

The port unpacks every payload: raw depth, the codec's I-, classic P- and
p4 P-frames (p4 on a homogeneous rig only), a heterogeneous rig's
per-group raw or I-frame segments, and f32, u16-quantized or delta-coded
lidar staging.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ros_gpu_depthmap_fusion_tpu_torch.core.config import FusionConfig
from ros_gpu_depthmap_fusion_tpu_torch.ops.depth_codec import (
    B_BUCKETS, EncodedDepth, EncodedDepthP4, words_per_row)


class PacketLayout(NamedTuple):
    c: int
    h: int
    w: int
    rows: int
    seq_cap: int        # S: staged sequence records
    stage_cap: int      # P: staged sequence points
    exc_cap: int
    off_intr: int
    off_tf_world: int
    off_tf_crop: int
    off_tf_world_move: int
    off_tf_crop_move: int
    off_seq_sec: int
    off_seq_nsec: int
    off_seq_count: int
    off_seq_tf: int
    off_seq_points: int
    off_row_first: int
    off_exc_idx: int
    off_exc_zz: int
    off_tail: int
    seq_quant_step: float = 0.0
    groups: "tuple | None" = None
    group_exc_caps: "tuple | None" = None
    off_gmeta: int = 0
    p4_budget: int = 0
    lidar_delta: int = 0
    lidar_exc_cap: int = 0
    off_seq_first: int = 0
    off_lidar_exc: int = 0

    def p4_words(self):
        gw = -(-self.w // 4)
        fw = -(-gw // 32)
        return self.rows * fw, self.rows * (self.p4_budget // 4)

    @classmethod
    def for_config(cls, cfg: FusionConfig, seq_cap: int,
                   stage_cap: int) -> "PacketLayout":
        c, h, w = cfg.num_depth_streams, cfg.depth_height, cfg.depth_width
        e = cfg.depth_codec_max_exceptions
        groups = None
        group_exc_caps = None
        off_gmeta = 0
        if cfg.is_heterogeneous:
            groups = tuple((len(ix), gh, gw)
                           for ix, gh, gw in cfg.stream_groups)
            rows = sum(cg * gh for cg, gh, _ in groups)
            n_total = sum(cg * gh * gw for cg, gh, gw in groups)
            group_exc_caps = tuple(
                max(256, e * (cg * gh * gw) // n_total)
                for cg, gh, gw in groups)
            e = sum(group_exc_caps)
        else:
            rows = c * h
        qs = float(cfg.lidar_link_quant_step or 0.0)
        ld = int(bool(cfg.lidar_link_delta))
        if ld and not qs > 0.0:
            raise ValueError("lidar_link_delta requires lidar_link_quant_step")
        lecap = max(256, min(2048, stage_cap // 8)) if ld else 0
        if ld:
            seq_pt_words = (stage_cap + 1) // 2
        elif qs:
            seq_pt_words = (stage_cap * 3 + 1) // 2
        else:
            seq_pt_words = stage_cap * 4
        off = 11   # header: [0] exc_count, [1..9] scalars, [10] lidar exc
        f = {}
        if groups is not None:
            off_gmeta = off
            off += len(groups)
        sections = [
            ("intr", c * 4), ("tf_world", c * 16), ("tf_crop", c * 16),
            ("tf_world_move", 16), ("tf_crop_move", 16),
            ("seq_sec", seq_cap), ("seq_nsec", seq_cap),
            ("seq_count", seq_cap), ("seq_tf", seq_cap * 16),
            ("seq_points", seq_pt_words)]
        if ld:
            sections += [("seq_first", (seq_cap * 3 + 1) // 2),
                         ("lidar_exc", 2 * lecap)]
        sections += [("row_first", (rows + 1) // 2),
                     ("exc_idx", e), ("exc_zz", e)]
        for name, size in sections:
            f["off_" + name] = off
            off += size
        p4 = int(cfg.depth_codec_p4_budget or 0)
        if p4 and (groups is not None or p4 % 4):
            raise ValueError("p4 P-frames need a homogeneous rig and a "
                             f"budget that is a multiple of 4, got {p4}")
        return cls(c=c, h=h, w=w, rows=rows, seq_cap=seq_cap,
                   stage_cap=stage_cap, exc_cap=e, off_tail=off,
                   seq_quant_step=qs, groups=groups,
                   group_exc_caps=group_exc_caps, off_gmeta=off_gmeta,
                   p4_budget=p4, lidar_delta=ld, lidar_exc_cap=lecap,
                   **f)

    def group_tail_words(self, gi: int, bits: Optional[int]) -> int:
        cg, gh, gw = self.groups[gi]
        if bits is None:
            return (cg * gh * gw + 1) // 2
        return cg * gh * words_per_row(gw, abs(bits))

    def tail_words(self, bits) -> int:
        if self.groups is not None:
            return sum(self.group_tail_words(g, b)
                       for g, b in enumerate(bits))
        if bits is None:  # raw u16 depth pairs
            return (self.rows * self.w + 1) // 2
        if bits == "p4":
            nf, nl = self.p4_words()
            return nf + nl
        return self.rows * words_per_row(self.w, abs(bits))

    def total_words(self, bits) -> int:
        return self.off_tail + self.tail_words(bits)

    def max_words(self) -> int:
        if self.groups is not None:
            g = len(self.groups)
            return max(self.total_words((None,) * g),
                       self.total_words((max(B_BUCKETS),) * g))
        return max(self.total_words(None),
                   self.total_words(max(B_BUCKETS)))


class HostPacket:
    """One reusable host packet buffer with named numpy views.

    With ``pin=True`` the buffer is page-locked host memory (a CUDA
    machine), so the frame's host -> device copy can run asynchronously;
    :attr:`tensor` is the same memory as a torch int32 tensor.
    """

    def __init__(self, layout: PacketLayout, pin: bool = False):
        self.layout = layout
        lo = layout
        self.tensor = torch.zeros((layout.max_words(),), dtype=torch.int32,
                                  pin_memory=pin)
        self.buf = self.tensor.numpy().view(np.uint32)
        b = self.buf

        def f32(off, n, shape):
            return b[off:off + n].view(np.float32).reshape(shape)

        def i32(off, n):
            return b[off:off + n].view(np.int32)

        self.intr = f32(lo.off_intr, lo.c * 4, (lo.c, 4))
        self.tf_world = f32(lo.off_tf_world, lo.c * 16, (lo.c, 4, 4))
        self.tf_crop = f32(lo.off_tf_crop, lo.c * 16, (lo.c, 4, 4))
        self.tf_world_move = f32(lo.off_tf_world_move, 16, (4, 4))
        self.tf_crop_move = f32(lo.off_tf_crop_move, 16, (4, 4))
        self.seq_sec = i32(lo.off_seq_sec, lo.seq_cap)
        self.seq_nsec = i32(lo.off_seq_nsec, lo.seq_cap)
        self.seq_count = i32(lo.off_seq_count, lo.seq_cap)
        self.seq_tf = f32(lo.off_seq_tf, lo.seq_cap * 16, (lo.seq_cap, 4, 4))
        self.seq_points = self.seq_points_q = self.seq_points_d = None
        # the engine's id of the frame staged in it
        self.frame = 0
        # staged per frame by the engine (delta-coded lidar only)
        self.lidar_exc_count = 0
        self.lidar_dropped = 0
        if lo.lidar_delta:
            nw = (lo.stage_cap + 1) // 2
            self.seq_points_d = b[lo.off_seq_points:lo.off_seq_points
                                  + nw].view(np.uint16)[: lo.stage_cap]
            nf = (lo.seq_cap * 3 + 1) // 2
            self.seq_first = b[lo.off_seq_first:lo.off_seq_first + nf] \
                .view(np.uint16)[: lo.seq_cap * 3].reshape(lo.seq_cap, 3)
            self.lidar_exc_idx = b[lo.off_lidar_exc:
                                   lo.off_lidar_exc + lo.lidar_exc_cap]
            self.lidar_exc_zz = b[lo.off_lidar_exc + lo.lidar_exc_cap:
                                  lo.off_lidar_exc + 2 * lo.lidar_exc_cap]
        elif lo.seq_quant_step:
            nw = (lo.stage_cap * 3 + 1) // 2
            self.seq_points_q = b[lo.off_seq_points:lo.off_seq_points + nw] \
                .view(np.uint16)[: lo.stage_cap * 3].reshape(lo.stage_cap, 3)
        else:
            self.seq_points = f32(lo.off_seq_points, lo.stage_cap * 4,
                                  (lo.stage_cap, 4))
        # depth-codec sections (the native encoders write into these)
        n_rf = (lo.rows + 1) // 2
        self.row_first = b[lo.off_row_first:lo.off_row_first + n_rf].view(
            np.uint16)[: lo.rows]
        self.exc_idx = b[lo.off_exc_idx:lo.off_exc_idx + lo.exc_cap]
        self.exc_zz = b[lo.off_exc_zz:lo.off_exc_zz + lo.exc_cap]
        self.tail = b[lo.off_tail:]
        if lo.p4_budget:
            nf, nl = lo.p4_words()
            self.p4_flags = self.tail[:nf]
            self.p4_lits = self.tail[nf:nf + nl].view(np.uint8)
        self.depth = None
        if lo.groups is None:
            # raw u16 depth pairs: pixel i is the low (i even) or high
            # half of tail word i // 2, i.e. a little-endian u16 array
            nw = lo.tail_words(None)
            self.depth = self.tail[:nw].view(np.uint16)[
                : lo.rows * lo.w].reshape(lo.c, lo.h, lo.w)

    def set_scalars(self, exc_count, now_sec, now_nsec, roll_min_sec,
                    roll_min_nsec, num_seq_points, num_seqs,
                    fp_threshold, fp_max_distance, ps_threshold):
        self.buf[0] = np.uint32(exc_count)
        hdr = np.array([now_sec, now_nsec, roll_min_sec, roll_min_nsec,
                        num_seq_points, num_seqs], np.int32)
        self.buf[1:7] = hdr.view(np.uint32)
        self.buf[7:10] = np.array(
            [fp_threshold, fp_max_distance, ps_threshold],
            np.float32).view(np.uint32)
        self.buf[10] = np.uint32(self.lidar_exc_count)

    def view(self, bits: Optional[int]) -> np.ndarray:
        return self.buf[: self.layout.total_words(bits)]


def _f32(b, off, n, shape):
    return b[off:off + n].view(torch.float32).reshape(shape)


def _u16(b, off, n_words):
    """``n_words`` packed u16 pairs -> ``[2 * n_words]`` int32 values."""
    return b[off:off + n_words].view(torch.int16).to(torch.int32) & 0xFFFF


def _unpack_groups(b, lo: PacketLayout, bits):
    """A heterogeneous rig's depth payload: per resolution group, raw
    ``[C_g, H_g, W_g]`` int32 u16 values (``bits[g]`` None) or an
    :class:`EncodedDepth` I-frame at width ``bits[g]``."""
    if bits is None:
        bits = (None,) * len(lo.groups)
    row_first = _u16(b, lo.off_row_first, (lo.rows + 1) // 2)[: lo.rows]
    depth = []
    row_off, exc_off, tail_off = 0, 0, lo.off_tail
    for gi, (cg, gh, gw) in enumerate(lo.groups):
        rows_g, cap_g = cg * gh, lo.group_exc_caps[gi]
        tw = lo.group_tail_words(gi, bits[gi])
        if bits[gi] is None:
            depth.append(_u16(b, tail_off, tw)[: rows_g * gw]
                         .reshape(cg, gh, gw))
        else:
            wpr = words_per_row(gw, abs(bits[gi]))
            depth.append(EncodedDepth(
                words=b[tail_off:tail_off + rows_g * wpr].reshape(
                    cg, gh, wpr),
                row_first=row_first[row_off:row_off + rows_g].reshape(
                    cg, gh),
                exc_idx=b[lo.off_exc_idx + exc_off:
                          lo.off_exc_idx + exc_off + cap_g],
                exc_zz=b[lo.off_exc_zz + exc_off:
                         lo.off_exc_zz + exc_off + cap_g],
                exc_count=b[lo.off_gmeta + gi]))
        # the encoder writes group g's exceptions at sum(caps[:g]) whether
        # or not the other groups were coded
        row_off += rows_g
        exc_off += cap_g
        tail_off += tw
    return tuple(depth)


def _unpack_depth(b, lo: PacketLayout, bits):
    """The frame's depth payload: raw ``[C, H, W]`` int32 u16 values
    (``bits`` None), an :class:`EncodedDepthP4` (``"p4"``) or an
    :class:`EncodedDepth` (``bits`` > 0 I-frame, < 0 classic P-frame); a
    tuple of per-group payloads on a heterogeneous rig."""
    if lo.groups is not None:
        return _unpack_groups(b, lo, bits)
    if bits is None:
        return _u16(b, lo.off_tail, lo.tail_words(None))[: lo.rows * lo.w] \
            .reshape(lo.c, lo.h, lo.w)
    exc_idx = b[lo.off_exc_idx:lo.off_exc_idx + lo.exc_cap]
    exc_zz = b[lo.off_exc_zz:lo.off_exc_zz + lo.exc_cap]
    tail = b[lo.off_tail:]
    if bits == "p4":
        nf, nl = lo.p4_words()
        return EncodedDepthP4(
            flags=tail[:nf].reshape(lo.rows, nf // lo.rows),
            lits=tail[nf:nf + nl].reshape(lo.rows, lo.p4_budget // 4),
            exc_idx=exc_idx, exc_zz=exc_zz, exc_count=b[0])
    wpr = words_per_row(lo.w, abs(bits))
    row_first = _u16(b, lo.off_row_first, (lo.rows + 1) // 2)[: lo.rows]
    return EncodedDepth(
        words=tail[:lo.rows * wpr].reshape(lo.c, lo.h, wpr),
        row_first=row_first.reshape(lo.c, lo.h),
        exc_idx=exc_idx, exc_zz=exc_zz, exc_count=b[0])


def _unpack_lidar_delta(b, lo: PacketLayout, seq_count, ends, seq_idx):
    """Delta-coded lidar staging -> ``[P, 3]`` float32 quantized
    coordinates.

    One u16 a point of 3 x 4-bit zigzag deltas of the u16-quantized
    coordinates, wide deltas on an exception list, each sequence's first
    point raw. The quantized series is ``first[s] + G[i] - G[start[s]]``
    with ``G`` the inclusive prefix sum of the deltas over the whole
    staging (the first point of a sequence codes delta 0). The JAX
    package's two-level matmul prefix sum and one-hot rebase become an
    integer ``cumsum`` and gathers; the rebase is kept in float32 as
    there, so the values agree bit for bit.
    """
    P, S = lo.stage_cap, lo.seq_cap
    dev = b.device
    codes16 = _u16(b, lo.off_seq_points, (P + 1) // 2)[:P]
    zz = torch.stack([(codes16 >> (4 * k)) & 15 for k in range(3)], dim=-1)
    delta = ((zz >> 1) ^ -(zz & 1)).reshape(-1)
    le_idx = b[lo.off_lidar_exc:lo.off_lidar_exc + lo.lidar_exc_cap]
    le_zz = b[lo.off_lidar_exc + lo.lidar_exc_cap:
              lo.off_lidar_exc + 2 * lo.lidar_exc_cap]
    live = (torch.arange(lo.lidar_exc_cap, dtype=torch.int32, device=dev)
            < b[10]) & (le_idx >= 0) & (le_idx < P * 3)
    target = torch.where(live, le_idx, P * 3).long()
    delta = torch.cat([delta, delta.new_zeros(1)])
    delta[target] = (le_zz >> 1) ^ -(le_zz & 1)
    g = torch.cumsum(delta[:P * 3].reshape(P, 3), dim=0,
                     dtype=torch.int32).to(torch.float32)
    starts = ends - seq_count
    g_start = torch.where((starts < P)[:, None],
                          g[torch.clamp(starts, 0, P - 1).long()], 0.0)
    firsts = _u16(b, lo.off_seq_first, (S * 3 + 1) // 2)[: S * 3] \
        .reshape(S, 3).to(torch.float32)
    base = firsts - g_start                                    # [S, 3]
    q = torch.where((seq_idx < S)[:, None],
                    base[torch.clamp_max(seq_idx, S - 1).long()], 0.0) + g
    return q


def unpack_packet(packet: torch.Tensor, layout: PacketLayout, bits=None):
    """Device-side unpack of a ``[words]`` int32 packet to
    :class:`pipeline.engine.FrameInputs` (slices, bit views and small
    integer ops; no host sync). ``bits`` names the depth payload as the
    engine's step does: ``None`` raw, ``"p4"``, ``B > 0`` an I-frame at
    width ``B``, ``-B`` a classic P-frame; on a heterogeneous rig a tuple
    of per-group ``None`` or ``B``.
    """
    from ros_gpu_depthmap_fusion_tpu_torch.pipeline.engine import (
        FrameInputs, SequenceBatch)
    lo = layout
    b = packet
    hdr = b[1:7]
    fhdr = _f32(b, 7, 3, (3,))
    depth = _unpack_depth(b, lo, bits)
    # per-point sequence indices from the cumulative counts (staging
    # appends sequences in order): idx[i] = #ends <= i
    seq_count = b[lo.off_seq_count:lo.off_seq_count + lo.seq_cap]
    ends = torch.cumsum(seq_count, 0, dtype=torch.int32)
    pt_iota = torch.arange(lo.stage_cap, dtype=torch.int32, device=b.device)
    seq_idx = (pt_iota[:, None] >= ends[None, :]).sum(1, dtype=torch.int32)
    if lo.lidar_delta or lo.seq_quant_step:
        if lo.lidar_delta:
            q = _unpack_lidar_delta(b, lo, seq_count, ends, seq_idx)
        else:
            q = _u16(b, lo.off_seq_points, (lo.stage_cap * 3 + 1) // 2)[
                : lo.stage_cap * 3].reshape(lo.stage_cap, 3) \
                .to(torch.float32)
        step = lo.seq_quant_step
        xyz = q * step - 32768.0 * step
        seq_points = torch.cat([xyz, torch.ones_like(xyz[:, :1])], dim=-1)
    else:
        seq_points = _f32(b, lo.off_seq_points, lo.stage_cap * 4,
                          (lo.stage_cap, 4))
    seq_batch = SequenceBatch(
        points=seq_points,
        seq_idx=seq_idx,
        seq_sec=b[lo.off_seq_sec:lo.off_seq_sec + lo.seq_cap],
        seq_nsec=b[lo.off_seq_nsec:lo.off_seq_nsec + lo.seq_cap],
        seq_count=seq_count,
        seq_tf_move=_f32(b, lo.off_seq_tf, lo.seq_cap * 16,
                         (lo.seq_cap, 4, 4)),
        num_points=hdr[4], num_seqs=hdr[5])
    return FrameInputs(
        depth=depth,
        intrinsics=_f32(b, lo.off_intr, lo.c * 4, (lo.c, 4)),
        tf_world=_f32(b, lo.off_tf_world, lo.c * 16, (lo.c, 4, 4)),
        tf_crop=_f32(b, lo.off_tf_crop, lo.c * 16, (lo.c, 4, 4)),
        seq_batch=seq_batch,
        tf_world_move=_f32(b, lo.off_tf_world_move, 16, (4, 4)),
        tf_crop_move=_f32(b, lo.off_tf_crop_move, 16, (4, 4)),
        now_sec=hdr[0], now_nsec=hdr[1],
        roll_min_sec=hdr[2], roll_min_nsec=hdr[3],
        fp_threshold=fhdr[0], fp_max_distance=fhdr[1],
        ps_threshold=fhdr[2])
