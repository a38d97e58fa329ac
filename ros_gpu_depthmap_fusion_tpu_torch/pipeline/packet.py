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
    seq_points         P*4 f32, or ceil(P*3/2) u16 pairs when quantized
    row_first          ceil(rows/2)  u16 pairs
    exc_idx, exc_zz    cap_e u32 each
    tail               depth payload: raw u16 depth pairs ceil(rows*W/2)
                       (bits None) or the codec's words

The port unpacks the raw-depth payload and the f32 or u16-quantized lidar
staging. The depth-link codecs, heterogeneous rigs and delta-coded lidar
have their layout computed here (so offsets agree) but unpacking them
raises ``NotImplementedError``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ros_gpu_depthmap_fusion_tpu_torch.core.config import FusionConfig

# depth-codec bit-width buckets and row word count (the JAX package's
# ops/depth_codec.py); they size the packet's largest tail
B_BUCKETS = (2, 3, 4, 6, 8, 12, 17)


def words_per_row(width: int, bits: int) -> int:
    return max(1, (width * bits + 31) // 32)


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
        self.seq_points = self.seq_points_q = None
        if lo.seq_quant_step and not lo.lidar_delta:
            nw = (lo.stage_cap * 3 + 1) // 2
            self.seq_points_q = b[lo.off_seq_points:lo.off_seq_points + nw] \
                .view(np.uint16)[: lo.stage_cap * 3].reshape(lo.stage_cap, 3)
        elif not lo.lidar_delta:
            self.seq_points = f32(lo.off_seq_points, lo.stage_cap * 4,
                                  (lo.stage_cap, 4))
        self.depth = None
        if lo.groups is None:
            # raw u16 depth pairs: pixel i is the low (i even) or high
            # half of tail word i // 2, i.e. a little-endian u16 array
            nw = lo.tail_words(None)
            self.depth = b[lo.off_tail:lo.off_tail + nw].view(np.uint16)[
                : lo.rows * lo.w].reshape(lo.c, lo.h, lo.w)

    def set_scalars(self, exc_count, now_sec, now_nsec, roll_min_sec,
                    roll_min_nsec, num_seq_points, num_seqs,
                    fp_threshold, fp_max_distance, ps_threshold,
                    lidar_exc_count=0):
        self.buf[0] = np.uint32(exc_count)
        hdr = np.array([now_sec, now_nsec, roll_min_sec, roll_min_nsec,
                        num_seq_points, num_seqs], np.int32)
        self.buf[1:7] = hdr.view(np.uint32)
        self.buf[7:10] = np.array(
            [fp_threshold, fp_max_distance, ps_threshold],
            np.float32).view(np.uint32)
        self.buf[10] = np.uint32(lidar_exc_count)

    def view(self, bits: Optional[int]) -> np.ndarray:
        return self.buf[: self.layout.total_words(bits)]


def _f32(b, off, n, shape):
    return b[off:off + n].view(torch.float32).reshape(shape)


def _u16(b, off, n_words):
    """``n_words`` packed u16 pairs -> ``[2 * n_words]`` int32 values."""
    return b[off:off + n_words].view(torch.int16).to(torch.int32) & 0xFFFF


def unpack_packet(packet: torch.Tensor, layout: PacketLayout,
                  bits: Optional[int] = None):
    """Device-side unpack of a ``[words]`` int32 packet to
    :class:`pipeline.engine.FrameInputs` (slices and bit views; no host
    sync). ``depth`` is the raw ``[C, H, W]`` depth as int32 u16 values.
    """
    from ros_gpu_depthmap_fusion_tpu_torch.pipeline.engine import (
        FrameInputs, SequenceBatch)
    lo = layout
    b = packet
    if lo.groups is not None:
        raise NotImplementedError(
            "stream_shapes: heterogeneous rigs are not ported yet")
    if bits is not None:
        raise NotImplementedError(
            f"depth_link_codec: the codec payload (bits={bits!r}) is not "
            "ported yet; use depth_link_codec='none'")
    if lo.lidar_delta:
        raise NotImplementedError(
            "lidar_link_delta: delta-coded lidar staging is not ported yet")
    hdr = b[1:7]
    fhdr = _f32(b, 7, 3, (3,))
    depth = _u16(b, lo.off_tail, lo.tail_words(None))[: lo.rows * lo.w] \
        .reshape(lo.c, lo.h, lo.w)
    # per-point sequence indices from the cumulative counts (staging
    # appends sequences in order): idx[i] = #ends <= i
    seq_count = b[lo.off_seq_count:lo.off_seq_count + lo.seq_cap]
    ends = torch.cumsum(seq_count, 0, dtype=torch.int32)
    pt_iota = torch.arange(lo.stage_cap, dtype=torch.int32, device=b.device)
    seq_idx = (pt_iota[:, None] >= ends[None, :]).sum(1, dtype=torch.int32)
    if lo.seq_quant_step:
        q = _u16(b, lo.off_seq_points, (lo.stage_cap * 3 + 1) // 2)[
            : lo.stage_cap * 3].reshape(lo.stage_cap, 3).to(torch.float32)
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
