"""Depth-link codec: the device decoders and the numpy reference encoders.

The format is the JAX package's (``ops/depth_codec.py``); the native host
encoders (``native/src/fusionhost.cpp``, bound in :mod:`utils.native`)
write it, and these decoders read it inside the frame step:

- I-frame (:func:`decode_depth`): escape-zero row DPCM. Each pixel is a
  ``B``-bit code, ``B`` in :data:`B_BUCKETS`; codes ``0 .. 2^B-2`` are
  ``zigzag(d - previous valid pixel)``, the top code ``2^B-1`` marks a
  hole; each row's first valid pixel travels raw (``row_first``) and
  oversized deltas ride an (index, zigzag) exception list.
- classic P-frame (:func:`decode_depth_temporal`): per-pixel
  ``zigzag(curr_q - prev_q)`` in the same word layout, against the
  previous frame's quantized series kept in the engine state.
- p4 P-frame (:func:`decode_depth_p4`): one flag bit per 4-pixel group,
  and per row a byte budget of 16-bit group literals (4 bits a pixel:
  zigzag deltas in [-7, 7], 15 = new hole); everything else rides the
  exception list.

Values are int32 tensors holding u16 values (torch has no unsigned 32-bit
arithmetic on every device), and every result is reduced mod 2^16 as the
JAX decoders' ``astype(uint16)`` does. The TPU mechanisms of the JAX
decoders are replaced by their plain counterparts, with equal results:
the triangular-matmul row prefix sum by an integer ``cumsum``, the bit
explosion of unaligned widths by word-index and shift arithmetic, and the
p4 one-hot literal lookup by a gather.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from ros_gpu_depthmap_fusion_tpu_torch.core.devconst import const

# frame bit widths are rounded up to one of these; B=17 never overflows:
# max zigzag(+-65535) = 2^17-2 = ESC-1
B_BUCKETS = (2, 3, 4, 6, 8, 12, 17)

P4_GROUP = 4
P4_HOLE = 15   # 4-bit code for a value -> hole transition


def bucket_bits(b: int) -> int:
    for cand in B_BUCKETS:
        if b <= cand:
            return cand
    return 17


def words_per_row(width: int, bits: int) -> int:
    return max(1, (width * bits + 31) // 32)


class EncodedDepth(NamedTuple):
    """One I- or classic P-frame (tensors, int32 carriers of u32/u16)."""
    words: torch.Tensor       # [C, H, words_per_row(W, B)]
    row_first: torch.Tensor   # [C, H] first valid pixel per row
    exc_idx: torch.Tensor     # [cap] flat pixel index
    exc_zz: torch.Tensor      # [cap] true zigzag delta
    exc_count: torch.Tensor   # 0-d


class EncodedDepthP4(NamedTuple):
    """One p4 P-frame (tensors, int32 carriers of u32 words)."""
    flags: torch.Tensor    # [rows, fw] flag words (little-endian bits)
    lits: torch.Tensor     # [rows, L // 4] literal bytes packed LE
    exc_idx: torch.Tensor  # [cap] flat pixel index
    exc_zz: torch.Tensor   # [cap] true zigzag delta
    exc_count: torch.Tensor


def _u32(x: torch.Tensor) -> torch.Tensor:
    """int32 carrier of u32 words -> their values in int64."""
    return x.to(torch.int64) & 0xFFFFFFFF


def _unzigzag(zz: torch.Tensor) -> torch.Tensor:
    return (zz >> 1) ^ -(zz & 1)


def _extract_codes(words: torch.Tensor, width: int, bits: int
                   ) -> torch.Tensor:
    """Per-pixel ``bits``-wide codes ``[C, H, width]`` int32 from the packed
    little-endian word stream ``[C, H, wpr]``: pixel x's field starts at
    bit ``x * bits``, in word ``x * bits // 32``, and may run into the next
    word (every width of :data:`B_BUCKETS` takes this one path)."""
    pos = torch.arange(width, dtype=torch.int64, device=words.device) * bits
    wi, sh = pos >> 5, pos & 31
    w = torch.nn.functional.pad(_u32(words), (0, 1))   # word wpr reads 0
    pair = w[..., wi] | (w[..., wi + 1] << 32)
    return ((pair >> sh) & ((1 << bits) - 1)).to(torch.int32)


def _scatter_exceptions(zz: torch.Tensor, exc_idx, exc_zz, exc_count
                        ) -> torch.Tensor:
    """``zz`` (flat) with the first ``exc_count`` exception values written
    at their pixel indices; the rest of the list, and an index outside the
    frame, is ignored (JAX's ``mode="drop"``)."""
    n = zz.shape[0]
    idx = exc_idx.to(torch.int32)
    live = (torch.arange(exc_idx.shape[0], dtype=torch.int32,
                         device=zz.device) < exc_count) \
        & (idx >= 0) & (idx < n)
    target = torch.where(live, idx, n).long()
    out = torch.cat([zz, zz.new_zeros(1)])
    out[target] = exc_zz.to(torch.int32)
    return out[:n]


def _extract_zz(enc: EncodedDepth, width: int, bits: int):
    """Decoder front half: per-pixel codes -> (zigzag values with the
    exceptions written in, hole mask)."""
    c, h, _ = enc.words.shape
    esc = (1 << bits) - 1
    codes = _extract_codes(enc.words, width, bits)
    is_hole = codes == esc
    zz = torch.where(is_hole, 0, codes).reshape(-1)
    zz = _scatter_exceptions(zz, enc.exc_idx, enc.exc_zz, enc.exc_count)
    return zz.reshape(c, h, width), is_hole


def _dequantize(series: torch.Tensor, quant_shift: int) -> torch.Tensor:
    depth = series << quant_shift if quant_shift else series
    return depth & 0xFFFF


def decode_depth(enc: EncodedDepth, height: int, width: int, bits: int,
                 quant_shift: int = 0, return_series: bool = False):
    """Decode an I-frame to ``[C, H, W]`` depth (int32 u16 values).

    ``quant_shift`` must match the encoder's: the series is in units of
    ``2**quant_shift`` and is scaled back here (holes stay 0). With
    ``return_series`` also returns the quantized series (holes = 0), the
    ``prev_q`` state of a following P-frame.
    """
    zz, is_hole = _extract_zz(enc, width, bits)
    delta = _unzigzag(zz)
    series = enc.row_first.to(torch.int32)[..., None] + torch.cumsum(
        delta, dim=-1, dtype=torch.int32)
    series = torch.where(is_hole, 0, series)
    depth = _dequantize(series, quant_shift)
    if return_series:
        return depth, series & 0xFFFF
    return depth


def decode_depth_temporal(enc: EncodedDepth, prev_q: torch.Tensor,
                          height: int, width: int, bits: int,
                          quant_shift: int = 0):
    """Decode a classic P-frame: ``curr_q = prev_q + unzigzag(code)`` per
    pixel. ``prev_q`` is the previous ``[C, H, W]`` quantized series
    (holes = 0), as either decoder returns it.

    Returns ``(depth, curr_q)``, int32 u16 values.
    """
    zz, is_hole = _extract_zz(enc, width, bits)
    curr_q = torch.where(is_hole, 0, prev_q.to(torch.int32) + _unzigzag(zz))
    return _dequantize(curr_q, quant_shift), curr_q & 0xFFFF


def _p4_geometry(width: int, budget: int):
    gw = -(-width // P4_GROUP)          # groups per row
    fw = -(-gw // 32)                   # flag words per row
    if budget % 4 or budget <= 0:
        raise ValueError(f"p4 budget must be a positive multiple of 4, "
                         f"got {budget}")
    return gw, fw


def decode_depth_p4(enc: EncodedDepthP4, prev_q: torch.Tensor,
                    height: int, width: int, budget: int,
                    quant_shift: int = 0):
    """Decode a p4 P-frame against ``prev_q`` ``[C, H, W]``.

    Group ``(r, j)``'s literal is ``lit16[r, k]`` with ``k`` the number of
    flagged groups before ``j`` in row ``r`` (an exclusive prefix sum of
    the flag bits); an unflagged group, or one past the row's literal
    capacity, reads 0.

    Returns ``(depth, curr_q)``, int32 u16 values.
    """
    rows = enc.flags.shape[0]
    gw, fw = _p4_geometry(width, budget)
    dev = enc.flags.device
    shifts = torch.arange(32, dtype=torch.int64, device=dev)
    fl = ((_u32(enc.flags)[:, :, None] >> shifts) & 1) \
        .reshape(rows, fw * 32)[:, :gw].to(torch.int32)       # [rows, gw]
    pr = torch.cumsum(fl, dim=1, dtype=torch.int32) - fl      # exclusive
    nlit = budget // 2
    lit16 = ((_u32(enc.lits)[:, :, None]
              >> const((0, 16), dev, torch.int64)) & 0xFFFF) \
        .reshape(rows, nlit)                                  # [rows, L/2]
    take = (fl > 0) & (pr < nlit)
    g16 = torch.where(take, torch.gather(
        lit16, 1, torch.clamp_max(pr, nlit - 1).long()), 0)
    k4 = 4 * torch.arange(P4_GROUP, dtype=torch.int64, device=dev)
    codes = ((g16[:, :, None] >> k4) & 15).reshape(
        rows, gw * P4_GROUP)[:, :width].to(torch.int32)       # [rows, W]
    is_hole = (codes == P4_HOLE).reshape(-1)
    zz = torch.where(is_hole, 0, codes.reshape(-1))
    zz = _scatter_exceptions(zz, enc.exc_idx, enc.exc_zz, enc.exc_count)
    curr = torch.where(is_hole, 0,
                       prev_q.reshape(-1).to(torch.int32) + _unzigzag(zz))
    c = prev_q.shape[0]
    return (_dequantize(curr, quant_shift).reshape(c, height, width),
            (curr & 0xFFFF).reshape(c, height, width))


# ---------------------------------------------------------------------------
# numpy reference encoders (oracles of the native encoders; pixel loops,
# test scale only). Copied from the JAX package as they are.
# ---------------------------------------------------------------------------

def quantize_reference(depth: np.ndarray, quant_shift: int) -> np.ndarray:
    """The encoders' quantization: nonzero depth -> clamped multiples of
    2**shift in quantized units (holes stay 0)."""
    d = np.asarray(depth).astype(np.int64)
    if not quant_shift:
        return d.astype(np.uint16)
    nz = d != 0
    q = np.clip((d + (1 << (quant_shift - 1))) >> quant_shift,
                1, 65535 >> quant_shift)
    return np.where(nz, q, 0).astype(np.uint16)


def quantize_hysteresis_reference(depth: np.ndarray, prev_q: np.ndarray,
                                  quant_shift: int,
                                  hysteresis: int) -> np.ndarray:
    """Encoder-side hysteresis quantization: a valid pixel KEEPS its
    previous bin while |raw - dequant(prev_q)| <= 2^(shift-1) +
    hysteresis (raw units); otherwise it re-quantizes normally. Error
    bound: q/2 + hysteresis while held, q/2 after a flip."""
    d = np.asarray(depth).astype(np.int64)
    pq = np.asarray(prev_q).astype(np.int64)
    q_std = quantize_reference(depth, quant_shift).astype(np.int64)
    if not quant_shift:
        return q_std.astype(np.uint16)
    band = (1 << (quant_shift - 1)) + int(hysteresis)
    hold = (d != 0) & (pq != 0) & (np.abs(d - (pq << quant_shift)) <= band)
    return np.where(hold, pq, q_std).astype(np.uint16)


def _pack_codes(codes: np.ndarray, bits: int, w: int) -> np.ndarray:
    rows = codes.shape[0]
    wpr = words_per_row(w, bits)
    words = np.zeros((rows, wpr), np.uint32)
    for r in range(rows):
        for x in range(w):
            z = int(codes[r, x])
            bitpos = x * bits
            wi, sh = bitpos // 32, bitpos % 32
            words[r, wi] |= (z << sh) & 0xFFFFFFFF
            if sh + bits > 32:
                words[r, wi + 1] |= z >> (32 - sh)
    return words


def encode_depth_reference(depth: np.ndarray, max_exceptions: int = 8192,
                           allowed_bits=B_BUCKETS,
                           quant_shift: int = 0) -> Tuple[dict, int]:
    """Reference implementation of ``fh_depth_encode2`` semantics. Returns
    exception arrays at their actual length (the native binding pads them
    to the static cap)."""
    c, h, w = depth.shape
    rows = depth.reshape(c * h, w).astype(np.int64)
    if quant_shift:
        nz = rows != 0
        q = np.clip((rows + (1 << (quant_shift - 1))) >> quant_shift,
                    1, 65535 >> quant_shift)
        rows = np.where(nz, q, 0)
    zz = np.zeros((c * h, w), np.int64)
    hole = np.zeros((c * h, w), bool)
    row_first = np.zeros(c * h, np.uint16)
    for r in range(c * h):
        prev = -1
        for x in range(w):
            d = int(rows[r, x])
            if d == 0:
                hole[r, x] = True
                continue
            if prev < 0:
                row_first[r] = d
            else:
                delta = d - prev
                zz[r, x] = (delta << 1) ^ (delta >> 63)
            prev = d
    valid_zz = zz[~hole]
    bits = None
    for b in sorted(allowed_bits):
        if 1 <= b <= 17 and int((valid_zz >= (1 << b) - 1).sum()) \
                <= max_exceptions:
            bits = b
            break
    if bits is None:
        raise ValueError("exception budget exceeded at every allowed width")
    esc = (1 << bits) - 1
    over = (zz >= esc) & ~hole
    exc = np.flatnonzero(over.reshape(-1))
    exc_zz = zz.reshape(-1)[exc].copy()
    codes = zz.copy()
    codes[over] = 0
    codes[hole] = esc
    words = _pack_codes(codes, bits, w)
    return dict(words=words.reshape(c, h, -1),
                row_first=row_first.reshape(c, h),
                exc_idx=exc.astype(np.uint32),
                exc_zz=exc_zz.astype(np.uint32)), bits


def encode_depth_temporal_reference(depth: np.ndarray,
                                    prev_q: np.ndarray,
                                    max_exceptions: int = 8192,
                                    allowed_bits=B_BUCKETS,
                                    quant_shift: int = 0):
    """Reference P-frame encoder: per-pixel ``zigzag(curr_q - prev_q)``
    with escape-zero holes; pixels whose previous value was a hole carry
    full magnitude and land in the exception list.

    Returns ``(enc dict, bits, curr_q)`` or ``None`` when no allowed
    width fits the exception budget. ``row_first`` is all zeros.
    """
    c, h, w = depth.shape
    curr_q = quantize_reference(depth, quant_shift)
    cq = curr_q.reshape(c * h, w).astype(np.int64)
    pq = np.asarray(prev_q).reshape(c * h, w).astype(np.int64)
    hole = cq == 0
    delta = cq - pq
    zz = np.where(delta >= 0, delta << 1, ((-delta) << 1) - 1)
    zz[hole] = 0
    bits = None
    for b in sorted(allowed_bits):
        if 1 <= b <= 17 and int(((zz >= (1 << b) - 1) & ~hole).sum()) \
                <= max_exceptions:
            bits = b
            break
    if bits is None:
        return None
    esc = (1 << bits) - 1
    over = (zz >= esc) & ~hole
    exc = np.flatnonzero(over.reshape(-1))
    exc_zz = zz.reshape(-1)[exc].copy()
    codes = zz.copy()
    codes[over] = 0
    codes[hole] = esc
    words = _pack_codes(codes, bits, w)
    return dict(words=words.reshape(c, h, -1),
                row_first=np.zeros((c, h), np.uint16),
                exc_idx=exc.astype(np.uint32),
                exc_zz=exc_zz.astype(np.uint32)), bits, curr_q


def encode_depth_p4_reference(depth: np.ndarray, prev_q: np.ndarray,
                              budget: int, max_exceptions: int,
                              quant_shift: int = 0,
                              hysteresis: int = 0):
    """Reference p4 encoder (oracle of the native ``fh_depth_encode_p4``).
    Returns ``(enc dict, curr_q)`` or ``None`` when the exception list
    overflows (the caller sends an I-frame)."""
    c, h, w = depth.shape
    rows = c * h
    gw, fw = _p4_geometry(w, budget)
    curr_q = quantize_hysteresis_reference(depth, prev_q, quant_shift,
                                           hysteresis)
    cq = curr_q.reshape(rows, w).astype(np.int64)
    pq = np.asarray(prev_q).reshape(rows, w).astype(np.int64)
    delta = cq - pq
    new_hole = (cq == 0) & (pq != 0)
    # in-stream 4-bit code per pixel: zigzag(delta) for |delta| <= 7,
    # P4_HOLE for value->hole
    zzs = np.where(delta >= 0, delta << 1, ((-delta) << 1) - 1)
    code = np.where((np.abs(delta) <= 7) & (cq != 0) & (pq != 0),
                    zzs, 0).astype(np.uint8)
    code[new_hole] = P4_HOLE
    code[(cq == 0) & (pq == 0)] = 0
    # pixels needing the exception list (code stays 0 there)
    wide = (np.abs(delta) > 7) & (cq != 0) & (pq != 0)
    revive = (cq != 0) & (pq == 0)
    exc_px = wide | revive
    code[exc_px] = 0
    wp = gw * P4_GROUP
    code_p = np.zeros((rows, wp), np.uint8)
    code_p[:, :w] = code
    gcodes = code_p.reshape(rows, gw, P4_GROUP).astype(np.uint32)
    gbytes = (gcodes << (4 * np.arange(P4_GROUP,
                                       dtype=np.uint32))).sum(-1)
    gnz = gbytes != 0
    gcap = budget // 2          # 2 bytes per group literal
    flags = np.zeros((rows, fw), np.uint32)
    lits = np.zeros((rows, budget), np.uint8)
    exc = []
    for r in range(rows):
        nz = np.flatnonzero(gnz[r])
        kept = nz[:gcap]
        spilled = nz[gcap:]
        lits[r, 0: 2 * len(kept): 2] = gbytes[r, kept] & 0xFF
        lits[r, 1: 2 * len(kept) + 1: 2] = gbytes[r, kept] >> 8
        for g in kept:
            flags[r, g // 32] |= np.uint32(1) << np.uint32(g % 32)
        for g in spilled:
            for k in range(P4_GROUP):
                x = g * P4_GROUP + k
                if x >= w:
                    break
                cd = code[r, x]
                if cd == 0 and not exc_px[r, x]:
                    continue
                # every non-zero-code pixel of a spilled group rides the
                # exception list; holes as zigzag(-prev)
                d_eff = int(cq[r, x] - pq[r, x])
                zz = (d_eff << 1) ^ (d_eff >> 63) if d_eff >= 0 else \
                    ((-d_eff) << 1) - 1
                exc.append((r * w + x, zz))
    # wide/revive pixels of KEPT (or unflagged-but-zero-byte) groups
    for r, x in zip(*np.nonzero(exc_px)):
        g = x // P4_GROUP
        if gnz[r, g] and g not in set(np.flatnonzero(gnz[r])[gcap:]):
            d_eff = int(delta[r, x])
            zz = (d_eff << 1) if d_eff >= 0 else ((-d_eff) << 1) - 1
            exc.append((r * w + x, zz))
        elif not gnz[r, g]:
            # exception-only group (all other pixels delta 0): unflagged
            d_eff = int(delta[r, x])
            zz = (d_eff << 1) if d_eff >= 0 else ((-d_eff) << 1) - 1
            exc.append((r * w + x, zz))
    exc.sort()
    if len(exc) > max_exceptions:
        return None
    exc_idx = np.asarray([e[0] for e in exc], np.uint32)
    exc_zz = np.asarray([e[1] for e in exc], np.uint32)
    lw = lits.reshape(rows, budget // 4, 4).astype(np.uint32)
    lit_words = (lw[..., 0] | (lw[..., 1] << 8) | (lw[..., 2] << 16)
                 | (lw[..., 3] << 24))
    return dict(flags=flags, lits=lit_words, exc_idx=exc_idx,
                exc_zz=exc_zz), curr_q
