"""The links' effect on what the step sees, worked out from the raw
staged inputs.

- Depth: with ``depth_link_codec="dpcm"`` and no quantization the link is
  lossless and the step sees the staged depth. With ``"dpcm_temporal"``
  the encoder sends an I-keyframe (the depth quantized to ``2**shift``
  units) first, then whenever ``depth_codec_keyframe_interval`` P-frames
  have followed one, and whenever a p4 P-frame would need more exception
  slots than ``depth_codec_max_exceptions``; a p4 P-frame carries the
  hysteresis-quantized depth, each pixel keeping its previous bin while
  the raw value stays within half a bin plus ``depth_codec_hysteresis``
  of it. The P-frame carries that series without loss, so the step sees
  ``series << shift``.
- Lidar with ``lidar_link_delta``: each point quantized to multiples of
  ``lidar_link_quant_step`` (3 x u16 about 32768), a sequence truncated at
  its first point whose wide deltas (more than 7 steps) no longer fit the
  frame's exception list.

Plain torch and numpy; nothing of the port is imported.
"""

from __future__ import annotations

import numpy as np
import torch

P4_GROUP = 4


def quantize(d: torch.Tensor, shift: int) -> torch.Tensor:
    """Nonzero depth -> clamped multiples of ``2**shift`` in quantized
    units; holes stay 0 (int32 in, int32 out)."""
    if not shift:
        return d
    q = torch.clamp((d + (1 << (shift - 1))) >> shift, 1, 65535 >> shift)
    return torch.where(d != 0, q, 0)


def quantize_hysteresis(d: torch.Tensor, prev_q: torch.Tensor, shift: int,
                        hysteresis: int) -> torch.Tensor:
    """A valid pixel keeps its previous bin while ``|d - dequant(prev)| <=
    2**(shift-1) + hysteresis``; otherwise it is quantized anew."""
    q = quantize(d, shift)
    if not shift:
        return q
    band = (1 << (shift - 1)) + hysteresis
    hold = (d != 0) & (prev_q != 0) & ((d - (prev_q << shift)).abs() <= band)
    return torch.where(hold, prev_q, q)


def p4_exceptions(cq: torch.Tensor, pq: torch.Tensor, budget: int
                  ) -> int:
    """Exception slots a p4 P-frame of series ``cq`` against ``pq`` needs
    (``[C, H, W]`` int32): every pixel whose step exceeds 7 bins or that
    comes back from a hole, and every nonzero 4-bit code of a group past
    the row's ``budget // 2`` literal groups."""
    c, h, w = cq.shape
    rows = c * h
    cq = cq.reshape(rows, w)
    pq = pq.reshape(rows, w)
    delta = cq - pq
    both = (cq != 0) & (pq != 0)
    exc_px = (both & (delta.abs() > 7)) | ((cq != 0) & (pq == 0))
    code_nz = ((both & (delta != 0)) | ((cq == 0) & (pq != 0))) & ~exc_px
    gw = -(-w // P4_GROUP)
    pad = gw * P4_GROUP - w
    g_nz = torch.nn.functional.pad(code_nz, (0, pad)).reshape(
        rows, gw, P4_GROUP)
    group_nz = g_nz.any(-1)
    rank = torch.cumsum(group_nz.to(torch.int32), 1)   # 1-based
    spilled = group_nz & (rank > budget // 2)
    return int(exc_px.sum()) + int((g_nz & spilled[..., None]).sum())


class DepthLink:
    """The depth series the step sees, frame by frame from frame 0.
    ``cfg``: the configuration file's ``fusion`` fields."""

    def __init__(self, cfg: dict):
        self.codec = cfg["depth_link_codec"]
        self.shift = cfg["depth_codec_quant_shift"]
        self.hyst = cfg["depth_codec_hysteresis"]
        self.interval = cfg["depth_codec_keyframe_interval"]
        self.budget = cfg["depth_codec_p4_budget"]
        self.max_exc = cfg["depth_codec_max_exceptions"]
        if self.codec not in ("dpcm", "dpcm_temporal"):
            raise ValueError(f"depth_link_codec {self.codec!r}")
        if self.codec == "dpcm_temporal" and not self.budget:
            raise ValueError("the reference models p4 P-frames only")
        self.frame = 0
        self.series = None
        self.since_key = 0
        self.keyframes = []

    def next(self, depth: torch.Tensor) -> torch.Tensor:
        """The decoded ``[C, H, W]`` int32 depth of the next frame, from
        its staged u16 depth (int32)."""
        f = self.frame
        self.frame += 1
        if self.codec == "dpcm":
            return (quantize(depth, self.shift) << self.shift) & 0xFFFF
        series = None
        if self.series is not None and self.since_key < self.interval:
            cq = quantize_hysteresis(depth, self.series, self.shift,
                                     self.hyst)
            if p4_exceptions(cq, self.series, self.budget) <= self.max_exc:
                series = cq
                self.since_key += 1
        if series is None:
            series = quantize(depth, self.shift)
            self.since_key = 0
            self.keyframes.append(f)
        self.series = series
        return (series << self.shift) & 0xFFFF


def stage_lidar(packets, step: float, exc_cap: int, stage_cap: int,
                seq_cap: int):
    """One frame's lidar packets as the delta-coded link delivers them:
    ``[(q [n, 3] int32 quantized, sec, nsec)]`` per staged sequence (a
    sequence that cannot take even one point is left out)."""
    fill = exc = 0
    out = []
    for pts, sec, nsec in packets:
        n = min(len(pts), stage_cap - fill)
        if n <= 0 or len(out) >= seq_cap:
            break
        q = np.clip(np.rint(np.asarray(pts[:n], np.float32)[:, :3] / step
                            + 32768.0), 0, 65535).astype(np.int32)
        d = np.zeros((n, 3), np.int32)
        if n > 1:
            d[1:] = np.diff(q, axis=0)
        wide = (np.abs(d) > 7).sum(axis=1)
        over = exc + np.cumsum(wide) > exc_cap
        if over.any():
            n = int(np.argmax(over))
            if n <= 0:
                continue
            q, wide = q[:n], wide[:n]
        exc += int(wide.sum())
        fill += n
        out.append((q, sec, nsec))
    return out
