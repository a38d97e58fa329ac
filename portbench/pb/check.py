"""The comparison that decides ``correct``.

Once the window has closed, a sample of the frames the window completed,
drawn from the seed, is held to the plain reference
(:mod:`reference.fusion`), which works each frame out again from the
scene. What is compared was copied to host memory when the frame was
published. Each frame gives these numbers, and a run's number is the
worst over its frames:

- ``fused_cells_pct``: cells of the published cloud not matched one to
  one by the reference's cells, both ways, per 100 reference cells;
- ``fused_gap_mm``: the widest gap, in any coordinate, between a matched
  cell's published mean point and the reference's;
- ``occupancy_pct``: cells whose occupancy differs from the reference's
  history (its value where the frame emits the dense grid, its occupied
  bit where it emits sparse blocks), per 100 occupied reference cells;
- ``raw_pct`` (frames that emit the raw cloud): the sum over cells of
  the gap between the raw cloud's point count in the cell and the
  reference's, per 100 reference points.

The limits are the configuration file's ``limits``: one for each number
a frame gives (an entry that judges its frames otherwise gives its own
numbers, each with a limit there).
"""

from __future__ import annotations

import sys

import numpy as np
import torch

NUMBERS = ("fused_cells_pct", "fused_gap_mm", "occupancy_pct", "raw_pct")


def sample_frames(seed: int, first: int, last: int) -> set:
    """Frames in ``[first, last]`` to compare: ``first`` (the window's
    first frame, so that every run compares one), then one every 90-179
    frames, drawn from the seed."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, 0x5A4D]))
    out, f = set(), first
    while f <= last:
        out.add(f)
        f += int(rng.integers(90, 180))
    return out


def program_outputs(out, fused_host: torch.Tensor) -> dict:
    """A frame's outputs in the judge's form, in host memory: the
    published cloud ``[n, 3]``, the dense occupancy or the occupied bits
    of the sparse blocks, and the raw cloud ``[m, 3]`` when the frame
    carries it."""
    d = {"fused": fused_host[:, :3]}
    if out.occupancy_u8.numel() > 1:
        d["occ_dense"] = out.occupancy_u8.cpu()
    else:
        n = int(out.occupancy_sparse_count)
        idx = out.occupancy_sparse_idx[:n].cpu().long()
        words = out.occupancy_sparse_words[:n].cpu().to(torch.int64) \
            & 0xFFFFFFFF
        bits = ((words[:, :, None] >> torch.arange(32)) & 1).reshape(
            n, 128).bool()
        blocks = -(-out.occupancy_bits.numel() // 16)
        occ = torch.zeros((blocks, 128), dtype=torch.bool)
        occ[idx] |= bits
        d["occ_bits"] = occ.reshape(-1)
    if out.raw_points.shape[0] > 1:
        d["raw"] = out.raw_points[:int(out.raw_count), :3].cpu()
    return d


def judge(ref, f: int, prog: dict) -> dict:
    """The numbers of frame ``f`` (see the module docstring)."""
    grid = ref.grid
    raw_ref, cells_ref, means_ref = ref.frame(f)
    dev = cells_ref.device
    pts = prog["fused"].to(dev, torch.float32)
    cells_p = grid.index(pts)
    order = torch.argsort(cells_p, stable=True)
    cells_p, pts = cells_p[order], pts[order]
    uniq_p, cnt_p = torch.unique_consecutive(cells_p, return_counts=True)
    n_p, n_r = int(cells_p.shape[0]), int(cells_ref.shape[0])
    if uniq_p.shape[0]:
        pos = torch.clamp_max(torch.searchsorted(uniq_p, cells_ref),
                              uniq_p.shape[0] - 1)
        hit = uniq_p[pos] == cells_ref
    else:
        pos = torch.zeros_like(cells_ref)
        hit = torch.zeros_like(cells_ref, dtype=torch.bool)
    common = int(hit.sum())
    nums = {"fused_cells_pct":
            100.0 * (n_p + n_r - 2 * common) / max(n_r, 1)}
    # the gap over cells the program emitted once and the reference has
    single = hit & (cnt_p[pos] == 1) if uniq_p.shape[0] else hit
    first = torch.cumsum(cnt_p, 0) - cnt_p
    gap = 0.0
    if bool(single.any()):
        a = pts[first[pos[single]]].double()
        b = means_ref[single].to(torch.float32).double()
        gap = float((a - b).abs().max()) * 1e3
    nums["fused_gap_mm"] = gap
    hist = ref.history(f)
    occupied = max(int((hist > 0).sum()), 1)
    if "occ_dense" in prog:
        diff = int((prog["occ_dense"].to(dev, torch.int32)
                    != torch.clamp(hist, 0, 255)).sum())
    else:
        bits = prog["occ_bits"].to(dev)
        ref_bits = torch.zeros_like(bits)
        ref_bits[:hist.shape[0]] = hist > 0
        diff = int((bits != ref_bits).sum())
    nums["occupancy_pct"] = 100.0 * diff / occupied
    if "raw" in prog:
        n = grid.num_cells
        cnt_prog = torch.bincount(grid.index(prog["raw"].to(
            dev, torch.float32)), minlength=n)
        cnt_ref = torch.bincount(grid.index(raw_ref.to(torch.float32)),
                                 minlength=n)
        nums["raw_pct"] = (100.0 * float((cnt_prog - cnt_ref).abs().sum())
                           / max(int(raw_ref.shape[0]), 1))
    return nums


def verdict(per_frame: dict, limits: dict) -> tuple:
    """``(correct, checks)``: every number's worst over the frames beside
    its limit; ``correct`` when at least one frame was compared and no
    number exceeds its limit. A number without a limit is an error."""
    checks = {}
    for nums in per_frame.values():
        for name, v in nums.items():
            if name not in checks:
                checks[name] = {"value": v, "limit": limits[name]}
            checks[name]["value"] = max(checks[name]["value"], v)
    ok = bool(per_frame) and all(c["value"] <= c["limit"]
                                 for c in checks.values())
    return ok, checks


def print_checks(checks: dict, frames: int) -> None:
    """Each number beside its limit, as the last lines on stderr."""
    print(f"correctness over {frames} frames:", file=sys.stderr)
    for name, c in checks.items():
        print(f"  {name} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
