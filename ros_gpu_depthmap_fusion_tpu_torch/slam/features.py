"""ORB-style feature detection, description and matching (port of the JAX
package's ``slam/features.py``).

FAST corners with non-maximum suppression and fixed-K top-k selection
(static shapes), intensity-centroid orientation, steered-BRIEF 256-bit
descriptors, and Hamming matching — vectorized tensor code on the image's
device, no data-dependent shapes and no host sync.

Where the port departs from the JAX code's letter (each to keep its
results, see ``tests/test_torch_slam.py``):

- **Top-K tie order.** ``jax.lax.top_k`` returns equal scores lowest flat
  index first; ``torch.topk`` promises no order for ties on CUDA, and FAST
  scores tie often (every pixel off a corner scores 0). The port takes
  the top K of a stable descending sort, which keeps that order.
- **Descriptors are int32** with the JAX package's uint32 bits (PyTorch's
  ``uint32`` supports few ops), and there is no popcount in PyTorch:
  :func:`hamming_matrix` counts the xor's bits with a SWAR sequence on
  int64. Host code that needs the JAX type views them as ``np.uint32``.
- **Orientation.** The BRIEF pattern is steered by ``(cos, sin)`` of the
  patch moment's angle, computed as ``(m10, m01) / hypot`` from IEEE
  divisions and a square root, which round the same on every device, in
  place of ``cos(arctan2(m01, m10))``, whose rounding differs by an ulp
  between XLA:CPU, PyTorch's CPU and CUDA. So the card's descriptors
  equal the CPU port's bit for bit; against the JAX package, a BRIEF
  test whose two samples nearly tie can flip (at most 0.1% of the bits on
  the parity tests' images).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

# 16-point Bresenham circle of radius 3 (FAST), clockwise from 12 o'clock
FAST_RING = np.array([
    (0, -3), (1, -3), (2, -2), (3, -1), (3, 0), (3, 1), (2, 2), (1, 3),
    (0, 3), (-1, 3), (-2, 2), (-3, 1), (-3, 0), (-3, -1), (-2, -2), (-1, -3),
], dtype=np.int32)

BRIEF_PATCH = 15  # half size of the 31x31 descriptor patch


def _brief_pairs(n_bits: int = 256, seed: int = 7) -> np.ndarray:
    """[n_bits, 4] (x1, y1, x2, y2) gaussian test pairs in the patch (the
    JAX package's draw: the same numpy generator and seed)."""
    rng = np.random.default_rng(seed)
    pts = np.clip(rng.normal(0.0, BRIEF_PATCH / 2.5, size=(n_bits, 4)),
                  -BRIEF_PATCH, BRIEF_PATCH)
    return pts.astype(np.float32)


BRIEF = _brief_pairs()

_ORIENT_RADIUS = 7
# intensity-centroid patch offsets (dx, dy) within the orientation radius
_ORIENT_OFFS = np.array(
    [(dx, dy) for dy in range(-_ORIENT_RADIUS, _ORIENT_RADIUS + 1)
     for dx in range(-_ORIENT_RADIUS, _ORIENT_RADIUS + 1)
     if dx * dx + dy * dy <= _ORIENT_RADIUS * _ORIENT_RADIUS], np.float32)


@functools.lru_cache(maxsize=None)
def _table(name: str, device: str) -> torch.Tensor:
    """A constant table on ``device``, copied there once (shared: callers
    must not modify it)."""
    return torch.from_numpy({"brief": BRIEF, "orient": _ORIENT_OFFS}[name]
                            ).to(device)


class Keypoints(NamedTuple):
    xy: torch.Tensor       # [K, 2] float (x, y)
    score: torch.Tensor    # [K]
    angle: torch.Tensor    # [K] radians
    valid: torch.Tensor    # [K] bool
    desc: torch.Tensor     # [K, 8] int32 (256-bit BRIEF, uint32 bits)


def _ring_values(img: torch.Tensor) -> torch.Tensor:
    """[16, H, W] ring samples around each pixel (border wraps; masked by
    the caller's border margin)."""
    return torch.stack([
        torch.roll(img, shifts=(-int(dy), -int(dx)), dims=(0, 1))
        for dx, dy in FAST_RING], dim=0)


def fast_scores(img: torch.Tensor, threshold: float) -> torch.Tensor:
    """FAST-9 corner response per pixel: 0 where not a corner, else the
    sum-of-absolute-differences score (vectorized over the image)."""
    img = img.to(torch.float32)
    ring = _ring_values(img)                              # [16, H, W]
    center = img[None]
    brighter = ring > center + threshold
    darker = ring < center - threshold

    def max_run(b):
        # longest circular run of True >= 9? test all 16 start positions
        doubled = torch.cat([b, b], dim=0)                # [32, H, W]
        ok = torch.zeros(img.shape, dtype=torch.bool, device=img.device)
        for s in range(16):
            ok = ok | torch.all(doubled[s:s + 9], dim=0)
        return ok

    is_corner = max_run(brighter) | max_run(darker)
    # the 16-term SAD summed in ring order, one add at a time, as the JAX
    # reduction over the ring axis adds
    terms = torch.clamp(torch.abs(ring - center) - threshold, min=0.0)
    sad = terms[0]
    for k in range(1, 16):
        sad = sad + terms[k]
    h, w = img.shape
    yy = torch.arange(h, device=img.device)[:, None]
    xx = torch.arange(w, device=img.device)[None, :]
    margin = BRIEF_PATCH + 1
    interior = ((yy >= margin) & (yy < h - margin) &
                (xx >= margin) & (xx < w - margin))
    return torch.where(is_corner & interior, sad, torch.zeros_like(sad))


def _nms3(score: torch.Tensor) -> torch.Tensor:
    """3x3 non-maximum suppression."""
    neigh = score
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy == 0 and dx == 0:
                continue
            neigh = torch.maximum(
                neigh, torch.roll(score, (-dy, -dx), dims=(0, 1)))
    return torch.where(score >= neigh, score, torch.zeros_like(score))


def _bilinear(img: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Bilinear sample img at [..., 2] (x, y) float coords (clamped)."""
    h, w = img.shape
    x = torch.clamp(coords[..., 0], 0.0, w - 1.001)
    y = torch.clamp(coords[..., 1], 0.0, h - 1.001)
    x0 = torch.floor(x).to(torch.int64)
    y0 = torch.floor(y).to(torch.int64)
    fx = x - x0
    fy = y - y0
    v00 = img[y0, x0]
    v01 = img[y0, x0 + 1]
    v10 = img[y0 + 1, x0]
    v11 = img[y0 + 1, x0 + 1]
    return ((1 - fy) * ((1 - fx) * v00 + fx * v01)
            + fy * ((1 - fx) * v10 + fx * v11))


def _moments(img: torch.Tensor, xy: torch.Tensor):
    """Intensity-centroid moments (m10, m01) of each keypoint's patch
    (ORB)."""
    offs = _table("orient", str(img.device))             # [P, 2]
    vals = _bilinear(img, xy[:, None, :] + offs[None])    # [K, P]
    m10 = torch.sum(vals * offs[None, :, 0], dim=1)
    m01 = torch.sum(vals * offs[None, :, 1], dim=1)
    return m10, m01


def _orientation(img: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """Intensity-centroid orientation per keypoint (ORB): angle of the
    patch moment vector (m01, m10)."""
    m10, m01 = _moments(img, xy)
    return torch.arctan2(m01, m10)


def _steering(m10: torch.Tensor, m01: torch.Tensor):
    """(cos, sin) [K, 1] of the moment vector's angle, by IEEE division and
    square root (device-independent rounding; see the module docstring).
    A zero moment vector gives (1, 0), as ``arctan2(0, 0) = 0`` does."""
    r = torch.sqrt(m10 * m10 + m01 * m01)
    flat = r == 0
    r = torch.where(flat, torch.ones_like(r), r)
    c = torch.where(flat, torch.ones_like(r), m10 / r)
    s = torch.where(flat, torch.zeros_like(r), m01 / r)
    return c[:, None], s[:, None]


def _pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """[K, 256] bool -> [K, 8] int32 words holding the JAX package's uint32
    bits (bit j of word w is test 32 w + j)."""
    weights = torch.ones(32, dtype=torch.int64, device=bits.device) \
        << torch.arange(32, device=bits.device)
    words = torch.sum(bits.reshape(-1, 8, 32).to(torch.int64)
                      * weights[None, None, :], dim=-1)
    # two's-complement wrap into int32
    return torch.where(words >= 1 << 31, words - (1 << 32),
                       words).to(torch.int32)


def _brief_descriptors(img: torch.Tensor, xy: torch.Tensor,
                       c: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """[K, 8] int32 steered-BRIEF descriptors; ``c``, ``s`` [K, 1] the
    cosine and sine of each keypoint's orientation."""
    pairs = _table("brief", str(img.device))             # [256, 4]

    def rot(px, py):
        return (c * px[None] - s * py[None],
                s * px[None] + c * py[None])

    x1, y1 = rot(pairs[:, 0], pairs[:, 1])               # [K, 256]
    x2, y2 = rot(pairs[:, 2], pairs[:, 3])
    p1 = torch.stack([xy[:, None, 0] + x1, xy[:, None, 1] + y1], dim=-1)
    p2 = torch.stack([xy[:, None, 0] + x2, xy[:, None, 1] + y2], dim=-1)
    return _pack_bits(_bilinear(img, p1) < _bilinear(img, p2))


def detect_and_describe(img: torch.Tensor,
                        max_keypoints: int = 256,
                        threshold: float = 12.0) -> Keypoints:
    """Full frontend feature pass on a [H, W] intensity (or depth) image,
    on the image's device."""
    img = img.to(torch.float32)
    score = _nms3(fast_scores(img, threshold))
    h, w = img.shape
    flat = score.reshape(-1)
    # jax.lax.top_k's order: descending, equal scores lowest index first
    # (a stable sort; torch.topk leaves ties unordered on CUDA)
    topv, topi = torch.sort(flat, descending=True, stable=True)
    topv, topi = topv[:max_keypoints], topi[:max_keypoints]
    xy = torch.stack([(topi % w).to(torch.float32),
                      (topi // w).to(torch.float32)], dim=-1)
    valid = topv > 0
    m10, m01 = _moments(img, xy)
    angle = torch.arctan2(m01, m10)
    desc = _brief_descriptors(img, xy, *_steering(m10, m01))
    return Keypoints(xy=xy, score=topv, angle=angle, valid=valid, desc=desc)


def _popcount32(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each int32's 32-bit pattern (SWAR on int64)."""
    x = x.to(torch.int64) & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & 0xFFFFFFFF) >> 24


def hamming_matrix(da: torch.Tensor, db: torch.Tensor) -> torch.Tensor:
    """[KA, KB] Hamming distances between int32x8 descriptor sets."""
    x = torch.bitwise_xor(da[:, None, :], db[None, :, :])
    return torch.sum(_popcount32(x), dim=-1).to(torch.int32)


class Matches(NamedTuple):
    idx_a: torch.Tensor    # [K] index into A
    idx_b: torch.Tensor    # [K] best match in B
    dist: torch.Tensor     # [K] hamming distance
    valid: torch.Tensor    # [K] mutual + ratio + validity gate


def match(a: Keypoints, b: Keypoints,
          max_distance: int = 64,
          ratio: float = 0.9) -> Matches:
    """Mutual nearest-neighbor matching with Lowe ratio test (static K).
    ``argmin`` returns the first minimum, as JAX's does."""
    big = 10_000
    d = hamming_matrix(a.desc, b.desc)
    d = torch.where(a.valid[:, None] & b.valid[None, :], d,
                    torch.full_like(d, big))
    best_b = torch.argmin(d, dim=1)
    ka = a.xy.shape[0]
    rows = torch.arange(ka, device=d.device)
    best_d = d[rows, best_b]
    # second best for ratio test
    d2 = d.clone()
    d2[rows, best_b] = big
    second_d = torch.min(d2, dim=1).values
    # mutual check
    best_a_of_b = torch.argmin(d, dim=0)
    mutual = best_a_of_b[best_b] == rows
    valid = (a.valid & mutual & (best_d <= max_distance)
             & (best_d.to(torch.float32)
                <= ratio * second_d.to(torch.float32)))
    return Matches(idx_a=rows.to(torch.int32),
                   idx_b=best_b.to(torch.int32),
                   dist=best_d, valid=valid)
