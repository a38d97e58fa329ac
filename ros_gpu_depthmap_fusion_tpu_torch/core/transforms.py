"""SE(3) transforms on homogeneous point tensors.

Transforms are row-major ``[4, 4]`` matrices applied as ``M @ p`` (the
reference's effective math, ``shader/transform_points_indirect.glsl:67``).
Points are ``[..., 4]`` homogeneous float32 with w = 1 for valid points and
all-zero rows for invalid ones.

Rounding is part of the contract: the JAX package is the reference, and
its float32 products of 4-vectors round in a fixed order on XLA:CPU
(measured against this module). ``transform_points`` and
``compose_seq_transforms`` sum pairwise, ``(x·T0 + y·T1) + (z·T2 + w·T3)``;
the per-point ``transform_points_indirect`` is a chain of fused
multiply-adds. A plain ``matmul``/``einsum`` rounds differently in the last
ulp and would move points that sit on a cell or crop boundary.
"""

from __future__ import annotations

import numpy as np
import torch


def fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 ``a * b + c`` (one rounding), on any
    device: the product is exact in float64, TwoSum gives the float64
    rounding error of the sum, and a sum that lands exactly halfway between
    two float32 values is nudged toward the exact result before the final
    rounding (the only case where rounding twice differs from once)."""
    x = a.double() * b.double()
    y = c.double().expand_as(x)
    s = x + y
    bb = s - x
    err = (x - (s - bb)) + (y - bb)
    # an f32 halfway point has exactly bit 28 set in the low 29 bits of
    # the f64 significand
    low = s.view(torch.int64) & ((1 << 29) - 1)
    tie = (low == (1 << 28)) & (err != 0)
    toward = torch.where(err > 0, torch.inf, -torch.inf).to(s.dtype)
    s = torch.where(tie, torch.nextafter(s, toward), s)
    return s.float()


def transform_points(points: torch.Tensor, tf: torch.Tensor) -> torch.Tensor:
    """Apply one ``[4, 4]`` transform to ``[..., 4]`` points."""
    cols = [points[..., j:j + 1] * tf[:, j] for j in range(4)]
    return (cols[0] + cols[1]) + (cols[2] + cols[3])


def transform_points_batched(points: torch.Tensor,
                             tfs: torch.Tensor) -> torch.Tensor:
    """``[C, N, 4]`` points, ``[C, 4, 4]`` transforms -> ``[C, N, 4]``
    (the JAX package's ``einsum("chw,cvw->chv")``)."""
    cols = [points[..., j:j + 1] * tfs[:, None, :, j] for j in range(4)]
    return (cols[0] + cols[1]) + (cols[2] + cols[3])


def transform_points_indirect(points: torch.Tensor,
                              tfs: torch.Tensor,
                              tf_indices: torch.Tensor,
                              mask: torch.Tensor) -> torch.Tensor:
    """``out[i] = tfs[tf_indices[i]] @ points[i]`` where ``mask[i]``, else
    ``points[i]`` (``shader/transform_points_indirect.glsl:60-68``).

    Args:
        points:     ``[N, 4]``.
        tfs:        ``[S, 4, 4]``.
        tf_indices: ``[N]`` integer indices into ``tfs``.
        mask:       ``[N]`` bool.
    """
    m = tfs[tf_indices.long()]                       # [N, 4, 4]
    acc = m[:, :, 0] * points[:, 0:1]
    for j in range(1, 4):
        acc = fma(m[:, :, j], points[:, j:j + 1], acc)
    return torch.where(mask[:, None], acc, points)


def compose_seq_transforms(tf_frame_move: torch.Tensor,
                           tf_move_seq: torch.Tensor) -> torch.Tensor:
    """``[4, 4]`` target <- move and ``[S, 4, 4]`` move <- sequence ->
    ``[S, 4, 4]`` target <- sequence (``T_frame<-move @ T_move<-seq``)."""
    t = [tf_frame_move[None, :, j, None] * tf_move_seq[:, j, None, :]
         for j in range(4)]
    return (t[0] + t[1]) + (t[2] + t[3])


# ---------------------------------------------------------------------------
# Host-side (numpy) constructors
# ---------------------------------------------------------------------------

def make_se3(rotation: np.ndarray = None,
             translation: np.ndarray = None) -> np.ndarray:
    t = np.eye(4, dtype=np.float32)
    if rotation is not None:
        t[:3, :3] = rotation
    if translation is not None:
        t[:3, 3] = translation
    return t


def rot_x(angle: float) -> np.ndarray:
    c, s = np.cos(angle), np.sin(angle)
    return np.array([[1, 0, 0], [0, c, -s], [0, s, c]], dtype=np.float32)


def rot_y(angle: float) -> np.ndarray:
    c, s = np.cos(angle), np.sin(angle)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], dtype=np.float32)


def rot_z(angle: float) -> np.ndarray:
    c, s = np.cos(angle), np.sin(angle)
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], dtype=np.float32)


def look_at(eye, target, up=(0.0, 0.0, 1.0)) -> np.ndarray:
    """world <- camera pose for a pinhole camera at ``eye`` looking at
    ``target`` (CV convention: +x right, +y down, +z forward)."""
    eye = np.asarray(eye, np.float64)
    fwd = np.asarray(target, np.float64) - eye
    fwd = fwd / max(np.linalg.norm(fwd), 1e-12)
    up = np.asarray(up, np.float64)
    x = np.cross(fwd, up)
    n = np.linalg.norm(x)
    if n < 1e-9:  # looking straight along up: pick an arbitrary right
        x = np.cross(fwd, np.array([1.0, 0.0, 0.0]))
        n = np.linalg.norm(x)
    x = x / n
    y = np.cross(fwd, x)
    r = np.stack([x, y, fwd], axis=1).astype(np.float32)
    return make_se3(r, eye.astype(np.float32))


def invert_se3(tf: np.ndarray) -> np.ndarray:
    """Closed-form inverse of a rigid transform."""
    r = tf[:3, :3]
    t = tf[:3, 3]
    out = np.eye(4, dtype=tf.dtype)
    out[:3, :3] = r.T
    out[:3, 3] = -r.T @ t
    return out


def to_homogeneous(xyz: np.ndarray) -> np.ndarray:
    """``[..., 3]`` -> ``[..., 4]`` with w=1."""
    shape = xyz.shape[:-1] + (4,)
    out = np.ones(shape, dtype=xyz.dtype)
    out[..., :3] = xyz
    return out
