"""Frame-to-frame pose estimation from 3-D correspondences (port of the JAX
package's ``slam/pose_estimation.py``).

RGB-D gives metric 3-D points per feature, so relative pose is a 3D-3D
alignment problem: Kabsch/Umeyama closed-form SVD alignment wrapped in a
fixed-iteration, fully vectorized RANSAC (all hypotheses in one batch, no
data-dependent control flow and no host sync in it), followed by an
all-inlier refinement.

Float32 throughout: the package turns TF32 off at import (the JAX
package's bf16 matmuls once put decimetre errors into every BA window;
see its ``kabsch`` docstring).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ros_gpu_depthmap_fusion_tpu_torch.core import devconst


def _det3(m: torch.Tensor) -> torch.Tensor:
    """Determinant of [..., 3, 3] by cofactors (elementwise: no solver and
    no host sync on the card)."""
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    return a * (e * i - f * h) - b * (d * i - f * g) + c * (d * h - e * g)


def _apply(tf: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """``pts @ R^T + t`` for [..., 4, 4] transforms and [..., N, 3]
    points."""
    return pts @ torch.swapaxes(tf[..., :3, :3], -1, -2) \
        + tf[..., None, :3, 3]


def kabsch(src: torch.Tensor, dst: torch.Tensor,
           weights: torch.Tensor) -> torch.Tensor:
    """Weighted rigid alignment: returns T (4x4) with dst ~= T @ src.
    Batched: ``src``, ``dst`` [..., N, 3], ``weights`` [..., N] give
    [..., 4, 4].

    Standard Kabsch/Umeyama via 3x3 SVD with reflection fix. The card's
    SVD (cuSOLVER) may return singular vectors of other signs than
    LAPACK's; ``R = V diag(1, 1, d) U^T`` does not depend on them when the
    singular values are distinct, so R and t agree with the CPU to a
    bound, not bit for bit.
    """
    w = weights.to(torch.float32)
    wsum = torch.clamp(torch.sum(w, dim=-1), min=1e-9)[..., None]
    mu_s = torch.sum(src * w[..., None], dim=-2) / wsum
    mu_d = torch.sum(dst * w[..., None], dim=-2) / wsum
    sc = src - mu_s[..., None, :]
    dc = dst - mu_d[..., None, :]
    h = torch.swapaxes(sc * w[..., None], -1, -2) @ dc     # [..., 3, 3]
    u, _, vt = torch.linalg.svd(h)
    v = torch.swapaxes(vt, -1, -2)
    ut = torch.swapaxes(u, -1, -2)
    d = torch.sign(_det3(v @ ut))
    diag = torch.stack([torch.ones_like(d), torch.ones_like(d), d], dim=-1)
    r = (v * diag[..., None, :]) @ ut
    t = mu_d - (r @ mu_s[..., None])[..., 0]
    top = torch.cat([r, t[..., None]], dim=-1)
    bottom = torch.zeros_like(top[..., :1, :])
    bottom[..., 0, 3] = 1.0
    return torch.cat([top, bottom], dim=-2)


class RansacResult(NamedTuple):
    transform: torch.Tensor   # [4, 4] dst <- src
    inliers: torch.Tensor     # [N] bool
    num_inliers: torch.Tensor
    rmse: torch.Tensor        # inlier RMSE


def _sample_hypotheses(generator: torch.Generator, probs: torch.Tensor,
                       iterations: int) -> torch.Tensor:
    """``[iterations, 3]`` int64 correspondence indices: per hypothesis 3
    distinct indices drawn with weights ``probs`` (Gumbel top-3, which
    is sampling without replacement), from ``generator`` on ``probs``'s
    device. Zero-weight rows are drawn only when fewer than 3 rows have
    weight, as JAX's ``random.choice(..., replace=False, p=probs)``
    draws them.

    The JAX package draws from threefry keys, which PyTorch cannot
    reproduce; the parity tests replace this function with one that
    returns JAX's indices for the same keys."""
    u = torch.rand((iterations, probs.shape[0]), generator=generator,
                   device=probs.device)
    gumbel = -torch.log(-torch.log(torch.clamp(u, min=1e-20)))
    return torch.topk(torch.log(probs)[None] + gumbel, 3, dim=-1).indices


def ransac_pose(src: torch.Tensor, dst: torch.Tensor, valid: torch.Tensor,
                generator: torch.Generator,
                iterations: int = 64,
                inlier_threshold: float = 0.05) -> RansacResult:
    """Robust rigid alignment of correspondences ``dst[i] ~ T @ src[i]``.

    Args:
        src, dst: [N, 3] matched points (invalid rows arbitrary).
        valid:    [N] bool correspondence validity.
        generator: a ``torch.Generator`` on the points' device
            (hypothesis sampling).
        iterations: hypothesis count, evaluated as one batch.

    The best hypothesis is the first with the most inliers (``argmax``'s
    first maximum, as JAX's). Degenerate (collinear) samples may pick
    another best hypothesis on the card than on the CPU when counts tie;
    the inlier counts agree.
    """
    thr2 = devconst.scalar_f32(inlier_threshold, src.device) ** 2
    probs = valid.to(torch.float32)
    probs = probs / torch.clamp(torch.sum(probs), min=1e-9)

    idx = _sample_hypotheses(generator, probs, iterations)  # [I, 3]
    tfs = kabsch(src[idx], dst[idx],
                 torch.ones(idx.shape, device=src.device))  # [I, 4, 4]
    res = dst[None] - _apply(tfs, src[None])
    err2 = torch.sum(res * res, dim=-1)                       # [I, N]
    counts = torch.sum((valid[None] & (err2 < thr2)).to(torch.int32),
                       dim=-1)
    tf = tfs[torch.argmax(counts)]

    # refine on the best hypothesis' inliers (two Kabsch refits)
    for _ in range(2):
        res = dst - _apply(tf, src)
        inl = valid & (torch.sum(res * res, dim=-1) < thr2)
        tf = kabsch(src, dst, inl.to(torch.float32))
    res = dst - _apply(tf, src)
    err2 = torch.sum(res * res, dim=-1)
    num = torch.sum(inl.to(torch.int32))
    rmse = torch.sqrt(torch.sum(torch.where(inl, err2, torch.zeros_like(err2)))
                      / torch.clamp(num, min=1))
    return RansacResult(transform=tf, inliers=inl, num_inliers=num,
                        rmse=rmse)


def unproject_keypoints(xy: torch.Tensor, depth_m: torch.Tensor,
                        fx: float, fy: float, cx: float, cy: float
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Camera-frame 3-D points for keypoint pixels from a [H, W] metric
    depth image (nearest-pixel lookup); returns (points [K, 3], has_depth).
    The intrinsics divide as float32 tensors on the points' device: on
    CUDA, PyTorch divides by a Python scalar as a multiplication by its
    reciprocal."""
    dev = xy.device
    h, w = depth_m.shape
    xi = torch.clamp(torch.round(xy[:, 0]).to(torch.int64), 0, w - 1)
    yi = torch.clamp(torch.round(xy[:, 1]).to(torch.int64), 0, h - 1)
    z = depth_m[yi, xi]
    x = (xy[:, 0] - devconst.const(cx, dev)) / devconst.const(fx, dev) * z
    y = (xy[:, 1] - devconst.const(cy, dev)) / devconst.const(fy, dev) * z
    return torch.stack([x, y, z], dim=-1), z > 0
