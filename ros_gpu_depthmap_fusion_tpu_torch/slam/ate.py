"""Absolute trajectory error (ATE) evaluation, TUM-benchmark style (numpy
copy of the JAX package's ``slam/ate.py``):
Umeyama-align the estimated trajectory to ground truth (SE(3), optional
scale), then RMSE over translational residuals."""

from __future__ import annotations

from typing import Tuple

import numpy as np


def umeyama_align(src: np.ndarray, dst: np.ndarray,
                  with_scale: bool = False
                  ) -> Tuple[np.ndarray, float]:
    """Least-squares similarity aligning src -> dst ([N, 3] each).
    Returns (T [4, 4], scale)."""
    mu_s = src.mean(axis=0)
    mu_d = dst.mean(axis=0)
    sc = src - mu_s
    dc = dst - mu_d
    cov = dc.T @ sc / len(src)
    u, d, vt = np.linalg.svd(cov)
    s = np.eye(3)
    if np.linalg.det(u) * np.linalg.det(vt) < 0:
        s[2, 2] = -1
    r = u @ s @ vt
    if with_scale:
        var_s = (sc ** 2).sum() / len(src)
        scale = float(np.trace(np.diag(d) @ s) / var_s)
    else:
        scale = 1.0
    t = mu_d - scale * r @ mu_s
    tf = np.eye(4)
    tf[:3, :3] = scale * r
    tf[:3, 3] = t
    return tf, scale


def ate_rmse(estimated: np.ndarray, groundtruth: np.ndarray,
             with_scale: bool = False) -> float:
    """RMSE of translational error after alignment ([N, 3] positions)."""
    tf, _ = umeyama_align(estimated, groundtruth, with_scale)
    aligned = estimated @ tf[:3, :3].T + tf[:3, 3]
    err = aligned - groundtruth
    return float(np.sqrt((err ** 2).sum(axis=-1).mean()))


def trajectory_positions(poses) -> np.ndarray:
    """[N, 3] camera positions from a list/array of 4x4 world<-cam poses."""
    poses = np.asarray(poses)
    return poses[..., :3, 3]
