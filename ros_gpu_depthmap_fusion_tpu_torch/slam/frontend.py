"""RGB-D visual odometry frontend + keyframe/landmark bookkeeping (port of
the JAX package's ``slam/frontend.py``).

Per frame: FAST/BRIEF features (device) -> match to the active keyframe
(device) -> RANSAC Kabsch relative pose (device) -> host keyframe decision.
Keyframes carry landmark ids; matched features propagate their landmark,
new ones spawn landmarks at their world position. The resulting window
(poses, landmarks, camera-frame observations) feeds
:func:`~.ba.solve_window` for windowed bundle adjustment.

Every tensor lives on the odometry's ``device``; the host reads the
keypoints' 3-D points and the match and RANSAC results once a frame
(the JAX package's ``np.asarray`` reads, kept where it has them). The
RANSAC draws come from a ``torch.Generator`` on that device, seeded from
``seed``.
"""

from __future__ import annotations

import dataclasses
from collections import Counter
from typing import List, Optional, Tuple

import numpy as np
import torch

from ros_gpu_depthmap_fusion_tpu_torch.core.camera import PinholeIntrinsics
from ros_gpu_depthmap_fusion_tpu_torch.slam import features as feat
from ros_gpu_depthmap_fusion_tpu_torch.slam.ba import BAProblem, solve_window
from ros_gpu_depthmap_fusion_tpu_torch.slam.pose_estimation import (
    ransac_pose, unproject_keypoints)


@dataclasses.dataclass
class Keyframe:
    stamp: float
    pose: np.ndarray            # world <- camera
    kps: feat.Keypoints         # on the odometry's device
    pts_cam: np.ndarray         # [K, 3]
    has_depth: np.ndarray       # [K]
    landmark_ids: np.ndarray    # [K] int64, -1 = none


@dataclasses.dataclass
class OdometryResult:
    pose: np.ndarray
    num_matches: int
    num_inliers: int
    rmse: float
    is_keyframe: bool


def _host(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


def _f32(a: np.ndarray, device) -> torch.Tensor:
    """A host image as float32 on ``device`` (JAX's ``jnp.asarray`` makes
    float64 float32 too)."""
    return torch.from_numpy(np.asarray(a, np.float32)).to(device)


class RgbdOdometry:
    """``device`` has no default: ``"cuda"`` runs the frontend on the card,
    ``"cpu"`` on the host."""

    def __init__(self, intrinsics: PinholeIntrinsics, device,
                 max_keypoints: int = 512,
                 fast_threshold: float = 12.0,
                 min_inliers: int = 12,
                 keyframe_translation: float = 0.15,
                 keyframe_rotation: float = 0.15,
                 keyframe_min_inliers: int = 40,
                 ransac_iterations: int = 64,
                 inlier_threshold: float = 0.05,
                 seed: int = 0):
        self.intr = intrinsics
        self.device = torch.device(device)
        self.max_keypoints = max_keypoints
        self.fast_threshold = fast_threshold
        self.min_inliers = min_inliers
        self.kf_trans = keyframe_translation
        self.kf_rot = keyframe_rotation
        self.kf_min_inliers = keyframe_min_inliers
        self.ransac_iterations = ransac_iterations
        self.inlier_threshold = inlier_threshold
        self.generator = torch.Generator(self.device).manual_seed(seed)
        self.keyframes: List[Keyframe] = []
        self.trajectory: List[Tuple[float, np.ndarray]] = []
        self._next_landmark = 0
        self.landmarks = {}         # id -> world position [3]
        self.observations = []      # (kf_index, landmark_id, p_cam [3])
        self.pose = np.eye(4, dtype=np.float32)
        # diagnostic: how far each run_ba call moved the latest pose
        self.ba_corrections: List[float] = []
        # fault-injection hook for drift-robustness tests: when set, each
        # accepted relative pose passes through it before composition
        # (tests inject systematic drift and check loop closure recovers
        # it — slam/loop_closure.py)
        self.rel_hook = None

    # ------------------------------------------------------------------
    def _extract(self, intensity: np.ndarray, depth_m: np.ndarray):
        kps = feat.detect_and_describe(
            _f32(intensity, self.device),
            max_keypoints=self.max_keypoints, threshold=self.fast_threshold)
        pts, has_d = unproject_keypoints(
            kps.xy, _f32(depth_m, self.device),
            self.intr.fx, self.intr.fy, self.intr.cx, self.intr.cy)
        return kps, _host(pts), _host(has_d & kps.valid)

    def _new_keyframe(self, stamp, pose, kps, pts_cam, has_depth,
                      inherited: Optional[np.ndarray] = None):
        k = pts_cam.shape[0]
        lm_ids = np.full(k, -1, np.int64)
        if inherited is not None:
            lm_ids = inherited
        kf_index = len(self.keyframes)
        for i in range(k):
            if not has_depth[i]:
                lm_ids[i] = -1
                continue
            if lm_ids[i] < 0:
                lm_ids[i] = self._next_landmark
                self._next_landmark += 1
                p_world = pose[:3, :3] @ pts_cam[i] + pose[:3, 3]
                self.landmarks[int(lm_ids[i])] = p_world
            self.observations.append((kf_index, int(lm_ids[i]),
                                      pts_cam[i].copy()))
        self.keyframes.append(Keyframe(
            stamp=stamp, pose=pose.copy(), kps=kps, pts_cam=pts_cam,
            has_depth=has_depth, landmark_ids=lm_ids))

    # ------------------------------------------------------------------
    def process(self, stamp: float, intensity: np.ndarray,
                depth_m: np.ndarray) -> OdometryResult:
        kps, pts_cam, has_depth = self._extract(intensity, depth_m)
        if not self.keyframes:
            self.pose = np.eye(4, dtype=np.float32)
            self._new_keyframe(stamp, self.pose, kps, pts_cam, has_depth)
            self.trajectory.append((stamp, self.pose.copy()))
            return OdometryResult(self.pose.copy(), 0, 0, 0.0, True)

        kf = self.keyframes[-1]
        matches = feat.match(kf.kps, kps)
        idx_a = _host(matches.idx_a)
        idx_b = _host(matches.idx_b)
        mvalid = (_host(matches.valid)
                  & kf.has_depth[idx_a] & has_depth[idx_b])
        num_matches = int(mvalid.sum())

        src = pts_cam[idx_b]            # current camera frame
        dst = kf.pts_cam[idx_a]         # keyframe camera frame
        dev = self.device
        res = ransac_pose(_f32(src, dev), _f32(dst, dev),
                          torch.from_numpy(mvalid).to(dev), self.generator,
                          iterations=self.ransac_iterations,
                          inlier_threshold=self.inlier_threshold)
        num_inliers = int(res.num_inliers)
        rmse = float(res.rmse)

        if num_inliers < self.min_inliers:
            # tracking failure: keep last pose, spawn a fresh keyframe
            self._new_keyframe(stamp, self.pose, kps, pts_cam, has_depth)
            self.trajectory.append((stamp, self.pose.copy()))
            return OdometryResult(self.pose.copy(), num_matches,
                                  num_inliers, rmse, True)

        rel = _host(res.transform)      # kf_cam <- cur_cam
        if self.rel_hook is not None:
            rel = np.asarray(self.rel_hook(rel), np.float32)
        self.pose = (kf.pose @ rel).astype(np.float32)
        self.trajectory.append((stamp, self.pose.copy()))

        dt_norm = float(np.linalg.norm(rel[:3, 3]))
        cos_a = (np.trace(rel[:3, :3]) - 1) / 2
        angle = float(np.arccos(np.clip(cos_a, -1, 1)))
        make_kf = (dt_norm > self.kf_trans or angle > self.kf_rot
                   or num_inliers < self.kf_min_inliers)
        if make_kf:
            inherited = np.full(pts_cam.shape[0], -1, np.int64)
            inl = _host(res.inliers)
            for a, b, v in zip(idx_a, idx_b, mvalid & inl):
                if v:
                    inherited[b] = kf.landmark_ids[a]
            self._new_keyframe(stamp, self.pose, kps, pts_cam, has_depth,
                               inherited)
        return OdometryResult(self.pose.copy(), num_matches, num_inliers,
                              rmse, make_kf)

    # ------------------------------------------------------------------
    def build_ba_window(self, window: int = 8,
                        max_landmarks: int = 2048,
                        max_observations: int = 8192
                        ) -> Optional[Tuple[BAProblem, np.ndarray, int]]:
        """BA problem over the last ``window`` keyframes, on the odometry's
        device. Returns (problem, landmark_id_order, first_kf_index) or
        None."""
        if len(self.keyframes) < 2:
            return None
        first = max(0, len(self.keyframes) - window)
        kf_slice = list(range(first, len(self.keyframes)))
        obs = [(k - first, lm, z) for (k, lm, z) in self.observations
               if k >= first]
        # keep only landmarks with >= 2 observations in the window
        cnt = Counter(lm for _, lm, _ in obs)
        lm_order = [lm for lm, c in cnt.items() if c >= 2][:max_landmarks]
        lm_index = {lm: i for i, lm in enumerate(lm_order)}
        obs = [(k, lm_index[lm], z) for (k, lm, z) in obs
               if lm in lm_index][:max_observations]
        if len(obs) < 6 or not lm_order:
            return None
        o = max(len(obs), 1)
        poses = np.stack([self.keyframes[k].pose for k in kf_slice])
        lms = np.stack([self.landmarks[lm] for lm in lm_order])
        obs_pose = np.zeros(o, np.int32)
        obs_lm = np.zeros(o, np.int32)
        obs_pt = np.zeros((o, 3), np.float32)
        obs_valid = np.zeros(o, bool)
        for i, (k, li, z) in enumerate(obs):
            obs_pose[i] = k
            obs_lm[i] = li
            obs_pt[i] = z
            obs_valid[i] = True

        def dev(a):
            return torch.from_numpy(a).to(self.device)
        problem = BAProblem(
            poses=dev(poses.astype(np.float32)),
            landmarks=dev(lms.astype(np.float32)),
            obs_pose=dev(obs_pose), obs_lm=dev(obs_lm),
            obs_pt=dev(obs_pt), obs_valid=dev(obs_valid))
        return problem, np.asarray(lm_order), first

    def run_ba(self, window: int = 8, iterations: int = 6) -> Optional[float]:
        """Optimize the window and write results back. Returns final chi2."""
        built = self.build_ba_window(window)
        if built is None:
            return None
        problem, lm_order, first = built
        solved, chi2s = solve_window(problem, iterations=iterations)
        poses = _host(solved.poses)
        # diagnostic: how far this BA call moved the latest pose
        # (divergence forensics — ba_corrections[-1] spikes identify the
        # window that injected a bad correction)
        prev_last = self.keyframes[-1].pose[:3, 3].copy()
        # re-anchor: keep the first window pose fixed at its prior value
        for off, k in enumerate(range(first, len(self.keyframes))):
            self.keyframes[k].pose = poses[off]
        self.ba_corrections.append(float(np.linalg.norm(
            self.keyframes[-1].pose[:3, 3] - prev_last)))
        lms = _host(solved.landmarks)
        for i, lm in enumerate(lm_order):
            self.landmarks[int(lm)] = lms[i]
        self.pose = self.keyframes[-1].pose.copy()
        return float(_host(chi2s)[-1])
