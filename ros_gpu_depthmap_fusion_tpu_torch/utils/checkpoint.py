"""Checkpoint/resume for long-running mapping sessions (port of the JAX
package's ``utils/checkpoint.py``).

The reference has no persistence at all — restart is a cold start
(SURVEY.md §5: "Checkpoint/resume: none"). Here the engine's device state
(rollbuffer + historic occupancy + frame index) and the SLAM session
(keyframe poses, landmarks, trajectory) save/restore as ``.npz`` files, so
a mapping process survives restarts with its decayed occupancy history
and map intact.

Both files use the JAX package's layouts: ``state.npz`` holds the
``EngineState`` leaves as ``leaf_0..leaf_12`` in its field order (the JAX
package's npz path; that package writes orbax instead when orbax is
installed), and ``slam.npz`` the same keys as the JAX package's
``save_slam_session``, so a session saved by either package restores
into the other.
"""

from __future__ import annotations

import os

import numpy as np

from ros_gpu_depthmap_fusion_tpu_torch.pipeline.engine import (
    EngineState, state_from_jax_numpy, state_to_numpy)
from ros_gpu_depthmap_fusion_tpu_torch.state.rollbuffer import RollBuffer

# the EngineState leaves in pytree order: the rollbuffer's fields, then
# the engine's own
_LEAVES = RollBuffer._fields + EngineState._fields[1:]


def save_engine_state(path: str, state: EngineState) -> None:
    """Persist an :class:`EngineState` (waits for its device) to
    ``path/state.npz``."""
    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    d = state_to_numpy(state)
    np.savez(os.path.join(path, "state.npz"),
             **{f"leaf_{i}": d[name] for i, name in enumerate(_LEAVES)})


def restore_engine_state(path: str, template: EngineState) -> EngineState:
    """Restore ``path/state.npz`` onto the device of ``template`` (an
    :class:`EngineState` of the same configuration)."""
    data = np.load(os.path.join(os.path.abspath(path), "state.npz"))
    d = {name: data[f"leaf_{i}"] for i, name in enumerate(_LEAVES)}
    return state_from_jax_numpy(d, template.historic_occupancy.device)


def save_slam_session(path: str, odometry) -> None:
    """Persist an RgbdOdometry session (keyframes, landmarks, trajectory)."""
    os.makedirs(path, exist_ok=True)
    kf_poses = np.stack([kf.pose for kf in odometry.keyframes]) \
        if odometry.keyframes else np.zeros((0, 4, 4), np.float32)
    kf_stamps = np.array([kf.stamp for kf in odometry.keyframes])
    lm_ids = np.array(sorted(odometry.landmarks), np.int64)
    lm_pos = np.stack([odometry.landmarks[i] for i in lm_ids]) \
        if len(lm_ids) else np.zeros((0, 3), np.float32)
    traj_stamps = np.array([s for s, _ in odometry.trajectory])
    traj_poses = np.stack([p for _, p in odometry.trajectory]) \
        if odometry.trajectory else np.zeros((0, 4, 4), np.float32)
    obs = odometry.observations
    np.savez(os.path.join(path, "slam.npz"),
             kf_poses=kf_poses, kf_stamps=kf_stamps,
             lm_ids=lm_ids, lm_pos=lm_pos,
             traj_stamps=traj_stamps, traj_poses=traj_poses,
             obs_kf=np.array([o[0] for o in obs], np.int64),
             obs_lm=np.array([o[1] for o in obs], np.int64),
             obs_pt=(np.stack([o[2] for o in obs])
                     if obs else np.zeros((0, 3), np.float32)),
             pose=odometry.pose,
             next_landmark=np.int64(odometry._next_landmark))


def restore_slam_session(path: str, odometry) -> None:
    """Restore trajectory/landmark state into an odometry instance (feature
    descriptors are not persisted; the next frame re-keyframes)."""
    data = np.load(os.path.join(path, "slam.npz"))
    odometry.keyframes = []  # descriptors not persisted; poses live below
    odometry.trajectory = [(float(s), p) for s, p in
                           zip(data["traj_stamps"], data["traj_poses"])]
    odometry.landmarks = {int(i): p for i, p in
                          zip(data["lm_ids"], data["lm_pos"])}
    odometry.observations = [
        (int(k), int(l), p) for k, l, p in
        zip(data["obs_kf"], data["obs_lm"], data["obs_pt"])]
    odometry.pose = data["pose"]
    odometry._next_landmark = int(data["next_landmark"])
    odometry.restored_keyframe_poses = data["kf_poses"]
