"""The port's TUM runner (``pipeline/tum_runner.py``) against the JAX
package's on the CPU: the sequence writers byte for byte, groundtruth-posed
fusion against the JAX run under ``jax.disable_jit()`` (equal occupancy,
fused count and trajectory), SLAM-posed runs with JAX's RANSAC draws (the
same keyframes, the trajectory within 1e-3 m) and with the port's own (ATE
below 10 cm), and the reduced hard cut of ``tests/test_tum_runner.py`` on
the port alone (ATE at most 5 cm, as that test asserts for JAX).
"""

import filecmp
import os

import numpy as np
import jax
import pytest

from ros_gpu_depthmap_fusion_tpu.core.config import FusionConfig as JCfg
from ros_gpu_depthmap_fusion_tpu.pipeline import tum_runner as jrun

from ros_gpu_depthmap_fusion_tpu_torch.core.config import FusionConfig
from ros_gpu_depthmap_fusion_tpu_torch.pipeline import tum_runner as trun
from ros_gpu_depthmap_fusion_tpu_torch.slam import pose_estimation as pe

from test_torch_slam import JaxDraws


def _cfg(cls, w, h):
    """``tests/test_tum_runner.py``'s configuration."""
    return cls(
        num_depth_streams=1, depth_height=h, depth_width=w,
        depth_scale=1.0 / 5000.0,
        crop_min=(-8, -8, -8), crop_max=(8, 8, 8),
        voxel_min=(-8, -8, 0), voxel_max=(8, 8, 8),
        voxel_size=(0.1, 0.1, 0.1), voxel_occupancy_lifetime=10,
        flyingpixels_filter_threshold=0.2,
        rollbuffer_point_capacity=256,
        max_points_per_sequence=32)


def _same_tree(a, b):
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b))
    for n in names:
        pa, pb = os.path.join(a, n), os.path.join(b, n)
        if os.path.isdir(pa):
            _same_tree(pa, pb)
        else:
            assert filecmp.cmp(pa, pb, shallow=False), n
    return names


@pytest.mark.parametrize("which", ["synthetic", "hard-room", "hard-hall"])
def test_writers_write_the_same_bytes(tmp_path, which):
    for pkg, name in ((jrun, "jax"), (trun, "torch")):
        root = str(tmp_path / name)
        if which == "synthetic":
            pkg.write_synthetic_tum_sequence(root, n_frames=4, width=96,
                                             height=72, seed=2)
        else:
            pkg.write_hard_synthetic_tum_sequence(
                root, n_frames=3, width=64, height=48, seed=1,
                family=which.split("-")[1])
    names = _same_tree(str(tmp_path / "jax"), str(tmp_path / "torch"))
    assert {"depth", "rgb", "depth.txt", "groundtruth.txt",
            "intrinsics.txt"} <= set(names)
    assert len(os.listdir(tmp_path / "torch" / "depth")) >= 3


def test_hard_writer_refuses_unknown_family(tmp_path):
    with pytest.raises(ValueError, match="family"):
        trun.write_hard_synthetic_tum_sequence(str(tmp_path), n_frames=1,
                                               width=32, height=24,
                                               family="cave")


@pytest.fixture(scope="module")
def seqs(tmp_path_factory):
    base = tmp_path_factory.mktemp("tum")
    gt, slam = str(base / "gt"), str(base / "slam")
    trun.write_synthetic_tum_sequence(gt, n_frames=6, width=96, height=72)
    trun.write_synthetic_tum_sequence(slam, n_frames=8, width=160,
                                      height=120, seed=3)
    return gt, slam


def test_groundtruth_run_matches_jax(seqs):
    """BASELINE config #2's shape: known poses, voxel fusion over the
    sequence, the JAX engine op by op."""
    with jax.disable_jit():
        jres = jrun.run_tum_sequence(seqs[0], cfg=_cfg(JCfg, 96, 72),
                                     pose_source="groundtruth", max_frames=6)
    tres = trun.run_tum_sequence(seqs[0], cfg=_cfg(FusionConfig, 96, 72),
                                 pose_source="groundtruth", max_frames=6,
                                 device="cpu")
    assert tres.frames == jres.frames == 6
    assert tres.occupied_cells == jres.occupied_cells > 50
    assert tres.fused_points_last == jres.fused_points_last > 10
    np.testing.assert_array_equal(tres.trajectory, jres.trajectory)
    assert tres.ate_rmse_m == jres.ate_rmse_m and tres.ate_rmse_m < 1e-6
    assert (tres.codec_i_frames, tres.codec_p_frames,
            tres.codec_mean_bytes) == (jres.codec_i_frames,
                                       jres.codec_p_frames,
                                       jres.codec_mean_bytes)


def test_slam_run_matches_jax_with_jax_draws(seqs, monkeypatch):
    """BASELINE config #4's shape, with the JAX frontend's RANSAC draws."""
    kw = dict(cfg=None, pose_source="slam", max_frames=8, ba_every=4)
    jres = jrun.run_tum_sequence(seqs[1], **dict(kw, cfg=_cfg(JCfg, 160,
                                                              120)))
    monkeypatch.setattr(pe, "_sample_hypotheses", JaxDraws(0))
    tres = trun.run_tum_sequence(seqs[1], device="cpu", **dict(
        kw, cfg=_cfg(FusionConfig, 160, 120)))
    assert tres.frames == jres.frames == 8
    assert tres.keyframes == jres.keyframes
    np.testing.assert_allclose(tres.trajectory, jres.trajectory, rtol=0,
                               atol=1e-3)
    assert abs(tres.ate_rmse_m - jres.ate_rmse_m) < 1e-3


def test_slam_run_own_draws(seqs):
    """``tests/test_tum_runner.py::test_tum_slam_pose_fusion`` on the port,
    with its own draws."""
    res = trun.run_tum_sequence(seqs[1], cfg=_cfg(FusionConfig, 160, 120),
                                pose_source="slam", max_frames=8,
                                ba_every=0, device="cpu")
    assert res.frames == 8
    assert res.ate_rmse_m is not None and res.ate_rmse_m < 0.10
    assert res.occupied_cells > 0


def test_hard_cut_ate_under_5cm(tmp_path):
    """``tests/test_tum_runner.py::test_tum_hard_sequence_ate_under_5cm``
    on the port (320x240, 40 frames at the full sequence's angular rate,
    the runner's own 32.8M-cell configuration), with loop closure on."""
    root = str(tmp_path / "hard")
    trun.write_hard_synthetic_tum_sequence(root, n_frames=40, width=320,
                                           height=240, orbit_frames=150)
    res = trun.run_tum_sequence(root, pose_source="slam", ba_every=8,
                                loop_close=True, device="cpu")
    assert res.frames == 40
    assert res.ate_rmse_m is not None
    assert res.ate_rmse_m <= 0.05, f"ATE {res.ate_rmse_m * 100:.2f} cm > 5 cm"
    assert res.ate_rmse_loop_closed_m is not None
    assert res.occupied_cells > 0 and res.fused_points_last > 0
    assert res.keyframes >= 3
