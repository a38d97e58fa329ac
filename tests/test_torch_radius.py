"""The port's radius outlier filter against the JAX package's: the three
cases of ``tests/test_radius.py`` on the port, and random clouds through
both, bit-equal masks (the counts are integers)."""

import jax
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ros_gpu_depthmap_fusion_tpu.ops.radius import (
    filter_radius_outliers as jfilter)
from ros_gpu_depthmap_fusion_tpu_torch.core.camera import PinholeIntrinsics
from ros_gpu_depthmap_fusion_tpu_torch.core.config import FusionConfig
from ros_gpu_depthmap_fusion_tpu_torch.ops.radius import (
    filter_radius_outliers)
from ros_gpu_depthmap_fusion_tpu_torch.pipeline.engine import FusionEngine


def _homogeneous(xyz):
    xyz = np.asarray(xyz, np.float32)
    return np.concatenate([xyz, np.ones((len(xyz), 1), np.float32)], -1)


def test_radius_filter_removes_isolated_points():
    rng = np.random.default_rng(0)
    cluster = rng.normal(0, 0.02, size=(50, 3)) + [1.0, 1.0, 1.0]
    isolated = np.array([[3.0, -3.0, 2.0], [-2.5, 2.5, 0.5]])
    pts = _homogeneous(np.concatenate([cluster, isolated]))
    out = filter_radius_outliers(
        torch.from_numpy(pts), torch.ones(len(pts), dtype=torch.bool),
        (-4, -4, -4), (4, 4, 4), radius=0.2, min_neighbors=3).numpy()
    assert out[:50].all()
    assert not out[50:].any()


def test_radius_filter_respects_input_mask():
    pts = _homogeneous(np.zeros((10, 3)))
    mask = torch.zeros(10, dtype=torch.bool)
    mask[:2] = True
    out = filter_radius_outliers(torch.from_numpy(pts), mask,
                                 (-1, -1, -1), (1, 1, 1), radius=0.5,
                                 min_neighbors=3)
    assert not out.any()


def test_engine_with_radius_filter():
    cfg = FusionConfig(
        num_depth_streams=1, depth_height=16, depth_width=24,
        crop_min=(-6, -6, -6), crop_max=(6, 6, 6),
        voxel_min=(-6, -6, -6), voxel_max=(6, 6, 6),
        voxel_size=(0.5, 0.5, 0.5), enable_radius_filter=True,
        radius_min=(-6, -6, -6), radius_max=(6, 6, 6),
        radius_filter_radius=0.3, depth_link_codec="none",
        rollbuffer_point_capacity=64, rollbuffer_seq_capacity=8,
        max_points_per_sequence=32)
    eng = FusionEngine(cfg, "cpu")
    eye = np.eye(4, dtype=np.float32)
    eng.add_depthmap(0, np.full((16, 24), 2000, np.uint16),
                     PinholeIntrinsics.default_for(24, 16), eye, eye)
    out = eng.process(1.0)
    assert int(out.raw_count) > 100


@pytest.mark.parametrize("seed,radius,min_neighbors", [
    (1, 0.2, 2), (2, 0.07, 3), (3, 0.15, 6)])
def test_radius_filter_matches_jax(seed, radius, min_neighbors):
    """Clusters, scattered points, points outside the filter's box (their
    cells clamp to the border) and masked rows: the same mask as JAX."""
    rng = np.random.default_rng(seed)
    xyz = np.concatenate([
        rng.normal(0, 0.05, (300, 3)) + rng.uniform(-1, 1, (1, 3)),
        rng.normal(0, 0.05, (300, 3)) + rng.uniform(-1, 1, (1, 3)),
        rng.uniform(-1.5, 1.5, (400, 3))])
    pts = _homogeneous(xyz)
    mask = rng.random(len(pts)) < 0.9
    lo, hi = (-1.0, -1.0, -1.2), (1.0, 1.1, 1.0)
    want = np.asarray(jfilter(jnp.asarray(pts), jnp.asarray(mask), lo, hi,
                              radius, min_neighbors))
    with jax.disable_jit():
        op_by_op = np.asarray(jfilter(jnp.asarray(pts), jnp.asarray(mask),
                                      lo, hi, radius, min_neighbors))
    got = filter_radius_outliers(torch.from_numpy(pts),
                                 torch.from_numpy(mask), lo, hi, radius,
                                 min_neighbors).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, op_by_op)
    assert 0 < got.sum() < mask.sum()
