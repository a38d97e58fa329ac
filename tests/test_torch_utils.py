"""The port's ``utils/`` (png, checkpoint, profiling, viz) and
``pipeline/datasets.py`` against the JAX package's, on the CPU: the PNG
writer writes the same bytes and the reader reads either's files; an
engine-state checkpoint round-trips and reads the JAX package's npz
layout; a SLAM session saved by either package restores into the other;
the tracer and a profiler capture run on the CPU; the visualization
payloads of a mapping result equal the JAX package's.
"""

import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ros_gpu_depthmap_fusion_tpu.core.camera import PinholeIntrinsics as JIntr
from ros_gpu_depthmap_fusion_tpu.core.config import FusionConfig as JCfg
from ros_gpu_depthmap_fusion_tpu.core.grid import VoxelGrid as JGrid
from ros_gpu_depthmap_fusion_tpu.mapping.pipeline import (
    MappingPipeline as JPipeline)
from ros_gpu_depthmap_fusion_tpu.pipeline import FusionEngine as JEngine
from ros_gpu_depthmap_fusion_tpu.pipeline import datasets as jdatasets
from ros_gpu_depthmap_fusion_tpu.slam.frontend import (
    RgbdOdometry as JOdometry)
from ros_gpu_depthmap_fusion_tpu.utils import checkpoint as jckpt
from ros_gpu_depthmap_fusion_tpu.utils import png as jpng
from ros_gpu_depthmap_fusion_tpu.utils import viz as jviz

from ros_gpu_depthmap_fusion_tpu_torch.core import transforms
from ros_gpu_depthmap_fusion_tpu_torch.core.camera import PinholeIntrinsics
from ros_gpu_depthmap_fusion_tpu_torch.core.config import FusionConfig
from ros_gpu_depthmap_fusion_tpu_torch.core.grid import VoxelGrid
from ros_gpu_depthmap_fusion_tpu_torch.mapping.pipeline import (
    MappingPipeline)
from ros_gpu_depthmap_fusion_tpu_torch.pipeline import datasets
from ros_gpu_depthmap_fusion_tpu_torch.pipeline.engine import (
    FusionEngine, state_to_numpy)
from ros_gpu_depthmap_fusion_tpu_torch.slam.frontend import RgbdOdometry
from ros_gpu_depthmap_fusion_tpu_torch.utils import (
    checkpoint, png, profiling, viz)

from test_torch_cuda import assert_same
from test_torch_mapping import _inputs, map_kw, scene


# --- png ---------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
def test_png_writes_the_same_bytes_and_round_trips(tmp_path, dtype):
    rng = np.random.default_rng(1)
    img = rng.integers(0, np.iinfo(dtype).max, (37, 53)).astype(dtype)
    png.write_png_gray(str(tmp_path / "t.png"), img)
    jpng.write_png_gray(str(tmp_path / "j.png"), img)
    assert (tmp_path / "t.png").read_bytes() == \
        (tmp_path / "j.png").read_bytes()
    got = png.read_png_gray(str(tmp_path / "j.png"))
    assert got.dtype == dtype
    np.testing.assert_array_equal(got, img)
    with pytest.raises(ValueError, match="dtype"):
        png.write_png_gray(str(tmp_path / "f.png"), img.astype(np.float32))


def test_png_reads_every_scanline_filter(tmp_path):
    """Sub, Up, Average and Paeth rows (the writer emits only filter 0)."""
    import struct
    import zlib
    rng = np.random.default_rng(2)
    img = rng.integers(0, 256, (5, 7)).astype(np.uint8)
    rows, prev = [], np.zeros(7, np.int32)
    for y, f in enumerate((0, 1, 2, 3, 4)):
        cur = img[y].astype(np.int32)
        if f == 0:
            line = cur
        else:
            line = np.zeros(7, np.int32)
            for i in range(7):
                a = cur[i - 1] if i else 0
                b = prev[i]
                c = prev[i - 1] if i else 0
                if f == 1:
                    pred = a
                elif f == 2:
                    pred = b
                elif f == 3:
                    pred = (a + b) // 2
                else:
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if (pa <= pb and pa <= pc) else \
                        (b if pb <= pc else c)
                line[i] = (cur[i] - pred) & 0xFF
        rows.append(bytes([f]) + line.astype(np.uint8).tobytes())
        prev = cur

    def chunk(tag, payload):
        return (struct.pack(">I", len(payload)) + tag + payload
                + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF))
    data = (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", 7, 5, 8, 0, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(b"".join(rows)))
            + chunk(b"IEND", b""))
    path = tmp_path / "f.png"
    path.write_bytes(data)
    np.testing.assert_array_equal(png.read_png_gray(str(path)), img)
    # the JAX package's reader wraps the Paeth predictor's differences in
    # uint16 (a reference-side fault); the rows before it agree
    np.testing.assert_array_equal(png.read_png_gray(str(path))[:4],
                                  jpng.read_png_gray(str(path))[:4])


# --- datasets ----------------------------------------------------------------

def test_datasets_render_and_quaternions_match_jax():
    rng = np.random.default_rng(4)
    kw = dict(spheres=[datasets.Sphere(np.array([0.2, -0.1, 3.0]), 0.5)],
              boxes=[datasets.Box(np.array([-1.0, -1.0, 4.0]),
                                  np.array([1.0, 0.5, 5.0]))],
              ground_z=-1.0, depth_scale=1.0 / 5000.0, noise_std=0.001,
              noise_quad=0.0025, dropout=0.01, dropout_per_m=0.012, seed=3)
    jkw = dict(kw, spheres=[jdatasets.Sphere(s.center, s.radius)
                            for s in kw["spheres"]],
               boxes=[jdatasets.Box(b.lower, b.upper) for b in kw["boxes"]])
    tds = datasets.SyntheticRigDataset(PinholeIntrinsics.default_for(64, 48),
                                       **kw)
    jds = jdatasets.SyntheticRigDataset(JIntr.default_for(64, 48), **jkw)
    for f in range(3):
        pose = transforms.make_se3(transforms.rot_y(0.1 * f),
                                   np.array([0.1 * f, 0.0, 0.0]))
        for a, b in zip(tds.render(pose), jds.render(pose)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    for _ in range(8):
        q = rng.normal(size=4)
        r = datasets.quat_to_rot(*q)
        np.testing.assert_array_equal(r, jdatasets.quat_to_rot(*q))
        assert datasets.rot_to_quat(r) == jdatasets.rot_to_quat(r)


# --- checkpoint --------------------------------------------------------------

def _ckpt_cfg(cls):
    """``tests/test_checkpoint.py``'s configuration."""
    return cls(
        num_depth_streams=1, depth_height=16, depth_width=24,
        crop_min=(-6, -6, -6), crop_max=(6, 6, 6),
        voxel_min=(-6, -6, -6), voxel_max=(6, 6, 6),
        voxel_size=(0.5, 0.5, 0.5), voxel_occupancy_lifetime=5,
        rollbuffer_point_capacity=64, rollbuffer_seq_capacity=8,
        max_points_per_sequence=32)


def _stage(eng, cls):
    eye = np.eye(4, dtype=np.float32)
    eng.add_depthmap(0, np.full((16, 24), 2000, np.uint16),
                     cls.default_for(24, 16), eye, eye)


def test_engine_state_roundtrip(tmp_path):
    """``tests/test_checkpoint.py::test_engine_state_roundtrip`` on the
    port: a fresh engine restores the decayed history and continues."""
    cfg = _ckpt_cfg(FusionConfig)
    eng = FusionEngine(cfg, "cpu")
    _stage(eng, PinholeIntrinsics)
    out = eng.process(1.0)
    occ = out.occupancy_u8.numpy()
    checkpoint.save_engine_state(str(tmp_path / "ckpt"), eng.state)
    eng2 = FusionEngine(cfg, "cpu")
    eng2.state = checkpoint.restore_engine_state(str(tmp_path / "ckpt"),
                                                 eng2.state)
    assert_same(state_to_numpy(eng2.state), state_to_numpy(eng.state))
    assert int(eng2.state.frame_index) == 1
    out2 = eng2.process(1.1)
    assert int((out2.occupancy_u8 > 0).sum()) == int((occ > 0).sum())


def test_engine_state_reads_the_jax_npz_layout(tmp_path, monkeypatch):
    """The JAX package's npz checkpoint (its path without orbax) restores
    into the port's engine, and the port's into the JAX engine."""
    monkeypatch.setattr(jckpt, "_HAVE_ORBAX", False)
    jeng = JEngine(_ckpt_cfg(JCfg))
    _stage(jeng, JIntr)
    jeng.process(1.0)
    jckpt.save_engine_state(str(tmp_path / "j"), jeng.state)
    eng = FusionEngine(_ckpt_cfg(FusionConfig), "cpu")
    eng.state = checkpoint.restore_engine_state(str(tmp_path / "j"),
                                                eng.state)
    for k, v in state_to_numpy(eng.state).items():
        want = np.asarray(getattr(jeng.state.rollbuffer, k, None)
                          if hasattr(jeng.state.rollbuffer, k)
                          else getattr(jeng.state, k))
        np.testing.assert_array_equal(v, want.astype(v.dtype), k)
    checkpoint.save_engine_state(str(tmp_path / "t"), eng.state)
    back = jckpt.restore_engine_state(str(tmp_path / "t"), jeng.state)
    np.testing.assert_array_equal(np.asarray(back.historic_occupancy),
                                  np.asarray(jeng.state.historic_occupancy))
    assert int(back.frame_index) == 1


def _session(odo_cls, intr_cls, device=None):
    """``tests/test_checkpoint.py::test_slam_session_roundtrip``'s three
    frames."""
    intr = intr_cls.default_for(96, 72)
    rng = np.random.default_rng(0)
    ds = datasets.SyntheticRigDataset(
        PinholeIntrinsics.default_for(96, 72),
        spheres=[datasets.Sphere(rng.uniform(-1, 1, 3) + [0, 0, 3], 0.4)
                 for _ in range(4)], ground_z=None)
    odo = (odo_cls(intr, max_keypoints=128, min_inliers=6) if device is None
           else odo_cls(intr, device, max_keypoints=128, min_inliers=6))
    for f in range(3):
        pose = transforms.make_se3(translation=np.array([0.05 * f, 0, 0]))
        d, i = ds.render(pose)
        odo.process(f / 30.0, i, d * 0.001)
    return odo


@pytest.mark.parametrize("saver", ["torch", "jax"])
def test_slam_session_restores_across_packages(tmp_path, saver):
    src = (_session(RgbdOdometry, PinholeIntrinsics, "cpu")
           if saver == "torch" else _session(JOdometry, JIntr))
    save = checkpoint if saver == "torch" else jckpt
    save.save_slam_session(str(tmp_path / "slam"), src)
    for odo, load in ((RgbdOdometry(PinholeIntrinsics.default_for(96, 72),
                                    "cpu"), checkpoint),
                      (JOdometry(JIntr.default_for(96, 72)), jckpt)):
        load.restore_slam_session(str(tmp_path / "slam"), odo)
        assert len(odo.trajectory) == len(src.trajectory) == 3
        np.testing.assert_allclose(odo.pose, src.pose)
        assert odo.landmarks.keys() == src.landmarks.keys()
        assert len(odo.observations) == len(src.observations)
        assert odo._next_landmark == src._next_landmark
        np.testing.assert_array_equal(
            odo.restored_keyframe_poses,
            np.stack([kf.pose for kf in src.keyframes]))
        assert odo.keyframes == []


# --- profiling ---------------------------------------------------------------

def test_profiling_on_the_cpu(tmp_path):
    """``hard_sync``, a ``trace()`` capture, and the tracer's spans,
    counters and per-frame report (``tests/test_torch_tracing.py`` tests
    the tracer in full)."""
    profiling.hard_sync("cpu")
    profiling.hard_sync(torch.zeros(3))
    profiling.reset()
    profiling.enable()
    try:
        with profiling.trace(str(tmp_path / "tr")) as prof:
            with profiling.span("fusion.step", 0):
                torch.ones(64).cumsum(0)
            profiling.count("fusion.frames")
        snap = profiling.snapshot()
        text = profiling.report(0)
    finally:
        profiling.enable(False)
        profiling.reset()
    assert prof is not None
    assert os.path.getsize(tmp_path / "tr" / "trace.json") > 0
    assert snap["spans"]["fusion.step"][1] == 1
    assert snap["spans"]["fusion.step"][0] > 0
    assert snap["counters"] == {"fusion.frames": 1}
    assert "fusion.step" in text


# --- viz ---------------------------------------------------------------------

def test_viz_payloads_match_jax():
    """The payload builders on a mapping result of each package (the
    device segmentation; five frames, so tracks exist)."""
    kw = map_kw(segmentation_backend="device")
    tgrid, jgrid = (VoxelGrid.from_config(FusionConfig(**kw)),
                    JGrid.from_config(JCfg(**kw)))
    tp = MappingPipeline(FusionConfig(**kw), tgrid, "cpu")
    jp = JPipeline(JCfg(**kw), jgrid)
    for occ in scene():
        u8 = _inputs(occ, 256)[0]
        t_res = tp.process(u8, dt=0.05)
        j_res = jp.process(jnp.asarray(u8.numpy()), dt=0.05)
    assert len(t_res.objects) > 2 and len(t_res.tracks) > 0
    for name in ("centroid_cloud", "object_id_texts",
                 "object_aabb_wireframes", "object_min_box_wireframes"):
        assert_same(getattr(jviz, name)(j_res.objects),
                    getattr(viz, name)(t_res.objects), name)
    for name in ("layer_centroid_points", "layer_connection_lines"):
        assert_same(getattr(jviz, name)(j_res.objects, jgrid),
                    getattr(viz, name)(t_res.objects, tgrid), name)
    for thr in (viz.SCORE_DISPLAY_THRESHOLD, 0.0):
        assert_same(jviz.track_wireframes(j_res.tracks,
                                          score_threshold=thr),
                    viz.track_wireframes(t_res.tracks, score_threshold=thr),
                    f"track_wireframes {thr}")
    assert len(viz.track_wireframes(t_res.tracks, score_threshold=0.0)) > 0
