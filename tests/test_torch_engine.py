"""The port's ``FusionEngine`` against the JAX package's, frame by frame, on
the small rig of ``tests/test_engine.py`` with the raw depth link.

The JAX engine runs its step under ``jax.disable_jit()``, op by op: under
``jit``, XLA:CPU contracts ``a * b + c`` into fused multiply-adds (a
compiler liberty, measured on 1M random triples: 234,455 results differ
from the separately rounded form), which moves a cell corner by an ulp
and, now and then, a point across a quantization step. The port rounds
every operation as written, on the CPU and in its CUDA kernels
(``--fmad=false``), so it is bit-equal to the JAX code as written;
:func:`test_engine_matches_jitted_jax_within_one_step` bounds the jitted
difference.
"""

import os
import subprocess
import sys

import numpy as np
import jax
import pytest

from ros_gpu_depthmap_fusion_tpu.core.config import FusionConfig as JCfg
from ros_gpu_depthmap_fusion_tpu.core.camera import PinholeIntrinsics
from ros_gpu_depthmap_fusion_tpu.pipeline import FusionEngine as JEngine

from ros_gpu_depthmap_fusion_tpu_torch.core.config import FusionConfig as TCfg
from ros_gpu_depthmap_fusion_tpu_torch.pipeline import engine as teng

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXACT = ("fused_points", "fused_count", "raw_count", "seq_selected_count",
         "occupancy_bits", "occupancy_sparse_idx", "occupancy_sparse_words",
         "occupancy_sparse_count", "occupancy_sparse_true")


def small_kw(**kw):
    base = dict(
        num_depth_streams=2, depth_height=24, depth_width=32,
        num_point_sequences=1,
        crop_min=(-5, -5, -5), crop_max=(5, 5, 5),
        voxel_min=(-5, -5, -5), voxel_max=(5, 5, 5),
        voxel_size=(0.5, 0.5, 0.5),
        rollbuffer_point_capacity=256, rollbuffer_seq_capacity=16,
        max_points_per_sequence=64, voxel_occupancy_lifetime=3,
        depth_link_codec="none", lidar_link_quant_step=0.002,
        occupancy_sparse_capacity=64, emit_occupancy_u8=False,
        emit_raw_points=False)
    base.update(kw)
    return base


def frames(n, seed=11):
    """``n`` frames of (depth [2, 24, 32] u16, lidar arc, nsec, now)."""
    rng = np.random.default_rng(seed)
    u = np.arange(32)[None, :] + np.zeros((24, 1))
    t = np.linspace(0, np.pi, 200)
    arc = np.stack([0.8 * np.cos(t), 0.8 * np.sin(t),
                    1 + 0.1 * np.sin(5 * t)], -1).astype(np.float32)
    for f in range(n):
        d = (2000 + 40 * u + 6 * rng.standard_normal((2, 24, 32))) \
            .astype(np.uint16)
        d[rng.random((2, 24, 32)) < 0.01] = 0
        yield d, arc + np.float32(0.01 * f), f * 33000000, 1.0 + f / 30.0


def stage(eng, d, arc, nsec):
    intr = PinholeIntrinsics.default_for(32, 24)
    eye = np.eye(4, dtype=np.float32)
    tf1 = eye.copy()
    tf1[:3, 3] = (0.3, -0.2, 0.1)
    for i, tf in enumerate((eye, tf1)):
        eng.add_depthmap(i, d[i], intr, tf, tf)
    eng.add_point_sequence(arc, sec=1, nsec=nsec, tf_move=eye)


def jax_process(eng, now, op_by_op=True):
    if op_by_op:
        with jax.disable_jit():
            return eng.process(now)
    return eng.process(now)


def assert_outputs_equal(t_out, j_out, fields=EXACT):
    for k in fields:
        np.testing.assert_array_equal(getattr(t_out, k).numpy(),
                                      np.asarray(getattr(j_out, k)),
                                      err_msg=k)


@pytest.mark.parametrize("quant_step", [0.002, 0.0])
def test_engine_matches_jax(quant_step):
    """Six frames of depth + lidar (u16-quantized or f32 lidar staging):
    fused points, counts, selection, occupancy bitmap and sparse blocks
    bit-equal to the JAX engine's."""
    kw = small_kw(lidar_link_quant_step=quant_step)
    j = JEngine(JCfg(**kw))
    t = teng.FusionEngine(TCfg(**kw), device="cpu")
    for d, arc, nsec, now in frames(6):
        stage(j, d, arc, nsec)
        stage(t, d, arc, nsec)
        j_out = jax_process(j, now)
        t_out = t.process(now)
        assert_outputs_equal(t_out, j_out)
        assert int(t_out.fused_count) > 0
        assert int(t_out.seq_selected_count) > 0


def test_engine_matches_jitted_jax_within_one_step():
    """Against the jitted JAX engine everything is equal except the cell
    means: a contracted multiply-add moves a cell corner by an ulp, which
    can move a point across a quantization step (cell / 1024 in x and y),
    so the means agree to within one step."""
    kw = small_kw()
    j = JEngine(JCfg(**kw))
    t = teng.FusionEngine(TCfg(**kw), device="cpu")
    for d, arc, nsec, now in frames(4):
        stage(j, d, arc, nsec)
        stage(t, d, arc, nsec)
        j_out = jax_process(j, now, op_by_op=False)
        t_out = t.process(now)
        assert_outputs_equal(t_out, j_out, EXACT[1:])
        np.testing.assert_allclose(t_out.fused_points.numpy(),
                                   np.asarray(j_out.fused_points), rtol=0,
                                   atol=0.5 / 1024)


def test_engine_continues_from_jax_state():
    """``state_from_jax_numpy`` starts the port from the JAX engine's
    mid-run state; the next frames match, and ``state_to_numpy`` inverts
    it."""
    kw = small_kw()
    j = JEngine(JCfg(**kw))
    t = teng.FusionEngine(TCfg(**kw), device="cpu")
    fr = list(frames(6, seed=3))
    for d, arc, nsec, now in fr[:3]:
        stage(j, d, arc, nsec)
        jax_process(j, now, op_by_op=False)
        t.clear()
    d_state = {k: np.asarray(v)
               for k, v in j.state.rollbuffer._asdict().items()}
    d_state["historic_occupancy"] = np.asarray(j.state.historic_occupancy)
    d_state["frame_index"] = np.asarray(j.state.frame_index)
    d_state["prev_depth_q"] = np.asarray(j.state.prev_depth_q)
    t.state = teng.state_from_jax_numpy(d_state, "cpu")
    back = teng.state_to_numpy(t.state)
    assert set(back) == set(d_state) - {"prev_depth_q"}
    for k, v in back.items():
        np.testing.assert_array_equal(v, d_state[k], err_msg=k)
    assert int(t.state.rollbuffer.num_seqs) > 0
    for d, arc, nsec, now in fr[3:]:
        stage(j, d, arc, nsec)
        stage(t, d, arc, nsec)
        assert_outputs_equal(t.process(now), jax_process(j, now))
    assert int(t.state.frame_index) == 6


def test_host_packet_bytes_match_jax():
    """The port stages the same packet words as the JAX engine."""
    kw = small_kw()
    j = JEngine(JCfg(**kw))
    t = teng.FusionEngine(TCfg(**kw), device="cpu")
    assert t.layout._asdict() == j.layout._asdict()
    captured = []
    encode = j._encode

    def capture(*a):
        view, bits = encode(*a)
        captured.append(np.array(view))
        return view, bits
    j._encode = capture
    d, arc, nsec, now = next(frames(1))
    stage(j, d, arc, nsec)
    stage(t, d, arc, nsec)
    # slot 1 counts as not added this frame: both engines send zeros
    t._depth_filled[1] = False
    j._depth_filled[1] = False
    jax_process(j, now, op_by_op=False)
    words = t._finish_packet(now, None, None)
    np.testing.assert_array_equal(words, captured[0])


def test_port_imports_no_jax():
    code = ("import sys; pre = 'jax' in sys.modules; "
            "import ros_gpu_depthmap_fusion_tpu_torch, "
            "ros_gpu_depthmap_fusion_tpu_torch.pipeline.engine, "
            "ros_gpu_depthmap_fusion_tpu_torch.ops.kernels._build; "
            "print(pre, 'jax' in sys.modules, "
            "any(m.startswith('ros_gpu_depthmap_fusion_tpu.') "
            "or m == 'ros_gpu_depthmap_fusion_tpu' for m in sys.modules))")
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=REPO, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.split() == ["False", "False", "False"], res.stdout


@pytest.mark.parametrize("field,value", [
    ("depth_link_codec", "dpcm"), ("emit_raw_points", True),
    ("stream_shapes", ((24, 32), (12, 16))), ("voxel_mean_mode", "exact"),
    ("enable_radius_filter", True), ("voxel_enable_average", False)])
def test_unported_configs_raise(field, value):
    with pytest.raises(NotImplementedError, match=field):
        teng.FusionEngine(TCfg(**small_kw(**{field: value})), device="cpu")


def test_engine_needs_explicit_device():
    with pytest.raises(TypeError):
        teng.FusionEngine(TCfg(**small_kw()))
    with pytest.raises(NotImplementedError, match="pipeline_depth"):
        teng.FusionEngine(TCfg(**small_kw()), device="cpu",
                          pipeline_depth=1)
