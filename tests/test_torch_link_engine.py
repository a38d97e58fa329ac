"""The port's coded link against the JAX package's: the delta-coded lidar
staging and its unpack, the engine on ``bench.py``'s link combination
(p4 temporal depth with hysteresis, delta-coded lidar, sparse occupancy)
synchronous and pipelined, and the ``prev_depth_q`` carry of a JAX state.

The JAX engine's step runs under ``jax.disable_jit()`` (op by op), as in
``tests/test_torch_engine.py``: jitted XLA:CPU contracts multiply-adds.
"""

import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ros_gpu_depthmap_fusion_tpu.core.config import FusionConfig as JCfg
from ros_gpu_depthmap_fusion_tpu.core.camera import PinholeIntrinsics
from ros_gpu_depthmap_fusion_tpu.pipeline import FusionEngine as JEngine
from ros_gpu_depthmap_fusion_tpu.pipeline.packet import (
    unpack_packet as j_unpack)
from ros_gpu_depthmap_fusion_tpu.utils import native as j_native

from ros_gpu_depthmap_fusion_tpu_torch.core.config import FusionConfig as TCfg
from ros_gpu_depthmap_fusion_tpu_torch.pipeline import engine as teng
from ros_gpu_depthmap_fusion_tpu_torch.pipeline.packet import (
    unpack_packet as t_unpack)
from ros_gpu_depthmap_fusion_tpu_torch.utils import native

# vox_partials_count is left out: the JAX engine runs its "packed"
# voxelize on the CPU, which reports 0 there
EXACT = ("fused_points", "fused_count", "raw_count", "seq_selected_count",
         "occupancy_bits", "occupancy_sparse_idx",
         "occupancy_sparse_words", "occupancy_sparse_count",
         "occupancy_sparse_true")
EYE = np.eye(4, dtype=np.float32)


@pytest.fixture
def native_lib():
    """Both packages' bindings must load the library: without it the JAX
    engine would ship raw depth and the port's would raise."""
    if not (native.available() and j_native.available()):
        pytest.skip("native library not built")


def link_kw(**kw):
    """``tests/test_engine.py:371``'s small rig with ``bench.py``'s link
    combination."""
    base = dict(
        num_depth_streams=2, depth_height=24, depth_width=32,
        num_point_sequences=1,
        crop_min=(-5, -5, -5), crop_max=(5, 5, 5),
        voxel_min=(-5, -5, -5), voxel_max=(5, 5, 5),
        voxel_size=(0.5, 0.5, 0.5),
        rollbuffer_point_capacity=256, rollbuffer_seq_capacity=16,
        max_points_per_sequence=64, voxel_occupancy_lifetime=3,
        depth_link_codec="dpcm_temporal", depth_codec_quant_shift=3,
        depth_codec_hysteresis=2, depth_codec_p4_budget=16,
        depth_codec_keyframe_interval=4, depth_codec_max_exceptions=2048,
        lidar_link_quant_step=0.002, lidar_link_delta=True,
        occupancy_sparse_capacity=64, emit_occupancy_u8=False,
        emit_raw_points=False)
    base.update(kw)
    return base


def frames(n, seed=11, pattern_sigma=6.0):
    """``n`` frames (depth [2, 24, 32] u16, lidar arc, nsec, now) of a
    moving scene: a fixed pattern with noise, holes, and a sweeping step
    that gives wide deltas and hole churn."""
    rng = np.random.default_rng(seed)
    u = np.arange(32)[None, :] + np.zeros((24, 1))
    pattern = pattern_sigma * rng.standard_normal((2, 24, 32))
    t = np.linspace(0, np.pi, 60)
    arc = np.stack([0.8 * np.cos(t), 0.8 * np.sin(t),
                    1 + 0.1 * np.sin(5 * t)], -1).astype(np.float32)
    for f in range(n):
        d = 2000 + 40 * u + pattern + rng.standard_normal((2, 24, 32))
        d[:, 6:12, 4 + 3 * f:10 + 3 * f] -= 400
        d = d.astype(np.uint16)
        d[rng.random((2, 24, 32)) < 0.01] = 0
        yield d, arc + np.float32(0.01 * f), f * 33000000, 1.0 + f / 30.0


def stage(eng, d, arc, nsec):
    intr = PinholeIntrinsics.default_for(32, 24)
    tf1 = EYE.copy()
    tf1[:3, 3] = (0.3, -0.2, 0.1)
    for i, tf in enumerate((EYE, tf1)):
        eng.add_depthmap(i, d[i], intr, tf, tf)
    eng.add_point_sequence(arc, sec=1, nsec=nsec, tf_move=EYE)


def assert_outputs_equal(t_out, j_out, what=""):
    for k in EXACT:
        np.testing.assert_array_equal(getattr(t_out, k).numpy(),
                                      np.asarray(getattr(j_out, k)),
                                      err_msg=f"{what} {k}")


def _packet_words(t, now):
    """The port engine's packet of the staged frame: (words, bits)."""
    return t._encode(t._pkt, t._depth_host, t._finish_packet(now, None, None))


def _jax_words(j, now):
    """The JAX engine's packet of the staged frame, as its process() would
    build it (header and encode), without stepping."""
    captured = []
    encode = j._encode

    def capture(*a):
        view, bits = encode(*a)
        captured.append((np.array(view), bits))
        return view, bits
    j._encode = capture
    state = j.state
    with jax.disable_jit():
        j.process(now)
    j._encode = encode
    j.state = state
    return captured[0]


@pytest.mark.parametrize("case", ["dense", "jumps", "truncated"])
def test_lidar_delta_unpack_matches_jax(case):
    """Delta-coded lidar: the port stages the same packet words as the JAX
    engine and unpacks the same points, including a sequence truncated at
    the exception budget (``tests/test_packet.py:189``)."""
    kw = link_kw(depth_link_codec="none", depth_codec_p4_budget=0)
    if case == "truncated":
        kw.update(rollbuffer_point_capacity=8192,
                  max_points_per_sequence=4096, num_point_sequences=2)
    j = JEngine(JCfg(**kw))
    t = teng.FusionEngine(TCfg(**kw), device="cpu")
    rng = np.random.default_rng(0)
    t_arc = np.linspace(0, np.pi, 240)
    arc = np.stack([0.8 * np.cos(t_arc), 0.8 * np.sin(t_arc),
                    1 + 0.1 * np.sin(5 * t_arc)], -1).astype(np.float32)
    seqs = [arc[:40]]
    if case == "jumps":
        jumpy = arc[:50].copy()
        jumpy[20:25] += np.array([1.5, -0.8, 0.4], np.float32)
        seqs.append(jumpy)
    elif case == "truncated":
        seqs.append(rng.uniform(-4, 4, (3000, 3)).astype(np.float32))
        seqs.append(arc[:30])   # no wide deltas: staged after the overflow
    d = np.full((2, 24, 32), 2000, np.uint16)
    for eng in (j, t):
        for i in range(2):
            eng.add_depthmap(i, d[i], PinholeIntrinsics.default_for(32, 24),
                             EYE, EYE)
        for k, s in enumerate(seqs):
            eng.add_point_sequence(s, sec=1, nsec=k, tf_move=EYE)
    assert t._pkt.lidar_dropped == j._pkt.lidar_dropped
    assert t._pkt.lidar_exc_count == j._pkt.lidar_exc_count
    if case == "truncated":
        assert 0 < t._pkt.lidar_dropped
        assert 0 < int(t._pkt.seq_count[1]) < 3000
    else:
        assert t._pkt.lidar_dropped == 0
    j_words, j_bits = _jax_words(j, 1.0)
    t_words, t_bits = _packet_words(t, 1.0)
    assert j_bits is None and t_bits is None
    np.testing.assert_array_equal(t_words, j_words)
    ji = j_unpack(jnp.asarray(j_words), j.layout, None)
    ti = t_unpack(torch.from_numpy(t_words.view(np.int32)), t.layout, None)
    n = int(ti.seq_batch.num_points)
    assert n == int(ji.seq_batch.num_points) > 0
    np.testing.assert_array_equal(ti.seq_batch.points.numpy(),
                                  np.asarray(ji.seq_batch.points))
    np.testing.assert_array_equal(ti.seq_batch.seq_idx.numpy(),
                                  np.asarray(ji.seq_batch.seq_idx))
    # the kept points come back to within the 1 mm link quantization
    kept = np.concatenate([s[:int(c)] for s, c in
                           zip(seqs, t._pkt.seq_count)])
    np.testing.assert_allclose(ti.seq_batch.points.numpy()[:n, :3], kept,
                               atol=0.001 + 1e-5)


def _run(eng, fr, jax_engine):
    outs, bits = [], []
    for d, arc, nsec, now in fr:
        stage(eng, d, arc, nsec)
        if jax_engine:
            with jax.disable_jit():
                out = eng.process(now)
        else:
            out = eng.process(now)
        if out is not None:
            outs.append(out)
            bits.append(eng.last_frame_bits)
    if getattr(eng, "pipeline_depth", 0):
        if jax_engine:
            with jax.disable_jit():
                out = eng.flush()
        else:
            out = eng.flush()
        assert out is not None
        outs.append(out)
        bits.append(eng.last_frame_bits)
        assert eng.flush() is None
    return outs, bits


@pytest.mark.parametrize("pipeline_depth", [0, 1])
def test_link_engine_matches_jax(native_lib, pipeline_depth):
    """Seven frames of the bench's link combination (an I-keyframe every
    4 frames, p4 P-frames between): every output, the per-frame
    ``last_frame_bits`` and the P-frame state equal the JAX engine's, with
    ``process`` returning frame k-1 and ``flush`` the last frame when
    pipelined."""
    kw = link_kw()
    j = JEngine(JCfg(**kw), pipeline_depth=pipeline_depth)
    t = teng.FusionEngine(TCfg(**kw), device="cpu",
                          pipeline_depth=pipeline_depth)
    fr = list(frames(7))
    j_outs, j_bits = _run(j, fr, True)
    t_outs, t_bits = _run(t, fr, False)
    assert len(t_outs) == len(j_outs) == 7
    assert t_bits == j_bits
    assert isinstance(t_bits[0], int) and t_bits[0] > 0
    assert t_bits[5] != "p4" and t_bits.count("p4") == 5, t_bits
    for f, (a, b) in enumerate(zip(t_outs, j_outs)):
        assert_outputs_equal(a, b, f"frame {f}")
    assert int(t_outs[-1].fused_count) > 0
    assert int(t_outs[-1].seq_selected_count) > 0
    np.testing.assert_array_equal(t.state.prev_depth_q.numpy(),
                                  np.asarray(j.state.prev_depth_q))


def test_pipelined_equals_sync_under_thread_switching(native_lib):
    """The pipelined engine's worker and main thread share the two host
    packets and depth buffers; with the interpreter switching threads every
    microsecond, 10 frames still equal the synchronous engine's."""
    kw = link_kw()
    sync = teng.FusionEngine(TCfg(**kw), device="cpu")
    pipe = teng.FusionEngine(TCfg(**kw), device="cpu", pipeline_depth=1)
    fr = list(frames(10, seed=5))
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        s_outs, s_bits = _run(sync, fr, False)
        p_outs, p_bits = _run(pipe, fr, False)
    finally:
        sys.setswitchinterval(interval)
        pipe.close()
    assert p_bits == s_bits and len(p_outs) == 10
    for f, (a, b) in enumerate(zip(p_outs, s_outs)):
        for k in a._fields:
            assert torch.equal(getattr(a, k), getattr(b, k)), (f, k)


@pytest.mark.parametrize("codec", ["dpcm", "dpcm_temporal"])
def test_link_engine_classic_frames_match_jax(native_lib, codec):
    """The spatial-only link and the classic (non-p4) temporal P-frames,
    unquantized, on a scene whose strong fixed pattern codes wider
    spatially than temporally."""
    kw = link_kw(depth_link_codec=codec, depth_codec_p4_budget=0,
                 depth_codec_quant_shift=0, depth_codec_hysteresis=0,
                 depth_codec_max_exceptions=128, lidar_link_delta=False)
    j = JEngine(JCfg(**kw))
    t = teng.FusionEngine(TCfg(**kw), device="cpu")
    fr = list(frames(5, seed=2, pattern_sigma=60.0))
    j_outs, j_bits = _run(j, fr, True)
    t_outs, t_bits = _run(t, fr, False)
    assert t_bits == j_bits
    if codec == "dpcm_temporal":
        assert any(isinstance(b, int) and b < 0 for b in t_bits), t_bits
    for f, (a, b) in enumerate(zip(t_outs, j_outs)):
        assert_outputs_equal(a, b, f"frame {f}")


def test_continues_from_jax_state_on_the_p4_link(native_lib):
    """A JAX state after three codec frames, carried to the port by
    ``state_from_jax_numpy`` (``prev_depth_q`` included), gives the same
    next P-frame outputs; ``state_to_numpy`` gives the JAX state back."""
    kw = link_kw(depth_codec_keyframe_interval=30)
    j = JEngine(JCfg(**kw))
    t = teng.FusionEngine(TCfg(**kw), device="cpu")
    fr = list(frames(5, seed=4))
    for d, arc, nsec, now in fr[:3]:
        stage(j, d, arc, nsec)
        with jax.disable_jit():
            j.process(now)
    d_state = {k: np.asarray(v)
               for k, v in j.state.rollbuffer._asdict().items()}
    for k in ("historic_occupancy", "frame_index", "prev_depth_q"):
        d_state[k] = np.asarray(getattr(j.state, k))
    assert d_state["prev_depth_q"].shape == (2, 24, 32)
    assert d_state["prev_depth_q"].any()
    t.state = teng.state_from_jax_numpy(d_state, "cpu")
    back = teng.state_to_numpy(t.state)
    assert set(back) == set(d_state)
    for k, v in back.items():
        np.testing.assert_array_equal(v, d_state[k], err_msg=k)
    assert back["prev_depth_q"].dtype == np.uint16
    # the host encoder's prediction travels with the host, not the state
    for k in ("_host_prev_q", "_host_prev_q_spare"):
        setattr(t, k, getattr(j, k).copy())
    for k in ("_frames_since_key", "_last_bits", "_last_p_bits"):
        setattr(t, k, getattr(j, k))
    for d, arc, nsec, now in fr[3:]:
        stage(j, d, arc, nsec)
        stage(t, d, arc, nsec)
        with jax.disable_jit():
            j_out = j.process(now)
        t_out = t.process(now)
        assert t.last_frame_bits == j.last_frame_bits == "p4"
        assert_outputs_equal(t_out, j_out)
    np.testing.assert_array_equal(t.state.prev_depth_q.numpy(),
                                  np.asarray(j.state.prev_depth_q))


def test_codec_without_native_library_raises(monkeypatch):
    """A configured codec never silently becomes the raw link."""
    monkeypatch.setattr(native, "_load", lambda: None)
    with pytest.raises(RuntimeError, match="native"):
        teng.FusionEngine(TCfg(**link_kw()), device="cpu")
    teng.FusionEngine(TCfg(**link_kw(depth_link_codec="none")),
                      device="cpu")
