"""The port's ``FusionEngine.segment_and_track`` and ``FusionComponent``
against the JAX package's, on the CPU.

The JAX engine's step runs under ``jax.disable_jit()`` (op by op: jitted
XLA:CPU contracts multiply-adds, see ``tests/test_torch_engine.py``); its
mapping runs as the JAX package runs it. Frame outputs, the
``on_points`` payloads and the ``MappingResult``s of ``on_mapping`` are
bit-equal. The component configurations are those of
``tests/test_component_io.py`` as written (``emit_raw_points`` and the
voxel mode at their defaults, so the raw cloud is compared too).
"""

import jax
import numpy as np
import pytest

from ros_gpu_depthmap_fusion_tpu_torch.utils import native as tnative

_NATIVE = tnative.available()

from ros_gpu_depthmap_fusion_tpu.core.camera import PinholeIntrinsics  # noqa: E402,E501
from ros_gpu_depthmap_fusion_tpu.core.config import FusionConfig as JCfg  # noqa: E402,E501
from ros_gpu_depthmap_fusion_tpu.pipeline import FusionEngine as JEngine  # noqa: E402,E501
from ros_gpu_depthmap_fusion_tpu.pipeline.component import (  # noqa: E402
    FusionComponent as JComponent)

from ros_gpu_depthmap_fusion_tpu_torch.core.config import FusionConfig as TCfg  # noqa: E402,E501
from ros_gpu_depthmap_fusion_tpu_torch.pipeline import engine as teng  # noqa: E402,E501
from ros_gpu_depthmap_fusion_tpu_torch.pipeline.component import (  # noqa: E402
    FusionComponent as TComponent)

from test_torch_engine import (  # noqa: E402
    EXACT, assert_outputs_equal, frames, small_kw, stage)
from test_torch_cuda import assert_same  # noqa: E402

OUTPUTS = EXACT + ("occupancy_u8", "raw_points")


@pytest.fixture
def need_native():
    if not _NATIVE:
        pytest.skip(f"native host library did not build: {tnative._error}")


@pytest.mark.parametrize("backend", ["host", "device"])
def test_segment_and_track_matches_jax(need_native, backend):
    """Five frames of the small rig with ``emit_occupancy_u8=True``: frame
    outputs and ``segment_and_track`` results (objects, tracks, stats)
    bit-equal to the JAX engine's."""
    kw = small_kw(emit_occupancy_u8=True, segmentation_backend=backend,
                  voxel_occupancy_lifetime=4)
    j = JEngine(JCfg(**kw), enable_mapping=True)
    t = teng.FusionEngine(TCfg(**kw), "cpu", enable_mapping=True)
    assert t.mapping.backend == j.mapping.backend == backend
    for d, arc, nsec, now in frames(5, seed=4):
        stage(j, d, arc, nsec)
        stage(t, d, arc, nsec)
        with jax.disable_jit():
            j_out = j.process(now)
        t_out = t.process(now)
        assert_outputs_equal(t_out, j_out, OUTPUTS)
        j_res = j.segment_and_track(j_out)
        t_res = t.segment_and_track(t_out)
        assert_same(j_res, t_res, "mapping")
        assert t_res.num_merged >= 2
    assert len(t_res.tracks) > 0


def test_segment_and_track_needs_dense_occupancy_and_mapping():
    t = teng.FusionEngine(TCfg(**small_kw(segmentation_backend="device")),
                          "cpu", enable_mapping=True)
    d, arc, nsec, now = next(frames(1))
    stage(t, d, arc, nsec)
    out = t.process(now)
    with pytest.raises(ValueError, match="emit_occupancy_u8"):
        t.segment_and_track(out)
    res = t.mapping.process_sparse(
        (out.occupancy_sparse_idx, out.occupancy_sparse_words,
         out.occupancy_sparse_count, out.occupancy_sparse_true,
         out.occupancy_bits))
    assert res.num_merged >= 2
    plain = teng.FusionEngine(TCfg(**small_kw()), "cpu")
    assert plain.mapping is None
    with pytest.raises(RuntimeError, match="enable_mapping=False"):
        plain.segment_and_track(out)


def test_set_runtime_filters_reach_the_packet():
    t = teng.FusionEngine(TCfg(**small_kw()), "cpu")
    t.set_runtime_filters(fp_threshold=0.25, ps_threshold=0.5)
    assert (t.fp_threshold, t.ps_threshold) == (0.25, 0.5)
    assert t.fp_max_distance == TCfg().flyingpixels_max_distance
    t.set_runtime_filters(fp_max_distance=3)
    scalars = t._finish_packet(1.0, None, None)
    assert scalars[-3:] == (0.25, 3.0, 0.5)


# --- the component ---------------------------------------------------------

GRID6 = dict(crop_min=(-6, -6, -6), crop_max=(6, 6, 6),
             voxel_min=(-6, -6, -6), voxel_max=(6, 6, 6),
             voxel_size=(0.5, 0.5, 0.5), rollbuffer_point_capacity=64,
             rollbuffer_seq_capacity=8, max_points_per_sequence=32)


def _op_by_op(comp):
    """Run the JAX component's engine step under ``jax.disable_jit()``."""
    process = comp.engine.process

    def run(*a, **k):
        with jax.disable_jit():
            return process(*a, **k)
    comp.engine.process = run


def _pair(kw, mapping=True):
    """The JAX and the port component on one config, recording their
    ``on_points`` and ``on_mapping`` payloads."""
    got = {"j": ([], []), "t": ([], [])}
    j = JComponent(JCfg(**kw), on_points=got["j"][0].append,
                   on_mapping=got["j"][1].append, enable_mapping=mapping)
    t = TComponent(TCfg(**kw), "cpu", on_points=got["t"][0].append,
                   on_mapping=got["t"][1].append, enable_mapping=mapping)
    _op_by_op(j)
    return j, t, got


def _assert_payloads_equal(got, n_frames):
    (jp, jm), (tp, tm) = got["j"], got["t"]
    assert len(jp) == len(tp) == n_frames
    for a, b in zip(tp, jp):
        assert_outputs_equal(a, b, OUTPUTS)
    assert len(jm) == len(tm)
    for k, (a, b) in enumerate(zip(jm, tm)):
        assert_same(a, b, f"on_mapping[{k}]")


def _depth(v=2000, h=16, w=24, step=0):
    d = np.full((h, w), v, np.uint16)
    d[4:9, 6 + step:12 + step] -= 400      # an object in front of the wall
    return d


def test_component_resample_matches_jax(need_native):
    """Two streams stashed and resampled, twice, each tick followed by one
    with nothing new: equal payloads, mapping on."""
    kw = dict(GRID6, num_depth_streams=2, depth_height=16, depth_width=24,
              resample_rate=30.0)
    j, t, got = _pair(kw)
    intr = PinholeIntrinsics.default_for(24, 16)
    eye = np.eye(4, dtype=np.float32)
    for k, stamp in enumerate((1.00, 1.05)):
        for comp in (j, t):
            assert comp.callback_depthmap(0, stamp, _depth(step=k), intr,
                                          eye) is None
            assert comp.callback_depthmap(1, stamp + 0.001, _depth(),
                                          intr, eye) is None
            assert comp.tick_resample(stamp + 0.02) is not None
            assert comp.tick_resample(stamp + 0.03) is None
    assert t.frames_processed == j.frames_processed == 2
    _assert_payloads_equal(got, 2)
    assert len(got["t"][1]) == 2


def test_component_immediate_mode_with_lidar_matches_jax(need_native):
    kw = dict(GRID6, num_depth_streams=1, depth_height=16, depth_width=24,
              num_point_sequences=1, resample_rate=0.0,
              point_sequence_filter_threshold=0.0)
    j, t, got = _pair(kw)
    intr = PinholeIntrinsics.default_for(24, 16)
    eye = np.eye(4, dtype=np.float32)
    s = np.linspace(0, 1, 10)
    for f in range(3):
        arc = np.stack([3 * np.cos(s + f), 3 * np.sin(s + f), 0 * s + 1], -1)
        outs = []
        for comp in (j, t):
            comp.callback_point_sequence(0.99 + f / 10, arc)
            outs.append(comp.callback_depthmap(0, 1.0 + f / 10,
                                               _depth(step=f), intr, eye))
        assert int(outs[1].seq_selected_count) >= 10
    _assert_payloads_equal(got, 3)


def test_component_live_reconfig_matches_jax(need_native):
    """A new filter size and rot45 rebuild the engine on the same device;
    the occupancy history carries over (the zero-depth frame after it still
    sees the first frame's cells)."""
    kw = dict(GRID6, num_depth_streams=1, depth_height=16, depth_width=24,
              resample_rate=0.0, voxel_occupancy_lifetime=5)
    j, t, got = _pair(kw)
    intr = PinholeIntrinsics.default_for(24, 16)
    eye = np.eye(4, dtype=np.float32)
    for comp in (j, t):
        comp.callback_depthmap(0, 1.0, _depth(), intr, eye)
        comp.set_flying_pixel_config(threshold=0.1, size=2, rot45=False)
    _op_by_op(j)
    assert t.cfg.flyingpixels_filter_threshold == 0.1
    assert t.engine.cfg.flyingpixels_filter_size == 2
    assert str(t.engine.device) == "cpu" and t.engine.fp_threshold == 0.1
    for comp in (j, t):
        comp.callback_depthmap(0, 1.1, np.zeros((16, 24), np.uint16), intr,
                               eye)
    _assert_payloads_equal(got, 2)
    occ = [int((p.occupancy_u8.numpy() > 0).sum()) for p in got["t"][0]]
    assert occ[1] == occ[0] > 0


def test_component_skips_frames_without_intrinsics_as_jax(need_native):
    kw = dict(GRID6, num_depth_streams=1, depth_height=16, depth_width=24,
              resample_rate=0.0)
    j, t, got = _pair(kw, mapping=False)
    eye = np.eye(4, dtype=np.float32)
    for comp in (j, t):
        assert comp.callback_depthmap(0, 1.0, _depth(), None, eye) is None
        comp.callback_camera_info(0, PinholeIntrinsics.default_for(24, 16))
        assert comp.callback_depthmap(0, 1.1, _depth(), None, eye) \
            is not None
    assert t.frames_skipped_no_intrinsics == j.frames_skipped_no_intrinsics \
        == 1
    assert t.frames_processed == j.frames_processed == 1
    _assert_payloads_equal(got, 1)
    assert got["t"][1] == []
