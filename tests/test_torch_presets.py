"""The launch-file presets end to end (``PRESET_HAFEN``, ``PRESET_OFFICE``;
``launch/gpu_depthmap_fusion.launch:144-181``): the port's
``FusionEngine`` on the CPU against the JAX engine (its step under
``jax.disable_jit()``, as in ``tests/test_torch_engine.py``), every output
bit-equal frame by frame.

Each preset runs as written, its grid, crop and lifetime and every other
field at ``FusionConfig()``'s default (the "dpcm" link, so both engines need
the native library; the raw cloud and the dense occupancy emitted; "auto",
which the JAX package resolves to "packed" on the CPU and the port to "rle"
below 2^24 cells: equal outputs, the partials count aside), with the camera
images cut to 64x48 and the small rigs of ``tests/test_torch_cuda.py``
(``PRESET_RIGS``): cameras on a ring around the grid's centre, 2 m up,
looking at it and tilted 0.3 rad down as ``bench.py``'s rig does; the first
6 of 8 on an 8 m ring for Hafen, 2 facing each other on a 4 m ring (the
edge of Office's 8 x 8 m crop) for Office.
"""

import pytest

from ros_gpu_depthmap_fusion_tpu.core import config as jconfig
from ros_gpu_depthmap_fusion_tpu.pipeline import FusionEngine as JEngine
from ros_gpu_depthmap_fusion_tpu.utils import native as j_native

from ros_gpu_depthmap_fusion_tpu_torch.core import config as tconfig
from ros_gpu_depthmap_fusion_tpu_torch.pipeline import engine as teng
from ros_gpu_depthmap_fusion_tpu_torch.utils import native

from test_torch_cuda import (
    PRESET_HW, PRESET_RIGS, preset_depths, stage_preset)
from test_torch_engine import ALL_FIELDS, assert_outputs_equal, jax_process


@pytest.fixture(scope="module")
def native_lib():
    if not (native.available() and j_native.available()):
        pytest.skip("native library not built")


@pytest.mark.parametrize("name", list(PRESET_RIGS))
def test_preset_engine_matches_jax(native_lib, name):
    h, w = PRESET_HW
    jcfg = getattr(jconfig, name).replace(depth_height=h, depth_width=w)
    tcfg = getattr(tconfig, name).replace(depth_height=h, depth_width=w)
    assert tcfg.num_depth_streams == PRESET_RIGS[name][0]
    assert tcfg.num_point_sequences == 0
    j = JEngine(jcfg)
    t = teng.FusionEngine(tcfg, device="cpu")
    assert teng.resolve_mean_mode(tcfg, t.grid) == "rle"
    for f, d in enumerate(preset_depths(name, 3)):
        stage_preset(j, name, f, d)
        stage_preset(t, name, f, d)
        now = 1.0 + f / 30.0
        j_out = jax_process(j, now)
        t_out = t.process(now)
        assert t.last_frame_bits == j.last_frame_bits
        assert isinstance(t.last_frame_bits, int) and t.last_frame_bits > 0
        assert_outputs_equal(t_out, j_out, ALL_FIELDS)
        occupied = int((t_out.occupancy_u8 > 0).sum())
        assert occupied >= 500, occupied
        assert 0 < int(t_out.fused_count) < int(t_out.raw_count)
    assert tuple(t_out.occupancy_u8.shape) == (t.grid.num_cells,)
