"""The timed path broken underneath a whole run (the chip look skipped,
the CPU's plain twins): ``correct`` must come out false for each fault a
cell can have. A single-card cell has no exchange between chips to
leave out."""

import time

import pytest
import torch

import run
from conftest import CELLS
from ros_gpu_depthmap_fusion_tpu_torch.pipeline import engine as engmod


def state_unchanged(mp):
    """Every step hands back the state it was given."""
    build = engmod.build_fusion_step

    def broken(*a, **k):
        step = build(*a, **k)

        def frozen(state, inp, depth_bits=None, plain=False):
            return state, step(state, inp, depth_bits, plain=plain)[1]
        return frozen
    mp.setattr(engmod, "build_fusion_step", broken)


def half_the_cameras(mp):
    """The second half of the cameras left out; the means are taken over
    the rest."""
    unproject = engmod.unproject_depthmaps

    def broken(depth, *a, **k):
        cam, world, crop, mask = unproject(depth, *a, **k)
        mask = mask.clone()
        mask[depth.shape[0] // 2:] = False
        return cam, world, crop, mask
    mp.setattr(engmod, "unproject_depthmaps", broken)


def answer_altered(mp):
    """The first fused point moved 20 mm where the voxelization produces
    it."""
    for name in ("voxelize_average_rle_domains", "voxelize_average_rle"):
        orig = getattr(engmod, name)

        def broken(*a, _orig=orig, **k):
            out = _orig(*a, **k)
            pts = out[0].clone()
            pts[0, 0] += 0.02
            return (pts,) + tuple(out[1:])
        mp.setattr(engmod, name, broken)


@pytest.mark.parametrize("fault", [state_unchanged, half_the_cameras,
                                   answer_altered])
@pytest.mark.parametrize("cell", CELLS)
def test_portbench_fault_is_not_correct(cell, fault, tiny_cell,
                                        monkeypatch):
    fault(monkeypatch)
    torch.manual_seed(0)
    res = run.run_cell(tiny_cell(cell), 2147484001, 1.0, False, "cpu",
                       time.perf_counter())
    assert res["attempted"] > 0
    assert res["correct"] is False, res["checks"]
