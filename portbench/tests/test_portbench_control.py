"""The control (the reference in bfloat16, in the program's place) is not
correct, at a size a test run holds; and the reference's link model
agrees with the port's numpy oracles of the encoders."""

import numpy as np
import pytest
import torch

import control
from conftest import CELLS
from reference.link import p4_exceptions, quantize_hysteresis


@pytest.mark.parametrize("cell", CELLS)
def test_portbench_control_fails(cell, tiny_cell):
    checks = control.control_numbers(tiny_cell(cell), 2147484101, 40, "cpu")
    failed = [k for k, c in checks.items() if c["value"] > c["limit"]]
    assert failed, checks


def test_portbench_p4_model_matches_the_encoder_oracle():
    """The exception count and the hysteresis series of a p4 P-frame, as
    the reference works them out, equal the port's reference encoder's
    (``ops/depth_codec.py encode_depth_p4_reference``) on frames with
    holes, revivals, wide steps and rows past the literal budget."""
    from ros_gpu_depthmap_fusion_tpu_torch.ops.depth_codec import (
        encode_depth_p4_reference, quantize_reference)
    rng = np.random.default_rng(7)
    c, h, w, shift, hyst, budget = 2, 6, 90, 4, 2, 8
    prev_raw = rng.integers(2000, 3000, (c, h, w)).astype(np.uint16)
    prev_raw[rng.random((c, h, w)) < 0.05] = 0
    prev_q = quantize_reference(prev_raw, shift)
    curr = prev_raw.astype(np.int64) + rng.integers(-40, 40, (c, h, w))
    curr[:, :, :20] += rng.integers(-400, 400, (c, h, 20))
    curr = np.clip(curr, 0, 65535).astype(np.uint16)
    curr[rng.random((c, h, w)) < 0.05] = 0
    enc, curr_q = encode_depth_p4_reference(curr, prev_q, budget, 10 ** 6,
                                            shift, hyst)
    cq = quantize_hysteresis(torch.from_numpy(curr.astype(np.int32)),
                             torch.from_numpy(prev_q.astype(np.int32)),
                             shift, hyst)
    assert np.array_equal(cq.numpy(), curr_q.astype(np.int32))
    n = p4_exceptions(cq, torch.from_numpy(prev_q.astype(np.int32)), budget)
    assert n == len(enc["exc_idx"]) and n > 0
