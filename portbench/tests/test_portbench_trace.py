"""The trace reader on a synthetic Chrome trace, and the roofline work
counts on small calls of the port's kernel twins."""

import pytest
import torch

from pb import roofline, trace


def ev(cat, name, ts, dur, tid=1, pid=1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
         "pid": pid, "tid": tid, "args": {}}
    if corr is not None:
        e["args"]["correlation"] = corr
    return e


def test_portbench_trace_attribution_busy_and_gaps():
    events = [
        ev("user_annotation", trace.FRAME, 0, 100),
        ev("user_annotation", "pipeline.engine.process", 10, 35),
        ev("user_annotation", "kernel.segreduce", 20, 10),
        ev("user_annotation", "harness.publish", 46, 49),
        ev("cuda_runtime", "cudaLaunchKernel", 12, 1, corr=1),
        ev("cuda_runtime", "cudaMemsetAsync", 22, 1, corr=2),
        ev("cuda_runtime", "cudaLaunchKernel", 24, 1, corr=3),
        ev("cuda_runtime", "cudaMemcpyAsync", 61, 1, corr=4),
        ev("kernel", "elementwise", 15, 10, pid=0, tid=7, corr=1),
        ev("gpu_memset", "Memset", 26, 2, pid=0, tid=7, corr=2),
        ev("kernel", "segreduce_kernel", 28, 12, pid=0, tid=7, corr=3),
        ev("gpu_memcpy", "Memcpy DtoH", 62, 4, pid=0, tid=7, corr=4),
        ev("gpu_user_annotation", "pipeline.engine.process", 10, 40,
           pid=0, tid=7),
    ]
    t = trace.parse(events)
    assert t.frames == 1 and t.window_s == pytest.approx(100e-6)
    # busy: [15, 25), [26, 40) and [62, 66)
    assert t.busy_s == pytest.approx(28e-6)
    labels = {e[0]: e[3] for e in t.device}
    assert labels == {"elementwise": "pipeline.engine.process",
                      "Memset": "kernel.segreduce",
                      "segreduce_kernel": "kernel.segreduce",
                      "Memcpy DtoH": "harness.publish"}
    assert [g[0] for g in t.gaps] == ["harness.publish", "harness.publish",
                                      "harness", "kernel.segreduce"]
    assert [g[1] for g in t.gaps] == pytest.approx([34e-6, 22e-6, 15e-6,
                                                    1e-6])
    r = trace.Reading(trace=t, spans=None, span_frames=0,
                      bounds={"segreduce": [7e-6]})
    assert r.roofline_pct("segreduce") == pytest.approx(50.0)
    assert r.roofline_pct("compact") is None
    bd = trace.breakdown(t)
    assert bd["device_ops"][0] == ["segreduce_kernel", pytest.approx(12e-6)]


def test_portbench_work_counts_what_the_inputs_need():
    from ros_gpu_depthmap_fusion_tpu_torch.ops.kernels import (
        compact, flying_pixels, segreduce)
    keys = torch.tensor([0, 0, 5, 9, 9, 9, 7, 9], dtype=torch.int32)
    vals = torch.ones((8, 4))
    args = (keys, vals, 100, 9, 0)
    out = segreduce.segreduce_plain(*args)
    # 8 keys, 4 valid rows of 4 columns, 3 runs of (key, 4 sums), 2 counts
    assert roofline.segreduce(args, out) == (8 * 4 + 4 * 16 + 3 * 20 + 8,
                                             16)
    words = torch.arange(12, dtype=torch.int32).reshape(6, 2)
    mask = torch.tensor([1, 0, 1, 1, 0, 0], dtype=torch.bool)
    cargs = (words, mask, 1000)
    cout = compact.compact_plain(*cargs)
    assert roofline.compact(cargs, cout) == (6 + 2 * 3 * 8 + 8, 0)
    pts = torch.zeros((1, 12, 4))
    pts[..., 2] = 2.0
    pts[0, 5, 2] = 20.0          # beyond the range gate
    fmask = torch.ones((1, 12), dtype=torch.bool)
    fmask[0, 0] = False
    args = (pts, fmask, 3, 4, 1, 0.5, True, 10.0)
    out = flying_pixels.filter_flying_pixels_plain(*args)
    assert roofline.flying_pixels(args, out) == (2 * 12 + 12 * 11,
                                                 46 * 11 + 66 * 2 * 10)
    assert roofline.call_bound_s("compact", cargs, cout) == pytest.approx(
        (6 + 2 * 3 * 8 + 8) / roofline.HBM_BYTES_PER_S)
