#!/usr/bin/env python3
"""Measures the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

The card's checks are ``tests/test_torch_cuda.py``'s (run them first, on
the card); this script asserts only what its own numbers need: each timed
kernel call equals its plain twin on the recorded inputs, and each loop
launched the kernels whose counts it reports. It drives the port
(``ros_gpu_depthmap_fusion_tpu_torch``) on ``portbench/pb/scene.py``'s
moving scene (drawn on the CPU from seed 0) at ``bench.py``'s operating
point, as ``operating_point.py`` sets it for the card tests too: 8 depth
cameras at 848x480 plus 2 lidar streams of 8192 points into a 400x400x21
= 3,360,000-cell grid. A kernel's bound is the larger of its
bytes and its float32 operations over ``portbench/pb/roofline.py``'s
peaks; for segreduce, flying pixels and compact the work is that file's
``WORK``, as the benchmark's ``*_roofline`` metrics read it. One line a
phase:

1. ``[env]``, ``[build]``: the card and its power limit, torch, CUDA and
   nvcc; the kernels' and the native library's build, ptxas registers;
2. ``[link]``: ``bench.py:120-182``'s configuration with
   ``FusionEngine(cfg, "cuda", pipeline_depth=1)``, 24 frames then
   ``flush()``, and ``pipeline_depth=0``: ms/frame, host process() and
   encode ms, I/P frames, packet size, partials; the kernels' calls of
   frame ``RECORD_FRAME`` recorded;
3. ``[raw]``: the raw depth link, 8 frames;
4. ``[publish]``: ``FusionConfig()``'s defaults at the bench rig ("dpcm"
   link, raw cloud, dense occupancy, "auto" = rle), pipelined and
   synchronous, "packed", one synchronous frame each of "exact" and
   occupied, and "auto" / "packed" in turns on fresh engines;
5. ``[hetero]``: 4 cameras at 848x480 and 4 at 640x360 (top-left crops of
   the bench scene), pipelined and synchronous;
6. ``[presets]``: ``PRESET_HAFEN`` (the bench rig's first 6 cameras) and
   ``PRESET_OFFICE`` (2 cameras facing each other from a 4 m ring at 87
   degrees), 10 synchronous frames each;
7. ``[mapping]``: ``bench.py:443-537``: a warm ``process_sparse`` cycle,
   the device segmentation of that frame's grid against the native host
   segmentation, then ``AsyncMappingWorker`` over 60 frames paced at 30 Hz
   between two mapping-off runs of the same loop;
8. ``[tum]``: the hard synthetic TUM sequence (640x480, 150 frames)
   rendered by the port's writer, ``run_tum_sequence(..., pose_source=
   "slam", ba_every=8, loop_close=True, device="cuda")``: ATEs and host ms
   of its parts, then call ms of the frontend and of ``solve_window`` on
   the run's first BA window;
9. ``[sharded]``: ``ShardedFusionEngine`` on the publish configuration at
   "packed", one rank over NCCL (synchronous and pipelined) and four ranks
   sharing the card over gloo (mesh 2 x 2): ms/frame, and rank 0 times its
   kernel calls of one frame;
10. after the loops (``torch.profiler`` slows a process's later host
    work): ``[kernel]`` lines, each engine kernel at each recorded call
    site (device ms from ``torch.profiler`` over 20 calls after 3
    warm-ups, ``call_ms`` by CUDA events, bound ms, the twin's, and for
    compact ``rows[flags]``); ``[lidar kernels]``, ``[segment kernels]``,
    ``[group kernels]`` (the foreground grouping on that segmentation)
    (each held to its twin before it is timed);
    ``[publish step]``, each publish mode's whole step from its tapped
    state; ``[fused]``, kernel 4 (``unproject_voxelize_l1``, not on the
    engine's path) on the recorded frame's masked metric depth beside
    the engine's chain.

Then one JSON line with every kernel's numbers (``PERF.md`` §6 is written
from it), the ``nvidia-smi`` line and ``{"ok": true, "device": ...}``.
Without a CUDA device it exits non-zero before printing any result.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.join(HERE, "portbench")]

from operating_point import (  # noqa: E402
    HETERO_SHAPES, LINK_FIELDS, PRESETS, RAW_FIELDS, RECORD_FRAME, config,
    kernel_modules, scene, stage)
from pb import roofline  # noqa: E402

LINK_FRAMES = 24
RAW_FRAMES = 8
PUBLISH_FRAMES = 8
HETERO_FRAMES = 6
PRESET_FRAMES = 10
MAP_WARM_FRAMES = 12   # the decaying history (lifetime 10) at steady state
MAP_FRAMES = 60        # the paced mapping-on loop
MAP_LAG = 4            # frames between a step and its drain (bench.py:500)
TUM_FRAMES = 150       # the hard synthetic sequence, 640x480, one orbit
SHARDED_FRAMES = PUBLISH_FRAMES

ENGINE_KERNELS = ("segreduce", "flying_pixels", "compact")
KERNELS = ENGINE_KERNELS + ("fused_unproject_rle",)
REPLACES = {
    "segreduce": "ros_gpu_depthmap_fusion_tpu/ops/pallas/segreduce.py:233",
    "flying_pixels":
        "ros_gpu_depthmap_fusion_tpu/ops/pallas/flying_pixels.py:130",
    "compact": "ros_gpu_depthmap_fusion_tpu/ops/pallas/compact.py:268",
    "fused_unproject_rle":
        "ros_gpu_depthmap_fusion_tpu/ops/pallas/fused_unproject_rle.py:128",
}
SOURCES = {name: f"ros_gpu_depthmap_fusion_tpu_torch/csrc/{name}.cu"
           for name in KERNELS}


def kernel_wrappers():
    """Each engine kernel's (wrapper, plain twin)."""
    from ros_gpu_depthmap_fusion_tpu_torch.ops.kernels import (
        compact, flying_pixels, segreduce)
    return {"segreduce": (segreduce.segreduce, segreduce.segreduce_plain),
            "flying_pixels": (flying_pixels.filter_flying_pixels,
                              flying_pixels.filter_flying_pixels_plain),
            "compact": (compact.compact_rows, compact.compact_plain)}


def gpu_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, reps=20, warm=3):
    """Median CUDA-event time of one call of ``fn`` in ms: host work
    before the launches included (a call's ``call_ms``)."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def device_ms(torch, fn, reps=20, warm=3):
    """Device time of one call of ``fn`` in ms (see :func:`device_profile`).
    """
    return device_profile(torch, fn, reps, warm)[0]


def device_profile(torch, fn, reps=20, warm=3):
    """(device ms, device activities) of one call of ``fn``: the summed
    durations and the number of the device activities (kernels, fills,
    copies) that ``reps`` calls launch, from ``torch.profiler``, over
    ``reps``, after ``warm`` warm-up calls. Host gaps between launches are
    not counted. The profiler now and then hands back a trace that lacks
    some or all of its device activities (seen about once in a hundred
    traces on the H100), so the measurement is taken twice, a third time
    if the two disagree on the number of activities, and the fullest
    trace counts."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    traces = []
    while len(traces) < 2 or (len(traces) == 2
                              and traces[0][0] != traces[1][0]):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = [ev.time_range.elapsed_us() for ev in prof.events()
              if ev.device_type == DeviceType.CUDA]
        traces.append((len(us), sum(us)))
    count, total = max(traces, key=lambda t: t[0])   # the first fullest
    if count < reps or total <= 0:
        raise RuntimeError("torch.profiler recorded no device activity")
    return total / 1e3 / reps, count / reps


def bound(nbytes, ops):
    """(bound ms, "bytes" or "operations") of a call that must move
    ``nbytes`` and do ``ops`` float32 operations, at ``pb.roofline``'s
    peaks."""
    by_bytes = nbytes / roofline.HBM_BYTES_PER_S >= \
        ops / roofline.FP32_OPS_PER_S
    return (roofline.bound_s(nbytes, ops) * 1e3,
            "bytes" if by_bytes else "operations")


def fused_inputs(torch, calls, cfg, grid):
    """Kernel 4's arguments on a recorded frame: its depth, masked by the
    flying-pixel filter's output, in metres. Returns (the masked integer
    depth, the unprojection's other arguments, the wrapper's arguments)."""
    (depth_u16, intr, tfw, tfc, scale), _, _ = calls["unproject"][0]
    fp_mask = calls["flying_pixels"][0][2].reshape(depth_u16.shape)
    depth_m = (depth_u16.to(torch.float32) * float(scale)
               * fp_mask.to(torch.float32)).contiguous()
    return (depth_u16 * fp_mask, (intr, tfw, tfc, scale),
            (depth_m, intr, tfw, tfc, grid, cfg.crop_min, cfg.crop_max,
             cfg.voxelize_partials_capacity))


def fused_work(fargs, valid):
    """(bytes, float32 operations) of one call of kernel 4 with ``valid``
    valid points: depth and the camera tables in; the static-capacity key
    and sum rows and three counts out. Per pixel with a depth ~50
    operations (unprojection with its two IEEE divisions at 11 each, crop
    transform and test), per valid point ~110 more (world transform, cell
    and quantization with six divisions, sums), counted from
    ``csrc/fused_unproject_rle.cu``; a pixel without depth costs none."""
    depth_m, intr, tfw, tfc, cap = *fargs[:4], fargs[7]
    return (depth_m.nbytes + intr.nbytes + tfw.nbytes + tfc.nbytes
            + cap * 4 * 5 + 12,
            int((depth_m > 0).sum()) * 50 + valid * 110)


def lidar_work(rb, kw, cap):
    """Bytes the lidar kernel pair must move (each input read once, each
    output written once): the buffer read and written, the staged batch
    read, the gathered rows and the window's composed transforms
    written."""
    p_cap, s_cap = rb.point_capacity, rb.seq_capacity
    sb = kw["seq_batch"]
    row = 16 + 1 + 4                       # points, mask, seq_idx
    seq = 4 * 4 + 64                       # sec, nsec, start, count, tf
    return (2 * p_cap * row + 2 * s_cap * seq
            + sb.points.shape[0] * (16 + 4) + sb.seq_sec.shape[0] * seq
            + cap * (16 + 16 + 1) + 2 * s_cap * 64)


def segment_work(occ, labels, objects):
    """Bytes the segmentation chain must move: the occupancy read once;
    labels, merged ids and the small outputs written once."""
    z = occ.shape[0]
    return occ.numel() * (1 + 4 + 4) + 4 * (z + z * labels + 1
                                             + 10 * objects)


def record_calls(mods, run):
    """Run ``run()`` with each named module function wrapped to record its
    arguments and result; returns ``{name: [(args, kwargs, result)]}``."""
    calls = {}
    patched = []
    for name, mod, attr in mods:
        orig = getattr(mod, attr)

        def rec(*a, _orig=orig, _name=name, **k):
            out = _orig(*a, **k)
            calls.setdefault(_name, []).append((a, k, out))
            return out
        setattr(mod, attr, rec)
        patched.append((mod, attr, orig))
    try:
        run()
    finally:
        for mod, attr, orig in patched:
            setattr(mod, attr, orig)
    return calls


def max_abs_err(torch, a, b):
    """Max |a - b| over tensors (or tuples of them) of equal shape."""
    if isinstance(a, (tuple, list)):
        return max(max_abs_err(torch, x, y) for x, y in zip(a, b))
    if a.shape != b.shape:
        raise AssertionError(f"shape {tuple(a.shape)} != {tuple(b.shape)}")
    if a.numel() == 0:
        return 0.0
    return float((a.double() - b.double()).abs().max())


def run_engine(torch, eng, sc, frames, tap=None, record=None):
    """Drive ``eng`` through ``frames`` frames of scene ``sc`` (then
    ``flush()`` when pipelined) through the user entry points, every
    kernel's launch counter counted from 0. ``tap(k, state, inputs,
    depth_bits)`` sees step ``k`` before it runs; ``record`` = (frame,
    mods) records that frame's kernel calls. Returns (outputs, depth_bits
    per output, wall ms a frame of frames 4.. (1.. of a shorter run)
    including a final synchronize, per-frame host ms of process() and of
    the step's enqueue, recorded calls, launches of each kernel)."""
    kmods = kernel_modules()
    for m in kmods.values():
        m.launches = 0
    orig_step = getattr(eng, "step", None)   # the sharded engine's is
    step_ms = []                             # inside process()

    def step(inp, depth_bits=None):
        if tap is not None:
            tap(len(step_ms), eng.state, inp, depth_bits)
        t = time.perf_counter()
        out = orig_step(inp, depth_bits)
        step_ms.append((time.perf_counter() - t) * 1e3)
        return out
    if orig_step is not None:
        eng.step = step
    outs, bits, host_ms, calls = [], [], [], {}
    warm = 4 if frames > 4 else 1
    for f in range(frames):
        if f == warm:
            torch.cuda.synchronize()
            t_steady = time.perf_counter()
        now = stage(eng, sc, f)
        t0 = time.perf_counter()
        if record is not None and f == record[0] + eng.pipeline_depth:
            box = []
            calls = record_calls(record[1], lambda: box.append(
                eng.process(now)))
            out = box[0]
        else:
            out = eng.process(now)
        host_ms.append((time.perf_counter() - t0) * 1e3)
        if out is not None:
            outs.append(out)
            bits.append(eng.last_frame_bits)
    if eng.pipeline_depth:
        outs.append(eng.flush())
        bits.append(eng.last_frame_bits)
    eng.close()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t_steady) * 1e3 / (frames - warm)
    if orig_step is not None:
        eng.step = orig_step
    return (outs, bits, wall, (host_ms, step_ms), calls,
            {n: m.launches for n, m in kmods.items()})


def keep_last(box):
    """A step tap that keeps the latest step's (state, inputs,
    depth_bits); the state is never modified in place."""
    def tap(k, *step):
        box[:] = [step]
    return tap


def lidar_tap(box, at):
    """A step tap that keeps step ``at``'s rollbuffer and a copy of its
    lidar inputs, as the keyword arguments of ``advance_and_gather`` but
    the buffer."""
    def tap(k, state, inp, bits):
        if k != at:
            return

        def c(x):
            return x.clone()
        box[:] = [(state.rollbuffer, dict(
            seq_batch=type(inp.seq_batch)(*map(c, inp.seq_batch)),
            ps_threshold=c(inp.ps_threshold),
            roll_min=(c(inp.roll_min_sec), c(inp.roll_min_nsec)),
            now=(c(inp.now_sec), c(inp.now_nsec)),
            tf_world_move=c(inp.tf_world_move),
            tf_crop_move=c(inp.tf_crop_move)))]
    return tap


def partials_max(outs):
    return max(int(o.vox_partials_count) for o in outs)


def link_phase(torch, engmod, native, record_mods, gpu):
    """``bench.py:120-182``'s link pipelined and synchronous. Returns the
    configuration, the grid, recorded calls, the lidar pair's recorded
    inputs and launches by path (with its steps)."""
    cfg = config(LINK_FIELDS)
    sc = scene()
    eng = engmod.FusionEngine(cfg, device="cuda", pipeline_depth=1)
    encodes = []
    encode = eng._encode

    def tap_encode(pkt, depth_host, scalars):
        t = time.perf_counter()
        words, bits = encode(pkt, depth_host, scalars)
        encodes.append((int(pkt.buf[0]), len(words),
                        (time.perf_counter() - t) * 1e3))
        return words, bits
    eng._encode = tap_encode
    lidar_rec = []
    outs, bits, ms, (host_ms, step_ms), calls, launches = run_engine(
        torch, eng, sc, LINK_FRAMES, tap=lidar_tap(lidar_rec, RECORD_FRAME),
        record=(RECORD_FRAME, record_mods))
    by_path = {"link": (launches, LINK_FRAMES)}
    sync = engmod.FusionEngine(cfg, device="cuda", pipeline_depth=0)
    _, _, sync_ms, _, _, s_launches = run_engine(torch, sync, sc,
                                                 LINK_FRAMES)
    by_path["link_sync"] = (s_launches, LINK_FRAMES)
    exc = [e[0] for e in encodes]
    enc_ms = [e[2] for e in encodes]
    pkt_kb = [4 * e[1] / 1e3 for e in encodes]
    n_i = sum(1 for b in bits if b != "p4")
    print(f"[link] bench.py:120-182 as written, pipeline_depth=1, "
          f"{LINK_FRAMES} frames + flush: {ms:.2f} ms/frame (frames 4.., "
          f"ends with a synchronize; pipeline_depth=0: {sync_ms:.2f}) | "
          f"host process() median {float(np.median(host_ms[4:])):.2f} ms "
          f"(step enqueue {float(np.median(step_ms[4:])):.2f}), encode "
          f"median {float(np.median(enc_ms[4:])):.2f} ms (I-frame "
          f"{enc_ms[0]:.2f}) | I/P {n_i}/{len(bits) - n_i} (frame 0 at "
          f"B={bits[0]}) | exceptions max {max(exc)} of "
          f"{cfg.depth_codec_max_exceptions} | packet median "
          f"{float(np.median(pkt_kb[1:])):.1f} KB (I {pkt_kb[0]:.1f} KB) | "
          f"level-1 partials max {partials_max(outs)} of "
          f"{eng.partials_capacity} | fused {int(outs[-1].fused_count)} "
          f"cells, lidar selected {int(outs[-1].seq_selected_count)} | "
          f"launches {launches} | native {native._LIB_PATH} | {gpu}",
          flush=True)
    return cfg, eng.grid, calls, lidar_rec[0], by_path


def raw_phase(torch, engmod, gpu):
    """The raw depth link, synchronous. Returns launches by path."""
    cfg = config(RAW_FIELDS)
    eng = engmod.FusionEngine(cfg, device="cuda")
    outs, _, ms, _, _, launches = run_engine(torch, eng, scene(),
                                             RAW_FRAMES)
    print(f"[raw] depth_link_codec='none', {RAW_FRAMES} frames: {ms:.2f} "
          f"ms/frame (frames 4.., ends with a synchronize) | level-1 "
          f"partials max {partials_max(outs)} of {eng.partials_capacity} "
          f"| launches {launches} | {gpu}", flush=True)
    return {"raw": (launches, RAW_FRAMES)}


def publish_phase(torch, engmod, record_mods, gpu):
    """FusionConfig()'s defaults at the bench rig's size: the non-split
    step with the raw cloud, in each mode. Returns (recorded calls of an
    "auto" and a "packed" frame, launches by path, and by mode the engine
    with its last tapped step: state, inputs, depth_bits)."""
    cfg = config()
    sc = scene()
    by_path, ms, taps = {}, {}, {}
    runs = (("auto", "publish", {}, 1, PUBLISH_FRAMES),
            ("auto_sync", "publish_sync", {}, 0, PUBLISH_FRAMES),
            ("packed", "publish_packed", dict(voxel_mean_mode="packed"), 1,
             PUBLISH_FRAMES),
            # one frame each, after a first: the history decays
            ("exact", "publish_exact", dict(voxel_mean_mode="exact"), 0, 2),
            ("occupied", "publish_occupied",
             dict(voxel_enable_average=False), 0, 2))
    calls = {}
    for mode, path, kw, depth, frames in runs:
        eng = engmod.FusionEngine(cfg.replace(**kw), device="cuda",
                                  pipeline_depth=depth)
        last = []
        record = (RECORD_FRAME, record_mods) if mode in ("auto",
                                                         "packed") else None
        outs, _, ms[mode], hosts, calls[mode], launches = run_engine(
            torch, eng, sc, frames, tap=keep_last(last), record=record)
        by_path[path] = (launches, frames)
        if mode != "auto_sync":
            taps[mode] = (eng, last[0])
        if mode == "auto":
            host_ms, step_ms = hosts
            auto_outs, grid, cap = outs, eng.grid, eng.partials_capacity
    last = auto_outs[-1]
    n_raw = int(last.raw_count)
    # the largest cell: packed == rle needs its z-sum below 2^24
    cell_ids = grid.cell_index_clamped(last.raw_points[:n_raw, :3]).long()
    max_members = int(torch.bincount(cell_ids).max())
    # ms/frame of "auto" and "packed" in turns, fresh pipelined engines
    turns = []
    for mode in ("auto", "packed", "packed", "auto"):
        e = engmod.FusionEngine(cfg.replace(voxel_mean_mode=mode),
                                device="cuda", pipeline_depth=1)
        turns.append(run_engine(torch, e, sc, PUBLISH_FRAMES)[2])
    print(f"[publish] FusionConfig() defaults at bench.py's rig (dpcm "
          f"link, raw cloud + dense occupancy, auto = rle on "
          f"{grid.num_cells} cells), {PUBLISH_FRAMES} frames + flush: "
          f"ms/frame auto pipelined {ms['auto']:.2f}, auto "
          f"pipeline_depth=0 {ms['auto_sync']:.2f}, packed pipelined "
          f"{ms['packed']:.2f}; exact {ms['exact']:.2f} and occupied "
          f"{ms['occupied']:.2f} (one synchronous frame each); in turns, "
          f"auto / packed / packed / auto: "
          f"{' / '.join(f'{t:.2f}' for t in turns)} | no speed "
          f"is claimed | host process() median "
          f"{float(np.median(host_ms[4:])):.2f} ms (step enqueue "
          f"{float(np.median(step_ms[4:])):.2f}) | raw cloud {n_raw} of "
          f"{cfg.total_point_capacity}, fused {int(last.fused_count)} of "
          f"{cfg.voxelize_output_capacity}, level-1 partials max "
          f"{partials_max(auto_outs)} of {cap}, largest cell "
          f"{max_members} points (z-sum below 2^24 up to 4,096) | launches "
          f"{ {p: v[0] for p, v in by_path.items()} } | {gpu}", flush=True)
    return calls["auto"], calls["packed"], by_path, taps


def hetero_phase(torch, engmod, gpu):
    """A mixed rig at the bench rig's size: 4 cameras at 848x480 and 4 at
    640x360 on the "dpcm" link at FusionConfig()'s defaults, pipelined and
    synchronous. Returns launches by path."""
    cfg = config(stream_shapes=HETERO_SHAPES)
    sc = scene()
    by_path, ms = {}, {}
    for path, depth in (("hetero", 1), ("hetero_sync", 0)):
        eng = engmod.FusionEngine(cfg, device="cuda", pipeline_depth=depth)
        outs, bits, ms[path], _, _, launches = run_engine(
            torch, eng, sc, HETERO_FRAMES)
        by_path[path] = (launches, HETERO_FRAMES)
    print(f"[hetero] 4 x 848x480 + 4 x 640x360 cameras, dpcm per group, "
          f"FusionConfig() defaults, {HETERO_FRAMES} frames + flush: "
          f"{ms['hetero']:.2f} ms/frame pipelined, {ms['hetero_sync']:.2f} "
          f"pipeline_depth=0 (no speed claimed) | widths {bits[-1]} | raw "
          f"cloud {int(outs[-1].raw_count)}, fused "
          f"{int(outs[-1].fused_count)}, level-1 partials max "
          f"{partials_max(outs)} of {eng.partials_capacity} | launches "
          f"{launches} | {gpu}", flush=True)
    return by_path


def presets_phase(torch, engmod, config_mod, gpu):
    """The launch file's two deployments as written (``PRESET_HAFEN``,
    ``PRESET_OFFICE``) on their rigs (:data:`PRESETS`), synchronous,
    :data:`PRESET_FRAMES` frames each. Returns launches by path."""
    by_path, parts = {}, []
    for key, (name, rig) in PRESETS.items():
        cfg = getattr(config_mod, name)
        eng = engmod.FusionEngine(cfg, device="cuda")
        outs, _, ms, _, _, launches = run_engine(torch, eng, scene(rig),
                                                 PRESET_FRAMES)
        by_path[key] = (launches, PRESET_FRAMES)
        occupied = [int((o.occupancy_u8 > 0).sum()) for o in outs]
        parts.append(
            f"{key} ({cfg.num_depth_streams} x {rig['width']}x"
            f"{rig['height']} at {rig['fov_deg']:g} deg, "
            f"{eng.grid.num_cells} cells): {ms:.2f} ms/frame | occupied "
            f"cells {min(occupied)}-{max(occupied)} | raw cloud "
            f"{int(outs[-1].raw_count)}, fused {int(outs[-1].fused_count)}, "
            f"level-1 partials max {partials_max(outs)} of "
            f"{eng.partials_capacity} | launches {launches}")
    print(f"[presets] launch-file deployments as written (dpcm link, raw "
          f"cloud + dense occupancy, auto = rle, no lidar), "
          f"{PRESET_FRAMES} frames, pipeline_depth=0, ms/frame of frames "
          f"4.. ending with a synchronize (no speed claimed): "
          f"{' || '.join(parts)} | {gpu}", flush=True)
    return by_path


def sparse_of(o):
    """A frame's sparse occupancy with its dense fallback
    (``bench.py:457-460``)."""
    return (o.occupancy_sparse_idx, o.occupancy_sparse_words,
            o.occupancy_sparse_count, o.occupancy_sparse_true,
            o.occupancy_bits)


def mapping_phase(torch, engmod, cfg, native, gpu):
    """``bench.py:443-537`` on the port: a warm cycle, the device
    segmentation of its frame beside native, then the paced mapping-on
    loop between two mapping-off runs. Prints the ``[mapping]`` line;
    returns the segmented grid (a CPU tensor) for the chain's timing."""
    from collections import deque
    from ros_gpu_depthmap_fusion_tpu_torch.mapping.pipeline import (
        AsyncMappingWorker, MappingPipeline, prefetch)
    from ros_gpu_depthmap_fusion_tpu_torch.mapping.segmentation import (
        segment)
    sc = scene()
    eng = engmod.FusionEngine(cfg, device="cuda", pipeline_depth=1)
    eng.enable_mapping = True
    eng.mapping = MappingPipeline(cfg.replace(mapping_detail_min_area=-1.0),
                                  eng.grid, "cuda")
    f = 0
    for f in range(MAP_WARM_FRAMES):
        out = eng.process(stage(eng, sc, f))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = eng.mapping.process_sparse(sparse_of(out))
    warm_ms = (time.perf_counter() - t0) * 1e3
    warm_phase = eng.mapping.last_phase_ms
    sp_true = int(out.occupancy_sparse_true)
    sp_cap = cfg.occupancy_sparse_capacity
    # the device segmentation on this frame's grid
    zyx = eng.grid.shape_zyx
    occ = np.unpackbits(out.occupancy_bits.cpu().numpy(), bitorder="little",
                        count=eng.grid.num_cells).reshape(zyx)
    lab, objs = cfg.cc_max_labels_per_layer, cfg.max_objects
    occ_t = torch.from_numpy(occ)
    seg_ms = cuda_ms(torch, lambda: segment(occ_t.cuda(), lab, objs),
                     reps=5, warm=1)
    nat_ms = []
    for _ in range(5):
        t0 = time.perf_counter()
        native.segment_grid(occ, lab, objs)
        nat_ms.append((time.perf_counter() - t0) * 1e3)
    kmods = kernel_modules()

    def paced(f0, worker):
        """``bench.py:478-530``: MAP_FRAMES frames paced at 30 Hz, each
        drained MAP_LAG frames after its step; with a worker, 3 of every 5
        frames are mapped, their sparse tuple's copy to the host started
        at enqueue. Returns (the seconds taken, launches of each kernel
        counted from 0)."""
        for m in kmods.values():
            m.launches = 0
        lagq = deque()
        t0 = time.perf_counter()
        for k in range(1, MAP_FRAMES + 1):
            out = eng.process(stage(eng, sc, f0 + k))
            done = torch.cuda.Event()
            done.record()
            lagq.append((done, prefetch(sparse_of(out))
                         if worker is not None and k % 5 < 3 else None))
            if len(lagq) > MAP_LAG:
                done_d, sub = lagq.popleft()
                done_d.synchronize()
                if sub is not None:
                    worker.submit(sub)
            lag = t0 + k * (1.0 / 30.0) - time.perf_counter()
            if lag > 0:
                time.sleep(lag)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0,
                {n: m.launches for n, m in kmods.items()})

    # the same paced loop with mapping off before and after the mapping-on
    # run: what the mapping worker costs the fused frame
    dt_off = [paced(f, None)[0]]
    worker = AsyncMappingWorker(eng.mapping, packed=True)
    dt_map, launches = paced(f + MAP_FRAMES, worker)
    cycles = worker.cycles
    worker.close()          # raises the worker's exception, if any
    latest = worker.latest()
    phase = eng.mapping.last_phase_ms
    dt_off.append(paced(f + 2 * MAP_FRAMES, None)[0])
    eng.flush()
    eng.close()
    # the guard of the rates below: the worker cycled and every frame
    # stepped the engine's kernels
    if cycles < 1 or latest is None:
        raise AssertionError(f"mapping worker: {cycles} cycles")
    for n in ENGINE_KERNELS + ("lidar_stages",):
        if launches[n] < MAP_FRAMES:
            raise AssertionError(f"mapping loop: {n} launched "
                                 f"{launches[n]} times in {MAP_FRAMES} "
                                 "frames")
    print(f"[mapping] bench.py:443-537, {MAP_FRAMES} frames at 30 Hz "
          f"pacing, lag {MAP_LAG}, 3 of 5 mapped: "
          f"{MAP_FRAMES / dt_map:.2f} fused frames/s with segmentation + "
          f"tracking, {cycles / dt_map:.2f} mapping cycles/s ({cycles} "
          f"cycles); mapping off, before and after: "
          f"{MAP_FRAMES / dt_off[0]:.2f} / {MAP_FRAMES / dt_off[1]:.2f} "
          f"fused frames/s | last cycle phase_ms (d2h/segment/assemble+track) "
          f"{tuple(round(p, 2) for p in phase)} | {len(latest.objects)} "
          f"objects, {len(latest.tracks)} tracks | warm cycle "
          f"{warm_ms:.1f} ms, phase_ms "
          f"{tuple(round(p, 2) for p in warm_phase)}, {res.num_merged} "
          f"merged ids, sparse blocks true {sp_true} of {sp_cap} "
          f"({'dense fallback engaged' if sp_true > sp_cap else 'no fallback'})"
          f" | device segment {zyx} on the card {seg_ms:.2f} ms (median of "
          f"5, the grid's copy to the card included) vs native "
          f"{float(np.median(nat_ms)):.2f} ms (host clock) | launches "
          f"{launches} | {gpu}", flush=True)
    return occ_t


def segment_timing(torch, grid, cfg, gpu):
    """The segmentation chain (``mapping/segmentation.py segment``, eight
    kernels of ``csrc/segment.cu``) and its plain twin on ``grid``, on the
    card: device ms and device activities a call, call ms, the chain's
    launches a call by its counter, and the bound (:func:`segment_work`).
    Prints the ``[segment kernels]`` line; returns its numbers."""
    from ros_gpu_depthmap_fusion_tpu_torch.mapping import segmentation
    occ = grid.cuda()
    lab, objs = cfg.cc_max_labels_per_layer, cfg.max_objects

    def chain():
        return segmentation.segment(occ, lab, objs)

    def twin():
        return segmentation.segment_plain(occ, lab, objs)
    before = segmentation.launches
    got = chain()
    torch.cuda.synchronize()
    n_launch = segmentation.launches - before
    if n_launch <= 0:
        raise AssertionError("segment launched no kernel")
    # the guard of the times: every field but the round counts (the
    # chain reports none) equal to the twin's
    ref = twin()
    for k in ref._fields[:-1]:
        x, y = getattr(got, k), getattr(ref, k)
        if x.dtype != y.dtype or not torch.equal(x, y):
            raise AssertionError(f"segment: chain != twin in {k}")
    ms, acts = device_profile(torch, chain)
    call = cuda_ms(torch, chain)
    t_ms, t_acts = device_profile(torch, twin, reps=5, warm=1)
    t_call = cuda_ms(torch, twin, reps=5, warm=1)
    b_ms, by = bound(segment_work(occ, lab, objs), 0)
    print(f"[segment kernels] segment on the mapping grid "
          f"{tuple(occ.shape)}, {lab} labels a layer, {objs} objects: "
          f"device ms {ms:.4f} ({acts:g} device activities, {n_launch} "
          f"launches a call) | call_ms {call:.4f} | bound_ms {b_ms:.4f} "
          f"({by}, {b_ms / ms:.4f} of the bound reached) | twin: device ms "
          f"{t_ms:.4f} ({t_acts:g} device activities), call_ms "
          f"{t_call:.4f} | {gpu}", flush=True)
    return dict(name="segment", route="cuda",
                source="ros_gpu_depthmap_fusion_tpu_torch/csrc/segment.cu",
                replaces=None, ms=ms, device_activities=acts,
                launches=n_launch, call_ms=call, plain_ms=t_ms,
                plain_device_activities=t_acts, plain_call_ms=t_call,
                bound_ms=b_ms, bound_by=by)


def group_work(seg, counts):
    """Bytes the foreground grouping must move: the merged map read once,
    the labels of the foreground cells read once, the counts and the rows
    they size written once."""
    from ros_gpu_depthmap_fusion_tpu_torch.mapping.segmentation import (
        group_rows_used)
    fg, ncomp = counts
    z = seg.merged_map.shape[0]
    return (seg.merged_map.numel() * 4 + fg * 4 + 8
            + 4 * group_rows_used(fg, ncomp, int(seg.num_merged), z))


def group_timing(torch, grid, cfg, gpu):
    """The foreground grouping (``mapping/segmentation.py
    group_foreground``, ``csrc/group.cu``) and its plain twin on the
    chain's segmentation of ``grid``, on the card: device ms and device
    activities a call, call ms, launches a call by its counter, and the
    bound (:func:`group_work`). Prints the ``[group kernels]`` line;
    returns its numbers."""
    from ros_gpu_depthmap_fusion_tpu_torch.mapping import segmentation
    seg = segmentation.segment(grid.cuda(), cfg.cc_max_labels_per_layer,
                               cfg.max_objects)

    def kernels():
        return segmentation.group_foreground(seg)

    def twin():
        return segmentation.group_foreground_plain(seg)
    before = segmentation.group_launches
    got = kernels()
    torch.cuda.synchronize()
    n_launch = segmentation.group_launches - before
    # the guard of the times: counts and rows equal to the twin's
    ref = twin()
    counts = ref.counts.tolist()
    used = segmentation.group_rows_used(*counts, int(seg.num_merged),
                                        grid.shape[0])
    if not (torch.equal(got.counts, ref.counts)
            and torch.equal(got.rows[:used], ref.rows[:used])):
        raise AssertionError("group_foreground: kernels != twin")
    ms, acts = device_profile(torch, kernels)
    call = cuda_ms(torch, kernels)
    t_ms, t_acts = device_profile(torch, twin, reps=5, warm=1)
    t_call = cuda_ms(torch, twin, reps=5, warm=1)
    b_ms, by = bound(group_work(seg, counts), 0)
    print(f"[group kernels] group_foreground on the mapping grid's "
          f"segmentation {tuple(grid.shape)}: {counts[0]} foreground cells,"
          f" {counts[1]} components, {int(seg.num_merged)} merged ids: "
          f"device ms {ms:.4f} ({acts:g} device activities, {n_launch} "
          f"launches a call) | call_ms {call:.4f} | bound_ms {b_ms:.4f} "
          f"({by}, {b_ms / ms:.4f} of the bound reached) | twin: device ms "
          f"{t_ms:.4f} ({t_acts:g} device activities), call_ms "
          f"{t_call:.4f} | {gpu}", flush=True)
    return dict(name="group_foreground", route="cuda",
                source="ros_gpu_depthmap_fusion_tpu_torch/csrc/group.cu",
                replaces=None, foreground=counts[0], components=counts[1],
                ms=ms, device_activities=acts, launches=n_launch,
                call_ms=call, plain_ms=t_ms, plain_device_activities=t_acts,
                plain_call_ms=t_call, bound_ms=b_ms, bound_by=by)


class timed_calls:
    """Context manager: each ``(owner, attribute, key)`` callable is wrapped
    to append its host ms (``time.perf_counter`` around the call) to the
    list ``self.ms[key]`` (targets may share a key)."""

    def __init__(self, targets):
        self.targets, self.ms, self._saved = targets, {}, []

    def __enter__(self):
        for owner, attr, key in self.targets:
            orig = getattr(owner, attr)
            self.ms.setdefault(key, [])

            def timed(*a, _orig=orig, _key=key, **k):
                t = time.perf_counter()
                try:
                    return _orig(*a, **k)
                finally:
                    self.ms[_key].append((time.perf_counter() - t) * 1e3)
            setattr(owner, attr, timed)
            self._saved.append((owner, attr, orig))
        return self

    def __exit__(self, *exc):
        for owner, attr, orig in reversed(self._saved):
            setattr(owner, attr, orig)


def frontend_ms(torch, root, window):
    """Call ms on the card (CUDA events, host included) of the frontend on
    frames 10-11 of the rendered sequence (``detect_and_describe``,
    ``match``, ``ransac_pose`` with 64 hypotheses) and of ``solve_window``
    (4 iterations) on ``window``."""
    from ros_gpu_depthmap_fusion_tpu_torch.pipeline.datasets import (
        TumRgbdDataset)
    from ros_gpu_depthmap_fusion_tpu_torch.slam import ba
    from ros_gpu_depthmap_fusion_tpu_torch.slam import features as feat
    from ros_gpu_depthmap_fusion_tpu_torch.slam import pose_estimation as pe
    ds = TumRgbdDataset(root)
    intr = ds.intrinsics
    kps = []
    for f, fr in enumerate(ds):
        if f in (10, 11):
            img = torch.from_numpy(fr.intensity).cuda()
            depth = torch.from_numpy(fr.depth_u16.astype(np.float32)
                                     * fr.depth_scale).cuda()
            k = feat.detect_and_describe(img, 512, 12.0)
            pts, has_d = pe.unproject_keypoints(k.xy, depth, intr.fx,
                                                intr.fy, intr.cx, intr.cy)
            kps.append((img, k, pts, has_d & k.valid))
        if f >= 11:
            break
    (img, ka, pa, va), (_, kb, pb, vb) = kps
    m = feat.match(ka, kb)
    valid = m.valid & va[m.idx_a.long()] & vb[m.idx_b.long()]
    src, dst = pb[m.idx_b.long()], pa[m.idx_a.long()]
    gen = torch.Generator("cuda").manual_seed(0)
    return dict(
        keypoints=int(ka.valid.sum()), matches=int(valid.sum()),
        detect=cuda_ms(torch, lambda: feat.detect_and_describe(img, 512,
                                                               12.0)),
        match=cuda_ms(torch, lambda: feat.match(ka, kb)),
        ransac=cuda_ms(torch, lambda: pe.ransac_pose(
            src, dst, valid, gen, iterations=64, inlier_threshold=0.08)),
        solve_window=cuda_ms(torch, lambda: ba.solve_window(window, 4),
                             reps=5, warm=1),
        window=tuple(window.poses.shape[:1]) + (
            window.landmarks.shape[0], window.obs_pose.shape[0]))


def tum_phase(torch, engmod, gpu):
    """The SLAM path (``pipeline/tum_runner.py run_tum_sequence``) on the
    card: the hard synthetic sequence (640x480, 150 frames, one closing
    orbit) rendered by the port's writer, then SLAM poses (512 keypoints,
    64 RANSAC hypotheses, BA every 8 keyframes, loop closure with 128)
    into the runner's own configuration (32.8M cells, "dpcm" link,
    "packed"): its ATEs and host ms, and the frontend's call ms. Returns
    launches by path."""
    import tempfile
    from ros_gpu_depthmap_fusion_tpu_torch.pipeline import tum_runner
    from ros_gpu_depthmap_fusion_tpu_torch.slam import frontend, loop_closure
    kmods = kernel_modules()
    with tempfile.TemporaryDirectory(prefix="tum_hard_") as root:
        t0 = time.perf_counter()
        tum_runner.write_hard_synthetic_tum_sequence(root)
        render_s = time.perf_counter() - t0
        windows, graphs = [], []
        solve, optimize = frontend.solve_window, loop_closure.optimize

        def keep_window(problem, **kw):
            if not windows:
                windows.append(problem)
            return solve(problem, **kw)

        def keep_graph(graph, **kw):
            graphs.append((graph, kw))
            return optimize(graph, **kw)
        frontend.solve_window = keep_window
        loop_closure.optimize = keep_graph
        for m in kmods.values():
            m.launches = 0
        Odo, Eng = frontend.RgbdOdometry, engmod.FusionEngine
        try:
            with timed_calls([(Odo, "process", "odometry"),
                              (Eng, "add_depthmap", "engine"),
                              (Eng, "process", "engine"),
                              (Odo, "run_ba", "run_ba"),
                              (tum_runner, "close_loops", "close_loops"),
                              (loop_closure.LoopCloser, "_verify", "verify"),
                              (loop_closure, "optimize", "pose_graph")]
                             ) as tc:
                t0 = time.perf_counter()
                res = tum_runner.run_tum_sequence(
                    root, pose_source="slam", ba_every=8, loop_close=True,
                    device="cuda")
                torch.cuda.synchronize()
                run_s = time.perf_counter() - t0
        finally:
            frontend.solve_window = solve
            loop_closure.optimize = optimize
        launches = {n: m.launches for n, m in kmods.items()}
        fe = frontend_ms(torch, root, windows[0])
    # the last pose-graph solve once more (none without loop edges): the
    # first use of torch.func's forward-mode rules in a process costs extra
    pg_again = "none"
    if graphs:
        t0 = time.perf_counter()
        optimize(graphs[-1][0], **graphs[-1][1])
        torch.cuda.synchronize()
        pg_again = f"{(time.perf_counter() - t0) * 1e3:.2f} ms"
    ms = tc.ms
    lc = res.ate_rmse_loop_closed_m
    per = {n: c / res.frames for n, c in launches.items()}
    print(f"[tum] hard synthetic 640x480 x {TUM_FRAMES} (rendered by the "
          f"port's writer in {render_s:.1f} s, host numpy), SLAM poses: "
          f"frames {res.frames}, keyframes {res.keyframes}, loop edges "
          f"{res.loop_edges} | ATE {res.ate_rmse_m * 100:.2f} cm full-frame, "
          f"{'none' if lc is None else f'{lc * 100:.2f} cm'} loop-closed "
          f"keyframes | occupied cells {res.occupied_cells} of 32,768,000, "
          f"fused points (last frame) {res.fused_points_last} | host "
          f"ms/frame: odometry {float(np.mean(ms['odometry'])):.2f} (median "
          f"{float(np.median(ms['odometry'])):.2f}), engine add+process "
          f"{float(np.sum(ms['engine'])) / res.frames:.2f}, whole runner "
          f"{run_s * 1e3 / res.frames:.2f} (PNG decode, BA and loop closure "
          f"included) | run_ba {len(ms['run_ba'])} calls, "
          f"{float(np.mean(ms['run_ba'])):.2f} ms each | close_loops "
          f"{len(ms['close_loops'])} call(s), "
          f"{float(np.mean(ms['close_loops'])):.2f} ms ({len(ms['verify'])} "
          f"verifications {float(np.sum(ms['verify'])):.2f} ms, "
          f"{len(ms['pose_graph'])} pose-graph solve(s) "
          f"{float(np.sum(ms['pose_graph'])):.2f} ms, the last again "
          f"{pg_again}) | launches per frame {per} | call ms on the card "
          f"(CUDA events, host included), frames 10-11 ({fe['keypoints']} "
          f"keypoints, {fe['matches']} matches): detect_and_describe "
          f"{fe['detect']:.3f}, match {fe['match']:.3f}, ransac_pose (64 "
          f"hypotheses) {fe['ransac']:.3f}, solve_window (4 iterations, "
          f"the first BA window {fe['window']}: poses, landmarks, "
          f"observations) {fe['solve_window']:.3f} | {gpu}", flush=True)
    return {"tum": (launches, res.frames)}


def sharded_rank(rank, shape, frames, gpu):
    """One rank of the ``[sharded]`` phase: the publish configuration at
    "packed" through ``ShardedFusionEngine`` on a ``shape`` mesh on
    ``cuda:0``, synchronous (and on a 1 x 1 mesh also pipelined), for
    ``frames`` frames; frame ``RECORD_FRAME``'s kernel calls recorded on
    the synchronous run, and rank 0 then times each of them
    (:func:`time_site`). Returns launches and ms/frame by path, and the
    call sites' numbers."""
    import torch
    from ros_gpu_depthmap_fusion_tpu_torch.ops import mask_ops, voxelize
    from ros_gpu_depthmap_fusion_tpu_torch.parallel import make_mesh, sharded
    from ros_gpu_depthmap_fusion_tpu_torch.parallel.engine import (
        ShardedFusionEngine)
    mesh = make_mesh(*shape, device=torch.device("cuda", 0))
    record_mods = [("segreduce", voxelize, "segreduce"),
                   ("flying_pixels", sharded, "filter_flying_pixels"),
                   ("compact", mask_ops, "compact_rows")]
    cfg = config(voxel_mean_mode="packed")
    sc = scene()
    res = dict(launches={}, ms={}, sites={})
    sx = f"sharded_{shape[0]}x{shape[1]}"
    for depth in ((0, 1) if shape == (1, 1) else (0,)):
        path = sx + ("_pipelined" if depth else "")
        eng = ShardedFusionEngine(cfg, mesh, pipeline_depth=depth)
        _, _, res["ms"][path], _, calls, launches = run_engine(
            torch, eng, sc, frames,
            record=None if depth else (RECORD_FRAME, record_mods))
        res["launches"][path] = (launches, frames)
        if depth == 0:
            site_calls = calls
    if rank == 0:
        launches = res["launches"][sx][0]
        for name, wrapper in kernel_wrappers().items():
            res["sites"][name] = time_site(
                torch, name, site_calls[name], wrapper,
                f"{sx} rank 0, frame {RECORD_FRAME}",
                launches[name] / frames, gpu)
    return res


def sharded_phase(gpu):
    """The distributed engine on the card at full width: one rank over
    NCCL (mesh 1 x 1) and four ranks sharing the card over gloo (mesh
    stream 2 x space 2, 4 cameras a rank); rank 0 of each world times its
    kernel call sites. Returns launches by path and the call sites'
    numbers by path."""
    from ros_gpu_depthmap_fusion_tpu_torch.parallel import spawn
    # one host: NCCL's bootstrap and gloo's pairs on the loopback
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    t0 = time.perf_counter()
    one = spawn(sharded_rank, 1, "nccl", timeout=120, join_timeout=400,
                args=((1, 1), SHARDED_FRAMES, gpu))[0]
    t1 = time.perf_counter()
    four = spawn(sharded_rank, 4, "gloo", timeout=120, join_timeout=400,
                 args=((2, 2), SHARDED_FRAMES, gpu))
    t2 = time.perf_counter()
    launches = dict(one["launches"], **four[0]["launches"])
    ms = dict(one["ms"], sharded_2x2=[round(r["ms"]["sharded_2x2"], 2)
                                      for r in four])
    print(f"[sharded] publish config at packed (dpcm link, 8 x 848x480, "
          f"3,360,000 cells), {SHARDED_FRAMES} frames: mesh 1x1 on NCCL "
          f"and mesh stream 2 x space 2 on gloo, 4 ranks sharing cuda:0 "
          f"(4 cameras a rank) | ms/frame (frames 4.., ends with a "
          f"synchronize): 1x1 {ms['sharded_1x1']:.2f}, 1x1 pipelined "
          f"{ms['sharded_1x1_pipelined']:.2f}, 2x2 by rank "
          f"{ms['sharded_2x2']} | launches "
          f"{ {p: v[0] for p, v in launches.items()} } | phase "
          f"{t2 - t0:.1f} s (1x1 world {t1 - t0:.1f} s, 2x2 {t2 - t1:.1f} "
          f"s, rank start-up and rank 0's kernel timing included) | {gpu}",
          flush=True)
    return launches, {"sharded_1x1": one["sites"],
                      "sharded_2x2": four[0]["sites"]}


def time_site(torch, name, site_calls, wrapper, what, per_frame, gpu):
    """Time engine kernel ``name`` on each recorded call of a frame, each
    call first held to its twin (exact: the guard of the times): per
    frame, the device ms, call ms, bound, and the twin's; for compact also
    ``rows[flags]``. Prints one ``[kernel]`` line and returns the
    numbers."""
    kern, twin = wrapper
    shapes, per_call = [], []
    tot = dict(ms=0.0, call_ms=0.0, plain_ms=0.0, plain_call_ms=0.0,
               bound_ms=0.0)
    for a, k, _ in site_calls:
        got = kern(*a, **k)
        ref = twin(*a, **k)
        torch.cuda.synchronize()
        err = max_abs_err(torch, got, ref)
        if err != 0.0:
            raise AssertionError(f"{name} ({what}): kernel != twin, max abs "
                                 f"err {err} (exact required)")
        bound_ms = roofline.call_bound_s(name, a, ref) * 1e3
        bound_by = bound(*roofline.WORK[name](a, ref))[1]
        one = dict(ms=device_ms(torch, lambda: kern(*a, **k)),
                   call_ms=cuda_ms(torch, lambda: kern(*a, **k)),
                   plain_ms=device_ms(torch, lambda: twin(*a, **k)),
                   plain_call_ms=cuda_ms(torch, lambda: twin(*a, **k)),
                   bound_ms=bound_ms)
        for key in tot:
            tot[key] += one[key]
        per_call.append(f"{one['ms']:.4f}/{bound_ms:.4f}")
        shapes.append("x".join(map(str, a[0].shape)))
    library = None
    if name == "compact":
        # one PyTorch call computes the same rows: boolean indexing (its
        # nonzero syncs the host; device time counts no gaps), per frame
        # over the same calls
        library = sum(device_ms(torch, lambda: a[0][a[1]])
                      for a, _, _ in site_calls)
    print(f"[kernel] {name} on {'+'.join(shapes)} ({what}), per frame "
          f"({len(site_calls)} call(s), launches_per_frame {per_frame:g}): "
          f"max_abs_err 0.0 | device ms {tot['ms']:.4f} (per call "
          f"device/bound {', '.join(per_call)}) | call_ms "
          f"{tot['call_ms']:.4f} | bound_ms {tot['bound_ms']:.4f} "
          f"({bound_by}, {tot['bound_ms'] / tot['ms']:.2f} of the bound "
          f"reached) | plain device {tot['plain_ms']:.4f} ms, call "
          f"{tot['plain_call_ms']:.4f} ms | library_ms "
          f"{'none' if library is None else f'{library:.4f}'} | {gpu}",
          flush=True)
    return dict(max_abs_err=0.0, bound_by=bound_by, library_ms=library,
                launches_per_frame=per_frame, **tot)


def lidar_timing(torch, rbmod, cfg, lidar_rec, by_path, gpu):
    """The lidar pair on the recorded link frame's buffer and inputs,
    beside its twin (the five calls it replaces). Prints the ``[lidar
    kernels]`` line; returns its numbers."""
    rb, kw = lidar_rec
    size, cap = cfg.point_sequence_filter_size, cfg.rollbuffer_point_capacity

    def lidar(plain=False):
        return rbmod.advance_and_gather(rb, filter_size=size, capacity=cap,
                                        plain=plain, **kw)
    # the guard of the times: buffer, gathered rows and selection equal to
    # the twin's, bit for bit
    for part, a, b in zip(("buffer", "gathered", "selection"), lidar(),
                          lidar(True)):
        for x, y in zip(a, b):
            if x.dtype != y.dtype or not torch.equal(x, y):
                raise AssertionError(f"lidar pair != twin in {part}")
    ms, acts = device_profile(torch, lidar)
    call = cuda_ms(torch, lidar)
    t_ms, t_acts = device_profile(torch, lambda: lidar(True))
    t_call = cuda_ms(torch, lambda: lidar(True))
    b_ms, by = bound(lidar_work(rb, kw, cap), 0)
    paths = {p: c["lidar_stages"] / n for p, (c, n) in by_path.items()}
    print(f"[lidar kernels] advance_and_gather on link frame "
          f"{RECORD_FRAME}'s buffer and inputs ({rb.point_capacity} rows, "
          f"{rb.seq_capacity} sequence slots, "
          f"{kw['seq_batch'].points.shape[0]} staged points): device ms "
          f"{ms:.4f} ({acts:g} device activities a call) | call_ms "
          f"{call:.4f} | bound_ms {b_ms:.4f} ({by}, {b_ms / ms:.3f} of "
          f"the bound reached) | twin: device ms {t_ms:.4f} ({t_acts:g} "
          f"device activities), call_ms {t_call:.4f} | launches a frame by "
          f"path {paths} | {gpu}", flush=True)
    return dict(name="lidar_stages", route="cuda",
                source="ros_gpu_depthmap_fusion_tpu_torch/csrc/"
                       "lidar_stages.cu",
                replaces=None, ms=ms, device_activities=acts, call_ms=call,
                plain_ms=t_ms, plain_device_activities=t_acts,
                plain_call_ms=t_call, bound_ms=b_ms, bound_by=by,
                launches_per_frame_by_path=paths)


def fused_timing(torch, calls, cfg, grid, link_launches, gpu):
    """Kernel 4 on the recorded link frame's masked metric depth, held to
    its twin (exact), timed beside the twin and the engine's chain
    (unproject, crop, cell index, quantize, level-1 segreduce), with the
    level-2 closure of both compared. Prints the ``[fused]`` line; returns
    its numbers and its launches a call."""
    from ros_gpu_depthmap_fusion_tpu_torch.ops import (
        mask_ops, unproject, voxelize)
    from ros_gpu_depthmap_fusion_tpu_torch.ops.kernels import (
        fused_unproject_rle, segreduce)
    depth_masked, (k_intr, k_tfw, k_tfc, scale), fargs = fused_inputs(
        torch, calls, cfg, grid)
    depth_m, cap = fargs[0], fargs[7]

    def fused():
        return fused_unproject_rle.unproject_voxelize_l1(*fargs)

    def fused_plain():
        return fused_unproject_rle.unproject_voxelize_l1_plain(*fargs)
    # kernel 4's own path: this call, counted from 0
    fused_unproject_rle.launches = 0
    got = fused()
    torch.cuda.synchronize()
    launches = fused_unproject_rle.launches
    err = max_abs_err(torch, got, fused_plain())
    if err != 0.0:
        raise AssertionError(f"fused_unproject_rle: kernel != twin, max abs "
                             f"err {err} (exact required)")

    def chain():
        _, pw, pc, m = unproject.unproject_depthmaps(
            depth_masked, k_intr, k_tfw, k_tfc, scale)
        n = pw.shape[0] * pw.shape[1]
        pts = pw.reshape(n, 4)
        m = mask_ops.crop_points(pc.reshape(n, 4), m.reshape(n),
                                 cfg.crop_min, cfg.crop_max)
        key, vals = voxelize._partial_rows(
            pts, grid.cell_index_clamped(pts[:, :3]), m, grid.num_cells,
            grid)
        return segreduce.segreduce(key, vals, cap, grid.num_cells,
                                   force_break=voxelize.LEVEL1_FORCE_BREAK), m
    (ck, cs, cc, ct), cm = chain()

    def level2(keys, sums, count):
        tot = torch.zeros((grid.num_cells + 1, 4), dtype=torch.float64,
                          device=keys.device)
        live = torch.arange(keys.shape[0], device=keys.device) < count
        tot.index_add_(0, torch.where(live, keys, grid.num_cells).long(),
                       sums.double())
        return tot[:grid.num_cells]
    lf, lc = level2(got[0], got[1], got[2]), level2(ck, cs, cc)
    cells_differ = int(((lf[:, 3] > 0) != (lc[:, 3] > 0)).sum())
    agree = lf[:, 3] == lc[:, 3]
    counts_differ = int((~agree).sum())
    moved = int((lf[:, 3] - lc[:, 3]).abs().sum()) // 2
    sum_err = float((lf[agree, :3] - lc[agree, :3]).abs().max())
    valid_diff = int(got[4]) - int(cm.sum())
    f_ms, f_call_ms = device_ms(torch, fused), cuda_ms(torch, fused)
    f_plain_ms = device_ms(torch, fused_plain)
    chain_ms, chain_call_ms = device_ms(torch, chain), cuda_ms(torch, chain)
    f_bound, f_bound_by = bound(*fused_work(fargs, int(got[4])))
    shape = "x".join(map(str, depth_m.shape))
    print(f"[fused] unproject_voxelize_l1 on {shape} (link frame "
          f"{RECORD_FRAME}, masked metric depth), capacity {cap}: "
          f"max_abs_err {err} in all five outputs | runs {int(got[3])} "
          f"(chain's level 1: {int(ct)}), valid points {int(got[4])} | "
          f"launches_per_frame {link_launches:g} on the link | device ms "
          f"{f_ms:.4f} | call_ms {f_call_ms:.4f} | bound_ms {f_bound:.4f} "
          f"({f_bound_by}, {f_bound / f_ms:.2f} of the bound reached) | "
          f"plain device {f_plain_ms:.4f} ms | library_ms none | the "
          f"engine's chain: device {chain_ms:.4f} ms, call "
          f"{chain_call_ms:.4f} ms | level-2 closure vs the chain: "
          f"{cells_differ} cells differ in occupancy, {counts_differ} in "
          f"count ({moved} points changed cell), max sum diff "
          f"{sum_err:.1f} quantization steps where counts agree, "
          f"valid-count diff {valid_diff} | launches {launches} | {gpu}",
          flush=True)
    return dict(max_abs_err=err, ms=f_ms, call_ms=f_call_ms,
                plain_ms=f_plain_ms, bound_ms=f_bound, bound_by=f_bound_by,
                library_ms=None), launches


def main():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py: no CUDA device; this script "
                         "measures the port on a GPU and has no CPU mode")
    from ros_gpu_depthmap_fusion_tpu_torch.core import config as config_mod
    from ros_gpu_depthmap_fusion_tpu_torch.ops import mask_ops, voxelize
    from ros_gpu_depthmap_fusion_tpu_torch.ops.kernels import _build
    from ros_gpu_depthmap_fusion_tpu_torch.pipeline import engine as engmod
    from ros_gpu_depthmap_fusion_tpu_torch.state import rollbuffer as rbmod
    from ros_gpu_depthmap_fusion_tpu_torch.utils import native

    gpu = gpu_line()
    nvcc = _build.find_nvcc()
    nvcc_ver = subprocess.run([nvcc, "--version"], capture_output=True,
                              text=True, check=True).stdout.strip() \
        .splitlines()[-1]
    print(f"[env] gpu: {gpu} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | nvcc {nvcc_ver} | "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}",
          flush=True)
    t0 = time.perf_counter()
    info = _build.build_info()
    with open(info["log"]) as f:
        regs = [ln.strip() for ln in f if "registers" in ln]
    t_kern = time.perf_counter() - t0
    t0 = time.perf_counter()
    native.require()     # builds native/libfusionhost.so when missing
    print(f"[build] kernels {t_kern:.2f}s (compiled={info['built']}) "
          f"{info['path']} | native host library "
          f"{time.perf_counter() - t0:.2f}s | ptxas: " + " ; ".join(regs),
          flush=True)

    record_mods = [("segreduce", voxelize, "segreduce"),
                   ("flying_pixels", engmod, "filter_flying_pixels"),
                   ("compact", mask_ops, "compact_rows"),
                   ("unproject", engmod, "unproject_depthmaps")]
    cfg, grid, calls, lidar_rec, by_path = link_phase(
        torch, engmod, native, record_mods, gpu)
    link_launches = by_path["link"][0]
    # the guard of the kernel lines: the link run launched every engine
    # kernel it reports, and kernel 4 not at all
    for n, c in link_launches.items():
        if (c <= 0) != (n == "fused_unproject_rle"):
            raise AssertionError(f"link: {n} launched {c} times")
    by_path.update(raw_phase(torch, engmod, gpu))
    pub_calls, packed_calls, pub_paths, pub_taps = publish_phase(
        torch, engmod, record_mods, gpu)
    by_path.update(pub_paths)
    by_path.update(hetero_phase(torch, engmod, gpu))
    by_path.update(presets_phase(torch, engmod, config_mod, gpu))
    seg_grid = mapping_phase(torch, engmod, cfg, native, gpu)
    by_path.update(tum_phase(torch, engmod, gpu))
    torch.cuda.empty_cache()
    sharded_launches, sharded_sites = sharded_phase(gpu)
    by_path.update(sharded_launches)

    # each engine kernel at each call site: the recorded link frame, the
    # publish frame (the raw cloud's compaction, level 1 + level 2 over
    # it) and the packed frame (one reduction of the sorted stream)
    wrappers = kernel_wrappers()
    results, sites = {}, {}
    for name, site, site_calls, path in (
            [(n, f"link frame {RECORD_FRAME}", calls, "link")
             for n in ENGINE_KERNELS]
            + [("compact", "publish raw cloud", pub_calls, "publish"),
               ("segreduce", "publish level 1 + 2 on the raw cloud",
                pub_calls, "publish"),
               ("segreduce", "publish packed, the sorted stream",
                packed_calls, "publish_packed")]):
        launches, steps = by_path[path]
        r = time_site(torch, name, site_calls[name], wrappers[name],
                      f"{site}, frame {RECORD_FRAME}" if path != "link"
                      else site, launches[name] / steps, gpu)
        sites.setdefault(name, {})[path] = r
        results.setdefault(name, r)
    for path, per_kernel in sharded_sites.items():
        for name, r in per_kernel.items():
            sites[name][path] = r
    lidar_res = lidar_timing(torch, rbmod, cfg, lidar_rec, by_path, gpu)
    seg_res = segment_timing(torch, seg_grid, cfg, gpu)
    group_res = group_timing(torch, seg_grid, cfg, gpu)
    del lidar_rec, seg_grid
    # the publish step of each mode, whole, from its tapped state: device
    # ms and device activities a step, and CUDA events around one step
    # (host enqueue included: what the host-bound frame pays)
    for mode, (e, (state, inp, bits)) in pub_taps.items():
        def step():
            return engmod.fusion_step(state, inp, bits, cfg=e.cfg,
                                      grid=e.grid,
                                      output_capacity=e.output_capacity)
        dev_ms, acts = device_profile(torch, step, reps=10, warm=2)
        print(f"[publish step] {mode}: device ms {dev_ms:.3f} a step, "
              f"{acts:g} device activities a step, call_ms "
              f"{cuda_ms(torch, step, reps=10, warm=2):.3f} (CUDA events "
              f"around one step, host enqueue included) | {gpu}",
              flush=True)
    del pub_taps
    results["fused_unproject_rle"], fused_launches = fused_timing(
        torch, calls, cfg, grid,
        link_launches["fused_unproject_rle"] / LINK_FRAMES, gpu)

    # the link run's numbers at the top level (launches: its counts), and
    # per path the launches a frame and, where timed, the call site's
    kernels = [dict(name=name, route="cuda", source=SOURCES[name],
                    replaces=REPLACES[name],
                    launches=(fused_launches if name == "fused_unproject_rle"
                              else link_launches[name]),
                    launches_per_frame=link_launches[name] / LINK_FRAMES,
                    **{k: results[name][k] for k in (
                        "max_abs_err", "ms", "call_ms", "plain_ms",
                        "bound_ms", "bound_by", "library_ms")},
                    launches_per_frame_by_path={
                        path: c[name] / n for path, (c, n) in by_path.items()},
                    sites={path: {k: v for k, v in r.items()
                                  if k != "plain_call_ms"}
                           for path, r in sites.get(name, {}).items()})
               for name in KERNELS]
    print(json.dumps({"kernels": kernels, "lidar_stages": lidar_res,
                      "segment": seg_res, "group": group_res}))
    print(gpu)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    if sys.argv[1:]:
        raise SystemExit(f"chip_smoke.py takes no arguments, not "
                         f"{sys.argv[1:]}")
    main()
