#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py                  # one card: every phase below
    python3 chip_smoke.py --sharded-nccl   # four cards: the distributed
                                           # engine over NCCL only

Drives the port (``ros_gpu_depthmap_fusion_tpu_torch``) at the operating
point of ``bench.py``: 8 depth cameras at 848x480 plus 2 lidar streams of
8192 points into a 400x400x21 = 3,360,000-cell grid. Phases, one line
each:

1. environment: the card's name and power limit (``nvidia-smi``), torch,
   CUDA and nvcc versions;
2. build: compile the CUDA kernels from ``csrc/`` with nvcc, and the
   native host library (the depth-link encoders) with make;
3. link (the main path): ``bench.py:120-182``'s configuration as it is
   (p4 temporal depth link with hysteresis, delta-coded lidar, 448k
   level-1 partials) with ``FusionEngine(cfg, "cuda", pipeline_depth=1)``,
   24 frames then ``flush()``; every kernel's launch counter, counted from
   0 before the run, must rise by its expected count each step (kernel
   4's by none: its launches per frame are measured here); frame 0 must
   be an I-keyframe and the rest p4 P-frames; the partials must stay
   within capacity; the last frame re-run with the plain twins from the same state, and a
   ``pipeline_depth=0`` engine on the same frames, must give equal
   outputs; so must a small rig of this configuration on the card and on
   the CPU;
4. raw link: the engine on the raw depth link (``depth_link_codec="none"``,
   768k partials: the raw series has more level-1 runs), 8 frames, with
   the same launch, plain-twin and small-rig checks;
5. publish: ``FusionConfig()``'s defaults at the bench rig's size (its
   rig, lidar, crop, voxel and rollbuffer fields; the ``"dpcm"`` link,
   the raw cloud and the dense occupancy emitted, ``voxel_mean_mode=
   "auto"``, default partials capacity, 262,144 output cells, no sparse
   blocks): the non-split step, ``FusionEngine(cfg, "cuda",
   pipeline_depth=1)``, 8 frames then ``flush()``. Launches a step as
   expected for this path (``EXPECTED``), partials within capacity, the
   last frame's plain-twin replay equal, a ``pipeline_depth=0`` engine
   equal, the same frames at ``"packed"`` equal in every output but the
   partials count (rle == packed at full size; the largest cell's count
   printed), one frame each at ``"exact"`` and with occupied cells equal
   to its plain replay; ms/frame of each mode, and of "auto" and
   "packed" in turns on fresh engines, no speed claimed. Then a
   heterogeneous rig (4 cameras at 848x480 and 4 at 640x360, ``"dpcm"``
   per group), 6 frames, with the same launch, plain-twin and
   pipelined == synchronous checks; then the launch file's two
   deployments as written (``PRESET_HAFEN``: the first 6 of the rig's
   cameras into the same 3,360,000-cell grid; ``PRESET_OFFICE``: 2
   cameras facing each other from the edge of an 80x80x25 = 160,000-cell
   grid, with a 87 degree field of view), no lidar, 10 synchronous frames
   each: every frame equal to its plain-twin replay, launches a step as
   ``EXPECTED``, at least 1,000 occupied cells a frame, ms/frame; then
   small rigs card == CPU in each mode (auto = rle, packed, exact,
   occupied, no voxel filter, radius filter, heterogeneous);
6. mapping (``bench.py:443-537``, field for field): a fresh link engine
   with ``eng.mapping = MappingPipeline(cfg.replace(
   mapping_detail_min_area=-1.0), eng.grid, "cuda")``, 12 frames to fill
   the decaying history; a warm ``process_sparse`` cycle on the last
   frame, equal in every field to ``process_packed`` of a fresh pipeline;
   the device segmentation on that frame's 21x400x400 grid on the card,
   exact against the native host segmentation (centroid within 1e-4) and
   against the CPU run (every field), timed beside native; then
   ``AsyncMappingWorker(packed=True)`` over 60 frames paced at 30 Hz, a
   4-frame lag drain, 3 of every 5 frames mapped, the sparse tuple
   prefetched at enqueue: the worker must cycle, raise nothing and leave
   a result, and every step must launch the engine kernels. The same
   paced loop with mapping off runs before and after it, for the fused
   frame rate without the worker.
7. tum (the SLAM path): the hard synthetic TUM sequence (640x480, 150
   frames, one closing orbit) rendered by the port's writer (timed
   apart), then ``run_tum_sequence(..., pose_source="slam", ba_every=8,
   loop_close=True, device="cuda")`` at the runner's own configuration
   (one camera into a 320^3 = 32,768,000-cell grid, the ``"dpcm"`` link,
   "auto" = "packed"; 512 keypoints, 64 RANSAC hypotheses, BA window 8
   with 4 iterations every 8 keyframes, loop closure with 128): 150
   frames, ATE below 10 cm, a loop-closed ATE, occupied cells, launches a
   frame 1 / 1 / 1 / 0; host ms a frame of the odometry, the engine and
   the whole runner, ms a ``run_ba`` and ``close_loops`` call. Then a
   frame pair through ``detect_and_describe``, ``match`` and
   ``ransac_pose`` (the same 64 sampled triples) and one captured BA
   window, on the card and on the CPU port: keypoints, descriptors and
   matches equal, inlier counts equal and the transform within 1e-5, BA
   poses within 1e-4 m and 1e-4 rad, with each call's ms on the card;
   then 20 groundtruth-posed frames, every step equal to its plain-twin
   replay; then the distributed engine (``parallel/``): the publish
   configuration at "packed" through ``ShardedFusionEngine`` in spawned
   ranks (the kernels and the native library built here first), 8 frames
   on one rank over NCCL (mesh 1 x 1, synchronous and pipelined, every
   frame equal to the single engine's in the same process: occupancy, raw
   rows, fused rows, bits == occupancy > 0; its ``segment_and_track``
   equal too) and on four ranks sharing ``cuda:0`` over gloo (mesh stream
   2 x space 2, every frame's digests equal to the 1 x 1 run's on every
   rank); launches a frame as ``EXPECTED`` on each run, ms/frame of each
   beside the single engine's; the sharded BA over the stream axis on the
   BA window captured from the SLAM run, against ``solve_window`` on the
   card (poses within 1e-4, ties as ``ba_agree`` states); and rank 0 of
   each world holds each kernel call of one recorded synchronous frame to
   its twin and times it, as phase 8 does (after that world's loops);
8. kernels (after the loops, so that ``torch.profiler``, which times
   them, cannot touch the host-bound loops): each kernel's inputs are
   recorded from one frame of the link phase, and compact's and
   segreduce's also from a publish frame (the raw cloud's compaction,
   level 1 + 2 over the compacted cloud) and a packed frame (one
   reduction of the sorted stream); the kernel is checked against its
   plain PyTorch twin on them (exact), flying_pixels also with 2 and 3
   rings on two of that frame's cameras. Per frame
   (segreduce: both levels) it prints the kernel's device ms (the
   summed device activity of a call, kernels and fills,
   from ``torch.profiler`` over 20 calls after 3 warm-ups: no host gaps),
   its ``call_ms`` (CUDA events around one call, host work before the
   launches included, median of 20), its ``bound_ms`` (the bytes the
   call must move over 3.35 TB/s, or its float32 operations over 67
   TFLOP/s, whichever is larger), its launches per frame, the twin's
   device and call ms, and for compact ``library_ms``, the device ms of
   ``rows[flags]``, the one PyTorch call that computes the same rows, on
   each of the frame's calls;
   then each publish mode's whole step, replayed from its tapped state:
   device ms and device activities a step, and its call ms;
9. fused front: kernel 4 (``unproject_voxelize_l1``, not on the engine's
   path) on the recorded frame's masked metric depth, against its twin
   (exact in all five outputs, with ``force_break`` 128 and, runs
   crossing its tiles, 0), timed as in phase 8 beside its twin and
   the engine's chain (unproject, crop, cell index, quantize, level-1
   segreduce), and the level-2 closure against that chain.

Then one JSON line with the kernels' names, sources, launch counts (and
launches per frame, also by path), errors, device, call, twin, bound and
library times (also by timed call site), the ``nvidia-smi`` line, and,
last, ``{"ok": true, "device": ...}``. Any failure is an uncaught exception and a non-zero exit; without a
CUDA device it exits non-zero before printing any result.

``--sharded-nccl`` (at least four cards) runs only the build and the
distributed engine over NCCL with one rank a card: the 1 x 1 run as above
(on ``cuda:0``, held to the single engine), then meshes 2 x 2 and 4 x 1 on
four ranks, every frame's digests and ``segment_and_track`` equal to the
1 x 1 run's on every rank, launches a frame as ``EXPECTED``; in each world
the sharded BA over the stream axis on the SLAM run's first BA window
(the hard sequence's first 24 frames on ``cuda:0``), held to
``solve_window`` on each rank's card as in the ``[sharded]`` phase.
"""

import hashlib
import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

H, W, C = 480, 848, 8
N_LIDAR_STREAMS, LIDAR_PTS = 2, 8192
N_STAGED = 8
LINK_FRAMES = 24
RAW_FRAMES = 8
MAP_WARM_FRAMES = 12   # the decaying history (lifetime 10) at steady state
MAP_FRAMES = 60        # the paced mapping-on loop
MAP_LAG = 4            # frames between a step and its drain (bench.py:500)
RECORD_FRAME = 6       # the recorded step's frame (lidar window full)
PUBLISH_FRAMES = 8
HETERO_FRAMES = 6
PRESET_FRAMES = 10
TUM_FRAMES = 150       # the hard synthetic sequence, 640x480, one orbit
TUM_GT_FRAMES = 20     # groundtruth-posed frames held to the plain replay
SHARDED_FRAMES = PUBLISH_FRAMES
BA_ITERS = 8           # the sharded BA's iterations (solve_window's default)
BA_WINDOW_FRAMES = 24  # the hard sequence's frames through its first BA
# the heterogeneous rig: 4 cameras at 848x480 and 4 at 640x360
HETERO_SHAPES = ((H, W),) * 4 + ((360, 640),) * 4
# the launch-file presets' rigs (core/config.py): Hafen takes the first 6
# of the bench rig's 8 cameras; Office's 8 x 8 m crop holds none of the
# bench rig's surfaces (8 m out, 2.2-2.9 m deep), so its 2 cameras face
# each other from its edge (a 4 m ring) with a RealSense D435's 87 degree
# depth field of view
PRESETS = {"hafen": ("PRESET_HAFEN", {}, 60.0),
           "office": ("PRESET_OFFICE", dict(spacing=2, radius=4.0), 87.0)}
ENGINE_KERNELS = ("segreduce", "flying_pixels", "compact")
KERNELS = ENGINE_KERNELS + ("fused_unproject_rle",)


def _launches(segreduce, flying_pixels, compact):
    return {"segreduce": segreduce, "flying_pixels": flying_pixels,
            "compact": compact, "fused_unproject_rle": 0}


# launches of each kernel in one engine step, by path (kernel 4 is on
# none). Split-domain step: level 1 + level 2, one filter, the sparse
# blocks. Non-split step: the raw cloud's compaction, then rle (level 1 +
# level 2), packed (one reduction of the sorted stream), exact (the run
# ends compacted) or occupied (the occupied ids compacted); a
# heterogeneous rig filters each of its two resolution groups.
EXPECTED = {
    "link": _launches(2, 1, 1), "raw": _launches(2, 1, 1),
    "mapping": _launches(2, 1, 1),
    "publish": _launches(2, 1, 1), "publish_sync": _launches(2, 1, 1),
    "publish_packed": _launches(1, 1, 1),
    "publish_exact": _launches(0, 1, 2),
    "publish_occupied": _launches(0, 1, 2),
    "hetero": _launches(2, 2, 1), "hetero_sync": _launches(2, 2, 1),
    # the launch-file presets: the non-split step at "auto" = rle, no lidar
    "hafen": _launches(2, 1, 1), "office": _launches(2, 1, 1),
    # the TUM runner's engine: one 640x480 camera, raw cloud, a 320^3 grid
    # (at least 2^24 cells: "auto" runs "packed")
    "tum": _launches(1, 1, 1), "tum_gt": _launches(1, 1, 1),
    # a rank of the sharded engine (publish at "packed"): its cameras'
    # filter, one reduction of its sorted stream, and four compactions (its
    # sequence records, its staged points, its raw cloud, its fused
    # sub-slab)
    "sharded_1x1": _launches(1, 1, 4),
    "sharded_1x1_pipelined": _launches(1, 1, 4),
    "sharded_2x2": _launches(1, 1, 4), "sharded_4x1": _launches(1, 1, 4),
}
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


def link_config(FusionConfig, h=H, w=W, c=C, lidar_pts=LIDAR_PTS, **kw):
    """``bench.py:120-182``'s configuration, field for field (the small
    rig passes its own sizes)."""
    base = dict(
        num_depth_streams=c, depth_height=h, depth_width=w,
        num_point_sequences=N_LIDAR_STREAMS,
        crop_min=(-20, -20, 0), crop_max=(20, 20, 2.5),
        voxel_min=(-20, -20, 0), voxel_max=(20, 20, 2.5),
        voxel_size=(0.1, 0.1, 0.12),
        voxel_occupancy_lifetime=10,
        rollbuffer_point_capacity=98304,
        max_points_per_sequence=N_LIDAR_STREAMS * lidar_pts,
        depth_link_codec="dpcm_temporal",
        depth_codec_p4_budget=48,
        depth_codec_hysteresis=2,
        depth_codec_keyframe_interval=120,
        depth_codec_quant_shift=4,
        depth_codec_max_exceptions=8192,
        lidar_link_quant_step=0.002,
        lidar_link_delta=True,
        voxelize_partials_capacity=448 * 1024,
        voxelize_output_capacity=16384,
        emit_raw_points=False,
        emit_occupancy_u8=False,
        occupancy_sparse_capacity=4096,
    )
    base.update(kw)
    return FusionConfig(**base)


def publish_config(FusionConfig, h=H, w=W, c=C, lidar_pts=LIDAR_PTS, **kw):
    """``bench.py``'s rig, lidar, crop, voxel and rollbuffer fields with
    every other field at ``FusionConfig()``'s default: the ``"dpcm"``
    link, the raw cloud and the dense occupancy emitted,
    ``voxel_mean_mode="auto"``, default partials capacity
    (``max(2^16, N // 4)``), 262,144 output cells, no sparse blocks."""
    base = dict(
        num_depth_streams=c, depth_height=h, depth_width=w,
        num_point_sequences=N_LIDAR_STREAMS,
        crop_min=(-20, -20, 0), crop_max=(20, 20, 2.5),
        voxel_min=(-20, -20, 0), voxel_max=(20, 20, 2.5),
        voxel_size=(0.1, 0.1, 0.12),
        voxel_occupancy_lifetime=10,
        rollbuffer_point_capacity=98304,
        max_points_per_sequence=N_LIDAR_STREAMS * lidar_pts,
    )
    base.update(kw)
    return FusionConfig(**base)


def bench_config(FusionConfig, h=H, w=W, c=C, lidar_pts=LIDAR_PTS, **kw):
    """``bench.py``'s configuration on the raw depth link: the codec fields
    it no longer uses are left at their defaults, and the level-1 partials
    capacity is raised to hold the raw series' runs."""
    base = dict(
        num_depth_streams=c, depth_height=h, depth_width=w,
        num_point_sequences=N_LIDAR_STREAMS,
        crop_min=(-20, -20, 0), crop_max=(20, 20, 2.5),
        voxel_min=(-20, -20, 0), voxel_max=(20, 20, 2.5),
        voxel_size=(0.1, 0.1, 0.12),
        voxel_occupancy_lifetime=10,
        rollbuffer_point_capacity=98304,
        max_points_per_sequence=N_LIDAR_STREAMS * lidar_pts,
        depth_link_codec="none",
        depth_codec_max_exceptions=8192,
        lidar_link_quant_step=0.002,
        # bench.py's 448k was sized to its 16 mm-quantized depth series;
        # the raw series breaks more raster runs (647,240 level-1 runs
        # measured on frame 0 of this scene), so the raw link needs more
        voxelize_partials_capacity=768 * 1024,
        voxelize_output_capacity=16384,
        emit_raw_points=False,
        emit_occupancy_u8=False,
        occupancy_sparse_capacity=4096,
    )
    base.update(kw)
    return FusionConfig(**base)


class Scene:
    """``bench.py``'s moving scene from a seed: static background, fixed
    per-camera pattern noise, persistent holes with churn, a circling
    blob, a swaying rig and two rotating lidar arcs (8 staged frames)."""

    def __init__(self, transforms, seed=0, h=H, w=W, c=C,
                 lidar_pts=LIDAR_PTS):
        self.transforms, self.c = transforms, c
        rng = np.random.default_rng(seed)
        u, v = np.meshgrid(np.arange(w), np.arange(h))
        base = 2500 + 200 * np.sin(u / 150.0) + 150 * np.cos(v / 120.0)
        pattern = [rng.normal(0.0, 6.0, (h, w)) for _ in range(c)]
        holes_fix = [rng.random((h, w)) < 0.01 for _ in range(c)]
        churn = [[rng.random((h, w)) < 0.001 for _ in range(c)]
                 for _ in range(N_STAGED)]
        self.depths = []
        for k in range(N_STAGED):
            ang = 2 * np.pi * k / N_STAGED
            cx = w * 0.5 + 6.0 * np.cos(ang)
            cy = h * 0.5 + 6.0 * np.sin(ang)
            blob = 400 * np.exp(-(((u - cx) / 25.0) ** 2
                                 + ((v - cy) / 20.0) ** 2))
            cams_k = []
            for i in range(c):
                d = (base - blob + pattern[i]
                     + rng.standard_normal((h, w))).astype(np.uint16)
                d[holes_fix[i] | churn[k][i]] = 0
                cams_k.append(d)
            self.depths.append(cams_k)
        t_l = np.linspace(0, np.pi, lidar_pts)
        self.arcs = []
        for k in range(N_STAGED):
            rot = 2 * np.pi * k / N_STAGED
            self.arcs.append([
                np.stack([6 * np.cos(t_l + rot), 6 * np.sin(t_l + rot),
                          1 + 0.3 * np.sin(5 * t_l)], axis=-1)
                .astype(np.float32),
                np.stack([12 * np.cos(-t_l * 0.7 + rot),
                          12 * np.sin(-t_l * 0.7 + rot),
                          1.5 + 0 * t_l], axis=-1).astype(np.float32)])

    def cams_at(self, f, spacing=None, radius=8.0):
        """Camera poses on a ring of ``radius`` m, 2 m up, looking at its
        centre 0.3 rad down; ``spacing`` slots (default: one a camera)."""
        tr = self.transforms
        yaw0 = 0.02 * np.sin(2 * np.pi * f / 60.0)  # rig sway
        spacing = spacing or self.c
        out = []
        for i in range(self.c):
            ang = i * 2 * np.pi / spacing + yaw0
            pos = np.array([radius * np.cos(ang), radius * np.sin(ang), 2.0])
            out.append(tr.make_se3(tr.rot_z(ang + np.pi)
                                   @ tr.rot_x(-np.pi / 2 - 0.3), pos))
        return out

    def stage(self, eng, intr, f, **ring):
        """Stage frame ``f`` into ``eng``; returns its timestamp. The
        engine's cameras are the scene's first ones (poses from
        :meth:`cams_at` with ``ring``'s keywords); ``intr`` is one camera
        model or a list, one a camera; a camera whose stream is smaller
        than the scene (a heterogeneous rig) gets the top-left crop of its
        image. The lidar arcs go to an engine that takes point
        sequences."""
        d = self.depths[f % N_STAGED]
        cams = self.cams_at(f, **ring)
        shapes = eng.cfg.resolved_stream_shapes
        for i in range(eng.cfg.num_depth_streams):
            h, w = shapes[i]
            eng.add_depthmap(i, d[i][:h, :w],
                             intr[i] if isinstance(intr, list) else intr,
                             cams[i], cams[i])
        if eng.cfg.num_point_sequences:
            for arc in self.arcs[f % N_STAGED]:
                eng.add_point_sequence(arc, sec=10 + (f // 30),
                                       nsec=int((f % 30) * 33e6),
                                       tf_move=np.eye(4, dtype=np.float32))
        return 10.0 + f / 30.0


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


# The card's published peaks (NVIDIA H100 SXM data sheet, dense, at the
# full 700 W): HBM3 bytes/s and float32 operations/s outside the tensor
# cores. A kernel's bound is the larger of its bytes (each input read
# once, each output written once) and its operations over these.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12


def roofline(nbytes, ops):
    """(bound ms, "bytes" or "operations") of a call that must move
    ``nbytes`` and do ``ops`` float32 operations."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def work_of(name, args, out):
    """(bytes, float32 operations) one call of engine kernel ``name``
    needs on these inputs, from its arguments and its (exact) output."""
    if name == "segreduce":
        keys, vals, cap, sentinel = args[:4]
        d = vals.shape[1]
        valid = int((keys != sentinel).sum())
        # every key and the valid positions' rows in (a sentinel's values
        # are never read); the static-capacity key and sum rows and the
        # two counts out; one add per valid element and column
        return (keys.nbytes + valid * 4 * d + cap * 4 * (1 + d) + 8,
                valid * d)
    if name == "flying_pixels":
        pts, mask, fs, rot45 = args[0], args[1], args[4], args[6]
        pix = mask.numel()
        # points and mask in, mask out. Operations at their most (every
        # ring tested on every pixel), an IEEE division counted as the 11
        # its instruction sequence does (a reciprocal and 5 fused
        # multiply-adds), a square root as 6: 46 for the range gate and
        # the view ray, 66 a ring test (12 of them loads' differences and
        # the cross product). Below the bytes; what holds the kernel is
        # the instruction rate of those sequences, not their operation count
        rings = fs * (2 if rot45 else 1)
        return pts.nbytes + 2 * pix + 8, pix * (46 + 66 * rings)
    if name == "compact":
        words, mask, cap = args[0], args[1], args[2]
        d = words.shape[1]
        moved = min(int(out[2]), cap)     # rows the output takes
        return mask.nbytes + moved * 4 * d + cap * 4 * d + 8, mask.numel()
    raise KeyError(name)


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


def assert_outputs_equal(torch, got, ref, what, skip=()):
    for k in ref._fields:
        if k not in skip and not torch.equal(getattr(got, k).cpu(),
                                             getattr(ref, k).cpu()):
            raise AssertionError(f"{what}: {k} differs")


def partials_capacity(cfg):
    """The level-1 partials capacity a step runs with: the configured one,
    or by default ``max(2^16, N // 4)`` of the step's N rows (the
    compacted cloud's capacity on the non-split step)."""
    if cfg.voxelize_partials_capacity > 0:
        return cfg.voxelize_partials_capacity
    n = cfg.total_point_capacity
    return min(max(1 << 16, n // 4), n)


def check_frame_outputs(cfg, eng, outs, what):
    """Capacity and sanity checks of a run's outputs; returns the max
    level-1 partials count."""
    import torch
    max_partials = 0
    cap = partials_capacity(cfg)
    for f, o in enumerate(outs):
        vp, fc = int(o.vox_partials_count), int(o.fused_count)
        max_partials = max(max_partials, vp)
        if vp > cap:
            raise AssertionError(f"{what} frame {f}: partials {vp} > {cap}")
        if fc >= cfg.voxelize_output_capacity:
            raise AssertionError(f"{what} frame {f}: fused_count {fc} at cap")
        if f >= 1 and int(o.seq_selected_count) <= 0:
            raise AssertionError(f"{what} frame {f}: no lidar selected")
    fp = outs[-1].fused_points
    if fp.shape != (eng.output_capacity, 4) or not torch.isfinite(fp).all():
        raise AssertionError(f"{what}: fused_points bad shape or non-finite")
    n = int(outs[-1].fused_count)
    if n <= 0 or not bool((fp[:n, 3] == 1).all()) or bool(fp[n:].any()):
        raise AssertionError(f"{what}: bad live/padding fused rows")
    return max_partials


def run_engine(torch, eng, scene, intr, frames, kmods, expected,
               step_tap=None, record=None, ring=None):
    """Drive ``eng`` through ``frames`` frames (then ``flush()`` when
    pipelined) through the user entry points. Every step must launch each
    engine kernel its ``expected`` number of times. ``step_tap`` receives
    (state before, inputs, depth_bits) of every step; ``record`` =
    (frame, mods) records that frame's kernel calls; ``ring`` places the
    cameras (:meth:`Scene.cams_at`'s keywords). Returns (outputs,
    depth_bits per output, wall ms a frame of frames 4.. (frame 1.. of a
    shorter run) including a final synchronize, per-frame host ms of
    process() and of the step's enqueue, recorded calls)."""
    orig_step = eng.step
    step_ms = []

    def step(inp, depth_bits=None):
        if step_tap is not None:
            step_tap(eng.state, inp, depth_bits)
        before = {n: m.launches for n, m in kmods.items()}
        t = time.perf_counter()
        out = orig_step(inp, depth_bits)
        step_ms.append((time.perf_counter() - t) * 1e3)
        for n, m in kmods.items():
            if m.launches - before[n] != expected[n]:
                raise AssertionError(
                    f"step launched {n} {m.launches - before[n]} times, "
                    f"expected {expected[n]}")
        return out
    eng.step = step
    outs, bits, host_ms, calls = [], [], [], {}
    t_steady = None
    warm = 4 if frames > 4 else 1
    for f in range(frames):
        if f == warm:
            torch.cuda.synchronize()
            t_steady = time.perf_counter()
        now = scene.stage(eng, intr, f, **(ring or {}))
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
    eng.step = orig_step
    return outs, bits, wall, (host_ms, step_ms), calls


def keep_last(box):
    """A step tap that keeps the latest (state, inputs, depth_bits)."""
    def tap(*step):
        box[:] = [step]
    return tap


def replay_plain(engmod, eng, tapped):
    """The tapped step again with the plain twins, from the same state."""
    state, inp, bits = tapped
    _, ref = engmod.fusion_step(state, inp, bits, cfg=eng.cfg, grid=eng.grid,
                                output_capacity=eng.output_capacity,
                                plain=True)
    return ref


def small_rig_equal(torch, engmod, cfg_fn, FusionConfig, transforms,
                    PinholeIntrinsics, pipeline_depth, what, **kw):
    """A small rig of a configuration (``kw`` overrides fields): equal
    outputs on the card and on the CPU, frame by frame; returns the last
    frame's depth_bits."""
    small = cfg_fn(FusionConfig, h=48, w=64, c=2, lidar_pts=256,
                   **dict(dict(rollbuffer_point_capacity=2048,
                               voxelize_partials_capacity=0,
                               occupancy_sparse_capacity=512), **kw))
    sm_scene = Scene(transforms, seed=1, h=48, w=64, c=2, lidar_pts=256)
    sm_intr = [PinholeIntrinsics.default_for(w, h, fov_deg=100.0)
               for h, w in small.resolved_stream_shapes]
    engines = [engmod.FusionEngine(small, device=d,
                                   pipeline_depth=pipeline_depth)
               for d in ("cuda", "cpu")]
    outs = ([], [])
    for f in range(6):
        for e, o in zip(engines, outs):
            out = e.process(sm_scene.stage(e, sm_intr, f))
            if out is not None:
                o.append(out)
    for e, o in zip(engines, outs):
        if pipeline_depth:
            o.append(e.flush())
        e.close()
    if len(outs[0]) != len(outs[1]) or len(outs[1]) != 6:
        raise AssertionError(f"{what} small rig: {len(outs[0])} and "
                             f"{len(outs[1])} outputs of 6 frames")
    for f, (a, b) in enumerate(zip(*outs)):
        assert_outputs_equal(torch, a, b, f"{what} small rig frame {f} "
                             "(card vs cpu)")
    if int(outs[1][-1].fused_count) <= 0:
        raise AssertionError(f"{what} small rig: nothing fused")
    return engines[0].last_frame_bits


def same(a, b, path="result"):
    """Recursive equality of two nested results (NamedTuples,
    dataclasses, plain objects, arrays, floats exactly)."""
    if type(a) is not type(b):
        raise AssertionError(f"{path}: {type(a)} != {type(b)}")
    if isinstance(a, np.ndarray):
        if a.dtype != b.dtype or not np.array_equal(a, b, equal_nan=True):
            raise AssertionError(f"{path} differs")
    elif isinstance(a, (list, tuple)):
        if len(a) != len(b):
            raise AssertionError(f"{path}: length {len(a)} != {len(b)}")
        for k, (x, y) in enumerate(zip(a, b)):
            same(x, y, f"{path}[{k}]")
    elif isinstance(a, (int, float, bool, str, type(None), np.generic)):
        if not (a == b or (a != a and b != b)):
            raise AssertionError(f"{path}: {a} != {b}")
    else:
        names = list(getattr(a, "__dict__", {}))
        for cls in type(a).__mro__:
            names += getattr(cls, "__slots__", ())
        for n in names:
            same(getattr(a, n), getattr(b, n), f"{path}.{n}")


def sparse_of(o):
    """A frame's sparse occupancy with its dense fallback
    (``bench.py:457-460``)."""
    return (o.occupancy_sparse_idx, o.occupancy_sparse_words,
            o.occupancy_sparse_count, o.occupancy_sparse_true,
            o.occupancy_bits)


def check_launches(kmods, expected, frames, what):
    """Each kernel's counter, zeroed before the run, against its expected
    launches a step times the steps; returns the launches."""
    launches = {n: m.launches for n, m in kmods.items()}
    for n, c in launches.items():
        if c != expected[n] * frames:
            raise AssertionError(f"{what}: {n} launched {c} times in "
                                 f"{frames} steps, expected "
                                 f"{expected[n] * frames}")
    return launches


def zero_counts(kmods):
    for m in kmods.values():
        m.launches = 0


def publish_phase(torch, engmod, FusionConfig, scene, intr, kmods,
                  record_mods, gpu):
    """FusionConfig()'s defaults at the bench rig's size: the non-split
    step with the raw cloud. Returns (recorded calls of an "auto" and a
    "packed" frame, launches by path, and by mode the engine with its
    last tapped step: state, inputs, depth_bits)."""
    cfg = publish_config(FusionConfig)
    launches, ms = {}, {}
    # "auto" (rle on this grid), pipelined: the path a default user runs
    eng = engmod.FusionEngine(cfg, device="cuda", pipeline_depth=1)
    last_step = []
    zero_counts(kmods)
    outs, bits, ms["auto"], (host_ms, step_ms), calls = run_engine(
        torch, eng, scene, intr, PUBLISH_FRAMES, kmods, EXPECTED["publish"],
        step_tap=keep_last(last_step), record=(RECORD_FRAME, record_mods))
    launches["publish"] = check_launches(kmods, EXPECTED["publish"],
                                         PUBLISH_FRAMES, "publish")
    if len(outs) != PUBLISH_FRAMES or not all(
            isinstance(b, int) and b > 0 for b in bits):
        raise AssertionError(f"publish: outputs {len(outs)}, frame kinds "
                             f"{bits} (dpcm I-frames expected)")
    max_partials = check_frame_outputs(cfg, eng, outs, "publish")
    grid = eng.grid
    last = outs[-1]
    n_raw = int(last.raw_count)
    if tuple(last.raw_points.shape) != (cfg.total_point_capacity, 4) \
            or n_raw <= 0 or bool(last.raw_points[n_raw:].any()) \
            or not bool((last.raw_points[:n_raw, 3] == 1).all()):
        raise AssertionError("publish: bad raw cloud")
    occ = last.occupancy_u8
    if occ.shape != (grid.num_cells,) or int((occ > 0).sum()) <= 0:
        raise AssertionError("publish: bad dense occupancy")
    # the largest cell: packed == rle needs its z-sum below 2^24
    cell_ids = grid.cell_index_clamped(last.raw_points[:n_raw, :3]).long()
    max_members = int(torch.bincount(cell_ids).max())
    assert_outputs_equal(torch, last, replay_plain(engmod, eng, last_step[0]),
                         "publish last frame vs the plain-twin step")
    # pipeline_depth=0 on the same frames
    sync = engmod.FusionEngine(cfg, device="cuda", pipeline_depth=0)
    zero_counts(kmods)
    s_outs, _, ms["auto_sync"], _, _ = run_engine(
        torch, sync, scene, intr, PUBLISH_FRAMES, kmods,
        EXPECTED["publish_sync"])
    launches["publish_sync"] = check_launches(
        kmods, EXPECTED["publish_sync"], PUBLISH_FRAMES, "publish sync")
    for f, (a, b) in enumerate(zip(outs, s_outs)):
        assert_outputs_equal(torch, a, b, f"publish frame {f} pipelined vs "
                             "pipeline_depth=0")
    del sync, s_outs
    taps = {"auto": (eng, last_step[0])}
    # "packed" on the same frames: rle == packed at full size
    packed = engmod.FusionEngine(cfg.replace(voxel_mean_mode="packed"),
                                 device="cuda", pipeline_depth=1)
    zero_counts(kmods)
    p_tap = []
    p_outs, _, ms["packed"], _, p_calls = run_engine(
        torch, packed, scene, intr, PUBLISH_FRAMES, kmods,
        EXPECTED["publish_packed"], step_tap=keep_last(p_tap),
        record=(RECORD_FRAME, record_mods))
    taps["packed"] = (packed, p_tap[0])
    launches["publish_packed"] = check_launches(
        kmods, EXPECTED["publish_packed"], PUBLISH_FRAMES, "publish packed")
    for f, (a, b) in enumerate(zip(p_outs, outs)):
        # mode "rle" reports its level-1 runs, the other modes 0
        assert_outputs_equal(torch, a, b, f"publish frame {f} packed vs rle",
                             skip=("vox_partials_count",))
        if int(a.vox_partials_count) != 0:
            raise AssertionError("publish packed: partials count not 0")
    del p_outs
    # one frame each of "exact" and occupied cells (two frames, the
    # second replayed with the twins)
    for mode, kw in (("exact", dict(voxel_mean_mode="exact")),
                     ("occupied", dict(voxel_enable_average=False))):
        e = engmod.FusionEngine(cfg.replace(**kw), device="cuda")
        zero_counts(kmods)
        tap = []
        m_outs, _, ms[mode], _, _ = run_engine(
            torch, e, scene, intr, 2, kmods, EXPECTED["publish_" + mode],
            step_tap=keep_last(tap))
        launches["publish_" + mode] = check_launches(
            kmods, EXPECTED["publish_" + mode], 2, "publish " + mode)
        assert_outputs_equal(torch, m_outs[-1], replay_plain(engmod, e,
                                                             tap[0]),
                             f"publish {mode} frame vs the plain-twin step")
        if int(m_outs[-1].fused_count) <= 0 or int(
                m_outs[-1].vox_partials_count) != 0:
            raise AssertionError(f"publish {mode}: bad counts")
        taps[mode] = (e, tap[0])
        del m_outs
    # ms/frame of "auto" and "packed" in turns, fresh pipelined engines
    turns = []
    for mode in ("auto", "packed", "packed", "auto"):
        e = engmod.FusionEngine(cfg.replace(voxel_mean_mode=mode),
                                device="cuda", pipeline_depth=1)
        zero_counts(kmods)
        path = "publish" if mode == "auto" else "publish_packed"
        turns.append(run_engine(torch, e, scene, intr, PUBLISH_FRAMES, kmods,
                                EXPECTED[path])[2])
        del e
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
          f"{max_partials} of {partials_capacity(cfg)}, largest cell "
          f"{max_members} points (z-sum below 2^24 up to 4,096) | launches "
          f"{launches} | plain-twin step equal (auto, exact, occupied); "
          f"pipelined == sync; packed == rle in every output but the "
          f"partials count | {gpu}", flush=True)
    return calls, p_calls, launches, taps


def hetero_phase(torch, engmod, FusionConfig, PinholeIntrinsics, scene,
                 kmods, gpu):
    """A mixed rig at the bench rig's size: 4 cameras at 848x480 and 4 at
    640x360 (the top-left crops of the scene's images) on the "dpcm"
    link at FusionConfig()'s defaults. Returns launches by path."""
    cfg = publish_config(FusionConfig, stream_shapes=HETERO_SHAPES)
    intr = [PinholeIntrinsics.default_for(w, h) for h, w in HETERO_SHAPES]
    launches = {}
    eng = engmod.FusionEngine(cfg, device="cuda", pipeline_depth=1)
    last_step = []
    zero_counts(kmods)
    outs, bits, het_ms, _, _ = run_engine(
        torch, eng, scene, intr, HETERO_FRAMES, kmods, EXPECTED["hetero"],
        step_tap=keep_last(last_step))
    launches["hetero"] = check_launches(kmods, EXPECTED["hetero"],
                                        HETERO_FRAMES, "hetero")
    if len(outs) != HETERO_FRAMES or not all(
            isinstance(b, tuple) and len(b) == 2
            and all(isinstance(g, int) and g > 0 for g in b) for b in bits):
        raise AssertionError(f"hetero: outputs {len(outs)}, frame kinds "
                             f"{bits} (per-group dpcm widths expected)")
    max_partials = check_frame_outputs(cfg, eng, outs, "hetero")
    assert_outputs_equal(torch, outs[-1],
                         replay_plain(engmod, eng, last_step[0]),
                         "hetero last frame vs the plain-twin step")
    del last_step[:]
    sync = engmod.FusionEngine(cfg, device="cuda", pipeline_depth=0)
    zero_counts(kmods)
    s_outs, s_bits, sync_ms, _, _ = run_engine(
        torch, sync, scene, intr, HETERO_FRAMES, kmods,
        EXPECTED["hetero_sync"])
    launches["hetero_sync"] = check_launches(
        kmods, EXPECTED["hetero_sync"], HETERO_FRAMES, "hetero sync")
    if s_bits != bits:
        raise AssertionError(f"hetero: sync widths {s_bits} != {bits}")
    for f, (a, b) in enumerate(zip(outs, s_outs)):
        assert_outputs_equal(torch, a, b, f"hetero frame {f} pipelined vs "
                             "pipeline_depth=0")
    print(f"[hetero] 4 x 848x480 + 4 x 640x360 cameras, dpcm per group, "
          f"FusionConfig() defaults, {HETERO_FRAMES} frames + flush: "
          f"{het_ms:.2f} ms/frame pipelined, {sync_ms:.2f} pipeline_depth=0 "
          f"(no speed claimed) | widths {bits[-1]} | raw cloud "
          f"{int(outs[-1].raw_count)}, fused {int(outs[-1].fused_count)}, "
          f"level-1 partials max {max_partials} of {partials_capacity(cfg)}"
          f" | launches {launches} | plain-twin step equal; pipelined == "
          f"sync | {gpu}", flush=True)
    return launches


def presets_phase(torch, engmod, config, PinholeIntrinsics, scene, kmods,
                  gpu):
    """The launch file's two deployments as written (``PRESET_HAFEN``,
    ``PRESET_OFFICE``): ``FusionConfig()``'s defaults but for the rig,
    grid, crop and lifetime, synchronous, :data:`PRESET_FRAMES` frames of
    the scene (the rigs of :data:`PRESETS`). Every frame equal to its
    plain-twin replay, launches a step as ``EXPECTED``, at least 1,000
    occupied cells a frame. Returns launches by path."""
    launches, parts = {}, []
    for key, (name, ring, fov) in PRESETS.items():
        cfg = getattr(config, name)
        intr = PinholeIntrinsics.default_for(W, H, fov_deg=fov)
        eng = engmod.FusionEngine(cfg, device="cuda")
        if engmod.resolve_mean_mode(cfg, eng.grid) != "rle":
            raise AssertionError(f"{key}: auto is not rle")
        taps = []
        zero_counts(kmods)
        outs, bits, ms, _, _ = run_engine(
            torch, eng, scene, intr, PRESET_FRAMES, kmods, EXPECTED[key],
            step_tap=lambda *step: taps.append(step), ring=ring)
        launches[key] = check_launches(kmods, EXPECTED[key], PRESET_FRAMES,
                                       key)
        if len(outs) != PRESET_FRAMES or not all(
                isinstance(b, int) and b > 0 for b in bits):
            raise AssertionError(f"{key}: outputs {len(outs)}, frame kinds "
                                 f"{bits} (dpcm I-frames expected)")
        for f, (out, tap) in enumerate(zip(outs, taps)):
            assert_outputs_equal(torch, out, replay_plain(engmod, eng, tap),
                                 f"{key} frame {f} vs the plain-twin step")
        occupied = [int((o.occupancy_u8 > 0).sum()) for o in outs]
        if min(occupied) < 1000:
            raise AssertionError(f"{key}: occupied cells {occupied}, fewer "
                                 "than 1,000 in a frame")
        max_partials = max(int(o.vox_partials_count) for o in outs)
        if max_partials > partials_capacity(cfg):
            raise AssertionError(f"{key}: partials {max_partials} over "
                                 "capacity")
        last = outs[-1]
        parts.append(
            f"{key} ({cfg.num_depth_streams} x {W}x{H} at {fov:g} deg, "
            f"{eng.grid.num_cells} cells): {ms:.2f} ms/frame | occupied "
            f"cells {min(occupied)}-{max(occupied)} | raw cloud "
            f"{int(last.raw_count)}, fused {int(last.fused_count)}, level-1 "
            f"partials max {max_partials} of {partials_capacity(cfg)} | "
            f"launches {launches[key]}")
        del eng, outs, taps
    print(f"[presets] launch-file deployments as written (dpcm link, raw "
          f"cloud + dense occupancy, auto = rle, no lidar), "
          f"{PRESET_FRAMES} frames, pipeline_depth=0, ms/frame of frames "
          f"4.. ending with a synchronize (no speed claimed): "
          f"{' || '.join(parts)} | every frame equal to its plain-twin "
          f"step | {gpu}", flush=True)
    return launches


def small_rigs_publish(torch, engmod, FusionConfig, transforms,
                       PinholeIntrinsics, gpu):
    """Each mode and branch of the non-split step, and a heterogeneous
    rig, on a small rig: equal outputs on the card and on the CPU."""
    cases = (("auto", {}), ("packed", dict(voxel_mean_mode="packed")),
             ("exact", dict(voxel_mean_mode="exact")),
             ("occupied", dict(voxel_enable_average=False)),
             ("no voxel filter", dict(enable_voxel_filter=False)),
             ("radius", dict(enable_radius_filter=True,
                             radius_filter_radius=0.2,
                             radius_min=(-20, -20, 0),
                             radius_max=(20, 20, 2.5))),
             ("hetero", dict(stream_shapes=((48, 64), (32, 40)))))
    for what, kw in cases:
        small_rig_equal(torch, engmod, publish_config, FusionConfig,
                        transforms, PinholeIntrinsics, 1 if what == "hetero"
                        else 0, f"publish {what}", **kw)
    print(f"[small rigs] card == cpu, 6 frames each: "
          f"{', '.join(w for w, _ in cases)} | {gpu}", flush=True)


def mapping_phase(torch, engmod, cfg, scene, intr, kmods, native, gpu):
    """``bench.py:443-537`` on the port: warm cycle, device segmentation
    on the card against native and the CPU, then the paced mapping-on
    loop. Prints the ``[mapping]`` line."""
    from collections import deque
    from ros_gpu_depthmap_fusion_tpu_torch.mapping.pipeline import (
        AsyncMappingWorker, MappingPipeline, prefetch)
    from ros_gpu_depthmap_fusion_tpu_torch.mapping.segmentation import (
        segment)
    eng = engmod.FusionEngine(cfg, device="cuda", pipeline_depth=1)
    eng.enable_mapping = True
    mcfg = cfg.replace(mapping_detail_min_area=-1.0)
    eng.mapping = MappingPipeline(mcfg, eng.grid, "cuda")
    f = 0
    for f in range(MAP_WARM_FRAMES):
        out = eng.process(scene.stage(eng, intr, f))

    # warm cycle: sparse, and packed through a fresh pipeline (tracks
    # carry state)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = eng.mapping.process_sparse(sparse_of(out))
    warm_ms = (time.perf_counter() - t0) * 1e3
    warm_phase = eng.mapping.last_phase_ms
    sp_true = int(out.occupancy_sparse_true)
    sp_cap = cfg.occupancy_sparse_capacity
    fresh = MappingPipeline(mcfg, eng.grid, "cuda")
    same(res, fresh.process_packed(out.occupancy_bits),
         "warm cycle: process_sparse vs process_packed")
    if eng.mapping.backend != "host" or res.num_merged < 2:
        raise AssertionError(f"mapping warm cycle: backend "
                             f"{eng.mapping.backend}, {res.num_merged} ids")

    # the device segmentation on this frame's grid
    zyx = eng.grid.shape_zyx
    occ = np.unpackbits(out.occupancy_bits.cpu().numpy(), bitorder="little",
                        count=eng.grid.num_cells).reshape(zyx)
    lab, objs = cfg.cc_max_labels_per_layer, cfg.max_objects
    occ_t = torch.from_numpy(occ)
    seg = segment(occ_t.cuda(), lab, objs)
    torch.cuda.synchronize()
    nat = native.segment_grid(occ, lab, objs)
    for k in ("labels", "num_labels", "merged_of_label", "voxel_count",
              "vmin", "vmax"):
        if not np.array_equal(nat[k], getattr(seg, k).cpu().numpy()):
            raise AssertionError(f"device segment on the card: {k} differs "
                                 "from native")
    if nat["num_merged"] != int(seg.num_merged):
        raise AssertionError("device segment: num_merged differs from native")
    cen_err = float(np.abs(nat["centroid"] - seg.centroid.cpu().numpy())
                    .max())
    if cen_err > 1e-4:
        raise AssertionError(f"device segment: centroid off native by "
                             f"{cen_err}")
    t0 = time.perf_counter()
    cpu = segment(occ_t, lab, objs)
    cpu_s = time.perf_counter() - t0
    for k in cpu._fields:
        a, b = getattr(seg, k), getattr(cpu, k)
        if not (a == b if k == "iterations" else torch.equal(a.cpu(), b)):
            raise AssertionError(f"device segment: {k} card != cpu")
    seg_ms = cuda_ms(torch, lambda: segment(occ_t.cuda(), lab, objs),
                     reps=5, warm=1)
    nat_ms = []
    for _ in range(5):
        t0 = time.perf_counter()
        native.segment_grid(occ, lab, objs)
        nat_ms.append((time.perf_counter() - t0) * 1e3)

    def paced(f0, worker):
        """``bench.py:478-530``: MAP_FRAMES frames paced at 30 Hz, each
        drained MAP_LAG frames after its step; with a worker, 3 of every 5
        frames are mapped, their sparse tuple's copy to the host started
        at enqueue. Returns the seconds taken."""
        lagq = deque()
        t0 = time.perf_counter()
        for k in range(1, MAP_FRAMES + 1):
            out = eng.process(scene.stage(eng, intr, f0 + k))
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
        return time.perf_counter() - t0

    # the same paced loop with mapping off before and after the mapping-on
    # run: what the mapping worker costs the fused frame
    dt_off = [paced(f, None)]
    zero_counts(kmods)
    worker = AsyncMappingWorker(eng.mapping, packed=True)
    dt_map = paced(f + MAP_FRAMES, worker)
    launches = {n: m.launches for n, m in kmods.items()}
    cycles = worker.cycles
    worker.close()          # raises the worker's exception, if any
    latest = worker.latest()
    phase = eng.mapping.last_phase_ms
    dt_off.append(paced(f + 2 * MAP_FRAMES, None))
    eng.flush()
    eng.close()
    if cycles < 1 or latest is None:
        raise AssertionError(f"mapping worker: {cycles} cycles")
    for n, c in launches.items():
        if c != EXPECTED["mapping"][n] * MAP_FRAMES:
            raise AssertionError(f"mapping loop: {n} launched {c} times in "
                                 f"{MAP_FRAMES} frames")
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
          f"; sparse == packed | device segment {zyx} on the card "
          f"{seg_ms:.2f} ms (median of 5, {seg.iterations[0]} label + "
          f"{seg.iterations[1]} merge iterations) vs native "
          f"{float(np.median(nat_ms)):.2f} ms (host clock), CPU torch "
          f"{cpu_s:.1f} s; card == native (centroid within {cen_err:.1e}) "
          f"== cpu | launches {launches} | {gpu}", flush=True)


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


def _rot_err(a, b):
    """Largest rotation angle (rad) between the [N, 3, 3] rotations of two
    pose stacks, from the skew part of a^T b."""
    rel = np.swapaxes(a[:, :3, :3], 1, 2).astype(np.float64) @ b[:, :3, :3]
    sk = rel - np.swapaxes(rel, 1, 2)
    return float(np.linalg.norm(np.stack([sk[:, 2, 1], sk[:, 0, 2],
                                          sk[:, 1, 0]], -1), axis=-1).max()
                 / 2)


def ba_agree(a, b, names, tie=1e-5):
    """Two runs of the same BA iterations, each (poses, chi2 before each
    step, each step's candidate chi2) on any device. A step whose
    candidate changes chi2 by at most ``tie`` relative is a rounding tie:
    its accept decision rests on float32 summation order, which the card's
    atomic scatter-adds leave open, and a flat direction can move poses by
    more than 1e-4 for no chi2 (seen on the hard synthetic: 1.7e-4 m at a
    1e-7 change). So: every step outside a tie takes the same decision in
    both runs; with every decision equal the poses agree within 1e-4 m and
    1e-4 rad; where a tie went the other way, the final chi2 agree within
    ``tie``. ``names`` label the two runs. Returns the numbers."""
    (pc, cc, kc), (ph, ch, kh) = [
        (p.cpu().numpy(), c.cpu().double(), k.cpu().double())
        for p, c, k in (a, b)]
    acc_c, acc_h = (kc <= cc).tolist(), (kh <= ch).tolist()
    ties = [bool(abs(a - b) <= tie * b) or bool(abs(x - y) <= tie * y)
            for a, b, x, y in zip(kc.tolist(), cc.tolist(), kh.tolist(),
                                  ch.tolist())]
    out = dict(ba_accepts=(acc_c, acc_h), ba_ties=ties,
               ba_t_err=float(np.abs(pc[:, :3, 3] - ph[:, :3, 3]).max()),
               ba_r_err=_rot_err(pc, ph))
    what = f"BA {names[0]} vs {names[1]}"
    if any(a != b and not t for a, b, t in zip(acc_c, acc_h, ties)):
        raise AssertionError(f"{what}: accept decisions {acc_c} vs {acc_h} "
                             f"outside a tie ({ties})")
    if acc_c == acc_h:
        if out["ba_t_err"] > 1e-4 or out["ba_r_err"] > 1e-4:
            raise AssertionError(f"{what}: poses {out['ba_t_err']} m, "
                                 f"{out['ba_r_err']} rad apart")
    else:
        final = [float(k[-1] if a[-1] else c[-1]) for k, c, a in
                 ((kc, cc, acc_c), (kh, ch, acc_h))]
        if abs(final[0] - final[1]) > tie * final[1]:
            raise AssertionError(f"{what}: final chi2 {final[0]} vs "
                                 f"{final[1]} after a tie")
    return out


def ba_card_vs_cpu(torch, window, iterations=4, tie=1e-5):
    """``solve_window``'s iterations on ``window`` (on the card) and on a
    CPU copy, held together by :func:`ba_agree`."""
    from ros_gpu_depthmap_fusion_tpu_torch.slam import ba
    res = [ba._iterate(w, iterations, 1e-4)
           for w in (window, ba.BAProblem(*(t.cpu() for t in window)))]
    return ba_agree(*[(p, c, k) for p, _, c, k in res],
                    names=("slam: card", "cpu"), tie=tie)


def slam_parity(torch, root, window, gpu):
    """One frame pair of the rendered sequence through the frontend and one
    captured BA window, on the card and on the CPU port: keypoints,
    descriptors and matches equal, RANSAC (the same 64 sampled triples on
    both) with equal inlier counts and the transform within 1e-5, BA poses
    within 1e-4 m and 1e-4 rad. Returns the numbers and call times."""
    from ros_gpu_depthmap_fusion_tpu_torch.pipeline.datasets import (
        TumRgbdDataset)
    from ros_gpu_depthmap_fusion_tpu_torch.slam import ba
    from ros_gpu_depthmap_fusion_tpu_torch.slam import features as feat
    from ros_gpu_depthmap_fusion_tpu_torch.slam import pose_estimation as pe
    ds = TumRgbdDataset(root)
    intr = ds.intrinsics
    frames = []
    for f, frame in enumerate(ds):
        if f in (10, 11):
            frames.append(frame)
        if f >= 11:
            break
    devs = (torch.device("cuda"), torch.device("cpu"))
    out = {}
    kps = []        # per device: per frame (keypoints, points, has depth)
    for d in devs:
        kps.append([])
        for fr in frames:
            img = torch.from_numpy(fr.intensity).to(d)
            depth = torch.from_numpy(fr.depth_u16.astype(np.float32)
                                     * fr.depth_scale).to(d)
            k = feat.detect_and_describe(img, 512, 12.0)
            pts, has_d = pe.unproject_keypoints(k.xy, depth, intr.fx,
                                                intr.fy, intr.cx, intr.cy)
            kps[-1].append((k, pts, has_d & k.valid))
    out["angle_err"] = 0.0
    for (kc, _, _), (kh, _, _) in zip(*kps):
        for f in ("xy", "score", "valid", "desc"):
            if not torch.equal(getattr(kc, f).cpu(), getattr(kh, f)):
                raise AssertionError(f"slam: keypoint {f} card != cpu")
        out["angle_err"] = max(out["angle_err"], float(
            (kc.angle.cpu() - kh.angle).abs().max()))
    if out["angle_err"] > 1e-6:
        raise AssertionError(f"slam: angle card vs cpu {out['angle_err']}")
    out["keypoints"] = int(kps[1][0][0].valid.sum())
    m = [feat.match(k[0][0], k[1][0]) for k in kps]
    for f in m[1]._fields:
        if not torch.equal(getattr(m[0], f).cpu(), getattr(m[1], f)):
            raise AssertionError(f"slam: match {f} card != cpu")
    # RANSAC on the CPU's correspondences, the same draws on both devices
    mh = m[1]
    (_, pa, va), (_, pb, vb) = kps[1]
    valid = mh.valid & va[mh.idx_a.long()] & vb[mh.idx_b.long()]
    src, dst = pb[mh.idx_b.long()], pa[mh.idx_a.long()]
    probs = valid.float() / valid.float().sum().clamp(min=1e-9)
    idx = pe._sample_hypotheses(torch.Generator().manual_seed(7), probs, 64)
    orig = pe._sample_hypotheses
    pe._sample_hypotheses = lambda g, p, it: idx.to(p.device)
    try:
        rc, rh = (pe.ransac_pose(src.to(d), dst.to(d), valid.to(d),
                                 torch.Generator(d).manual_seed(0),
                                 iterations=64, inlier_threshold=0.08)
                  for d in devs)
        args = (src.to(devs[0]), dst.to(devs[0]), valid.to(devs[0]),
                torch.Generator(devs[0]).manual_seed(0))
        out["ransac_call_ms"] = cuda_ms(
            torch, lambda: pe.ransac_pose(*args, iterations=64,
                                          inlier_threshold=0.08))
    finally:
        pe._sample_hypotheses = orig
    out["matches"] = int(valid.sum())
    out["inliers"] = int(rh.num_inliers)
    out["ransac_err"] = float((rc.transform.cpu() - rh.transform).abs().max())
    if int(rc.num_inliers) != int(rh.num_inliers) or out["ransac_err"] > 1e-5:
        raise AssertionError(f"slam: ransac inliers {int(rc.num_inliers)} "
                             f"vs {int(rh.num_inliers)}, transform err "
                             f"{out['ransac_err']}")
    img_c = torch.from_numpy(frames[0].intensity).to(devs[0])
    out["detect_call_ms"] = cuda_ms(
        torch, lambda: feat.detect_and_describe(img_c, 512, 12.0))
    kc0, kc1 = kps[0][0][0], kps[0][1][0]
    out["match_call_ms"] = cuda_ms(torch, lambda: feat.match(kc0, kc1))
    # one captured BA window, 4 iterations on each device
    out.update(ba_card_vs_cpu(torch, window))
    out["ba_window"] = (window.poses.shape[0], window.landmarks.shape[0],
                        window.obs_pose.shape[0])
    out["ba_call_ms"] = cuda_ms(
        torch, lambda: ba.solve_window(window, iterations=4), reps=5, warm=1)
    return out


def tum_phase(torch, engmod, kmods, gpu):
    """The SLAM path (``pipeline/tum_runner.py run_tum_sequence``) on the
    card at full width: the hard synthetic sequence (640x480, 150 frames,
    one closing orbit) rendered by the port's writer, then SLAM poses
    (512 keypoints, 64 RANSAC hypotheses, BA every 8 keyframes, loop
    closure with 128) into the runner's own configuration (32.8M cells,
    "dpcm" link, "packed"). Then the frontend and BA card == CPU on a frame
    pair and a captured window, and 20 groundtruth-posed frames each equal
    to its plain-twin step. Returns launches by path, and the first BA
    window of the SLAM run (numpy: poses, landmarks, obs_pose, obs_lm,
    obs_pt, obs_valid)."""
    import tempfile
    from ros_gpu_depthmap_fusion_tpu_torch.pipeline import tum_runner
    from ros_gpu_depthmap_fusion_tpu_torch.slam import frontend, loop_closure
    launches = {}
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
        zero_counts(kmods)
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
        launches["tum"] = {n: m.launches for n, m in kmods.items()}
        if res.frames != TUM_FRAMES:
            raise AssertionError(f"tum: {res.frames} frames")
        check_launches(kmods, EXPECTED["tum"], res.frames, "tum")
        if res.ate_rmse_m is None or not res.ate_rmse_m < 0.10:
            raise AssertionError(f"tum: ATE {res.ate_rmse_m} m")
        if res.ate_rmse_loop_closed_m is None:
            raise AssertionError("tum: no loop-closed ATE")
        if res.occupied_cells <= 0:
            raise AssertionError("tum: no occupied cells")
        if not windows:
            raise AssertionError("tum: BA never ran")
        ms = tc.ms
        odo_ms = float(np.mean(ms["odometry"]))
        eng_ms = float(np.sum(ms["engine"])) / res.frames
        par = slam_parity(torch, root, windows[0], gpu)
        # the last pose-graph solve once more (none without loop edges):
        # the first use of torch.func's forward-mode rules in a process
        # costs extra
        pg_again = "none"
        if graphs:
            t0 = time.perf_counter()
            optimize(graphs[-1][0], **graphs[-1][1])
            torch.cuda.synchronize()
            pg_again = f"{(time.perf_counter() - t0) * 1e3:.2f} ms"

        # groundtruth poses: every step held to its plain-twin replay
        steps = []
        step = Eng.step

        def replayed(self, inp, depth_bits=None):
            state = self.state
            out = step(self, inp, depth_bits)
            _, ref = engmod.fusion_step(
                state, inp, depth_bits, cfg=self.cfg, grid=self.grid,
                output_capacity=self.output_capacity, plain=True)
            assert_outputs_equal(torch, out, ref, f"tum groundtruth frame "
                                 f"{len(steps)} vs the plain-twin step")
            steps.append(int(out.fused_count))
            return out
        Eng.step = replayed
        zero_counts(kmods)
        try:
            gt = tum_runner.run_tum_sequence(
                root, pose_source="groundtruth", max_frames=TUM_GT_FRAMES,
                device="cuda")
        finally:
            Eng.step = step
        launches["tum_gt"] = check_launches(kmods, EXPECTED["tum_gt"],
                                            TUM_GT_FRAMES, "tum groundtruth")
        if gt.frames != TUM_GT_FRAMES or len(steps) != TUM_GT_FRAMES \
                or gt.occupied_cells <= 0 or gt.ate_rmse_m > 1e-6:
            raise AssertionError(f"tum groundtruth: {gt.frames} frames, "
                                 f"{len(steps)} steps, occupied "
                                 f"{gt.occupied_cells}, ATE {gt.ate_rmse_m}")
    lc = res.ate_rmse_loop_closed_m
    per = {n: c / res.frames for n, c in launches["tum"].items()}
    print(f"[tum] hard synthetic 640x480 x {TUM_FRAMES} (rendered by the "
          f"port's writer in {render_s:.1f} s, host numpy), SLAM poses: "
          f"frames {res.frames}, keyframes {res.keyframes}, loop edges "
          f"{res.loop_edges} | ATE {res.ate_rmse_m * 100:.2f} cm full-frame, "
          f"{lc * 100:.2f} cm loop-closed keyframes | occupied cells "
          f"{res.occupied_cells} of 32,768,000, fused points (last frame) "
          f"{res.fused_points_last} | host ms/frame: odometry {odo_ms:.2f} "
          f"(median {float(np.median(ms['odometry'])):.2f}), engine "
          f"add+process {eng_ms:.2f}, whole runner "
          f"{run_s * 1e3 / res.frames:.2f} (PNG decode, BA and loop closure "
          f"included) | run_ba {len(ms['run_ba'])} calls, "
          f"{float(np.mean(ms['run_ba'])):.2f} ms each | close_loops "
          f"{len(ms['close_loops'])} call(s), "
          f"{float(np.mean(ms['close_loops'])):.2f} ms ({len(ms['verify'])} "
          f"verifications {float(np.sum(ms['verify'])):.2f} ms, "
          f"{len(ms['pose_graph'])} pose-graph solve(s) "
          f"{float(np.sum(ms['pose_graph'])):.2f} ms, the last again "
          f"{pg_again}) | launches per frame "
          f"{per} | card == cpu on frames 10-11: {par['keypoints']} "
          f"keypoints, descriptors and {par['matches']} matches equal (angle "
          f"within {par['angle_err']:.1e}), RANSAC {par['inliers']} inliers "
          f"equal, transform within {par['ransac_err']:.1e}; BA window "
          f"{par['ba_window']} (poses, landmarks, observations) 4 iterations, "
          f"accepted card {par['ba_accepts'][0]} / cpu "
          f"{par['ba_accepts'][1]} (rounding ties {par['ba_ties']}), poses "
          f"within {par['ba_t_err']:.1e} m, {par['ba_r_err']:.1e} rad | "
          f"call ms on the card (CUDA events, host included): "
          f"detect_and_describe {par['detect_call_ms']:.3f}, match "
          f"{par['match_call_ms']:.3f}, ransac_pose (64 hypotheses) "
          f"{par['ransac_call_ms']:.3f}, solve_window (4 iterations) "
          f"{par['ba_call_ms']:.3f} | groundtruth poses, {TUM_GT_FRAMES} "
          f"frames: every step equal to its plain-twin replay, occupied "
          f"{gt.occupied_cells}, fused {gt.fused_points_last} | {gpu}",
          flush=True)
    return launches, tuple(t.cpu().numpy() for t in windows[0])


def shard_window(window, n_shards):
    """A BA window (numpy poses, landmarks, obs_pose, obs_lm, obs_pt,
    obs_valid) sharded landmark-major over ``n_shards``: the landmarks
    padded with unobserved zeros to a multiple of ``n_shards`` (such a
    landmark's block is the damping alone and its step 0, so the poses'
    system is unchanged), each shard's observations with landmark indices
    local to it, padded invalid. Returns (per shard (landmarks, obs_pose,
    obs_lm, obs_pt, obs_valid), landmarks a shard, observations a
    shard)."""
    _, lms, op, ol, pt, valid = window
    lps = -(-len(lms) // n_shards)
    lms = np.pad(lms, ((0, lps * n_shards - len(lms)), (0, 0)))
    members = [np.flatnonzero(ol // lps == d) for d in range(n_shards)]
    ops = max(len(i) for i in members)
    shards = []
    for d, idx in enumerate(members):
        pad = (0, ops - len(idx))
        shards.append((lms[d * lps:(d + 1) * lps], np.pad(op[idx], pad),
                       np.pad(ol[idx] - d * lps, pad),
                       np.pad(pt[idx], (pad, (0, 0))),
                       np.pad(valid[idx], pad)))
    return shards, lps, ops


def sha(a):
    """sha256 of an array's bytes."""
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def sorted_rows_sha(torch, rows):
    """:func:`sha` of ``[N, 4]`` float32 rows sorted lexicographically by
    their bits, on the card: the raw cloud's digest, whose row order
    follows the stream shards."""
    t = torch.from_numpy(np.ascontiguousarray(rows)).cuda()
    bits = t.view(torch.int32)
    order = torch.arange(t.shape[0], device=t.device)
    for col in range(t.shape[1] - 1, -1, -1):
        order = order[torch.sort(bits[order, col], stable=True)[1]]
    return sha(t[order].cpu().numpy())


def sharded_rank(rank, shape, frames, opts):
    """One rank of the ``[sharded]`` phase: the publish configuration at
    "packed" through ``ShardedFusionEngine`` on a ``shape`` mesh for
    ``frames`` frames, synchronous (and on a 1 x 1 mesh also pipelined),
    the launches of each run counted from 0; the host views (collective)
    digested frame by frame; ``segment_and_track`` on the last frame.
    ``opts``: ``cards``, the cards the ranks spread over (rank r on
    ``cuda:r % cards``); ``with_single``, the single engine runs the same
    frames in this process first, and every frame of the sharded engine is
    held to it exactly, its objects and tracks too; ``window``, a BA window
    (numpy, or None) that the sharded BA solves over the stream axis
    (:func:`sharded_ba`); ``gpu``, the ``nvidia-smi`` line (or None), and
    then rank 0 holds each kernel call of the synchronous run's frame
    ``RECORD_FRAME`` to its twin and times it (:func:`time_site`). Returns
    the numbers."""
    import torch
    from ros_gpu_depthmap_fusion_tpu_torch.core import transforms
    from ros_gpu_depthmap_fusion_tpu_torch.core.camera import (
        PinholeIntrinsics)
    from ros_gpu_depthmap_fusion_tpu_torch.core.config import FusionConfig
    from ros_gpu_depthmap_fusion_tpu_torch.ops import mask_ops, voxelize
    from ros_gpu_depthmap_fusion_tpu_torch.ops.kernels import (
        compact, flying_pixels, fused_unproject_rle, segreduce)
    from ros_gpu_depthmap_fusion_tpu_torch.parallel import (
        STREAM_AXIS, make_mesh, sharded)
    from ros_gpu_depthmap_fusion_tpu_torch.parallel.engine import (
        ShardedFusionEngine)
    from ros_gpu_depthmap_fusion_tpu_torch.pipeline import engine as engmod
    from ros_gpu_depthmap_fusion_tpu_torch.slam import ba
    mesh = make_mesh(*shape, device=torch.device("cuda",
                                                 rank % opts["cards"]))
    kmods = {"segreduce": segreduce, "flying_pixels": flying_pixels,
             "compact": compact, "fused_unproject_rle": fused_unproject_rle}
    record_mods = [("segreduce", voxelize, "segreduce"),
                   ("flying_pixels", sharded, "filter_flying_pixels"),
                   ("compact", mask_ops, "compact_rows")]
    cfg = publish_config(FusionConfig, voxel_mean_mode="packed")
    scene = Scene(transforms, seed=0)
    intr = PinholeIntrinsics.default_for(W, H)
    res = dict(launches={}, ms={}, digests={})
    calls = {}

    def drive(eng, record=False):
        """``frames`` frames through ``eng`` (then ``flush()`` when
        pipelined), recording the kernel calls of frame ``RECORD_FRAME``
        into ``calls`` if ``record``: the outputs, and the wall ms a frame
        of frames 1.. ending with a synchronize."""
        outs = []
        for f in range(frames):
            if f == 1:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            box = []

            def run(f=f):
                box.append(eng.process(scene.stage(eng, intr, f)))
            if record and f == RECORD_FRAME:
                calls.update(record_calls(record_mods, run))
            else:
                run()
            if box[0] is not None:
                outs.append(box[0])
        if eng.pipeline_depth:
            outs.append(eng.flush())
        torch.cuda.synchronize()
        return outs, (time.perf_counter() - t0) * 1e3 / (frames - 1)

    single = None
    if opts["with_single"]:
        eng = engmod.FusionEngine(cfg, mesh.device, enable_mapping=True)
        s_outs, res["ms"]["single"] = drive(eng)
        single = [dict(occ=o.occupancy_u8.cpu().numpy(),
                       raw=o.raw_points[:int(o.raw_count)].cpu().numpy(),
                       fused=o.fused_points[:int(o.fused_count)].cpu()
                       .numpy()) for o in s_outs]
        single_map = eng.segment_and_track(s_outs[-1])
        eng.close()
        del eng, s_outs
    sx = f"{shape[0]}x{shape[1]}"
    for depth in ((0, 1) if opts["with_single"] else (0,)):
        path = f"sharded_{sx}" + ("_pipelined" if depth else "")
        eng = ShardedFusionEngine(cfg, mesh, pipeline_depth=depth,
                                  enable_mapping=True)
        zero_counts(kmods)
        outs, res["ms"][path] = drive(eng, record=depth == 0)
        res["launches"][path] = check_launches(kmods, EXPECTED[path], frames,
                                               path)
        if len(outs) != frames or eng._last_bits <= 0:
            raise AssertionError(f"{path}: {len(outs)} outputs, last dpcm "
                                 f"width {eng._last_bits}")
        digests = []
        for f, o in enumerate(outs):
            v = dict(occ=eng.occupancy_host(o),
                     bits=eng.occupancy_grid_from_bits(o).reshape(-1),
                     raw=eng.raw_points_host(o),
                     fused=eng.fused_points_host(o))
            if not np.array_equal(v["bits"], (v["occ"] > 0)
                                  .astype(np.uint8)):
                raise AssertionError(f"{path} frame {f}: occupancy_grid_"
                                     "from_bits != (occupancy > 0)")
            if single is not None:
                for k in ("occ", "raw", "fused"):
                    if not np.array_equal(v[k], single[f][k]):
                        raise AssertionError(f"{path} frame {f}: {k} != "
                                             "the single engine's")
            digests.append((sha(v["occ"]), len(v["raw"]),
                            sorted_rows_sha(torch, v["raw"]),
                            len(v["fused"]), sha(v["fused"])))
        res["digests"][path] = digests
        mapped = eng.segment_and_track(outs[-1])
        if single is not None:
            same(mapped, single_map, f"{path}: segment_and_track vs the "
                 "single engine's")
        res["mapping"] = mapped
        res["raw_last"], res["fused_last"] = digests[-1][1], digests[-1][3]
        eng.close()
        del eng, outs
    if opts["window"] is not None:
        res["ba"] = sharded_ba(torch, ba, mesh, STREAM_AXIS, opts["window"],
                               f"sharded {sx}")
    if opts["gpu"] is not None and rank == 0:
        path = f"sharded_{sx}"
        res["sites"] = {}
        for name, wrapper in kernel_wrappers().items():
            if len(calls.get(name, ())) != EXPECTED[path][name]:
                raise AssertionError(f"{name} on {path}: recorded "
                                     f"{len(calls.get(name, ()))} calls")
            res["sites"][name] = time_site(
                torch, name, calls[name], wrapper,
                f"{path} rank 0, frame {RECORD_FRAME}",
                res["launches"][path][name] / frames, opts["gpu"])
    return res


def sharded_ba(torch, ba, mesh, axis, window, what):
    """``build_sharded_ba_step`` (``BA_ITERS`` iterations) on this rank's
    landmark shard of ``window`` over ``axis``, held to ``solve_window``'s
    iterations on the whole window on this rank's card by
    :func:`ba_agree` (tie-aware: poses within 1e-4 m and 1e-4 rad where
    every accept decision agrees), the last chi2 within 1e-3 relative
    (``tests/test_slam.py:175-211``); timed with CUDA events (every rank of
    the axis calls it together), ``solve_window`` too on a one-rank mesh.
    Returns the numbers."""
    shards, lps, ops = shard_window(window, mesh.shape[axis])

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(mesh.device)
    step = ba.build_sharded_ba_step(mesh, axis, len(window[0]), lps, ops,
                                    iterations=BA_ITERS)
    sh = [t(a) for a in shards[mesh.stream_id if axis == "stream"
                               else mesh.space_id]]
    poses0 = t(window[0])
    poses, _, chi2s, cands = step(poses0, *sh)
    whole = ba.BAProblem(*map(t, window))
    ref = ba._iterate(whole, BA_ITERS, 1e-4)
    out = ba_agree((poses, chi2s, cands), (ref[0], ref[2], ref[3]),
                   names=(what, "solve_window"))
    last = (float(chi2s[-1]), float(ref[2][-1]))
    if abs(last[0] - last[1]) > 1e-3 * last[1]:
        raise AssertionError(f"{what} BA: last chi2 {last}")
    out.update(chi2=(float(chi2s[0]), float(chi2s[-1])),
               window=tuple(len(a) for a in window[:3]),
               sharded_ms=cuda_ms(torch, lambda: step(poses0, *sh), reps=5,
                                  warm=1))
    if mesh.size == 1:
        out["solve_ms"] = cuda_ms(
            torch, lambda: ba.solve_window(whole, BA_ITERS), reps=5, warm=1)
    return out


def check_world(results, path, one):
    """Every rank of a world: each frame's digests and its
    ``segment_and_track`` equal to the 1 x 1 run ``one``'s."""
    for r, res in enumerate(results):
        if res["digests"][path] != one["digests"]["sharded_1x1"]:
            raise AssertionError(f"{path} rank {r}: a frame differs from "
                                 "the 1x1 run")
        same(res["mapping"], one["mapping"], f"{path} rank {r}: "
             "segment_and_track vs 1x1")


def sharded_phase(gpu, window):
    """The distributed engine on the card at full width: the publish
    configuration at "packed", 8 cameras at 848x480, on one rank over NCCL
    (mesh 1 x 1; synchronous and pipelined, every frame held to the single
    engine) and on four ranks sharing the card over gloo (mesh stream 2 x
    space 2, 4 cameras a rank; every frame's digests equal to the 1 x 1
    run's); the sharded BA on ``window`` (a BA window of the SLAM run) in
    both; rank 0 of each world times its kernel call sites. The kernels
    and the native library are built before any rank starts. Returns
    launches by path and the call sites' numbers by path."""
    from ros_gpu_depthmap_fusion_tpu_torch.parallel import spawn
    # one host: NCCL's bootstrap and gloo's pairs on the loopback
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    opts = dict(cards=1, window=window, gpu=gpu)
    t0 = time.perf_counter()
    # each rank's host threads: spawn's default, the cores split over the
    # ranks
    one = spawn(sharded_rank, 1, "nccl", timeout=120, join_timeout=400,
                args=((1, 1), SHARDED_FRAMES, dict(opts, with_single=True)))[0]
    t1 = time.perf_counter()
    four = spawn(sharded_rank, 4, "gloo", timeout=120, join_timeout=400,
                 args=((2, 2), SHARDED_FRAMES,
                       dict(opts, with_single=False)))
    t2 = time.perf_counter()
    if one["digests"]["sharded_1x1_pipelined"] != \
            one["digests"]["sharded_1x1"]:
        raise AssertionError("sharded 1x1: pipelined digests differ")
    check_world(four, "sharded_2x2", one)
    two = four[0]
    launches = dict(one["launches"], **two["launches"])
    ms = dict(one["ms"], **two["ms"])
    b1, b2 = one["ba"], two["ba"]
    print(f"[sharded] publish config at packed (dpcm link, 8 x 848x480, "
          f"3,360,000 cells), {SHARDED_FRAMES} frames: mesh 1x1 on NCCL "
          f"(local capacity 3,354,624) and mesh stream 2 x space 2 on gloo, "
          f"4 ranks sharing cuda:0 (4 cameras a rank, local capacity "
          f"1,677,312) | ms/frame (frames 1.., ends with a synchronize): "
          f"single engine {ms['single']:.2f}, sharded 1x1 "
          f"{ms['sharded_1x1']:.2f}, 1x1 pipelined "
          f"{ms['sharded_1x1_pipelined']:.2f} (same process); 2x2 "
          f"{ms['sharded_2x2']:.2f} (rank 0) | every 1x1 frame == the "
          f"single engine (occupancy, raw rows in order, fused rows), "
          f"bits == occupancy > 0, pipelined == sync; every 2x2 frame's "
          f"digests == 1x1's on all 4 ranks | raw {one['raw_last']}, fused "
          f"{one['fused_last']} (last frame) | segment_and_track == single "
          f"({len(one['mapping'].objects)} objects, "
          f"{len(one['mapping'].tracks)} tracks), 2x2 == 1x1 | BA window "
          f"of the SLAM run {b1['window']} (poses, landmarks, observations),"
          f" {BA_ITERS} iterations: sharded 1x1 vs solve_window accepted "
          f"{b1['ba_accepts'][0]} / {b1['ba_accepts'][1]} (ties "
          f"{b1['ba_ties']}), poses within {b1['ba_t_err']:.1e} m / "
          f"{b1['ba_r_err']:.1e} rad; 2x2 over stream accepted "
          f"{b2['ba_accepts'][0]} (ties {b2['ba_ties']}), within "
          f"{b2['ba_t_err']:.1e} m / {b2['ba_r_err']:.1e} rad; chi2 "
          f"{b1['chi2'][0]:.4g} -> {b1['chi2'][1]:.4g}; call ms sharded "
          f"1x1 {b1['sharded_ms']:.3f}, 2x2 {b2['sharded_ms']:.3f} (4 "
          f"processes on one card, gloo through host memory), solve_window "
          f"{b1['solve_ms']:.3f} | launches {launches} | phase "
          f"{t2 - t0:.1f} s (1x1 world {t1 - t0:.1f} s, 2x2 {t2 - t1:.1f} "
          f"s, rank start-up and rank 0's kernel timing included) | {gpu}",
          flush=True)
    return launches, {"sharded_1x1": one["sites"],
                      "sharded_2x2": two["sites"]}


def first_ba_window(device):
    """The SLAM run's first BA window without the whole run: the hard
    synthetic sequence's first :data:`BA_WINDOW_FRAMES` frames (rendered
    at the full sequence's orbit rate, so the same frames) through
    ``run_tum_sequence``'s SLAM poses on ``device``; the window its first
    ``run_ba`` solves (numpy: poses, landmarks, obs_pose, obs_lm, obs_pt,
    obs_valid)."""
    import tempfile
    from ros_gpu_depthmap_fusion_tpu_torch.pipeline import tum_runner
    from ros_gpu_depthmap_fusion_tpu_torch.slam import frontend
    windows = []
    solve = frontend.solve_window

    def keep_window(problem, **kw):
        if not windows:
            windows.append(problem)
        return solve(problem, **kw)
    frontend.solve_window = keep_window
    try:
        with tempfile.TemporaryDirectory(prefix="tum_hard_") as root:
            tum_runner.write_hard_synthetic_tum_sequence(
                root, n_frames=BA_WINDOW_FRAMES, orbit_frames=TUM_FRAMES)
            tum_runner.run_tum_sequence(root, pose_source="slam",
                                        ba_every=8, device=device)
    finally:
        frontend.solve_window = solve
    if not windows:
        raise AssertionError(f"no BA window in {BA_WINDOW_FRAMES} frames")
    return tuple(t.cpu().numpy() for t in windows[0])


def sharded_nccl_main():
    """``--sharded-nccl``: the distributed engine over NCCL, one rank a
    card, on four cards (see the module's docstring)."""
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        raise SystemExit("chip_smoke.py --sharded-nccl: needs four CUDA "
                         "devices")
    sys.path.insert(0, HERE)
    from ros_gpu_depthmap_fusion_tpu_torch.ops.kernels import _build
    from ros_gpu_depthmap_fusion_tpu_torch.parallel import spawn
    from ros_gpu_depthmap_fusion_tpu_torch.utils import native
    gpu = gpu_line()
    print(f"[env] gpu: {gpu} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | {torch.cuda.get_device_name(0)} "
          f"x{torch.cuda.device_count()}", flush=True)
    _build.build_info()
    native.require()
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    t0 = time.perf_counter()
    window = first_ba_window("cuda:0")
    t_window = time.perf_counter() - t0
    opts = dict(cards=4, window=window, gpu=None, with_single=False)
    t0 = time.perf_counter()
    one = spawn(sharded_rank, 1, "nccl", timeout=120, join_timeout=300,
                args=((1, 1), SHARDED_FRAMES, dict(opts, with_single=True)))[0]
    times, launches, ms = [time.perf_counter() - t0], dict(one["launches"]), {}
    bas = {"1x1": one["ba"]}
    for shape in ((2, 2), (4, 1)):
        t0 = time.perf_counter()
        sx = f"{shape[0]}x{shape[1]}"
        path = f"sharded_{sx}"
        world = spawn(sharded_rank, 4, "nccl", timeout=120, join_timeout=300,
                      args=(shape, SHARDED_FRAMES, opts))
        check_world(world, path, one)
        launches.update(world[0]["launches"])
        ms[path] = [round(w["ms"][path], 2) for w in world]
        bas[sx] = world[0]["ba"]
        times.append(time.perf_counter() - t0)
    ba_part = "; ".join(
        f"{sx} accepted {b['ba_accepts'][0]} / solve_window "
        f"{b['ba_accepts'][1]} (ties {b['ba_ties']}), poses within "
        f"{b['ba_t_err']:.1e} m / {b['ba_r_err']:.1e} rad, call ms "
        f"{b['sharded_ms']:.3f}" for sx, b in bas.items())
    print(f"[sharded nccl] publish config at packed, {SHARDED_FRAMES} "
          f"frames, one rank a card over NCCL: mesh 1x1 == the single "
          f"engine every frame; meshes 2x2 and 4x1 on cuda:0-3, every "
          f"frame's digests and segment_and_track == 1x1's on every rank | "
          f"ms/frame (frames 1.., ends with a synchronize): single "
          f"{one['ms']['single']:.2f}, 1x1 {one['ms']['sharded_1x1']:.2f}, "
          f"by rank {ms} | launches {launches} | sharded BA over the "
          f"stream axis, {BA_ITERS} iterations, on the SLAM run's first "
          f"window {one['ba']['window']} (poses, landmarks, observations; "
          f"{BA_WINDOW_FRAMES} frames in {t_window:.1f} s), rank 0 against "
          f"solve_window on its card: {ba_part}; solve_window "
          f"{one['ba']['solve_ms']:.3f} ms | worlds "
          f"{', '.join(f'{x:.1f}' for x in times)} s (rank start-up "
          f"included) | {gpu}", flush=True)
    print(gpu)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


def time_site(torch, name, site_calls, wrapper, what, per_frame, gpu):
    """Hold engine kernel ``name`` to its twin on each recorded call of a
    frame (exact), and time them: per frame, the device ms, call ms,
    bound, and the twin's; for compact also ``rows[flags]``. Prints one
    ``[kernel]`` line and returns the numbers."""
    kern, twin = wrapper
    errs, shapes, per_call = [], [], []
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
        errs.append(err)
        nbytes, ops = work_of(name, a, ref)
        bound, bound_by = roofline(nbytes, ops)
        one = dict(ms=device_ms(torch, lambda: kern(*a, **k)),
                   call_ms=cuda_ms(torch, lambda: kern(*a, **k)),
                   plain_ms=device_ms(torch, lambda: twin(*a, **k)),
                   plain_call_ms=cuda_ms(torch, lambda: twin(*a, **k)),
                   bound_ms=bound)
        for key in tot:
            tot[key] += one[key]
        per_call.append(f"{one['ms']:.4f}/{bound:.4f}")
        shapes.append("x".join(map(str, a[0].shape)))
    if name == "flying_pixels":
        # the halo wider than one pixel, at the full image size
        pts, mask, fh, fw, _, thr, _, maxd = site_calls[0][0]
        for rings in (2, 3):
            wide = (pts[:2], mask[:2], fh, fw, rings, thr, True, maxd)
            if not torch.equal(kern(*wide), twin(*wide)):
                raise AssertionError(f"{name}: kernel != twin with "
                                     f"{rings} rings")
    library = None
    if name == "compact":
        # one PyTorch call computes the same rows: boolean indexing (its
        # nonzero syncs the host; device time counts no gaps), per frame
        # over the same calls
        library = sum(device_ms(torch, lambda: a[0][a[1]])
                      for a, _, _ in site_calls)
    print(f"[kernel] {name} on {'+'.join(shapes)} ({what}), per frame "
          f"({len(site_calls)} call(s), launches_per_frame {per_frame:g}): "
          f"max_abs_err {max(errs)} | device ms {tot['ms']:.4f} (per call "
          f"device/bound {', '.join(per_call)}) | call_ms "
          f"{tot['call_ms']:.4f} | bound_ms {tot['bound_ms']:.4f} "
          f"({bound_by}, {tot['bound_ms'] / tot['ms']:.2f} of the bound "
          f"reached) | plain device {tot['plain_ms']:.4f} ms, call "
          f"{tot['plain_call_ms']:.4f} ms | library_ms "
          f"{'none' if library is None else f'{library:.4f}'} | {gpu}",
          flush=True)
    return dict(max_abs_err=max(errs), bound_by=bound_by, library_ms=library,
                launches_per_frame=per_frame, **tot)


def main():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py: no CUDA device; this script "
                         "measures the port on a GPU and has no CPU mode")
    sys.path.insert(0, HERE)
    from ros_gpu_depthmap_fusion_tpu_torch.core import config, transforms
    from ros_gpu_depthmap_fusion_tpu_torch.core.config import FusionConfig
    from ros_gpu_depthmap_fusion_tpu_torch.core.camera import (
        PinholeIntrinsics)
    from ros_gpu_depthmap_fusion_tpu_torch.ops import (
        mask_ops, unproject, voxelize)
    from ros_gpu_depthmap_fusion_tpu_torch.ops.kernels import (
        _build, compact, flying_pixels, fused_unproject_rle, segreduce)
    from ros_gpu_depthmap_fusion_tpu_torch.pipeline import engine as engmod
    from ros_gpu_depthmap_fusion_tpu_torch.utils import native

    kmods = {"segreduce": segreduce, "flying_pixels": flying_pixels,
             "compact": compact, "fused_unproject_rle": fused_unproject_rle}
    wrappers = kernel_wrappers()

    # -- 1. environment --
    gpu = gpu_line()
    nvcc = _build.find_nvcc()
    nvcc_ver = subprocess.run([nvcc, "--version"], capture_output=True,
                              text=True, check=True).stdout.strip() \
        .splitlines()[-1]
    print(f"[env] gpu: {gpu} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | nvcc {nvcc_ver} | "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}",
          flush=True)

    # -- 2. build --
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

    cfg = link_config(FusionConfig)
    intr = PinholeIntrinsics.default_for(W, H)
    t0 = time.perf_counter()
    scene = Scene(transforms, seed=0)
    print(f"[scene] seed 0, {N_STAGED} staged frames, "
          f"{time.perf_counter() - t0:.1f}s", flush=True)

    # -- 3. the link: bench.py's frame, pipelined (the main path) --
    eng = engmod.FusionEngine(cfg, device="cuda", pipeline_depth=1)
    encodes = []
    encode = eng._encode

    def tap_encode(pkt, depth_host, scalars):
        t = time.perf_counter()
        words, bits = encode(pkt, depth_host, scalars)
        encodes.append((bits, int(pkt.buf[0]), len(words),
                        (time.perf_counter() - t) * 1e3))
        return words, bits
    eng._encode = tap_encode
    last_step = []
    record_mods = [("segreduce", voxelize, "segreduce"),
                   ("flying_pixels", engmod, "filter_flying_pixels"),
                   ("compact", mask_ops, "compact_rows"),
                   ("unproject", engmod, "unproject_depthmaps")]
    zero_counts(kmods)
    outs, bits, link_ms, (host_ms, step_ms), calls = run_engine(
        torch, eng, scene, intr, LINK_FRAMES, kmods, EXPECTED["link"],
        step_tap=keep_last(last_step), record=(RECORD_FRAME, record_mods))
    launches = check_launches(kmods, EXPECTED["link"], LINK_FRAMES, "link")
    per_frame = {n: launches[n] / LINK_FRAMES for n in KERNELS}
    by_path = {"link": dict(launches)}
    if len(outs) != LINK_FRAMES:
        raise AssertionError(f"link: {len(outs)} outputs")
    if not (isinstance(bits[0], int) and bits[0] > 0) \
            or any(b != "p4" for b in bits[1:]):
        raise AssertionError(f"link: frame kinds {bits}, expected an "
                             "I-keyframe then p4 P-frames")
    exc = [e[1] for e in encodes]
    if max(exc) > cfg.depth_codec_max_exceptions:
        raise AssertionError(f"link: exceptions {max(exc)}")
    max_partials = check_frame_outputs(cfg, eng, outs, "link")
    ref = replay_plain(engmod, eng, last_step[0])
    assert_outputs_equal(torch, outs[-1], ref, "link last frame vs the "
                         "plain-twin step")
    del last_step[:]
    sync = engmod.FusionEngine(cfg, device="cuda", pipeline_depth=0)
    s_outs, s_bits, sync_ms, _, _ = run_engine(torch, sync, scene, intr,
                                               LINK_FRAMES, kmods,
                                               EXPECTED["link"])
    if s_bits != bits:
        raise AssertionError(f"link: sync frame kinds {s_bits} != {bits}")
    for f, (a, b) in enumerate(zip(outs, s_outs)):
        assert_outputs_equal(torch, a, b, f"link frame {f} pipelined vs "
                             "pipeline_depth=0")
    del sync, s_outs
    sm_bits = small_rig_equal(torch, engmod, link_config, FusionConfig,
                              transforms, PinholeIntrinsics, 1, "link")
    enc_ms = [e[3] for e in encodes[:LINK_FRAMES]]
    pkt_kb = [4 * e[2] / 1e3 for e in encodes[:LINK_FRAMES]]
    n_i = sum(1 for b in bits if b != "p4")
    print(f"[link] bench.py:120-182 as written, pipeline_depth=1, "
          f"{LINK_FRAMES} frames + flush: {link_ms:.2f} ms/frame "
          f"(frames 4.., ends with a synchronize; pipeline_depth=0: "
          f"{sync_ms:.2f}) | host process() median "
          f"{float(np.median(host_ms[4:])):.2f} ms (step enqueue "
          f"{float(np.median(step_ms[4:])):.2f}), encode median "
          f"{float(np.median(enc_ms[4:])):.2f} ms (I-frame "
          f"{enc_ms[0]:.2f}) | I/P {n_i}/{len(bits) - n_i} (frame 0 at "
          f"B={bits[0]}) | exceptions max {max(exc)} of "
          f"{cfg.depth_codec_max_exceptions} | packet median "
          f"{float(np.median(pkt_kb[1:])):.1f} KB (I {pkt_kb[0]:.1f} KB) | "
          f"level-1 partials max {max_partials} of "
          f"{cfg.voxelize_partials_capacity} | fused "
          f"{int(outs[-1].fused_count)} cells, lidar selected "
          f"{int(outs[-1].seq_selected_count)} | launches {launches} | "
          f"native {native._LIB_PATH} | plain-twin step equal; pipelined "
          f"== sync; small rig card == cpu (last bits {sm_bits}) | {gpu}",
          flush=True)
    grid = eng.grid
    del eng, outs

    # -- 4. the raw link (PR 1's engine phase, fewer frames) --
    raw = bench_config(FusionConfig)
    eng = engmod.FusionEngine(raw, device="cuda")
    zero_counts(kmods)
    last_step = []
    outs, _, raw_ms, _, _ = run_engine(
        torch, eng, scene, intr, RAW_FRAMES, kmods, EXPECTED["raw"],
        step_tap=keep_last(last_step))
    raw_launches = check_launches(kmods, EXPECTED["raw"], RAW_FRAMES, "raw")
    by_path["raw"] = raw_launches
    raw_partials = check_frame_outputs(raw, eng, outs, "raw")
    ref = replay_plain(engmod, eng, last_step[0])
    assert_outputs_equal(torch, outs[-1], ref, "raw last frame vs the "
                         "plain-twin step")
    small_rig_equal(torch, engmod, bench_config, FusionConfig, transforms,
                    PinholeIntrinsics, 0, "raw")
    print(f"[raw] depth_link_codec='none', {RAW_FRAMES} frames: "
          f"{raw_ms:.2f} ms/frame (frames 4.., ends with a synchronize) | "
          f"level-1 partials max {raw_partials} of "
          f"{raw.voxelize_partials_capacity} | launches {raw_launches} | "
          f"plain-twin step equal; small rig card == cpu | {gpu}",
          flush=True)
    del eng, outs, ref

    # -- 5. FusionConfig()'s defaults: the publish path, a heterogeneous
    #    rig, every mode on a small rig card == CPU --
    pub_calls, packed_calls, pub_launches, pub_taps = publish_phase(
        torch, engmod, FusionConfig, scene, intr, kmods, record_mods, gpu)
    by_path.update(pub_launches)
    by_path.update(hetero_phase(torch, engmod, FusionConfig,
                                PinholeIntrinsics, scene, kmods, gpu))
    by_path.update(presets_phase(torch, engmod, config, PinholeIntrinsics,
                                 scene, kmods, gpu))
    small_rigs_publish(torch, engmod, FusionConfig, transforms,
                       PinholeIntrinsics, gpu)

    # -- 6. mapping on --
    mapping_phase(torch, engmod, cfg, scene, intr, kmods, native, gpu)

    # -- 7. the SLAM path: the TUM runner on the hard synthetic sequence --
    tum_launches, window = tum_phase(torch, engmod, kmods, gpu)
    by_path.update(tum_launches)

    # -- 7b. the distributed engine: 1 rank on NCCL, 4 ranks on gloo --
    torch.cuda.empty_cache()
    sharded_launches, sharded_sites = sharded_phase(gpu, window)
    by_path.update(sharded_launches)

    # -- 8. each engine kernel against its twin at each call site: the
    #    recorded link frame, the publish frame (the raw cloud's compaction,
    #    level 1 + level 2 over it) and the packed frame (one reduction of
    #    the sorted stream); after the loops, so that torch.profiler cannot
    #    touch them --
    results, sites = {}, {}
    for name in ENGINE_KERNELS:
        if len(calls.get(name, ())) != EXPECTED["link"][name]:
            raise AssertionError(f"{name}: recorded "
                                 f"{len(calls.get(name, ()))} calls")
        results[name] = time_site(torch, name, calls[name], wrappers[name],
                                  f"link frame {RECORD_FRAME}",
                                  per_frame[name], gpu)
        sites.setdefault(name, {})["link"] = results[name]
    for name, site, site_calls, path in (
            ("compact", "publish raw cloud", pub_calls, "publish"),
            ("segreduce", "publish level 1 + 2 on the raw cloud",
             pub_calls, "publish"),
            ("segreduce", "publish packed, the sorted stream", packed_calls,
             "publish_packed")):
        if len(site_calls.get(name, ())) != EXPECTED[path][name]:
            raise AssertionError(f"{name} at {site}: recorded "
                                 f"{len(site_calls.get(name, ()))} calls")
        sites[name][path] = time_site(
            torch, name, site_calls[name], wrappers[name],
            f"{site}, frame {RECORD_FRAME}",
            by_path[path][name] / PUBLISH_FRAMES, gpu)
    for path, per_kernel in sharded_sites.items():
        for name, r in per_kernel.items():
            sites[name][path] = r

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

    # -- 9. kernel 4, the fused front, on the recorded frame --
    depth_masked, (k_intr, k_tfw, k_tfc, scale), fargs = fused_inputs(
        torch, calls, cfg, grid)
    depth_m, cap = fargs[0], fargs[7]
    # kernel 4's own path: this call, counted from 0
    fused_unproject_rle.launches = 0
    got = fused_unproject_rle.unproject_voxelize_l1(*fargs)
    torch.cuda.synchronize()
    launches["fused_unproject_rle"] = fused_unproject_rle.launches
    ref = fused_unproject_rle.unproject_voxelize_l1_plain(*fargs)
    err = max_abs_err(torch, got, ref)
    if err != 0.0:
        raise AssertionError(f"fused_unproject_rle: kernel != twin, max abs "
                             f"err {err} (exact required)")
    # without forced breaks runs cross the kernel's tiles and rows
    free = max_abs_err(
        torch, fused_unproject_rle.unproject_voxelize_l1(*fargs, 0),
        fused_unproject_rle.unproject_voxelize_l1_plain(*fargs, 0))
    if free != 0.0:
        raise AssertionError(f"fused_unproject_rle: kernel != twin at "
                             f"force_break=0, max abs err {free}")

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
    same = lf[:, 3] == lc[:, 3]
    counts_differ = int((~same).sum())
    moved = int((lf[:, 3] - lc[:, 3]).abs().sum()) // 2
    sum_err = float((lf[same, :3] - lc[same, :3]).abs().max())
    valid_diff = int(got[4]) - int(cm.sum())
    def fused():
        return fused_unproject_rle.unproject_voxelize_l1(*fargs)

    def fused_plain():
        return fused_unproject_rle.unproject_voxelize_l1_plain(*fargs)
    f_ms, f_call_ms = device_ms(torch, fused), cuda_ms(torch, fused)
    f_plain_ms = device_ms(torch, fused_plain)
    chain_ms, chain_call_ms = device_ms(torch, chain), cuda_ms(torch, chain)
    f_bound, f_bound_by = roofline(*fused_work(fargs, int(got[4])))
    results["fused_unproject_rle"] = dict(
        max_abs_err=err, ms=f_ms, call_ms=f_call_ms, plain_ms=f_plain_ms,
        bound_ms=f_bound, bound_by=f_bound_by, library_ms=None)
    shape = "x".join(map(str, depth_m.shape))
    print(f"[fused] unproject_voxelize_l1 on {shape} (link frame "
          f"{RECORD_FRAME}, masked metric "
          f"depth), capacity {cap}: max_abs_err {err} in all five outputs "
          f"(force_break=0: {free}) | "
          f"runs {int(got[3])} (chain's level 1: {int(ct)}), valid points "
          f"{int(got[4])} | launches_per_frame "
          f"{per_frame['fused_unproject_rle']:g} on the link | device ms "
          f"{f_ms:.4f} | "
          f"call_ms {f_call_ms:.4f} | bound_ms {f_bound:.4f} ({f_bound_by}, "
          f"{f_bound / f_ms:.2f} of the bound reached) | plain device "
          f"{f_plain_ms:.4f} ms | library_ms none | the engine's chain: "
          f"device {chain_ms:.4f} ms, call {chain_call_ms:.4f} ms | level-2 "
          f"closure "
          f"vs the chain: {cells_differ} cells differ in occupancy, "
          f"{counts_differ} in count ({moved} points changed cell), max sum "
          f"diff {sum_err:.1f} quantization steps where counts agree, "
          f"valid-count diff {valid_diff} | launches "
          f"{launches['fused_unproject_rle']} | {gpu}", flush=True)
    del calls, got, ref

    # the link run's numbers at the top level (launches: its counts), and
    # per path the launches a frame and, where timed, the call site's
    steps = {"link": LINK_FRAMES, "raw": RAW_FRAMES,
             "publish": PUBLISH_FRAMES, "publish_sync": PUBLISH_FRAMES,
             "publish_packed": PUBLISH_FRAMES, "publish_exact": 2,
             "publish_occupied": 2, "hetero": HETERO_FRAMES,
             "hetero_sync": HETERO_FRAMES, "hafen": PRESET_FRAMES,
             "office": PRESET_FRAMES, "tum": TUM_FRAMES,
             "tum_gt": TUM_GT_FRAMES, "sharded_1x1": SHARDED_FRAMES,
             "sharded_1x1_pipelined": SHARDED_FRAMES,
             "sharded_2x2": SHARDED_FRAMES}
    kernels = [dict(name=name, route="cuda", source=SOURCES[name],
                    replaces=REPLACES[name], launches=launches[name],
                    launches_per_frame=per_frame[name],
                    **{k: results[name][k] for k in (
                        "max_abs_err", "ms", "call_ms", "plain_ms",
                        "bound_ms", "bound_by", "library_ms")},
                    launches_per_frame_by_path={
                        path: by_path[path][name] / n
                        for path, n in steps.items()},
                    sites={path: {k: v for k, v in r.items()
                                  if k != "plain_call_ms"}
                           for path, r in sites.get(name, {}).items()})
               for name in KERNELS]
    for path, n in steps.items():
        for name in ENGINE_KERNELS:
            if EXPECTED[path][name] and by_path[path][name] <= 0:
                raise AssertionError(f"{path}: {name} was not launched")
    if any(k["launches"] <= 0 for k in kernels):
        raise AssertionError(f"a kernel was not launched: {kernels}")
    print(json.dumps({"kernels": kernels}))
    print(gpu)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    if sys.argv[1:] == ["--sharded-nccl"]:
        sharded_nccl_main()
    elif sys.argv[1:]:
        raise SystemExit(f"chip_smoke.py: unknown arguments {sys.argv[1:]}")
    else:
        main()
