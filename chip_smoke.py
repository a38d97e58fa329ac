#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main path (``ros_gpu_depthmap_fusion_tpu_torch``) at the
operating point of ``bench.py``: 8 depth cameras at 848x480 plus 2 lidar
streams of 8192 points into a 400x400x21 = 3,360,000-cell grid, on the raw
depth link (``depth_link_codec="none"``). Phases, one line each:

1. environment: the card's name and power limit (``nvidia-smi``), torch,
   CUDA and nvcc versions;
2. build: compile the CUDA kernels from ``csrc/`` with nvcc;
3. kernels: record each kernel's inputs from one frame of the engine,
   check the kernel against its plain PyTorch twin on them (exact for
   segreduce and compact; equal masks for flying pixels) and time both
   (CUDA events, median of 20 runs after 3 warm-up runs);
4. engine: 20 frames through ``add_depthmap`` / ``add_point_sequence`` /
   ``process``; every kernel's launch counter must rise by its expected
   count each frame; the last frame is re-run with the plain twins from
   the same state and must give equal outputs; a small rig must give equal
   outputs on the card and on the CPU.

Then one JSON line with the kernels' names, sources, launch counts, errors
and times, the ``nvidia-smi`` line, and, last, ``{"ok": true, "device":
...}``. Any failure is an uncaught exception and a non-zero exit; without a
CUDA device it exits non-zero before printing any result.
"""

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
ENGINE_FRAMES = 20
KERNEL_FRAMES = 6      # frames before the recorded one (lidar window full)
EXPECTED_LAUNCHES = {"segreduce": 2, "flying_pixels": 1, "compact": 1}
REPLACES = {
    "segreduce": "ros_gpu_depthmap_fusion_tpu/ops/pallas/segreduce.py:233",
    "flying_pixels":
        "ros_gpu_depthmap_fusion_tpu/ops/pallas/flying_pixels.py:130",
    "compact": "ros_gpu_depthmap_fusion_tpu/ops/pallas/compact.py:268",
}
SOURCES = {
    "segreduce": "ros_gpu_depthmap_fusion_tpu_torch/csrc/segreduce.cu",
    "flying_pixels": "ros_gpu_depthmap_fusion_tpu_torch/csrc/flying_pixels.cu",
    "compact": "ros_gpu_depthmap_fusion_tpu_torch/csrc/compact.cu",
}


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

    def cams_at(self, f):
        tr = self.transforms
        yaw0 = 0.02 * np.sin(2 * np.pi * f / 60.0)  # rig sway
        out = []
        for i in range(self.c):
            ang = i * 2 * np.pi / self.c + yaw0
            pos = np.array([8 * np.cos(ang), 8 * np.sin(ang), 2.0])
            out.append(tr.make_se3(tr.rot_z(ang + np.pi)
                                   @ tr.rot_x(-np.pi / 2 - 0.3), pos))
        return out

    def stage(self, eng, intr, f):
        """Stage frame ``f`` into ``eng``; returns its timestamp."""
        d = self.depths[f % N_STAGED]
        cams = self.cams_at(f)
        for i in range(self.c):
            eng.add_depthmap(i, d[i], intr, cams[i], cams[i])
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
    """Median CUDA-event time of ``fn`` in ms."""
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


def record_kernel_inputs(mods, run_frame):
    """Run one frame with each kernel wrapper wrapped to record its
    arguments; returns ``{name: [(args, kwargs), ...]}``."""
    calls = {}
    patched = []
    for name, mod, attr in mods:
        orig = getattr(mod, attr)

        def rec(*a, _orig=orig, _name=name, **k):
            calls.setdefault(_name, []).append((a, k))
            return _orig(*a, **k)
        setattr(mod, attr, rec)
        patched.append((mod, attr, orig))
    try:
        run_frame()
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


def main():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py: no CUDA device; this script "
                         "measures the port on a GPU and has no CPU mode")
    sys.path.insert(0, HERE)
    from ros_gpu_depthmap_fusion_tpu_torch.core.config import FusionConfig
    from ros_gpu_depthmap_fusion_tpu_torch.core.camera import (
        PinholeIntrinsics)
    from ros_gpu_depthmap_fusion_tpu_torch.core import transforms
    from ros_gpu_depthmap_fusion_tpu_torch.ops import mask_ops, voxelize
    from ros_gpu_depthmap_fusion_tpu_torch.ops.kernels import (
        _build, compact, flying_pixels, segreduce)
    from ros_gpu_depthmap_fusion_tpu_torch.pipeline import engine as engmod

    kmods = {"segreduce": segreduce, "flying_pixels": flying_pixels,
             "compact": compact}
    wrappers = {"segreduce": (segreduce.segreduce, segreduce.segreduce_plain),
                "flying_pixels": (flying_pixels.filter_flying_pixels,
                                  flying_pixels.filter_flying_pixels_plain),
                "compact": (compact.compact_rows, compact.compact_plain)}

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
    print(f"[build] {time.perf_counter() - t0:.2f}s "
          f"(compiled={info['built']}) {info['path']} | ptxas: "
          + " ; ".join(regs), flush=True)

    cfg = bench_config(FusionConfig)
    intr = PinholeIntrinsics.default_for(W, H)
    t0 = time.perf_counter()
    scene = Scene(transforms, seed=0)
    print(f"[scene] seed 0, {N_STAGED} staged frames, "
          f"{time.perf_counter() - t0:.1f}s", flush=True)

    # -- 3. each kernel against its plain twin on the main path's inputs --
    eng = engmod.FusionEngine(cfg, device="cuda")
    for f in range(KERNEL_FRAMES):
        eng.process(scene.stage(eng, intr, f))
    calls = record_kernel_inputs(
        [("segreduce", voxelize, "segreduce"),
         ("flying_pixels", engmod, "filter_flying_pixels"),
         ("compact", mask_ops, "compact_rows")],
        lambda: eng.process(scene.stage(eng, intr, KERNEL_FRAMES)))
    torch.cuda.synchronize()
    results = {}
    for name in ("segreduce", "flying_pixels", "compact"):
        kern, twin = wrappers[name]
        if len(calls.get(name, ())) != EXPECTED_LAUNCHES[name]:
            raise AssertionError(f"{name}: recorded "
                                 f"{len(calls.get(name, ()))} calls")
        errs, ms, plain_ms, shapes = [], 0.0, 0.0, []
        for a, k in calls[name]:
            got = kern(*a, **k)
            ref = twin(*a, **k)
            torch.cuda.synchronize()
            err = max_abs_err(torch, got, ref)
            if err != 0.0:
                raise AssertionError(f"{name}: kernel != twin, max abs "
                                     f"err {err} (exact required)")
            errs.append(err)
            ms += cuda_ms(torch, lambda: kern(*a, **k))
            plain_ms += cuda_ms(torch, lambda: twin(*a, **k))
            shapes.append("x".join(map(str, a[0].shape)))
        results[name] = dict(max_abs_err=max(errs), ms=ms,
                             plain_ms=plain_ms)
        print(f"[kernel] {name} on {'+'.join(shapes)}: max_abs_err "
              f"{max(errs)} | kernel {ms:.4f} ms vs plain {plain_ms:.4f} ms "
              f"per frame ({len(calls[name])} call(s)) | {gpu}", flush=True)
    del eng, calls

    # -- 4. the engine: 20 frames through the user entry points --
    eng = engmod.FusionEngine(cfg, device="cuda")
    for m in kmods.values():
        m.launches = 0
    frame_ms, outs = [], []
    for f in range(ENGINE_FRAMES):
        before = {n: m.launches for n, m in kmods.items()}
        t0 = time.perf_counter()
        now = scene.stage(eng, intr, f)
        if f < ENGINE_FRAMES - 1:
            out = eng.process(now)
        else:  # last frame: keep its inputs and the state before it
            state_before = eng.state
            inp = eng.upload(now)
            out = eng.step(inp)
        torch.cuda.synchronize()
        frame_ms.append((time.perf_counter() - t0) * 1e3)
        for n, m in kmods.items():
            if m.launches - before[n] != EXPECTED_LAUNCHES[n]:
                raise AssertionError(
                    f"frame {f}: {n} launched {m.launches - before[n]} "
                    f"times, expected {EXPECTED_LAUNCHES[n]}")
        outs.append(out)
    launches = {n: m.launches for n, m in kmods.items()}

    last = outs[-1]
    max_partials = 0
    for f, o in enumerate(outs):
        vp, fc = int(o.vox_partials_count), int(o.fused_count)
        max_partials = max(max_partials, vp)
        if vp > cfg.voxelize_partials_capacity:
            raise AssertionError(f"frame {f}: partials {vp} overflow")
        if fc >= cfg.voxelize_output_capacity:
            raise AssertionError(f"frame {f}: fused_count {fc} at cap")
        if f >= 1 and int(o.seq_selected_count) <= 0:
            raise AssertionError(f"frame {f}: no lidar points selected")
    fp = last.fused_points
    if fp.shape != (eng.output_capacity, 4) or not torch.isfinite(fp).all():
        raise AssertionError("fused_points: bad shape or non-finite")
    n = int(last.fused_count)
    if not bool((fp[:n, 3] == 1).all()) or bool(fp[n:].any()):
        raise AssertionError("fused_points: bad live/padding rows")

    # the last frame again with the plain twins, from the same state
    _, ref = engmod.fusion_step(state_before, inp, cfg=cfg, grid=eng.grid,
                                output_capacity=eng.output_capacity,
                                plain=True)
    for k in ("occupancy_bits", "occupancy_sparse_idx",
              "occupancy_sparse_words", "occupancy_sparse_count",
              "occupancy_sparse_true", "fused_count", "raw_count",
              "seq_selected_count", "fused_points", "vox_partials_count"):
        if not torch.equal(getattr(last, k), getattr(ref, k)):
            raise AssertionError(f"last frame: {k} differs from the "
                                 "plain-twin step")

    # a small rig: the card gives the CPU's outputs, bit for bit
    small = bench_config(FusionConfig, h=48, w=64, c=2, lidar_pts=256,
                         rollbuffer_point_capacity=2048,
                         voxelize_partials_capacity=0,
                         occupancy_sparse_capacity=512)
    sm_scene = Scene(transforms, seed=1, h=48, w=64, c=2, lidar_pts=256)
    sm_intr = PinholeIntrinsics.default_for(64, 48, fov_deg=100.0)
    e_gpu = engmod.FusionEngine(small, device="cuda")
    e_cpu = engmod.FusionEngine(small, device="cpu")
    for f in range(4):
        o_gpu = e_gpu.process(sm_scene.stage(e_gpu, sm_intr, f))
        o_cpu = e_cpu.process(sm_scene.stage(e_cpu, sm_intr, f))
        for k in o_cpu._fields:
            if not torch.equal(getattr(o_gpu, k).cpu(), getattr(o_cpu, k)):
                raise AssertionError(f"small rig frame {f}: {k} differs "
                                     "between the card and the CPU")
    if int(o_cpu.fused_count) <= 0:
        raise AssertionError("small rig: nothing fused")

    steady = frame_ms[4:]
    print(f"[engine] {ENGINE_FRAMES} frames of {C}x{W}x{H} + "
          f"{N_LIDAR_STREAMS}x{LIDAR_PTS} lidar into "
          f"{eng.grid.num_cells} cells: {float(np.median(steady)):.2f} "
          f"ms/frame median (min {min(steady):.2f}, max {max(steady):.2f}; "
          f"staging + upload + step + synchronize, frames 4..) | "
          f"fused {n} cells, level-1 partials max {max_partials} of "
          f"{cfg.voxelize_partials_capacity}, "
          f"lidar selected {int(last.seq_selected_count)}, sparse blocks "
          f"{int(last.occupancy_sparse_true)} | launches {launches} | "
          f"plain-twin step equal; small rig card == cpu | {gpu}",
          flush=True)

    kernels = [dict(name=name, route="cuda", source=SOURCES[name],
                    replaces=REPLACES[name], launches=launches[name],
                    max_abs_err=results[name]["max_abs_err"],
                    ms=results[name]["ms"],
                    plain_ms=results[name]["plain_ms"])
               for name in ("segreduce", "flying_pixels", "compact")]
    print(json.dumps({"kernels": kernels}))
    print(gpu)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
