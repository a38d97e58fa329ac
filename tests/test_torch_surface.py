"""The port's public surface against the JAX package's, and the names that
completed it.

:func:`test_module_defines_every_public_name` reads each ``.py`` module of
the JAX package with ``ast`` (nothing of it is imported for this) and
lists its public top-level functions and classes, the public methods of
those classes, and its UPPER_CASE constants. The port's module at the same
path (``ops/pallas/`` maps to ``ops/kernels/``) must define each one, or
the name stands in :data:`EXCLUDED` with the port's counterpart (which must
exist) or the reason it belongs to JAX or the TPU alone. One case a module.

The rest holds the names that completed the surface to the JAX package on
the CPU, bit for bit: the launch-file presets, the wrapped grid
coordinate and the numpy corner mirror, the four native host helpers, and
the two step builders (the JAX step under ``jax.disable_jit()``, as in
``tests/test_torch_engine.py``).
"""

import ast
import dataclasses
import importlib
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ros_gpu_depthmap_fusion_tpu.core import config as jconfig
from ros_gpu_depthmap_fusion_tpu.core.config import FusionConfig as JCfg
from ros_gpu_depthmap_fusion_tpu.core.grid import VoxelGrid as JGrid
from ros_gpu_depthmap_fusion_tpu.pipeline import FusionEngine as JEngine
from ros_gpu_depthmap_fusion_tpu.utils import native as j_native

from ros_gpu_depthmap_fusion_tpu_torch.core import config as tconfig
from ros_gpu_depthmap_fusion_tpu_torch.core.config import FusionConfig as TCfg
from ros_gpu_depthmap_fusion_tpu_torch.core.grid import VoxelGrid as TGrid
from ros_gpu_depthmap_fusion_tpu_torch.pipeline import engine as teng
from ros_gpu_depthmap_fusion_tpu_torch.pipeline.packet import unpack_packet
from ros_gpu_depthmap_fusion_tpu_torch.utils import native

from test_torch_engine import (
    EXACT, assert_outputs_equal, frames, jax_process, small_kw, stage)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_PKG = "ros_gpu_depthmap_fusion_tpu"
PORT_PKG = "ros_gpu_depthmap_fusion_tpu_torch"

_PALLAS_BLOCKS = ("a Pallas block constant of the TPU kernel (its tiling "
                  "of VMEM); the CUDA kernel has its own tile constants")

# The JAX names the port does not define, by JAX module: ("port", name) is
# the counterpart in the port's module at the same path, ("cuda", file,
# symbol) a kernel body in the port's CUDA sources, ("why", text) the
# reason the name belongs to JAX or the TPU alone.
EXCLUDED = {
    "ops/pallas/segreduce.py": {
        "rle_reduce_pallas": ("port", "segreduce"),
        "rle_body": ("cuda", "csrc/segreduce.cu", "segreduce_kernel"),
    },
    "ops/pallas/compact.py": {
        "compact_rows_pallas": ("port", "compact_rows"),
        "BN": ("why", _PALLAS_BLOCKS),
        "DP": ("why", _PALLAS_BLOCKS),
        "SLAB": ("why", _PALLAS_BLOCKS),
    },
    "ops/pallas/flying_pixels.py": {
        # the port's filter dispatches by the tensor's device
        "filter_flying_pixels_pallas": ("port", "filter_flying_pixels"),
        "filter_flying_pixels_auto": ("port", "filter_flying_pixels"),
        "BAND_ROWS": ("why", _PALLAS_BLOCKS),
        "HALO_ROWS": ("why", _PALLAS_BLOCKS),
    },
    "ops/pallas/fused_unproject_rle.py": {
        "ROWS_PER_BLOCK": ("why", _PALLAS_BLOCKS),
    },
    "parallel/sharded.py": {
        "input_shardings": ("port", "shard_inputs"),
        "state_shardings": ("port", "sharded_initial_state"),
    },
    "utils/compilation_cache.py": {
        "*": ("why", "XLA's persistent compile cache: PyTorch compiles "
              "nothing a frame, and the CUDA kernels are built once by "
              "ops/kernels/_build.py"),
    },
    # the port times its host work with one tracer: spans where the work
    # happens, and the per-frame report of enable_debug_output
    "utils/profiling.py": {
        **{n: ("port", "span") for n in (
            "MeasureTime", "MeasureTime.begin", "MeasureTime.begin_frame",
            "MeasureTime.end", "MeasureTime.end_frame",
            "MeasureTime.section")},
        "MeasureTime.report": ("port", "report"),
        **{n: ("port", "report") for n in (
            "StageTimer", "StageTimer.record", "StageTimer.report",
            "StageTimer.stage", "StageTimer.summary_us",
            "REFERENCE_STAGES")},
    },
}


def _jax_modules():
    root = os.path.join(REPO, JAX_PKG)
    out = []
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = sorted(d for d in dirnames if d != "__pycache__")
        for f in sorted(filenames):
            if f.endswith(".py"):
                out.append(os.path.relpath(os.path.join(dirpath, f), root)
                           .replace(os.sep, "/"))
    return out


def public_names(path):
    """Public top-level functions and classes, the public methods of those
    classes (``Class.method``), and UPPER_CASE constants of a source
    file."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            names.add(node.name)
        elif isinstance(node, ast.ClassDef) and not node.name.startswith("_"):
            names.add(node.name)
            names.update(
                f"{node.name}.{m.name}" for m in node.body
                if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef))
                and not m.name.startswith("_"))
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            names.update(n.id for t in targets for n in ast.walk(t)
                          if isinstance(n, ast.Name) and n.id.isupper())
    return {n for n in names if not n.startswith("_")}


def _port_module(rel):
    rel = rel.replace("ops/pallas/", "ops/kernels/")
    dotted = rel[:-3].replace("/", ".")
    if dotted.endswith("__init__"):
        dotted = dotted[:-len(".__init__")]
    return PORT_PKG + ("." + dotted if dotted else "")


def _defines(mod, name):
    obj = mod
    for part in name.split("."):
        if not hasattr(obj, part):
            return False
        obj = getattr(obj, part)
    return True


MODULES = _jax_modules()


def test_walk_finds_the_jax_package():
    assert len(MODULES) >= 50
    assert {"pipeline/engine.py", "ops/pallas/segreduce.py",
            "slam/loop_closure.py", "parallel/sharded.py"} <= set(MODULES)
    assert set(EXCLUDED) <= set(MODULES)


@pytest.mark.parametrize("rel", MODULES)
def test_module_defines_every_public_name(rel):
    names = public_names(os.path.join(REPO, JAX_PKG, rel))
    excluded = EXCLUDED.get(rel, {})
    if "*" in excluded:
        assert excluded["*"][0] == "why" and excluded["*"][1]
        with pytest.raises(ImportError):
            importlib.import_module(_port_module(rel))
        return
    mod = importlib.import_module(_port_module(rel))
    assert set(excluded) <= names, "an exclusion names no JAX name"
    for name, entry in excluded.items():
        kind = entry[0]
        if kind == "port":
            assert _defines(mod, entry[1]), (rel, name, entry)
        elif kind == "cuda":
            with open(os.path.join(REPO, PORT_PKG, entry[1])) as f:
                assert entry[2] in f.read(), (rel, name, entry)
        else:
            assert kind == "why" and entry[1], (rel, name, entry)
    missing = sorted(n for n in names - set(excluded)
                     if not _defines(mod, n))
    assert not missing, f"{_port_module(rel)} lacks {missing}"


# -- core/config.py: the launch-file presets --------------------------------

@pytest.mark.parametrize("name", ["PRESET_HAFEN", "PRESET_OFFICE"])
def test_preset_equals_jax_field_for_field(name):
    j, t = getattr(jconfig, name), getattr(tconfig, name)
    assert [f.name for f in dataclasses.fields(t)] == \
        [f.name for f in dataclasses.fields(j)]
    for f in dataclasses.fields(j):
        assert getattr(t, f.name) == getattr(j, f.name), f.name
    jg, tg = JGrid.from_config(j), TGrid.from_config(t)
    assert tg.grid_size == jg.grid_size
    assert tg.num_cells == {"PRESET_HAFEN": 3_360_000,
                            "PRESET_OFFICE": 160_000}[name]


# -- core/grid.py -------------------------------------------------------------

GRIDS = [((-20, -20, 0), (20, 20, 2.5), (0.1, 0.1, 0.12)),
         ((-4, -4, 0), (4, 4, 2.5), (0.1, 0.1, 0.1)),
         ((-1.5, 0.25, -3), (2.5, 3.0, 1.0), (0.3, 0.25, 0.7))]


@pytest.mark.parametrize("g", range(len(GRIDS)))
def test_grid_coord_wrapped_matches_jax(g):
    """Points inside, below and beyond the grid (up to three grid extents
    away on each side), and on cell boundaries: C truncation toward zero,
    then a positive modulo, bit-equal."""
    lo, hi, cs = GRIDS[g]
    jg, tg = JGrid(lo, hi, cs), TGrid(lo, hi, cs)
    rng = np.random.default_rng(40 + g)
    span = np.asarray(hi, np.float32) - np.asarray(lo, np.float32)
    pts = (np.asarray(lo, np.float32)
           + rng.uniform(-3, 4, (4096, 3)).astype(np.float32) * span)
    edges = (np.asarray(lo, np.float32) + rng.integers(
        -50, 50, (512, 3)).astype(np.float32) * np.asarray(cs, np.float32))
    pts = np.concatenate([pts, edges]).astype(np.float32)
    got = tg.grid_coord_wrapped(torch.from_numpy(pts))
    want = np.asarray(jg.grid_coord_wrapped(jnp.asarray(pts)))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got.numpy() >= 0).all()
    assert (got.numpy() < np.asarray(tg.grid_size)).all()
    assert ((pts - np.asarray(lo, np.float32)) < 0).any()


@pytest.mark.parametrize("g", range(len(GRIDS)))
def test_np_world_coord_of_index_matches_jax(g):
    """Every corner cell of the grid, and a seeded sample, bit-equal; the
    numpy mirror agrees with the tensor conversion."""
    lo, hi, cs = GRIDS[g]
    jg, tg = JGrid(lo, hi, cs), TGrid(lo, hi, cs)
    gx, gy, gz = tg.grid_size
    corners = np.asarray([x + y * gx + z * gx * gy
                          for x in (0, gx - 1) for y in (0, gy - 1)
                          for z in (0, gz - 1)], np.int64)
    idx = np.concatenate([corners, np.random.default_rng(g).integers(
        0, tg.num_cells, 256)])
    got = tg.np_world_coord_of_index(idx)
    assert got.dtype == np.float32 and got.shape == (len(idx), 3)
    np.testing.assert_array_equal(got, jg.np_world_coord_of_index(idx))
    np.testing.assert_array_equal(
        got, tg.world_coord_of_index(torch.from_numpy(idx)).numpy())


# -- utils/native.py: the host helpers ----------------------------------------

@pytest.fixture(scope="module")
def native_lib():
    """Both packages' bindings of the native library (built on first use),
    or a skip."""
    if not (native.available() and j_native.available()):
        pytest.skip("native library not built")


@pytest.mark.parametrize("n", [0, 1, 7, 4096, 640 * 480 + 1])
def test_depth_pairs_match_jax(native_lib, n):
    d = np.random.default_rng(n).integers(0, 65536, n, dtype=np.uint16)
    packed = native.pack_depth_pairs(d)
    np.testing.assert_array_equal(packed, j_native.pack_depth_pairs(d))
    assert packed.dtype == np.uint32 and packed.size == n // 2
    back = native.unpack_depth_pairs(packed)
    np.testing.assert_array_equal(back, j_native.unpack_depth_pairs(packed))
    np.testing.assert_array_equal(back, d[:2 * (n // 2)])


@pytest.mark.parametrize("n,hi", [(0, 10), (1, 10), (5000, 37),
                                  (200_000, 1 << 32)])
def test_radix_sort_and_group_match_jax(native_lib, n, hi):
    """A stable sort (equal keys keep their order) and its groups, on keys
    with many repeats and on full-range keys."""
    keys = np.random.default_rng(n).integers(0, hi, n, dtype=np.uint64) \
        .astype(np.uint32)
    sk, si = native.radix_sort_u32(keys)
    jk, ji = j_native.radix_sort_u32(keys)
    np.testing.assert_array_equal(sk, jk)
    np.testing.assert_array_equal(si, ji)
    np.testing.assert_array_equal(si, np.argsort(keys, kind="stable"))
    for cap in (None, 3):
        got = native.group_sorted_u32(sk, cap)
        want = j_native.group_sorted_u32(jk, cap)
        assert got[3] == want[3]
        for a, b in zip(got[:3], want[:3]):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    assert native.group_sorted_u32(sk)[3] == len(np.unique(keys))


def test_host_helpers_raise_without_the_library(monkeypatch):
    monkeypatch.setattr(native, "_load", lambda: None)
    with pytest.raises(RuntimeError, match="native"):
        native.radix_sort_u32(np.arange(4, dtype=np.uint32))


# -- pipeline/engine.py: the step builders ------------------------------------

@pytest.mark.parametrize("capacity", [None, 96])
def test_step_builders_match_engine_and_jax(capacity):
    """Four frames of the small rig: the step of ``build_fusion_step`` on
    the unpacked packet and the step of ``build_packet_step`` on the packet
    (the JAX engine's words, which the port's equal:
    ``test_host_packet_bytes_match_jax``) give the port engine's outputs
    and the JAX step's, bit for bit; so does the JAX package's own
    ``build_fusion_step`` at an explicit capacity."""
    kw = small_kw()
    jcfg, tcfg = JCfg(**kw), TCfg(**kw)
    j = JEngine(jcfg)
    t = teng.FusionEngine(tcfg, device="cpu")
    grid = TGrid.from_config(tcfg)
    fstep = teng.build_fusion_step(tcfg, grid, capacity)
    pstep = teng.build_packet_step(tcfg, grid, t.layout, capacity,
                                   donate=False)
    cap = capacity or t.output_capacity
    assert fstep.keywords["output_capacity"] == cap
    jstep = None
    if capacity is not None:
        from ros_gpu_depthmap_fusion_tpu.pipeline import engine as jeng
        jstep = jeng.build_packet_step(jcfg, j.grid, j.layout, capacity,
                                       donate=False)
    words = []
    encode = j._encode

    def capture(*a):
        view, bits = encode(*a)
        words.append(np.array(view))
        return view, bits
    j._encode = capture
    fs = ps = teng.initial_state(tcfg, grid, "cpu")
    js = j.state
    for d, arc, nsec, now in frames(4):
        stage(j, d, arc, nsec)
        stage(t, d, arc, nsec)
        j_out = jax_process(j, now)
        t_out = t.process(now)
        packet = torch.from_numpy(words[-1].view(np.int32).copy())
        bits = j.last_frame_bits
        fs, f_out = fstep(fs, unpack_packet(packet, t.layout, bits), bits)
        ps, p_out = pstep(ps, packet, bits)
        assert f_out.fused_points.shape == (cap, 4)
        for out in (f_out, p_out):
            for k in EXACT[1:]:
                np.testing.assert_array_equal(
                    getattr(out, k).numpy(), getattr(p_out, k).numpy(), k)
        if capacity is None:
            assert_outputs_equal(f_out, j_out)
            assert_outputs_equal(p_out, t_out)
        else:
            with jax.disable_jit():
                js, jc_out = jstep(js, jnp.asarray(words[-1]), bits)
            assert_outputs_equal(f_out, jc_out)
            assert_outputs_equal(p_out, jc_out)
        assert int(p_out.fused_count) > 0
    assert torch.equal(fs.historic_occupancy, ps.historic_occupancy)
    assert int(fs.frame_index) == int(ps.frame_index) == 4
