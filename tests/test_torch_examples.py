"""The port's examples and entry points (``examples_torch/``) on the CPU:
``entry.py``'s ``entry`` against the JAX ``fusion_step`` on the same tiny
rig (``__graft_entry__.py``'s config and frame), its ``dryrun_multichip``
on 2 gloo ranks, ``run_multihost.py``'s digest equal with 2 ranks and
with 1, and the minimal slice and component stream run through.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from ros_gpu_depthmap_fusion_tpu_torch.utils import native

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(REPO, "examples_torch")


def _entry_module():
    # the spawned ranks of dryrun_multichip import it by name from the path
    if EXAMPLES not in sys.path:
        sys.path.insert(0, EXAMPLES)
    import entry
    return entry


def _run(script, *args, timeout=300):
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    res = subprocess.run([sys.executable, os.path.join(EXAMPLES, script),
                          *args], capture_output=True, text=True, env=env,
                         cwd=REPO, timeout=timeout)
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-2000:]
    return res.stdout


def test_entry_matches_jax_fusion_step():
    """One step of ``entry("cpu")`` equal to the JAX ``fusion_step`` (under
    ``jax.disable_jit()``) on the same config and inputs, in every output
    but the partials count ("auto" runs "rle" in the port, "packed" in
    JAX on the CPU; equal outputs, ``pipeline/engine.py
    resolve_mean_mode``)."""
    import jax
    from ros_gpu_depthmap_fusion_tpu.core.config import FusionConfig as JCfg
    from ros_gpu_depthmap_fusion_tpu.core.grid import VoxelGrid as JGrid
    from ros_gpu_depthmap_fusion_tpu.pipeline.engine import (
        FrameInputs as JInputs, SequenceBatch as JBatch,
        fusion_step as jstep, initial_state as jinit)
    entry = _entry_module()
    fn, (state, inp) = entry.entry("cpu")
    assert inp.depth.device.type == "cpu"
    _, out = fn(state, inp)
    cfg = fn.keywords["cfg"]
    jcfg = JCfg(**{f: getattr(cfg, f) for f in cfg.__dataclass_fields__})
    jgrid = JGrid.from_config(jcfg)
    f = entry._frame_inputs(cfg)
    with jax.disable_jit():
        _, ref = jstep(jinit(jcfg, jgrid),
                       JInputs(*f[:4], JBatch(*f.seq_batch), *f[5:]),
                       cfg=jcfg, grid=jgrid, output_capacity=256)
    assert int(out.fused_count) > 0
    for k in ("fused_points", "fused_count", "raw_points", "raw_count",
              "occupancy_u8", "occupancy_bits", "seq_selected_count"):
        np.testing.assert_array_equal(getattr(out, k).numpy(),
                                      np.asarray(getattr(ref, k)), err_msg=k)


def test_dryrun_multichip_two_ranks(capsys):
    entry = _entry_module()
    entry.dryrun_multichip(2, "cpu", operating_scale=False)
    assert "== single step OK" in capsys.readouterr().out


def test_run_multihost_digest_two_ranks_equals_one(tmp_path):
    if not native.available():
        pytest.skip("native library not built")
    digests = []
    for ranks in (1, 2):
        path = tmp_path / f"digest{ranks}.json"
        _run("run_multihost.py", "--ranks", str(ranks), "--device", "cpu",
             "--backend", "gloo", "--digest-out", str(path))
        digests.append(json.loads(path.read_text()))
    one, two = digests
    assert two["mesh"] == {"stream": 2, "space": 1}
    assert one["fused_total"] > 0 and one["raw_total"] > 0
    for k in ("fused_total", "raw_total", "occ_sum", "fused_rows_sha",
              "occ_sha"):
        assert one[k] == two[k], k


@pytest.mark.parametrize("script,marker", [
    ("run_minimal_slice.py", "ALL CHECKS PASSED"),
    ("run_component_stream.py", "COMPONENT STREAM OK")])
def test_example_runs_on_cpu(script, marker):
    if script == "run_component_stream.py" and not native.available():
        pytest.skip("native library not built")
    assert marker in _run(script, "--device", "cpu")


def test_examples_need_no_jax():
    """The examples import the port and never JAX."""
    for name in sorted(os.listdir(EXAMPLES)):
        if name.endswith(".py"):
            with open(os.path.join(EXAMPLES, name)) as fh:
                src = fh.read()
            assert "import jax" not in src and "from jax" not in src, name
            assert "ros_gpu_depthmap_fusion_tpu." not in src, name
    assert torch.backends.cuda.matmul.allow_tf32 is False
