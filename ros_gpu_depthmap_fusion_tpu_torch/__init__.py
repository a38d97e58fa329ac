"""PyTorch + CUDA port of :mod:`ros_gpu_depthmap_fusion_tpu` for one NVIDIA
H100 (Hopper, ``sm_90a``).

The JAX package is the reference; this package is its counterpart module
for module (``core/``, ``ops/``, ``ops/kernels/`` in place of
``ops/pallas/``, ``state/``, ``pipeline/``), held to it by the
``tests/test_torch_*.py`` parity tests. It imports ``torch`` and never
``jax``. Every Pallas kernel on the ported path is a hand-written CUDA
kernel under ``csrc/``, compiled with ``nvcc`` at first use; each has a
plain PyTorch twin with the same contract, which is what runs for CPU
tensors.

Importing the package sets ``torch.backends.cuda.matmul.allow_tf32`` and
``torch.backends.cudnn.allow_tf32`` to ``False``: the reference's exactness
arguments assume true float32 arithmetic.

Ported slice: the fused per-frame step through
``FusionEngine.add_depthmap`` / ``add_point_sequence`` / ``process`` for a
homogeneous rig on the raw depth link (``depth_link_codec="none"``), with
the split-domain RLE average voxelize.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from ros_gpu_depthmap_fusion_tpu_torch.core import (  # noqa: E402,F401
    FusionConfig, VoxelGrid)
from ros_gpu_depthmap_fusion_tpu_torch.pipeline.engine import (  # noqa: E402,F401,E501
    EngineState, FrameInputs, FrameOutputs, FusionEngine, SequenceBatch,
    fusion_step, initial_state)
