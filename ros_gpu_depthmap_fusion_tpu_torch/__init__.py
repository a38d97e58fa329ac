"""PyTorch + CUDA port of :mod:`ros_gpu_depthmap_fusion_tpu` for one NVIDIA
H100 (Hopper, ``sm_90a``).

The JAX package is the reference; this package is its counterpart module
for module (``core/``, ``ops/``, ``ops/kernels/`` in place of
``ops/pallas/``, ``state/``, ``pipeline/``, ``mapping/``, ``slam/``,
``parallel/``, ``utils/``), held to it by the
``tests/test_torch_*.py`` parity tests. It imports ``torch`` and never
``jax``. Every Pallas kernel on the ported path is a hand-written CUDA
kernel under ``csrc/``, compiled with ``nvcc`` at first use; each has a
plain PyTorch twin with the same contract, which is what runs for CPU
tensors.

Importing the package sets ``torch.backends.cuda.matmul.allow_tf32`` and
``torch.backends.cudnn.allow_tf32`` to ``False``: the reference's exactness
arguments assume true float32 arithmetic.

What is ported: the fused per-frame step through
``FusionEngine.add_depthmap`` / ``add_point_sequence`` / ``process`` at
every single-device configuration of the JAX engine: ``FusionConfig()``'s
defaults (the raw cloud emitted), the split-domain step, the voxel modes
"rle", "packed", "exact" and occupied cells, no voxel filter, the radius
filter, heterogeneous rigs, on the raw or the coded depth link
(``"dpcm"``, ``"dpcm_temporal"`` with p4 P-frames; encoders in the native
host library), with ``pipeline_depth`` 0 or 1; the mapping
(``MappingPipeline``: device or native host segmentation, object
assembly, tracking; ``AsyncMappingWorker``); the streaming component
(``FusionComponent``); and the SLAM path (``slam/``: features, RANSAC,
windowed BA, odometry, pose graph, loop closure; ``pipeline/tum_runner.py``
with ``pipeline/datasets.py``) with ``utils/`` png, checkpoint, profiling
and viz; and the distributed engine (``parallel/``: a ``(stream, space)``
mesh of ranks on ``torch.distributed``, the sharded step,
``ShardedFusionEngine``; ``slam.ba.build_sharded_ba_step``). What the JAX
package refuses raises ``ValueError`` naming the field.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from ros_gpu_depthmap_fusion_tpu_torch.core import (  # noqa: E402,F401
    FusionConfig, VoxelGrid)
from ros_gpu_depthmap_fusion_tpu_torch.pipeline.engine import (  # noqa: E402,F401,E501
    EngineState, FrameInputs, FrameOutputs, FusionEngine, SequenceBatch,
    fusion_step, initial_state)
from ros_gpu_depthmap_fusion_tpu_torch.mapping.pipeline import (  # noqa: E402,F401,E501
    AsyncMappingWorker, MappingPipeline, MappingResult)
from ros_gpu_depthmap_fusion_tpu_torch.pipeline.component import (  # noqa: E402,F401,E501
    FusionComponent)
