"""The distributed engine on ``torch.distributed``: a ``(stream, space)``
mesh of ranks (:mod:`.mesh`), the sharded frame step (:mod:`.sharded`)
and its host orchestrator (:mod:`.engine`)."""

from ros_gpu_depthmap_fusion_tpu_torch.parallel.mesh import (  # noqa: F401
    SPACE_AXIS,
    STREAM_AXIS,
    Mesh,
    make_mesh,
    spawn,
)
from ros_gpu_depthmap_fusion_tpu_torch.parallel.sharded import (  # noqa: F401
    ShardedFrameOutputs,
    build_sharded_fusion_step,
    shard_inputs,
    sharded_initial_state,
)
