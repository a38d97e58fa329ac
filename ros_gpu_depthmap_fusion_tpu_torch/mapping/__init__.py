from ros_gpu_depthmap_fusion_tpu_torch.mapping import (  # noqa: F401
    filters,
    geometry,
    objects,
    segmentation,
    tracking,
)
from ros_gpu_depthmap_fusion_tpu_torch.mapping.pipeline import (  # noqa: F401
    AsyncMappingWorker,
    MappingPipeline,
    MappingResult,
)
