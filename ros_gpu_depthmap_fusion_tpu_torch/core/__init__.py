from ros_gpu_depthmap_fusion_tpu_torch.core import (  # noqa: F401
    timeutil, transforms)
from ros_gpu_depthmap_fusion_tpu_torch.core.camera import (  # noqa: F401
    PinholeIntrinsics)
from ros_gpu_depthmap_fusion_tpu_torch.core.config import (  # noqa: F401
    FusionConfig)
from ros_gpu_depthmap_fusion_tpu_torch.core.grid import VoxelGrid  # noqa: F401
