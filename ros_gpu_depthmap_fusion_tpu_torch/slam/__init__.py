"""SLAM frontend and backend (port of the JAX package's ``slam/``):
features, pose estimation, windowed BA, pose graph, loop closure, ATE."""

from ros_gpu_depthmap_fusion_tpu_torch.slam import (  # noqa: F401
    ate,
    ba,
    features,
    lie,
    pose_estimation,
    pose_graph,
)
from ros_gpu_depthmap_fusion_tpu_torch.slam.frontend import (  # noqa: F401
    OdometryResult,
    RgbdOdometry,
)
