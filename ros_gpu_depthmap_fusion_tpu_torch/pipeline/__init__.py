from ros_gpu_depthmap_fusion_tpu_torch.pipeline.engine import (  # noqa: F401
    EngineState, FrameInputs, FrameOutputs, FusionEngine, SequenceBatch,
    fusion_step, initial_state)
