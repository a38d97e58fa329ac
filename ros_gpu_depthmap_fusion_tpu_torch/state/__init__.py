from ros_gpu_depthmap_fusion_tpu_torch.state.rollbuffer import (  # noqa: F401
    RollBuffer, Selection, gather_selection, insert_sequences,
    make_rollbuffer, roll, select_timespan)
