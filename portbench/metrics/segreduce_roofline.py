"""The segreduce kernel's share of its roofline over the traced frames:
the bound time of the work its calls' inputs need
(:func:`pb.roofline.segreduce`) over their device time (the activities
launched inside the kernel wrapper), against the H100's published peaks
at 700 W; the card's power limit is in the result's ``device``."""

LAYER = "ops.kernels"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "fps"
KERNEL = "segreduce"
CALL = ("ros_gpu_depthmap_fusion_tpu_torch.ops.kernels.segreduce",
        "segreduce")


def read(r):
    return r.roofline_pct(KERNEL)
