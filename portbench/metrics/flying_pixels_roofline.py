"""The flying_pixels kernel's share of its roofline over the traced frames:
the bound time of the work its calls' inputs need
(:func:`pb.roofline.flying_pixels`) over their device time (the activities
launched inside the kernel wrapper), against the H100's published peaks
at 700 W; the card's power limit is in the result's ``device``."""

LAYER = "ops.kernels"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "fps"
KERNEL = "flying_pixels"
CALL = ("ros_gpu_depthmap_fusion_tpu_torch.ops.kernels."
        "flying_pixels", "filter_flying_pixels")


def read(r):
    return r.roofline_pct(KERNEL)
