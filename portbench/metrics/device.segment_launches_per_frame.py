"""Device activities (kernels, copies, fills) a frame launched inside the
mapping stage's segmentation, from the profiler."""
from entries import node

LAYER = "mapping.segmentation"
UNIT = "launches"
SOURCE = "device_trace"
MOVES = "fps"


def read(r):
    t = r.trace
    n = len(t.device_by_label(node.SEGMENT))
    if not t.frames or not n:
        return None
    return n / t.frames
