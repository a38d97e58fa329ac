"""Device ms a frame of the activities (kernels, copies, fills) launched
inside the mapping stage's segmentation, from the profiler."""
from entries import node

LAYER = "mapping.segmentation"
UNIT = "ms"
SOURCE = "device_trace"
MOVES = "fps"


def read(r):
    t = r.trace
    acts = t.device_by_label(node.SEGMENT)
    if not t.frames or not acts:
        return None
    return sum(e[2] for e in acts) * 1e3 / t.frames
