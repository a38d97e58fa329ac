"""Host ms a frame in ``engine.segment_and_track`` outside the
segmentation, the object assembly and the tracker: mostly the copy of
the segmentation's results (the [Z, Y, X] labels) to the host."""
from entries import node

LAYER = "mapping.pipeline"
UNIT = "ms"
SOURCE = "host_clock"
MOVES = "fps"


def read(r):
    return r.span_ms(node.CYCLE)
