"""Host ms a frame in the mapping stage's segmentation (``segment`` as
``mapping/pipeline.py`` binds it): its launches and the waits of its
two fixpoint loops, one a loop iteration."""
from entries import node

LAYER = "mapping.segmentation"
UNIT = "ms"
SOURCE = "host_clock"
MOVES = "fps"


def read(r):
    return r.span_ms(node.SEGMENT)
