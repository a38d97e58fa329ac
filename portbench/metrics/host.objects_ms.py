"""Host ms a frame in the object assembly (``build_objects`` as
``mapping/pipeline.py`` binds it): grouping, hulls, shapes and contours
of every merged object."""
from entries import node

LAYER = "mapping.objects"
UNIT = "ms"
SOURCE = "host_clock"
MOVES = "fps"


def read(r):
    return r.span_ms(node.OBJECTS)
