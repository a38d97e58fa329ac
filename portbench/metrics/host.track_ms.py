"""Host ms a frame in the tracker (``track_objects`` as
``mapping/pipeline.py`` binds it): association, filters, expiry."""
from entries import node

LAYER = "mapping.tracking"
UNIT = "ms"
SOURCE = "host_clock"
MOVES = "fps"


def read(r):
    return r.span_ms(node.TRACK)
