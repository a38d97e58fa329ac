"""Host ms a frame in ``process`` and the packet upload, outside the
encode: the step's enqueue, which returns before the device finishes
(and, pipelined, the wait for the previous frame's encode)."""
from pb import drive

LAYER = "pipeline.engine step enqueue"
UNIT = "ms"
SOURCE = "host_clock"
MOVES = "fps"


def read(r):
    return r.span_ms(drive.PROCESS, drive.UPLOAD)
