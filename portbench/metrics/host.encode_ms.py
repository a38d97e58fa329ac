"""Host ms a frame in the engine's depth-link encode (the native
encoders), on the worker thread when the engine is pipelined."""
from pb import drive

LAYER = "utils.native encode"
UNIT = "ms"
SOURCE = "host_clock"
MOVES = "fps"


def read(r):
    return r.span_ms(drive.ENCODE)
