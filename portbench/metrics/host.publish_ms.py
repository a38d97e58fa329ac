"""Host ms a frame publishing: waiting for the frame's fused cloud,
copying it to host memory and reading the drop counts."""
from pb import drive

LAYER = "publish (the harness's on_points)"
UNIT = "ms"
SOURCE = "host_clock"
MOVES = "fps"


def read(r):
    return r.span_ms(drive.PUBLISH)
