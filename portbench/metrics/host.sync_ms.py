"""Host ms a frame in the component's callbacks and resample tick,
outside the engine's staging, its ``process`` and the publish: the sync
policy's pushes and the stash."""
from pb import drive

LAYER = "pipeline.component sync and callbacks"
UNIT = "ms"
SOURCE = "host_clock"
MOVES = "fps"


def read(r):
    return r.span_ms(drive.CALLBACK, drive.TICK)
