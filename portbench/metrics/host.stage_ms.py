"""Host ms a frame in ``add_depthmap`` and ``add_point_sequence``:
staging the depth images and lidar packets into the host packet."""
from pb import drive

LAYER = "pipeline.engine ingest"
UNIT = "ms"
SOURCE = "host_clock"
MOVES = "fps"


def read(r):
    return r.span_ms(drive.STAGE)
