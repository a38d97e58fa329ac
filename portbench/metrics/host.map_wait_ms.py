"""Main-thread self ms a frame in the mapping worker's ``submit`` (the
harness's ``mapping.submit``): the hand-off of the frame's occupancy, and
the wait for the worker's slot. Near 0 when fusion sets the pace; the
mapping's excess over the fusion frame when the worker does."""
from entries import link_mapping

LAYER = "mapping.worker"
UNIT = "ms"
SOURCE = "host_clock"
MOVES = "fps"


def read(r):
    return r.span_ms(link_mapping.SUBMIT)
