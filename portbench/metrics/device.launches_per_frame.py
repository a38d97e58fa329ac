"""Device activities (kernels, copies, fills) a step launches, from the
profiler: those launched inside ``process`` or the packet upload, over
the traced frames."""
from pb import drive

LAYER = "pipeline.engine step enqueue"
UNIT = "launches"
SOURCE = "device_trace"
MOVES = "fps"


def read(r):
    t = r.trace
    if not t.frames or not t.device:
        return None
    n = sum(1 for e in t.device if e[3] is not None and (
        e[3] in (drive.PROCESS, drive.UPLOAD) or e[3].startswith("kernel.")))
    return n / t.frames if n else None
