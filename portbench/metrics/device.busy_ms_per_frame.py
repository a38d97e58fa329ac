"""Device ms a frame: the union of device activity over the traced
window, over its frames."""

LAYER = "device"
UNIT = "ms"
SOURCE = "device_trace"
MOVES = "fps"


def read(r):
    t = r.trace
    if not t.frames or t.busy_s <= 0:
        return None
    return t.busy_s * 1e3 / t.frames
