"""The share of the traced window in which no device activity ran."""

LAYER = "device"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "fps"


def read(r):
    t = r.trace
    if t.window_s <= 0 or t.busy_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
