"""Device ms a frame of the activities (kernels, copies, fills) the
mapping worker's cycles launch, from the profiler: the on-card unpack,
the segmentation chain, the grouping and the copies to the host.

``torch.profiler`` records no range on a thread other than the one that
started it, so the worker thread's launches reach the trace with no
harness span open (label None), and ``mapping.worker_cycle`` labels
none of them. They are told from the others by elimination: of the
activities launched outside every harness span, the host-to-device
copies are the engine's encode thread's packet copies and are left out;
the rest are counted as the worker's."""
LAYER = "mapping.worker"
UNIT = "ms"
SOURCE = "device_trace"
MOVES = "fps"


def read(r):
    t = r.trace
    acts = [e for e in t.device if e[3] is None and "HtoD" not in e[0]]
    if not t.frames or not acts:
        return None
    return sum(e[2] for e in acts) * 1e3 / t.frames
