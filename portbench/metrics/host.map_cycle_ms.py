"""Worker-thread ms a cycle in ``engine.mapping.process_packed`` /
``process_sparse`` as the mapping worker calls them (the harness's
``mapping.worker_cycle``): the on-card unpack's and the segmentation's
enqueue, the results' copy and its wait, the object assembly and the
tracker, with the GIL shared with the main and encode threads."""
from entries import link_mapping

LAYER = "mapping.worker"
UNIT = "ms"
SOURCE = "host_clock"
MOVES = "fps"


def read(r):
    n = r.spans.calls.get(link_mapping.CYCLE, 0)
    if not n:
        return None
    return r.spans.self_s[link_mapping.CYCLE] * 1e3 / n
