"""The tracker of :mod:`reference.mapping` replayed over a mapping
worker's cycles, each stepped with the dt that cycle's tracking was given.

A worker (``AsyncMappingWorker``) passes each cycle the measured wall
time since the cycle before, clamped, and not the configuration's
``tracking_dt``: the filters and the scores move by it. The replay takes
the program's cycles in order, with the objects each one tracked and its
dt, so that the reference's tracks after a cycle are what the program's
should be. Plain torch and numpy, nothing of the port imported.
"""

from __future__ import annotations

import torch

from .mapping import Tracker


class Replay:
    """:class:`reference.mapping.Tracker` stepped cycle by cycle."""

    def __init__(self, min_area: float, max_tracks: int,
                 host_dtype=torch.float64):
        self.tracker = Tracker(min_area, 0.0, max_tracks, host_dtype)

    def tracks(self, cycle: int, inputs: list, dts: list) -> dict:
        """The live tracks after cycle ``cycle`` (ascending from one call
        to the next), each cycle ``k`` stepped over ``inputs[k]`` (its
        ``[(object id, box)]``) with ``dts[k]`` seconds."""
        tr = self.tracker
        while tr.frame < cycle:
            k = tr.frame + 1
            tr.dt = float(dts[k])
            tr.step(inputs[k])
        return tr.state()
