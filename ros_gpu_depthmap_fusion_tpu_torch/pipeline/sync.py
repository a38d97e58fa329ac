"""Multi-stream message synchronization (the JAX package's
``pipeline/sync.py``, pure Python, with the messages it discards counted
in :attr:`ApproximateTimeSynchronizer.dropped`).

Host-side equivalent of the reference's ``ros_topic_sync::AdvancedSyncPolicy``
wiring (``gpu_depthmap_fusion_component.h:29-62``,
``_component.cpp:1243-1396``): up to 6 depth streams are synchronized by
timestamp, with per-slot configuration:

- ``trigger`` slots must all have a message for a tuple to be emitted
  (the reference marks slot 0 as trigger and the rest optional with clear);
- ``optional`` slots contribute their latest message within the slop window
  when available, else None;
- ``clear`` slots have their stash consumed on emission.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Optional, Sequence


@dataclasses.dataclass
class SlotConfig:
    trigger: bool = True
    optional: bool = False
    clear: bool = True


@dataclasses.dataclass
class Stamped:
    stamp: float
    data: Any


class ApproximateTimeSynchronizer:
    """Emit tuples of per-slot messages whose stamps agree within ``slop``."""

    def __init__(self, slots: Sequence[SlotConfig], slop: float = 1.0 / 60.0,
                 queue_size: int = 4,
                 callback: Optional[Callable[[List[Optional[Stamped]]], None]]
                 = None):
        self.slots = list(slots)
        self.slop = slop
        self.queue_size = queue_size
        self.callback = callback
        self._queues: List[List[Stamped]] = [[] for _ in self.slots]
        # messages discarded unemitted: queue overflow, stale on the
        # trigger slot, consumed beside the picked one
        self.dropped = 0

    def push(self, slot: int, stamp: float, data: Any
             ) -> Optional[List[Optional[Stamped]]]:
        q = self._queues[slot]
        q.append(Stamped(stamp, data))
        if len(q) > self.queue_size:
            q.pop(0)
            self.dropped += 1
        return self._try_emit()

    def _try_emit(self) -> Optional[List[Optional[Stamped]]]:
        trigger_idx = [i for i, s in enumerate(self.slots) if s.trigger]
        if not trigger_idx:
            trigger_idx = [0]
        if any(not self._queues[i] for i in trigger_idx):
            return None
        # candidate time: latest of the earliest pending trigger messages
        t = max(self._queues[i][0].stamp for i in trigger_idx)
        picked: List[Optional[Stamped]] = [None] * len(self.slots)
        for i, cfg in enumerate(self.slots):
            best = None
            for msg in self._queues[i]:
                if abs(msg.stamp - t) <= self.slop:
                    if best is None or abs(msg.stamp - t) < abs(best.stamp - t):
                        best = msg
            if best is None and cfg.trigger and not cfg.optional:
                # trigger slot has no message near t: drop stale messages
                # older than t - slop and wait
                kept = [m for m in self._queues[i]
                        if m.stamp >= t - self.slop]
                self.dropped += len(self._queues[i]) - len(kept)
                self._queues[i] = kept
                return None
            picked[i] = best
        # consume
        for i, cfg in enumerate(self.slots):
            if cfg.clear:
                kept = [m for m in self._queues[i]
                        if m.stamp > t + self.slop]
                # every message consumed but the one picked is discarded
                self.dropped += (len(self._queues[i]) - len(kept)
                                 - (picked[i] is not None))
                self._queues[i] = kept
            elif picked[i] is not None:
                self._queues[i] = [m for m in self._queues[i]
                                   if m.stamp > picked[i].stamp - 1e-9 or
                                   m is not picked[i]]
        if self.callback is not None:
            self.callback(picked)
        return picked
