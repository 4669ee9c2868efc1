"""Serving scheduler state: the in-memory drained snapshots
(counterpart of ``repro.serve.state``; saving to and loading from disk
arrives with the checkpoint port).

A ``SchedulerSnapshot`` is the drained image ``BatchScheduler.snapshot()``
produces at a decode-step boundary.  Each in-flight slot carries its
``RequestCache`` — live pages plus per-slot state, page-granular, so
snapshot bytes scale with generated tokens rather than ``max_len``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List


@dataclasses.dataclass
class SlotSnapshot:
    """One in-flight request frozen mid-decode: the request (with its
    generated-so-far tokens) plus its ``RequestCache`` — the live pages
    and slot state ``PagePool.extract`` copied to host."""
    req: Any                      # repro_torch.serve.engine.Request
    cache: Any                    # repro_torch.serve.paging.RequestCache


@dataclasses.dataclass
class SchedulerSnapshot:
    """Drained ``BatchScheduler`` image at a decode-step boundary."""
    cfg: Any                      # ServeCfg at snapshot time
    decode_steps: int
    inflight: List[SlotSnapshot]  # occupied slots, slot order
    parked: List[SlotSnapshot]    # already waiting for a slot pre-drain
    queue: List[Any]              # Requests never admitted
    completed: List[Any]
    shed: List[Any]

    @property
    def resumable(self) -> List[SlotSnapshot]:
        """Every request with decode progress to preserve (in-flight
        first — they drained most recently — then the parked backlog)."""
        return list(self.inflight) + list(self.parked)
