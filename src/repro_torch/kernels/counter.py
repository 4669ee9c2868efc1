"""A count of kernel launches that several threads may add to at once.

Each kernel has one named ``LaunchCounter``; its ``ops`` wrapper adds
one where it launches the kernel, and nowhere else, so a run can show
that its main path went through the kernel.  Ranks run as threads on one
card (``repro_torch.runtime.substrate``), so the read-modify-write of a
count is done under a lock.  ``reset_all`` and ``counts`` act on every
kernel's counter at once: set them to 0 before a run, read them after.
"""

from __future__ import annotations

import threading
from typing import Dict

COUNTERS: Dict[str, "LaunchCounter"] = {}


class LaunchCounter:
    def __init__(self, name: str = "") -> None:
        self.name = name
        self._lock = threading.Lock()
        self._value = 0
        if name:
            if name in COUNTERS:
                raise ValueError(f"a launch counter named {name!r} exists")
            COUNTERS[name] = self

    def add(self, n: int = 1) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> int:
        with self._lock:
            return self._value

    def reset(self) -> int:
        """Set the count to 0; returns what it was."""
        with self._lock:
            old, self._value = self._value, 0
            return old


def reset_all() -> None:
    for c in COUNTERS.values():
        c.reset()


def counts() -> Dict[str, int]:
    """Every named kernel's launches since its last reset."""
    return {name: c.value for name, c in COUNTERS.items()}
