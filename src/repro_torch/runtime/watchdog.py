"""Straggler / hang detection: a wall-clock step watchdog.

Counterpart of ``repro.runtime.watchdog``, copied: it imports only the
standard library.

At 1000+ nodes the common failure is not a crash but a *stall* (one host
wedged on a collective).  The watchdog runs a monitor thread; the training
loop calls ``beat()`` every step.  If no beat arrives within ``timeout``
seconds the callback fires (default: record + log), letting the loop
abort the stuck step, checkpoint-restore, and re-mesh — instead of burning
the whole allocation.  Slow-but-alive steps are tracked as straggler
events with the observed step-time distribution.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Callable, List, Optional

logger = logging.getLogger("repro_torch.runtime")


class StepWatchdog:
    def __init__(self, timeout: float, on_stall: Optional[Callable] = None,
                 straggler_factor: float = 3.0,
                 on_straggler: Optional[Callable] = None):
        self.timeout = timeout
        self.straggler_factor = straggler_factor
        self.on_stall = on_stall or self._default_stall
        self.on_straggler = on_straggler
        self.step_times: List[float] = []
        self.stalls: List[float] = []
        self.stragglers: List[int] = []
        self._last = time.monotonic()
        self._stall_fired = False
        self._beats = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle -------------------------------------------------------

    def start(self) -> "StepWatchdog":
        self._last = time.monotonic()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=self.timeout + 1)

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    # -- heartbeat ---------------------------------------------------------

    def beat(self) -> None:
        now = time.monotonic()
        dt = now - self._last
        if self._beats > 0:
            self.step_times.append(dt)
            median = sorted(self.step_times)[len(self.step_times) // 2]
            if (len(self.step_times) >= 5
                    and dt > self.straggler_factor * median):
                self.stragglers.append(self._beats)
                logger.warning("straggler step %d: %.2fs vs median %.2fs",
                               self._beats, dt, median)
                if self.on_straggler is not None:
                    self.on_straggler(self._beats, dt)
        self._beats += 1
        self._last = now
        self._stall_fired = False        # re-arm: episode (if any) is over

    # -- monitor -----------------------------------------------------------

    def _run(self) -> None:
        # One stall *episode* (beat silence crossing the timeout) fires
        # on_stall exactly once; only the next beat() re-arms.  Without
        # the debounce a 10-minute hang with a 5s timeout would fire the
        # callback ~120 times — 119 redundant abort/restore attempts.
        while not self._stop.wait(min(self.timeout / 4, 1.0)):
            silence = time.monotonic() - self._last
            if silence > self.timeout and not self._stall_fired:
                self._stall_fired = True
                self.stalls.append(silence)
                self.on_stall(silence)

    def _default_stall(self, silence: float) -> None:
        logger.error("watchdog: no step heartbeat for %.1fs (timeout %.1fs)",
                     silence, self.timeout)
