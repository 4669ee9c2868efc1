"""Real failure signals -> the controllers' ``mark_unhealthy`` path.

Counterpart of ``repro.runtime.health``.  The injected ``FaultPlan``
drives tests; real failures arrive through three channels, and this
module turns each into the one recovery path the controllers own:

* **runtime errors** — ``classify_failure`` decides whether an exception
  is a device failure (recover) or a bug (propagate), and names the
  victims:

  - a ``substrate.RankFailure`` (a rank of ``run_spmd`` failed) is
    classified by the error it carries and names that rank's member id.
    A rank the others waited for at a hop (``hung``) carries only a
    peer's timeout, so it propagates: ranks are threads on one card, and
    a thread that never reached its hop is a deadlock or a step slower
    than the hop timeout, not a lost device (the reference has no such
    case);
  - a ``RuntimeError`` (PyTorch raises CUDA and NCCL errors as one)
    counts when its message carries a marker of a lost or unreachable
    device: the reference's markers ("device lost", "nccl", "peer
    down", ...) and CUDA's ("GPU has fallen off the bus", "uncorrectable
    ECC", ``cudaErrorDevicesUnavailable``, ...); ids written as "device
    3" are the victims;
  - everything else propagates.  Out of memory, an illegal address, a
    device-side assert or a misaligned access are bugs of the program,
    not losses of a device, even when they surface through NCCL, and so
    are errors that are not ``RuntimeError``s;

* **preemption notices** — ``PreemptionNotice`` is the thread-safe
  mailbox controllers drain at each step boundary;
  ``install_preemption_handler`` binds it to a real signal (SIGTERM by
  default, chaining any previous handler);

* **survivor agreement** — ``agree_survivors`` is the single-host fast
  path of the control plane's vote (``ctrlplane.intersect_views``).
"""

from __future__ import annotations

import re
import signal
import threading
from typing import Callable, Iterable, Optional, Sequence, Set, Tuple

import torch

from repro_torch.runtime.ctrlplane import intersect_views
from repro_torch.runtime.substrate import RankFailure

# Message fragments that mark a runtime error as a *device* failure: the
# reference's (lost devices, preemption, collective peer death) and
# CUDA's for a card that is gone or cannot be reached.
_DEVICE_FAILURE_MARKERS = (
    "device lost",
    "device failure",
    "device unavailable",
    "unavailable:",
    "failed precondition",
    "preempt",
    "socket closed",
    "connection reset",
    "peer down",
    "nccl",
    "dead device",
    "fallen off the bus",
    "uncorrectable ecc",
    "cudaerroreccuncorrectable",
    "cudaerrordevicesunavailable",
    "busy or unavailable",
    "cudaerrornodevice",
    "no cuda-capable device",
    "cudaerrordeviceuninitialized",
    "nvlink error",
    "ncclremoteerror",
    "ncclsystemerror",
)

# Weak markers appear in non-failure payloads too: they classify only
# next to the word "device" (\b keeps "device_count" out).
_WEAK_FAILURE_MARKERS = ("halted", "terminated")
_DEVICE_WORD_RE = re.compile(r"\bdevices?\b", re.IGNORECASE)

# Bugs of the program: these veto every marker above (an NCCL error that
# reports a CUDA out-of-memory is an out-of-memory).
_BUG_MARKERS = (
    "out of memory",
    "illegal memory access",
    "illegal address",
    "device-side assert",
    "misaligned address",
    "illegal instruction",
    "ncclinvalidusage",
    "ncclinvalidargument",
)

# "device 3", "device:5", "device #2" — but not "device_count=8".
_DEVICE_ID_RE = re.compile(r"\bdevice[ :#]{1,2}(\d+)\b", re.IGNORECASE)


def _is_device_failure(exc: BaseException) -> bool:
    if not isinstance(exc, RuntimeError) or isinstance(
            exc, torch.cuda.OutOfMemoryError):
        return False
    msg = str(exc).lower()
    if any(marker in msg for marker in _BUG_MARKERS):
        return False
    strong = any(marker in msg for marker in _DEVICE_FAILURE_MARKERS)
    weak = (any(marker in msg for marker in _WEAK_FAILURE_MARKERS)
            and _DEVICE_WORD_RE.search(msg) is not None)
    return strong or weak


def classify_failure(exc: BaseException) -> Optional[Tuple[int, ...]]:
    """Is ``exc`` a device failure?

    Returns ``None`` for anything that is not (the caller re-raises: a
    bug must never be "recovered" into silence).  For a device failure,
    returns the victims' member ids: the failing rank's for a
    ``RankFailure``, else the ids the message names — possibly ``()``
    when something died but the message does not say what."""
    if isinstance(exc, RankFailure):
        if _is_device_failure(exc.exc):
            return (int(exc.member),)
        return None
    if not _is_device_failure(exc):
        return None
    return tuple(sorted({int(m) for m in
                         _DEVICE_ID_RE.findall(str(exc))}))


class PreemptionNotice:
    """Thread-safe preemption mailbox (the pluggable notice callback).

    Producers — a SIGTERM handler, a maintenance-event poller, a test —
    call ``post(member_ids)`` from any thread.  The controller drains it
    at each step boundary and turns the notice into a graceful drain +
    re-mesh.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._pending: Set[int] = set()
        self._posted = 0

    def post(self, device_ids: Sequence[int]) -> None:
        with self._lock:
            self._pending.update(int(d) for d in device_ids)
            self._posted += 1

    def drain(self) -> Tuple[int, ...]:
        """Take (and clear) the pending victim set."""
        with self._lock:
            out = tuple(sorted(self._pending))
            self._pending.clear()
        return out

    @property
    def pending(self) -> bool:
        with self._lock:
            return bool(self._pending)


def install_preemption_handler(notice: PreemptionNotice,
                               device_ids: Sequence[int],
                               signum: int = signal.SIGTERM) -> Callable:
    """Bind ``notice`` to a real OS signal (default SIGTERM — what cloud
    schedulers send ahead of eviction).  On delivery the handler posts
    ``device_ids`` into the mailbox: the member ids this process holds
    (its mesh's ``members``; the reference defaults to its local
    devices, which a process of thread ranks cannot enumerate apart from
    its mesh).  Chains any previously installed callable handler and
    returns it so callers can restore.  Must run on the main thread (a
    CPython rule)."""
    previous = signal.getsignal(signum)
    ids = tuple(int(d) for d in device_ids)

    def _handler(sig, frame):
        notice.post(ids)
        if callable(previous):
            previous(sig, frame)

    signal.signal(signum, _handler)
    return previous


def agree_survivors(local_view: Iterable[int],
                    peer_views: Sequence[Iterable[int]] = ()
                    ) -> Set[int]:
    """Single-host fast path of the survivor vote: a member survives only
    if EVERY view still trusts it — the rule the control plane commits
    under an epoch (``intersect_views``), applied in-process."""
    return intersect_views(local_view, peer_views)
