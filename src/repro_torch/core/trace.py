"""Application scan (paper §2.2): find the collective functions an
application actually invokes, before building its library.

Counterpart of ``repro.core.trace``.  The reference traces the step to a
jaxpr with abstract inputs and walks it for collective primitives.  The
port runs the step once, as rank 0, on ``meta`` tensors under the
substrate's recording transport (``substrate.recording``): no operation
computes and no memory is allocated, and every hop (``ppermute``, with
its bytes) and rank query (``axis_index``) is recorded as a call site —
the primitives the reference's jaxpr holds for the same step.  The
result is the function set 𝓕 plus the counts that drive tier
assignment (paper §3), and, through ``TraceReport.to_schedule``, the
step's program order as a comm schedule.  The recording transport sees
hops, not the compute between them, so the port's scanned schedule has
no compute barriers.

``region`` names a stretch of a step for the dry-run's accounting (the
training attention's score tiles), ``label`` a tree of tensors (the
gradients) for its live-bytes meter.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from collections import defaultdict
from typing import Any, Callable, Dict, List, Optional, Tuple

from repro_torch.core import registry
from repro_torch.core import schedule as schedule_mod
from repro_torch.runtime import substrate


@dataclasses.dataclass
class CallSite:
    """One collective call site of the scanned step."""

    function: str            # registry function name
    primitive: str           # the substrate primitive recorded
    count: int               # executions per step
    nbytes: int              # payload bytes per execution (per rank)
    axes: Tuple[str, ...]    # mesh axes it runs over
    path: Tuple[str, ...] = ()

    @property
    def total_bytes(self) -> int:
        return self.count * self.nbytes


@dataclasses.dataclass
class TraceReport:
    """The application's collective profile: 𝓕, frequencies, bytes."""

    sites: List[CallSite]

    @property
    def function_set(self) -> frozenset:
        return frozenset(s.function for s in self.sites)

    def frequencies(self) -> Dict[str, float]:
        freq: Dict[str, float] = defaultdict(float)
        for s in self.sites:
            freq[s.function] += float(s.count)
        return dict(freq)

    def bytes_by_function(self) -> Dict[str, int]:
        total: Dict[str, int] = defaultdict(int)
        for s in self.sites:
            total[s.function] += s.total_bytes
        return dict(total)

    def count(self, function: str) -> int:
        return sum(s.count for s in self.sites if s.function == function)

    def summary(self) -> str:
        lines = ["function            calls        bytes/step"]
        freq = self.frequencies()
        byt = self.bytes_by_function()
        for fn in sorted(freq, key=lambda f: -freq[f]):
            lines.append(f"{fn:<18s} {int(freq[fn]):>8d} {byt[fn]:>16,d}")
        return "\n".join(lines)

    def to_schedule(self, plan=None, topology=None) -> schedule_mod.Schedule:
        """The scanned program as a schedule, annotated through a
        ``CommPlan``: each unit gets the planned protocol, its (start,
        wait) stage split for its function and the cost model's per-phase
        wire bytes.  Without a plan, the scanner's default annotation."""
        base = _sites_schedule(self.sites)
        if plan is None:
            return base
        topo = topology if topology is not None else plan.topology

        def resolve(u: schedule_mod.CommUnit) -> schedule_mod.CommUnit:
            from repro_torch.core import plan as plan_mod
            axis = u.axes[0] if u.axes else None
            nbytes = u.start_bytes + u.wait_bytes
            if axis is None or topo is None or axis not in topo.axis_sizes:
                return u
            entry = plan.entry_for(u.fn, nbytes, axis)
            p = topo.axis_sizes[axis]
            sb, wb = plan_mod.phase_wire_bytes(entry.protocol, p, nbytes,
                                               u.fn)
            return dataclasses.replace(
                u, protocol=entry.protocol,
                start_stages=entry.start_stages,
                wait_stages=entry.wait_stages,
                start_bytes=sb, wait_bytes=wb)

        return schedule_mod.annotate(base, resolve)


def _sites_schedule(sites: List[CallSite]) -> schedule_mod.Schedule:
    """Default-annotated schedule of a scanned step: every collective an
    ``xla_default`` single-stage unit (the pre-plan view), in program
    order; rank queries are not messages and are dropped."""
    evs: List[Tuple[str, Any]] = []
    for s in sites:
        if s.function == registry.AXIS_INDEX:
            continue
        n = len(evs)
        evs.append(("comm", schedule_mod.sync_unit(
            name=f"{s.function}#{n}", index=n, fn=s.function,
            axes=s.axes, protocol="xla_default", start_stages=1,
            wait_stages=0, start_bytes=s.nbytes, wait_bytes=0)))
    return schedule_mod.schedule_from_events(evs)


def scan_step(fn: Callable, *args, **kwargs) -> TraceReport:
    """Run ``fn`` on ``meta`` inputs under the recording transport and
    report its collective call sites.  Nothing computes; a step that
    touches a real tensor's data raises (meta tensors have none)."""
    with substrate.recording() as rec:
        fn(*args, **kwargs)
    sites = [CallSite(function=s.function, primitive=s.function, count=1,
                      nbytes=s.nbytes, axes=(s.axis,)) for s in rec.sites]
    return TraceReport(sites=sites)


_local = threading.local()


@contextlib.contextmanager
def region(name: str):
    """Name the ops the calling thread runs in the block (innermost name
    wins): ``region_name()`` reads it."""
    prev = getattr(_local, "name", None)
    _local.name = name
    try:
        yield
    finally:
        _local.name = prev


def region_name() -> Optional[str]:
    """The calling thread's innermost ``region``, or None."""
    return getattr(_local, "name", None)


@contextlib.contextmanager
def labelling(fn: Callable[[Any, str], None]):
    """While the block runs, ``label(tree, kind)`` on this thread calls
    ``fn(tree, kind)`` (the dry-run's live-bytes meter)."""
    prev = getattr(_local, "labeller", None)
    _local.labeller = fn
    try:
        yield
    finally:
        _local.labeller = prev


#: the kind ``add_flops`` labels its count with
FLOPS = "flops"


def add_flops(n: int) -> None:
    """Count ``n`` flops for the meter of ``labelling`` (an op that runs
    none of its products on ``meta``: the flash op); nothing without
    one."""
    label(n, FLOPS)


def label(tree: Any, kind: str) -> None:
    """Name the tensors of ``tree`` ``kind`` ("grads", ...) for the
    meter of ``labelling``; nothing without one."""
    fn = getattr(_local, "labeller", None)
    if fn is not None:
        fn(tree, kind)
