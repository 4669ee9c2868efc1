"""Communication-schedule IR: collectives as a rewritable program.

Counterpart of ``repro.core.schedule``, op for op: for the same units
the builders, the passes (``repro_torch.core.plan``) and the cost-model
views give the reference's programs and numbers.  The module is
framework-free.

Which collective stages run when, interleaved with what compute, is a
small SSA-style program the planner can legally rewrite, in the spirit
of the xdsl MPI dialect (MPI ops over SSA values) and of *MPI Progress
For All*'s per-stage progression.

The op set:

  ``start(unit)``     post the collective; returns a token value.
                      Carries ``start_stages`` protocol stages and the
                      cost-model-predicted start-phase wire bytes.
  ``progress(unit)``  advance the in-flight collective by ``stages``
                      protocol stages (ring hops, doubling rounds, ...)
                      without completing it.
  ``wait(unit)``      complete the collective and consume its token.
                      Carries the *remaining* wait stages and bytes.
  ``compute(tag)``    opaque compute barrier (a microbatch's grads, the
                      loss epilogue).  Comm ops may not be reordered
                      across a compute op that defines one of their
                      operands; ``overlappable`` compute admits hoisted
                      starts running *under* it.

Values are plain strings (SSA names).  A schedule validates: every value
is defined before use, each unit is started exactly once and waited
exactly once, progress hops sit strictly between their unit's start and
wait, and progressed stages never exceed the unit's wait-stage budget.

On one card the ranks are threads sharing one stream, so a rewritten
program changes the order of the hops, not what runs concurrently.

The module is an import leaf: plan/trace/engine import *it*, never the
reverse, so passes stay pure data-to-data rewrites.
"""

from __future__ import annotations

import dataclasses
from typing import (Any, Callable, Dict, List, Optional, Sequence,
                    Tuple)

START = "start"
PROGRESS = "progress"
WAIT = "wait"
COMPUTE = "compute"

OP_KINDS = (START, PROGRESS, WAIT, COMPUTE)


@dataclasses.dataclass(frozen=True)
class CommUnit:
    """One logical collective in the program: a gradient bucket's
    all-reduce, a leaf sync, a broadcast.  Ops reference units by name;
    the unit carries everything the executor and the cost model need."""

    name: str                  # SSA-ish unique id, e.g. "bucket3.all_reduce"
    index: int                 # dense executor index (bucket, leaf slot)
    fn: str                    # registry function name ("all_reduce", ...)
    axes: Tuple[str, ...]      # mesh axes the collective spans
    protocol: str              # costmodel protocol constant
    start_stages: int          # protocol stages retired inside start
    wait_stages: int           # protocol stages retired inside wait
    start_bytes: int           # predicted wire bytes moved by start
    wait_bytes: int            # predicted wire bytes moved by wait
    uses: Tuple[str, ...] = () # SSA values the collective reads
    defs: Tuple[str, ...] = () # SSA values it produces (post-wait)

    @property
    def total_bytes(self) -> int:
        return self.start_bytes + self.wait_bytes


@dataclasses.dataclass(frozen=True)
class CommOp:
    """One phase hop of a unit."""

    kind: str                  # start | progress | wait
    unit: str                  # CommUnit.name
    stages: int = 0            # protocol stages this op retires
    bytes: int = 0             # predicted wire bytes this op moves
    uses: Tuple[str, ...] = ()
    defs: Tuple[str, ...] = ()
    overlaps: Optional[str] = None  # compute tag a hoisted start runs under

    def __post_init__(self):
        if self.kind not in (START, PROGRESS, WAIT):
            raise ValueError(f"bad CommOp kind {self.kind!r}")


@dataclasses.dataclass(frozen=True)
class ComputeOp:
    """Opaque compute region between comm ops."""

    kind: str = COMPUTE
    tag: str = "compute"
    uses: Tuple[str, ...] = ()
    defs: Tuple[str, ...] = ()
    overlappable: bool = False  # may hoisted starts run under this?

    def __post_init__(self):
        if self.kind != COMPUTE:
            raise ValueError(f"bad ComputeOp kind {self.kind!r}")


Op = Any  # CommOp | ComputeOp


@dataclasses.dataclass
class Schedule:
    """A straight-line comm/compute program over named units."""

    units: Tuple[CommUnit, ...]
    ops: Tuple[Op, ...]
    meta: Dict[str, Any] = dataclasses.field(default_factory=dict)

    # -- introspection -------------------------------------------------
    def unit(self, name: str) -> CommUnit:
        for u in self.units:
            if u.name == name:
                return u
        raise KeyError(f"no unit named {name!r}")

    @property
    def comm_ops(self) -> Tuple[CommOp, ...]:
        return tuple(op for op in self.ops if isinstance(op, CommOp))

    @property
    def depth(self) -> int:
        """Max collectives simultaneously in flight."""
        live = 0
        worst = 0
        for op in self.comm_ops:
            if op.kind == START:
                live += 1
                worst = max(worst, live)
            elif op.kind == WAIT:
                live -= 1
        return worst

    # -- validation ----------------------------------------------------
    def validate(self) -> "Schedule":
        """SSA + phase-protocol well-formedness.  Raises ValueError."""
        names = [u.name for u in self.units]
        if len(set(names)) != len(names):
            raise ValueError("duplicate unit names in schedule")
        by_name = {u.name: u for u in self.units}
        # a value some op defines must be defined *before* use; values no
        # op defines are schedule inputs (free)
        op_defs: set = set()
        for op in self.ops:
            op_defs.update(op.defs)
        defined: set = set()
        for u in self.units:
            defined.update(v for v in u.uses if v not in op_defs)
        for op in self.ops:
            defined.update(v for v in op.uses if v not in op_defs)
        state: Dict[str, str] = {}          # unit -> phase
        progressed: Dict[str, int] = {}     # unit -> stages progressed
        for i, op in enumerate(self.ops):
            for v in op.uses:
                if v not in defined:
                    raise ValueError(
                        f"op {i} ({_op_str(op)}) uses undefined value {v!r}")
            if isinstance(op, ComputeOp):
                defined.update(op.defs)
                continue
            u = by_name.get(op.unit)
            if u is None:
                raise ValueError(f"op {i} references unknown unit {op.unit!r}")
            phase = state.get(op.unit)
            if op.kind == START:
                if phase is not None:
                    raise ValueError(f"unit {op.unit!r} started twice")
                state[op.unit] = START
            elif op.kind == PROGRESS:
                if phase != START:
                    raise ValueError(
                        f"progress on unit {op.unit!r} outside its "
                        f"start/wait window")
                progressed[op.unit] = progressed.get(op.unit, 0) + op.stages
                if progressed[op.unit] > u.wait_stages:
                    raise ValueError(
                        f"unit {op.unit!r} progressed "
                        f"{progressed[op.unit]} stages but only "
                        f"{u.wait_stages} wait stages exist")
            elif op.kind == WAIT:
                if phase != START:
                    raise ValueError(
                        f"unit {op.unit!r} waited without a live start")
                state[op.unit] = WAIT
                defined.update(op.defs)
        for u in self.units:
            if state.get(u.name) != WAIT:
                raise ValueError(f"unit {u.name!r} never completed "
                                 f"(state={state.get(u.name)})")
        return self

    # -- cost-model views ----------------------------------------------
    def predicted_phase_bytes(self) -> Dict[str, int]:
        """Predicted wire bytes keyed like ``CommStats.phase_bytes``
        (``"<fn>.start"`` / ``"<fn>.progress"`` / ``"<fn>.wait"``)."""
        by_name = {u.name: u for u in self.units}
        out: Dict[str, int] = {}
        for op in self.comm_ops:
            fn = by_name[op.unit].fn
            key = f"{fn}.{op.kind}"
            out[key] = out.get(key, 0) + int(op.bytes)
        return out

    def predicted_timeline(self) -> List[Dict[str, Any]]:
        """Op-by-op predicted timeline (for ``describe``/diff views)."""
        by_name = {u.name: u for u in self.units}
        rows: List[Dict[str, Any]] = []
        for op in self.ops:
            if isinstance(op, ComputeOp):
                rows.append({"op": COMPUTE, "tag": op.tag,
                             "overlappable": op.overlappable})
            else:
                u = by_name[op.unit]
                rows.append({"op": op.kind, "unit": op.unit, "fn": u.fn,
                             "protocol": u.protocol, "stages": op.stages,
                             "bytes": int(op.bytes),
                             "overlaps": op.overlaps})
        return rows

    def describe(self) -> str:
        lines = [f"schedule: {len(self.units)} unit(s), "
                 f"{len(self.ops)} op(s), depth {self.depth}"]
        for op in self.ops:
            lines.append("  " + _op_str(op))
        return "\n".join(lines)


def _op_str(op: Op) -> str:
    if isinstance(op, ComputeOp):
        flag = " [overlappable]" if op.overlappable else ""
        return f"compute<{op.tag}>{flag}"
    extra = f" +{op.stages}st" if op.kind == PROGRESS else ""
    under = f" under<{op.overlaps}>" if op.overlaps else ""
    return f"{op.kind}<{op.unit}>{extra} ~{op.bytes}B{under}"


# ---------------------------------------------------------------------------
# builders


def sync_unit(name: str, index: int, fn: str, axes: Sequence[str],
              protocol: str, start_stages: int, wait_stages: int,
              start_bytes: int, wait_bytes: int,
              uses: Sequence[str] = (), defs: Sequence[str] = ()) -> CommUnit:
    """Convenience constructor used by the comm layer (keeps call sites
    keyword-light)."""
    if not defs:
        defs = (f"{name}.out",)
    return CommUnit(name=name, index=index, fn=fn, axes=tuple(axes),
                    protocol=protocol, start_stages=int(start_stages),
                    wait_stages=int(wait_stages),
                    start_bytes=int(start_bytes), wait_bytes=int(wait_bytes),
                    uses=tuple(uses), defs=tuple(defs))


def build_sync_schedule(units: Sequence[CommUnit],
                        compute: Sequence[ComputeOp] = (),
                        meta: Optional[Dict[str, Any]] = None) -> Schedule:
    """The canonical *blocking* program: each compute op in order, then
    ``start; wait`` per unit back-to-back.  Every overlapped program is
    derived from this by passes — never hand-built."""
    ops: List[Op] = list(compute)
    for u in units:
        ops.append(CommOp(kind=START, unit=u.name, stages=u.start_stages,
                          bytes=u.start_bytes, uses=u.uses))
        ops.append(CommOp(kind=WAIT, unit=u.name, stages=u.wait_stages,
                          bytes=u.wait_bytes, defs=u.defs))
    sched = Schedule(units=tuple(units), ops=tuple(ops), meta=dict(meta or {}))
    return sched.validate()


def schedule_from_events(events: Sequence[Tuple[str, Any]],
                         meta: Optional[Dict[str, Any]] = None) -> Schedule:
    """Build a blocking schedule from a trace-scanner event stream:
    ``("comm", CommUnit)`` and ``("compute", tag_str)`` tuples in
    program order."""
    units: List[CommUnit] = []
    ops: List[Op] = []
    for kind, payload in events:
        if kind == "compute":
            ops.append(ComputeOp(tag=str(payload)))
        elif kind == "comm":
            u: CommUnit = payload
            units.append(u)
            ops.append(CommOp(kind=START, unit=u.name, stages=u.start_stages,
                              bytes=u.start_bytes, uses=u.uses))
            ops.append(CommOp(kind=WAIT, unit=u.name, stages=u.wait_stages,
                              bytes=u.wait_bytes, defs=u.defs))
        else:
            raise ValueError(f"unknown event kind {kind!r}")
    sched = Schedule(units=tuple(units), ops=tuple(ops), meta=dict(meta or {}))
    return sched.validate()


def annotate(schedule: Schedule,
             resolve: Callable[[CommUnit], CommUnit]) -> Schedule:
    """Re-annotate every unit through ``resolve`` (e.g. swap in planner
    protocols + honest stage splits) and rebuild op stage/byte fields
    from the new units.  Op *order* is preserved."""
    new_units = tuple(resolve(u) for u in schedule.units)
    by_name = {u.name: u for u in new_units}
    ops: List[Op] = []
    for op in schedule.ops:
        if isinstance(op, ComputeOp):
            ops.append(op)
            continue
        u = by_name[op.unit]
        if op.kind == START:
            ops.append(dataclasses.replace(op, stages=u.start_stages,
                                           bytes=u.start_bytes))
        elif op.kind == WAIT:
            ops.append(dataclasses.replace(op, stages=u.wait_stages,
                                           bytes=u.wait_bytes))
        else:  # progress hops are rebuilt by passes, not annotation
            ops.append(op)
    out = Schedule(units=new_units, ops=tuple(ops),
                   meta=dict(schedule.meta))
    return out.validate()


# ---------------------------------------------------------------------------
# execution


def execute(schedule: Schedule, *,
            start: Callable[[CommUnit], Any],
            wait: Callable[[CommUnit, Any], Any],
            progress: Optional[Callable[[CommUnit, Any, int], Any]] = None,
            compute: Optional[Callable[[ComputeOp], None]] = None,
            ) -> Dict[str, Any]:
    """Run a validated schedule through phase callbacks.

    ``start(unit) -> token``; ``progress(unit, token, stages) -> token``
    (may return None to keep the old token); ``wait(unit, token) ->
    result``.  Returns ``{unit.name: result}``.  The executor is the
    ONLY place op order turns into calls — the trainer
    never sequences start/wait by hand."""
    by_name = {u.name: u for u in schedule.units}
    tokens: Dict[str, Any] = {}
    results: Dict[str, Any] = {}
    for op in schedule.ops:
        if isinstance(op, ComputeOp):
            if compute is not None:
                compute(op)
            continue
        u = by_name[op.unit]
        if op.kind == START:
            tokens[u.name] = start(u)
        elif op.kind == PROGRESS:
            if progress is not None:
                tok = progress(u, tokens[u.name], op.stages)
                if tok is not None:
                    tokens[u.name] = tok
        elif op.kind == WAIT:
            results[u.name] = wait(u, tokens.pop(u.name))
    return results


def modeled_exposed_comm_frac(schedule: Schedule,
                              compute_weight: float = 0.0) -> float:
    """Cost-model exposure of a schedule: the fraction of comm bytes
    still on the critical path after overlap, from a byte-time
    simulation of the op order (deterministic — no wall clock, so it is
    meaningful on hosts whose timings can't resolve real overlap).

    Semantics: ``start`` posts its bytes on the wire (no synchronous
    cost); ``progress`` drives more of a unit's transfer onto the wire
    early; in-flight bytes drain for free under subsequent synchronous
    work (other units' waits, ``compute_weight`` per compute op).  A
    ``wait`` synchronously pays its remaining bytes plus whatever the
    window since start failed to hide.  Blocking schedules score 1.0;
    deeper interleaving scores lower because each unit sees a larger
    hiding window and progress hops shrink the synchronous wait tail.
    """
    by_name = {u.name: u for u in schedule.units}
    w = 0.0                      # cumulative synchronous time (byte units)
    start_w: Dict[str, float] = {}
    inflight: Dict[str, float] = {}
    exposed = 0.0
    total = 0.0
    for op in schedule.ops:
        if isinstance(op, ComputeOp):
            w += compute_weight
            continue
        if op.unit not in by_name:
            continue
        if op.kind == START:
            start_w[op.unit] = w
            inflight[op.unit] = float(op.bytes)
            total += op.bytes
        elif op.kind == PROGRESS:
            inflight[op.unit] = inflight.get(op.unit, 0.0) + float(op.bytes)
            total += op.bytes
        elif op.kind == WAIT:
            window = w - start_w.get(op.unit, w)
            hid = min(inflight.get(op.unit, 0.0), window)
            exp_u = inflight.get(op.unit, 0.0) - hid + float(op.bytes)
            exposed += exp_u
            total += op.bytes
            w += exp_u
    return exposed / total if total else 0.0


# ---------------------------------------------------------------------------
# predicted-vs-measured diff


def timeline_diff(schedule: Schedule,
                  measured_phase_bytes: Dict[str, int]
                  ) -> Dict[str, Dict[str, int]]:
    """Diff the schedule's predicted phase bytes against a
    ``CommStats.phase_bytes`` mapping.  Keys present on either side
    appear in the output with ``predicted``, ``measured``, ``delta``."""
    predicted = schedule.predicted_phase_bytes()
    keys = sorted(set(predicted) | set(measured_phase_bytes))
    out: Dict[str, Dict[str, int]] = {}
    for k in keys:
        p = int(predicted.get(k, 0))
        m = int(measured_phase_bytes.get(k, 0))
        out[k] = {"predicted": p, "measured": m, "delta": m - p}
    return out
