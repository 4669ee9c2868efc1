"""Plan-once communication runtime (paper §3/§4): the protocol dispatch
table and gradient bucket planning.

Counterpart of ``repro.core.plan``.  The arithmetic is the reference's:

* ``CommPlan`` — a per-engine protocol dispatch table keyed on
  ``(function, axis, pow2 size-bucket)``, precomputed from the cost model
  at engine construction and consulted with a single dict lookup per
  call.  The cache is rebuilt only when the topology fingerprint changes.

* Gradient bucket planning — dtype-grouped, size-capped buckets: leaves
  are grouped by dtype (bf16 stays bf16 on the wire), each group is
  split into buckets of at most ``bucket_bytes``.  Dtypes are grouped
  and ordered by their numpy names ("bfloat16", "float32"), as the
  reference orders them.

* Schedule-IR passes — ``reverse_layout_pass``, ``interleave_pass(depth)``
  and ``hoist_starts_pass``, composed by ``canonical_overlap_passes`` and
  applied by ``run_passes``.
"""

from __future__ import annotations

import dataclasses
import time
from collections import Counter
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import torch

from repro_torch.core import costmodel, registry
from repro_torch.core import schedule as schedule_mod
from repro_torch.core.costmodel import ProtocolChoice
from repro_torch.core.topology import Topology

#: default size cap per gradient bucket (bytes on the wire).
DEFAULT_BUCKET_BYTES = 32 * 1024 * 1024

#: size buckets cover 1 byte .. 16 GiB; larger messages share the top bucket.
MAX_SIZE_BUCKET = 34


def size_bucket(nbytes: float) -> int:
    """Pow2 bucket index b such that nbytes <= 2**b (0 for empty)."""
    n = int(nbytes)
    if n <= 1:
        return 0
    return min((n - 1).bit_length(), MAX_SIZE_BUCKET)


def bucket_nbytes(bucket: int) -> int:
    """Representative message size the cost model is evaluated at."""
    return 1 << bucket


# ---------------------------------------------------------------------------
# Two-phase stage accounting: every planned protocol is split into a start
# phase and a wait phase (the remaining stages + finalization).
# ---------------------------------------------------------------------------


def _log_stages(p: int) -> Tuple[int, int]:
    """All ``ceil(log2 p)`` rounds in start (recursive doubling, Bruck,
    binomial tree)."""
    if p <= 1:
        return (0, 0)
    return ((p - 1).bit_length(), 0)


def _linear_stages(p: int) -> Tuple[int, int]:
    """p - 1 rounds, all in start (pairwise exchange)."""
    if p <= 1:
        return (0, 0)
    return (p - 1, 0)


def _p2p_stages(p: int) -> Tuple[int, int]:
    """One hop in start (a pipeline send/recv)."""
    if p <= 1:
        return (0, 0)
    return (1, 0)


def _rabenseifner_stages(p: int) -> Tuple[int, int]:
    """log2 p halving rounds in start, log2 p doubling rounds in wait."""
    if p <= 1:
        return (0, 0)
    lg = (p - 1).bit_length()
    return (lg, lg)


def protocol_stage_counts(protocol: str, p: int,
                          fn: str = registry.ALL_REDUCE) -> Tuple[int, int]:
    """(start stages, wait stages) of ``protocol``'s start/wait split on an
    axis of size ``p``.  The base table is the all-reduce split; some
    functions override it (a ring all-gather has no reduce half)."""
    if p <= 1:
        return (0, 0)
    lg = (p - 1).bit_length()            # ceil(log2 p)
    if fn != registry.ALL_REDUCE:
        override = _FN_STAGE_OVERRIDES.get((fn, protocol))
        if override is not None:
            return override(p)
    table = {
        costmodel.RING: (p - 1, p - 1),                # RS | AG
        costmodel.BIDIR_RING: (p - 1, p // 2),         # bidir RS | bidir AG
        costmodel.RECURSIVE_HALVING: _rabenseifner_stages(p),
        costmodel.RECURSIVE_DOUBLING: _log_stages(p),
        costmodel.XLA_DEFAULT: (1, 0),
        costmodel.BRUCK: _log_stages(p),
        costmodel.PAIRWISE: _linear_stages(p),
        costmodel.BINOMIAL_TREE: (lg, 0),
        costmodel.PIPELINE: _p2p_stages(p),
        costmodel.TWO_PHASE_2D: (p - 1, 2 * (p - 1)),  # RS(ax0) | AR+AG
        costmodel.HIERARCHICAL: (p - 1, 2 * (p - 1)),
    }
    return table.get(protocol, (1, 0))


_FN_STAGE_OVERRIDES = {
    (registry.REDUCE_SCATTER, costmodel.RING): lambda p: (p - 1, 0),
    (registry.REDUCE_SCATTER, costmodel.BIDIR_RING): lambda p: (p - 1, 0),
    (registry.REDUCE_SCATTER, costmodel.RECURSIVE_HALVING):
        lambda p: ((p - 1).bit_length(), 0),
    (registry.ALL_GATHER, costmodel.RING): lambda p: (p - 1, 0),
    (registry.ALL_GATHER, costmodel.BIDIR_RING): lambda p: (p // 2, 0),
    (registry.ALL_GATHER, costmodel.BRUCK): _log_stages,
    (registry.ALL_GATHER, costmodel.RECURSIVE_DOUBLING): _log_stages,
    (registry.ALL_TO_ALL, costmodel.BRUCK): _log_stages,
    (registry.ALL_TO_ALL, costmodel.PAIRWISE): _linear_stages,
    # van de Geijn: binomial scatter in start | ring all-gather in wait
    (registry.BROADCAST, costmodel.RING):
        lambda p: ((p - 1).bit_length(), p - 1),
    (registry.BROADCAST, costmodel.BINOMIAL_TREE):
        lambda p: ((p - 1).bit_length(), 0),
    (registry.PERMUTE, costmodel.PIPELINE): _p2p_stages,
    (registry.SEND_RECV, costmodel.PIPELINE): _p2p_stages,
}


def phase_wire_bytes(protocol: str, p: int, nbytes: int,
                     fn: str = registry.ALL_REDUCE) -> Tuple[int, int]:
    """Per-rank wire bytes each phase of the split moves for an
    ``nbytes`` payload.  Ring-class protocols move (p-1)/p·n per phase;
    start-only protocols put everything in flight at ``start``."""
    if p <= 1:
        return (0, 0)
    n = int(nbytes)
    share = (p - 1) * n // p
    lg = (p - 1).bit_length()
    if fn != registry.ALL_REDUCE:
        override = _FN_BYTE_OVERRIDES.get((fn, protocol))
        if override is not None:
            return override(p, n)
    table = {
        costmodel.RING: (share, share),
        costmodel.BIDIR_RING: (share, share),
        costmodel.RECURSIVE_HALVING: (share, share),
        costmodel.RECURSIVE_DOUBLING: (lg * n, 0),
        costmodel.XLA_DEFAULT: (2 * share, 0),
        costmodel.BRUCK: (share, 0),
        costmodel.PAIRWISE: (share, 0),
        costmodel.BINOMIAL_TREE: (lg * n, 0),
        costmodel.PIPELINE: (n, 0),
        costmodel.TWO_PHASE_2D: (share, share + 2 * n // p),
        costmodel.HIERARCHICAL: (share, share + 2 * n // p),
    }
    return table.get(protocol, (n, 0))


def _one_phase(p: int, n: int) -> Tuple[int, int]:
    return ((p - 1) * n // p, 0)


_FN_BYTE_OVERRIDES = {
    (registry.REDUCE_SCATTER, costmodel.RING): _one_phase,
    (registry.REDUCE_SCATTER, costmodel.BIDIR_RING): _one_phase,
    (registry.REDUCE_SCATTER, costmodel.RECURSIVE_HALVING): _one_phase,
    (registry.ALL_GATHER, costmodel.RING): _one_phase,
    (registry.ALL_GATHER, costmodel.BIDIR_RING): _one_phase,
    (registry.ALL_GATHER, costmodel.BRUCK):
        lambda p, n: ((p - 1).bit_length() * n // 2, 0),
    (registry.ALL_GATHER, costmodel.RECURSIVE_DOUBLING): _one_phase,
    (registry.ALL_TO_ALL, costmodel.BRUCK):
        lambda p, n: ((p - 1).bit_length() * n // 2, 0),
    (registry.ALL_TO_ALL, costmodel.PAIRWISE): _one_phase,
    (registry.BROADCAST, costmodel.RING):
        lambda p, n: ((p - 1) * n // p, (p - 1) * n // p),
    (registry.BROADCAST, costmodel.BINOMIAL_TREE):
        lambda p, n: ((p - 1).bit_length() * n, 0),
    (registry.PERMUTE, costmodel.PIPELINE): lambda p, n: (n, 0),
    (registry.SEND_RECV, costmodel.PIPELINE): lambda p, n: (n, 0),
}


@dataclasses.dataclass(frozen=True)
class PlanEntry:
    """One planned dispatch-table row: the cost-model choice plus the
    two-phase stage counts of the chosen protocol on this axis."""

    protocol: str
    est_seconds: float
    alternatives: Tuple[Tuple[str, float], ...]
    start_stages: int
    wait_stages: int

    @classmethod
    def from_choice(cls, choice: ProtocolChoice, p: int,
                    fn: str = registry.ALL_REDUCE) -> "PlanEntry":
        start, wait = protocol_stage_counts(choice.protocol, p, fn)
        return cls(protocol=choice.protocol, est_seconds=choice.est_seconds,
                   alternatives=choice.alternatives,
                   start_stages=start, wait_stages=wait)


@dataclasses.dataclass
class PlanStats:
    computes: Counter = dataclasses.field(default_factory=Counter)
    hits: int = 0
    rebuilds: int = 0
    last_rebuild_seconds: float = 0.0

    def compute_count(self, key) -> int:
        return self.computes[key]

    @property
    def total_computes(self) -> int:
        return sum(self.computes.values())


class CommPlan:
    """Protocol dispatch table: plan once, execute many.

    ``protocol_for`` is the hot-path entry: one dict lookup when the
    ``(fn, axis, size_bucket)`` key was planned (always, after the eager
    warm at construction), one cost-model evaluation otherwise.  With
    ``enabled=False`` the cost model runs on every call."""

    def __init__(self, topology: Topology, *, composed: bool = True,
                 force: Optional[Mapping[str, str]] = None,
                 enabled: bool = True,
                 warm_functions: Sequence[str] = ()) -> None:
        self.topology = topology
        self.fingerprint = None if topology is None else topology.fingerprint()
        self.composed = composed
        self.force = dict(force or {})
        self.enabled = enabled
        self.warm_functions = tuple(warm_functions)
        self.stats = PlanStats()
        self._table: Dict[Tuple[str, str, int], PlanEntry] = {}
        self._protocols: Dict[Tuple[str, str, int], str] = {}
        if enabled and composed:
            self.warm(self.warm_functions or None)

    def warm(self, functions: Optional[Sequence[str]] = None,
             axes: Optional[Sequence[str]] = None) -> None:
        """Eagerly fill the dispatch table for every (fn, axis, bucket)."""
        if self.topology is None:
            return
        fns = [f for f in (functions or costmodel.protocol_functions())
               if costmodel.protocol_menu(f)]
        for fn in fns:
            for axis in (axes or self.topology.axis_sizes):
                for b in range(MAX_SIZE_BUCKET + 1):
                    self._plan_key(fn, axis, b)

    def _plan_key(self, fn: str, axis: str, bucket: int) -> PlanEntry:
        key = (fn, axis, bucket)
        entry = self._table.get(key)
        if entry is None:
            self.stats.computes[key] += 1
            choice = costmodel.choose_protocol(
                fn, bucket_nbytes(bucket), self.topology, axis)
            p = (self.topology.axis_sizes.get(axis, 1)
                 if self.topology is not None else 1)
            entry = PlanEntry.from_choice(choice, p, fn)
            self._table[key] = entry
            self._protocols[key] = entry.protocol
        return entry

    def protocol_for(self, fn: str, nbytes: float, axis: str) -> str:
        if not self.composed:
            return costmodel.XLA_DEFAULT
        forced = self.force.get(fn)
        if forced:
            return forced
        if not self.enabled:
            return costmodel.choose_protocol(
                fn, nbytes, self.topology, axis).protocol
        n = int(nbytes)
        b = (n - 1).bit_length() if n > 1 else 0
        if b > MAX_SIZE_BUCKET:
            b = MAX_SIZE_BUCKET
        proto = self._protocols.get((fn, axis, b))
        if proto is None:
            return self._plan_key(fn, axis, b).protocol
        self.stats.hits += 1
        return proto

    def entry_for(self, fn: str, nbytes: float, axis: str) -> PlanEntry:
        if self.composed and self.enabled and fn not in self.force:
            return self._plan_key(fn, axis, size_bucket(nbytes))
        proto = self.protocol_for(fn, nbytes, axis)
        p = (self.topology.axis_sizes.get(axis, 1)
             if self.topology is not None else 1)
        return PlanEntry.from_choice(ProtocolChoice(proto, 0.0, ()), p, fn)

    def maybe_rebuild(self, topology: Topology) -> bool:
        """Topology change => rebuild (the one plan-invalidation rule)."""
        fp = None if topology is None else topology.fingerprint()
        if fp == self.fingerprint:
            self.topology = topology
            return False
        self.topology = topology
        self.fingerprint = fp
        self._table.clear()
        self._protocols.clear()
        self.stats.rebuilds += 1
        t0 = time.perf_counter()
        if self.enabled and self.composed:
            self.warm(self.warm_functions or None)
        self.stats.last_rebuild_seconds = time.perf_counter() - t0
        return True

    @property
    def table_size(self) -> int:
        return len(self._table)

    def describe(self) -> str:
        return (f"CommPlan(entries={len(self._table)}, "
                f"computes={self.stats.total_computes}, "
                f"hits={self.stats.hits}, rebuilds={self.stats.rebuilds})")


# ---------------------------------------------------------------------------
# Gradient bucket planning: dtype-grouped, size-capped fused buckets
# ---------------------------------------------------------------------------


def dtype_name(dtype) -> str:
    """numpy's name of a torch dtype ("float32", "bfloat16", ...)."""
    return str(dtype).rsplit(".", 1)[-1]


@dataclasses.dataclass(frozen=True)
class LeafSlot:
    """Where one leaf lives inside a bucket's flat vector."""

    index: int
    offset: int
    size: int
    shape: Tuple[int, ...]
    dtype: Any


@dataclasses.dataclass(frozen=True)
class GradBucket:
    """One fused collective's worth of gradient leaves (same wire dtype)."""

    wire_dtype: Any
    size: int
    slots: Tuple[LeafSlot, ...]

    @property
    def nbytes(self) -> int:
        return self.size * torch.empty((), dtype=self.wire_dtype
                                       ).element_size()


_DTYPES = {dtype_name(d): d for d in (torch.float32, torch.bfloat16,
                                      torch.float16, torch.float64)}


def plan_buckets(leaves: Sequence[Any],
                 bucket_bytes: Optional[int] = DEFAULT_BUCKET_BYTES,
                 dtype_aware: bool = True,
                 keys: Optional[Sequence[bool]] = None
                 ) -> Tuple[GradBucket, ...]:
    """Group leaves by dtype, then split each group into size-capped
    buckets (the reference's layout: groups in dtype-name order, leaves
    in tree order; a leaf larger than the cap gets its own bucket).
    ``keys`` (one a leaf) splits each dtype group further: leaves of
    different keys never share a bucket, False's buckets first."""
    groups: Dict[Tuple[str, bool], List[int]] = {}
    for idx, leaf in enumerate(leaves):
        key = dtype_name(leaf.dtype) if dtype_aware else "float32"
        groups.setdefault((key, bool(keys[idx]) if keys else False),
                          []).append(idx)

    buckets: List[GradBucket] = []
    for key in sorted(groups):
        wire_dtype = _DTYPES[key[0]]
        itemsize = torch.empty((), dtype=wire_dtype).element_size()
        slots: List[LeafSlot] = []
        offset = 0
        for idx in groups[key]:
            leaf = leaves[idx]
            size = int(leaf.numel())
            if (slots and bucket_bytes is not None
                    and (offset + size) * itemsize > bucket_bytes):
                buckets.append(GradBucket(wire_dtype, offset, tuple(slots)))
                slots, offset = [], 0
            slots.append(LeafSlot(idx, offset, size, tuple(leaf.shape),
                                  leaf.dtype))
            offset += size
        if slots:
            buckets.append(GradBucket(wire_dtype, offset, tuple(slots)))
    return tuple(buckets)


def gather_bucket(leaves: Sequence[torch.Tensor], bucket: GradBucket
                  ) -> torch.Tensor:
    """Concatenate a bucket's leaves into one flat wire-dtype vector."""
    parts = [leaves[s.index].reshape(-1).to(bucket.wire_dtype)
             for s in bucket.slots]
    return parts[0] if len(parts) == 1 else torch.cat(parts)


def scatter_bucket(flat: torch.Tensor, bucket: GradBucket,
                   out: List[Optional[torch.Tensor]]) -> None:
    """Slice a synced bucket back into per-leaf tensors (leaf dtypes)."""
    for s in bucket.slots:
        out[s.index] = (flat[s.offset:s.offset + s.size]
                        .reshape(s.shape).to(s.dtype))


# ---------------------------------------------------------------------------
# Schedule-IR rewrite passes: the planner's legal transformations of a
# comm/compute program.  Every overlapped execution order of the port is
# one of these passes applied to the canonical blocking schedule — never a
# hand-written loop.  Op for op the reference's.
# ---------------------------------------------------------------------------


def _split_blocking(sched: "schedule_mod.Schedule"):
    """Split ops into (prefix, unit-order, suffix) where the comm region is
    strictly blocking ``start; wait`` pairs.  Raises ValueError if the
    schedule was already pipelined (passes compose on blocking form)."""
    ops = list(sched.ops)
    first = next((i for i, op in enumerate(ops)
                  if isinstance(op, schedule_mod.CommOp)), len(ops))
    prefix, rest = ops[:first], ops[first:]
    order: List[str] = []
    suffix: List[Any] = []
    i = 0
    while i < len(rest):
        op = rest[i]
        if not isinstance(op, schedule_mod.CommOp):
            suffix.append(op)
            i += 1
            continue
        if (op.kind != schedule_mod.START or i + 1 >= len(rest)
                or not isinstance(rest[i + 1], schedule_mod.CommOp)
                or rest[i + 1].kind != schedule_mod.WAIT
                or rest[i + 1].unit != op.unit):
            raise ValueError(
                "pass expects a blocking schedule (start; wait pairs); "
                f"got {op.kind}<{op.unit}> at comm position {i}")
        order.append(op.unit)
        i += 2
    return prefix, order, suffix


def reverse_layout_pass(sched: "schedule_mod.Schedule"
                        ) -> "schedule_mod.Schedule":
    """Reverse the bucket issue order.  Backprop produces the *last*
    layers' gradients first, so issuing buckets in reverse layout order
    lets the earliest-ready collectives start first."""
    prefix, order, suffix = _split_blocking(sched)
    by_name = {u.name: u for u in sched.units}
    ops = list(prefix)
    for name in reversed(order):
        u = by_name[name]
        ops.append(schedule_mod.CommOp(
            kind=schedule_mod.START, unit=name, stages=u.start_stages,
            bytes=u.start_bytes, uses=u.uses))
        ops.append(schedule_mod.CommOp(
            kind=schedule_mod.WAIT, unit=name, stages=u.wait_stages,
            bytes=u.wait_bytes, defs=u.defs))
    ops.extend(suffix)
    out = schedule_mod.Schedule(units=sched.units, ops=tuple(ops),
                                meta=dict(sched.meta))
    return out.validate()


def interleave_pass(depth: int = 2):
    """Depth-``depth`` software pipelining of the comm region.

    Keeps up to ``depth`` collectives in flight: start unit k, and once
    ``depth`` are live, wait the oldest.  ``depth=2`` is the classic
    software pipeline (start one ahead, no progress hops).  ``depth>=3``
    also emits a one-stage ``progress`` hop on every younger in-flight
    unit before each wait, draining wait-phase stages early so the final
    wait has less exposed work — the *MPI Progress For All* move.

    Progress byte accounting matches the engine's conservation rule
    (``moved = bytes_left * k // stages_left``), so predicted phase
    bytes stay exact.
    """
    if depth < 1:
        raise ValueError(f"interleave depth must be >= 1, got {depth}")

    def run(sched: "schedule_mod.Schedule") -> "schedule_mod.Schedule":
        prefix, order, suffix = _split_blocking(sched)
        by_name = {u.name: u for u in sched.units}
        stages_left = {n: by_name[n].wait_stages for n in order}
        bytes_left = {n: by_name[n].wait_bytes for n in order}
        ops = list(prefix)
        inflight: List[str] = []

        def emit_progress(name: str) -> None:
            if depth < 3 or stages_left[name] <= 0:
                return
            moved = bytes_left[name] // stages_left[name]
            ops.append(schedule_mod.CommOp(
                kind=schedule_mod.PROGRESS, unit=name, stages=1,
                bytes=moved))
            stages_left[name] -= 1
            bytes_left[name] -= moved

        def emit_wait(name: str) -> None:
            u = by_name[name]
            ops.append(schedule_mod.CommOp(
                kind=schedule_mod.WAIT, unit=name,
                stages=stages_left[name], bytes=bytes_left[name],
                defs=u.defs))

        for name in order:
            u = by_name[name]
            ops.append(schedule_mod.CommOp(
                kind=schedule_mod.START, unit=name, stages=u.start_stages,
                bytes=u.start_bytes, uses=u.uses))
            inflight.append(name)
            if len(inflight) > depth - 1:
                oldest = inflight.pop(0)
                for younger in inflight:
                    emit_progress(younger)
                emit_wait(oldest)
        while inflight:
            oldest = inflight.pop(0)
            for younger in inflight:
                emit_progress(younger)
            emit_wait(oldest)
        ops.extend(suffix)
        out = schedule_mod.Schedule(units=sched.units, ops=tuple(ops),
                                    meta=dict(sched.meta))
        return out.validate()

    run.__name__ = f"interleave_pass(depth={depth})"
    return run


def hoist_starts_pass(sched: "schedule_mod.Schedule"
                      ) -> "schedule_mod.Schedule":
    """Hoist ``start`` ops upward across overlappable compute.

    A start may cross a ``ComputeOp`` iff the compute is marked
    ``overlappable`` and defines none of the collective's operands (SSA
    legality).  The crossed start is annotated ``overlaps=<tag>`` so the
    predicted timeline knows which compute hides its launch (the peeled
    microbatch of the overlapped train step)."""
    ops = list(sched.ops)
    by_name = {u.name: u for u in sched.units}
    changed = True
    while changed:
        changed = False
        for i in range(1, len(ops)):
            op = ops[i]
            if (not isinstance(op, schedule_mod.CommOp)
                    or op.kind != schedule_mod.START):
                continue
            prev = ops[i - 1]
            if (not isinstance(prev, schedule_mod.ComputeOp)
                    or not prev.overlappable):
                continue
            operands = set(op.uses) | set(by_name[op.unit].uses)
            if operands & set(prev.defs):
                continue
            ops[i - 1], ops[i] = (dataclasses.replace(op, overlaps=prev.tag),
                                  prev)
            changed = True
    out = schedule_mod.Schedule(units=sched.units, ops=tuple(ops),
                                meta=dict(sched.meta))
    return out.validate()


def canonical_overlap_passes(depth: int = 2):
    """The overlapped train step's pass pipeline: reverse layout order,
    depth-``depth`` interleaving, start hoisting."""
    return (
        ("reverse_layout", reverse_layout_pass),
        (f"interleave_depth{depth}", interleave_pass(depth)),
        ("hoist_starts", hoist_starts_pass),
    )


def run_passes(sched: "schedule_mod.Schedule", passes
               ) -> Tuple["schedule_mod.Schedule", Dict[str, float]]:
    """Apply (name, pass) pairs in order, validating after each.
    Returns the rewritten schedule and per-pass wall time in µs."""
    timings: Dict[str, float] = {}
    for name, p in passes:
        t0 = time.perf_counter()
        sched = p(sched).validate()
        timings[name] = (time.perf_counter() - t0) * 1e6
    return sched, timings
