"""Roofline accounting of one rank's step, as the port runs it.

Counterpart of ``repro.launch.hloanalysis``.  The reference parses the
compiled, SPMD-partitioned HLO of a step and multiplies each computation
by its loop trip counts.  The port has no HLO: its step is eager
PyTorch, so it accounts for the step it runs.  ``analyze_step`` runs the
step under the substrate's recording transport (rank 0 alone, on
``meta`` tensors: nothing computes, nothing is allocated) with a
dispatch mode on rank 0's thread (``LiveBytes``), and reads per rank:

  flops        ``torch.utils.flop_counter``'s formulas (the registry
               ``FlopCounterMode`` counts by): 2·M·N·K for every product
               the rank runs, backward and rematerialized forwards
               included; on ``meta`` the flash op counts its two
               products itself (``trace.add_flops``).
  hbm_bytes    operand + output bytes of the reference's
               materialization-class ops only (its ``_CHARGE_BYTES_OPS``
               in aten terms, ``CHARGED``): contractions, gathers,
               scatters and indexing, reductions, sorts, concatenation
               and padding.  Views, casts and elementwise ops are not
               charged (on a fused device program they ride along).
               What the training attention's blockwise loops charge (its
               score and probability tiles, ``layers.ATTN_TILES``) is
               counted in ``hbm_bytes_attn_tiles`` too: a fused kernel
               keeps those in shared memory.
  wire_bytes   the bytes rank 0's recorded hops sent (``substrate.
               sent_bytes``): the port's collectives are explicit
               point-to-point schedules, so no bandwidth factor applies.
               Hops over "pod" ride InfiniBand and land in
               ``wire_bytes_dcn``, the others NVLink in
               ``wire_bytes_ici`` (``core.topology``'s link kinds, in
               the reference's slots).
  collectives  ``{function: {count, tensor_bytes, wire_bytes,
               dcn_bytes}}`` from the calls ``substrate.collective``
               labels.
  peak_bytes   the largest sum of the bytes of the storages the rank
               holds live: its state when the step starts and every
               storage an op of the rank allocates, freed when Python
               frees it (``LiveBytes``), split into params, grads,
               optimizer state and the rest as labelled at the peak.

The eager run executes every iteration of every loop, so no trip-count
multiplier applies; ``trip_counts`` records each stage's ``repeat``.
``scan_recorded_step`` is the counterpart of the reference's
``core.trace.scan_lowered_hlo`` (the collectives' counts and bytes).
``measure_rank`` reads the same meters off one rank of a real step on a
thread mesh: what the dry-run is held against (flops and wire bytes
exactly, the peak to the byte on the CPU).
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import threading
import weakref
from collections import defaultdict
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.core import trace
from repro_torch.core.topology import topology_from_mesh_shape
from repro_torch.models.layers import ATTN_TILES
from repro_torch.runtime import substrate
from repro_torch.tree import flatten

aten = torch.ops.aten

#: The reference's ``COLLECTIVES`` (its HLO kinds, ``_wire_factor``'s)
COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")

#: The reference's ``_CHARGE_BYTES_OPS`` in aten: its "dot" and
#: "convolution" are the products, "gather" / "scatter" / "dynamic-slice"
#: / "dynamic-update-slice" the indexing ops, "reduce" / "reduce-window" /
#: "select-and-scatter" the reductions (softmax included: a max and a sum),
#: "sort" the sorts, "concatenate" and "pad" their own.  Its collectives
#: are the port's hops, accounted as wire bytes.
CHARGED = frozenset(op for op in (
    # products
    aten.mm, aten.addmm, aten.bmm, aten.baddbmm, aten.convolution,
    aten.convolution_backward,
    # gathers, scatters, indexing
    aten.gather, aten.scatter, aten.scatter_add, aten.scatter_reduce,
    aten.index, aten.index_select, aten.index_put, aten.index_put_,
    aten._index_put_impl_, aten.index_add, aten.index_add_,
    aten.embedding, aten.embedding_dense_backward, aten.take,
    aten.masked_select, aten.masked_scatter,
    # reductions
    aten.sum, aten.mean, aten.amax, aten.amin, aten.max, aten.min,
    aten.prod, aten.argmax, aten.argmin, aten.logsumexp, aten.var,
    aten.std, aten.var_mean, aten.linalg_vector_norm, aten.norm,
    aten.cumsum, aten.cumprod, aten._softmax, aten._log_softmax,
    aten._softmax_backward_data, aten._log_softmax_backward_data,
    aten.nll_loss_forward, aten.nll_loss_backward,
    # sorts, concatenation, padding
    aten.sort, aten.topk, aten.cat, aten.constant_pad_nd,
))


def _wire_factor(kind: str, p: int) -> float:
    """The reference's bytes on the wire per byte of a collective's
    tensor over ``p`` ranks under bandwidth-optimal algorithms (its
    ``_wire_factor``, kind by kind)."""
    if p <= 1:
        return 0.0
    r = (p - 1) / p
    return {"all-reduce": 2 * r, "all-gather": r, "reduce-scatter": r,
            "all-to-all": r, "collective-permute": 1.0}[kind]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(x) -> List[torch.Tensor]:
    """The tensors of an op's arguments or outputs (a tensor, or lists
    and tuples of them)."""
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for item in x for t in _tensors(item)]
    return []


def _storage_id(t: torch.Tensor) -> Optional[int]:
    try:
        return id(t.untyped_storage())
    except (RuntimeError, NotImplementedError):
        return None                       # no storage (sparse, nested)


@dataclasses.dataclass
class ModuleCost:
    """Per-rank accounting of one step (the reference's ``ModuleCost``
    and its ``as_dict`` keys, with the port's peak beside them)."""

    flops: float = 0.0
    hbm_bytes: float = 0.0
    hbm_bytes_attn_tiles: float = 0.0   # a fused kernel's on-chip tiles
    wire_bytes: float = 0.0
    wire_bytes_ici: float = 0.0         # NVLink: every axis but "pod"
    wire_bytes_dcn: float = 0.0         # InfiniBand: "pod"
    collectives: Dict[str, Dict[str, float]] = dataclasses.field(
        default_factory=dict)
    trip_counts: List[int] = dataclasses.field(default_factory=list)
    peak_bytes: int = 0
    peak: Dict[str, int] = dataclasses.field(default_factory=dict)

    @property
    def hbm_bytes_kernel_adjusted(self) -> float:
        """Memory traffic with the attention tiles kept on chip."""
        return self.hbm_bytes - self.hbm_bytes_attn_tiles

    def as_dict(self) -> Dict:
        return {"flops": self.flops, "hbm_bytes": self.hbm_bytes,
                "hbm_bytes_attn_tiles": self.hbm_bytes_attn_tiles,
                "hbm_bytes_kernel_adjusted": self.hbm_bytes_kernel_adjusted,
                "wire_bytes": self.wire_bytes,
                "wire_bytes_ici": self.wire_bytes_ici,
                "wire_bytes_dcn": self.wire_bytes_dcn,
                "collectives": self.collectives,
                "trip_counts": self.trip_counts,
                "peak_bytes": self.peak_bytes, "peak": self.peak}


# ---------------------------------------------------------------------------
# Live bytes of one rank
# ---------------------------------------------------------------------------

#: the categories of ``ModuleCost.peak`` (a serving step's caches,
#: labelled by ``Model.init_caches``, as "caches")
KINDS = ("params", "grads", "opt_state", "caches", "other")


class LiveBytes(TorchDispatchMode):
    """The bytes of the storages one thread's ops allocate, while Python
    holds them, plus those ``hold`` registers; the largest sum is the
    peak.  Every op's operand and output bytes are charged to
    ``hbm_bytes`` when the op is in ``CHARGED``.  A storage is one
    allocation however many views share it; a storage another thread
    allocated (a peer's tensor a hop reads) is not this rank's."""

    def __init__(self) -> None:
        super().__init__()
        self._lock = threading.Lock()
        self._live: Dict[int, List] = {}     # id -> [bytes, kind]
        self.totals = dict.fromkeys(KINDS, 0)
        self.now = 0
        self.peak = 0
        self.peak_split = dict(self.totals)
        self.hbm_bytes = 0
        self.attn_bytes = 0
        self.flops = 0

    def hold(self, tree: Any, kind: str) -> None:
        """Count the storages of ``tree``'s tensors as ``kind`` (already
        counted ones move to ``kind``)."""
        for t in flatten(tree)[0]:
            if isinstance(t, torch.Tensor):
                self._track(t, kind)
        self._check_peak()

    def _track(self, t: torch.Tensor, kind: str = "other") -> None:
        try:
            st = t.untyped_storage()
        except (RuntimeError, NotImplementedError):
            return
        key = id(st)
        with self._lock:
            entry = self._live.get(key)
            if entry is not None:
                if kind != "other" and entry[1] != kind:
                    self.totals[entry[1]] -= entry[0]
                    self.totals[kind] += entry[0]
                    entry[1] = kind
                return
            n = st.nbytes()
            self._live[key] = [n, kind]
            self.totals[kind] += n
            self.now += n
        weakref.finalize(st, self._free, key)

    def _free(self, key: int) -> None:
        with self._lock:
            entry = self._live.pop(key, None)
            if entry is not None:
                self.totals[entry[1]] -= entry[0]
                self.now -= entry[0]

    def _check_peak(self) -> None:
        with self._lock:
            if self.now > self.peak:
                self.peak = self.now
                self.peak_split = dict(self.totals)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        outs = _tensors(out)
        ins = _tensors(args) + _tensors(tuple(kwargs.values()))
        count = flop_registry.get(func.overloadpacket)
        if count is not None:
            self.flops += count(*args, **kwargs, out_val=out)
        if func.overloadpacket in CHARGED:
            n = sum(_nbytes(t) for t in ins) + sum(_nbytes(t) for t in outs)
            self.hbm_bytes += n
            if trace.region_name() == ATTN_TILES:
                self.attn_bytes += n
        # an output on an operand's storage (a view, an in-place op) is
        # no allocation, whoever allocated the operand
        seen = {_storage_id(t) for t in ins}
        for t in outs:
            if _storage_id(t) not in seen:
                self._track(t)
        self._check_peak()
        return out


# ---------------------------------------------------------------------------
# The meters of one rank
# ---------------------------------------------------------------------------

class StepMeter:
    """Flops, charged bytes, live bytes and wire bytes of one rank.
    ``metering()`` meters the calling thread; ``rank`` (the factory
    ``substrate.instrument`` takes) meters one rank of every
    ``run_spmd`` of a block, on its thread, or, where that thread is
    metered already (the recording transport runs rank 0 on the
    caller's), only adds its state.  The rank's first argument, when it
    is a train state (``{"params", "opt", ...}``), is held from the
    start: params as params, the optimizer state and the error-feedback
    residual as optimizer state."""

    def __init__(self) -> None:
        self.wire = 0
        self.live = LiveBytes()
        self._thread: Optional[int] = None

    @contextlib.contextmanager
    def metering(self):
        gc_on = gc.isenabled()
        gc.disable()         # no collector pass frees a cycle mid-step
        self._thread = threading.get_ident()
        try:
            with self.live, trace.labelling(self._label):
                yield
        finally:
            self._thread = None
            if gc_on:
                gc.enable()

    @contextlib.contextmanager
    def rank(self, args: Sequence[Any]):
        if self._thread == threading.get_ident():
            self._hold_state(args)
            yield
            return
        sent0 = substrate.sent_bytes()
        with self.metering():
            self._hold_state(args)
            yield
        self.wire += substrate.sent_bytes() - sent0

    def _hold_state(self, args: Sequence[Any]) -> None:
        state = args[0] if args else None
        if isinstance(state, dict) and "params" in state:
            self.live.hold(state["params"], "params")
            self.live.hold({k: v for k, v in state.items()
                            if k in ("opt", "ef")}, "opt_state")
            self.live.hold(state.get("caches", {}), "caches")

    def _label(self, tree: Any, kind: str) -> None:
        if kind == trace.FLOPS:
            self.live.flops += tree
            return
        self.live.hold(tree, kind)

    def cost(self, rec: Optional[substrate.RecordingTransport] = None,
             trip_counts: Sequence[int] = ()) -> ModuleCost:
        """The meters' readings; with ``rec`` (the recording transport
        of the run) the wire bytes are its hops', split by link and by
        collective."""
        live = self.live
        cost = ModuleCost(flops=float(live.flops),
                          hbm_bytes=float(live.hbm_bytes),
                          hbm_bytes_attn_tiles=float(live.attn_bytes),
                          wire_bytes=float(self.wire),
                          wire_bytes_ici=float(self.wire),
                          trip_counts=list(trip_counts),
                          peak_bytes=int(live.peak),
                          peak=dict(live.peak_split))
        if rec is not None:
            cost.wire_bytes = float(sum(s.sent for s in rec.sites))
            cost.wire_bytes_dcn = float(sum(
                s.sent for s in rec.sites if _cross_pod(s.axis)))
            cost.wire_bytes_ici = cost.wire_bytes - cost.wire_bytes_dcn
            cost.collectives = _collectives(rec)
        return cost


def _cross_pod(axis: str) -> bool:
    """Whether a hop over ``axis`` leaves the pod (``core.topology``'s
    link kinds: "pod" is InfiniBand, every other axis NVLink)."""
    return topology_from_mesh_shape((axis,), (2,)).is_cross_pod(axis)


def _collectives(rec: substrate.RecordingTransport
                 ) -> Dict[str, Dict[str, float]]:
    out: Dict[str, Dict[str, float]] = defaultdict(
        lambda: {"count": 0.0, "tensor_bytes": 0.0, "wire_bytes": 0.0,
                 "dcn_bytes": 0.0})
    for c in rec.calls:
        out[c.function]["count"] += 1
        out[c.function]["tensor_bytes"] += c.nbytes
    for s in rec.sites:
        if s.function != "permute":
            continue                      # a rank query moves nothing
        entry = out[s.call or s.function]
        entry["wire_bytes"] += s.sent
        if _cross_pod(s.axis):
            entry["dcn_bytes"] += s.sent
    return {k: dict(v) for k, v in out.items()}


def analyze_step(fn: Callable, *args, trip_counts: Sequence[int] = (),
                 **kwargs) -> ModuleCost:
    """Run ``fn(*args, **kwargs)`` on ``meta`` inputs under the recording
    transport (a step over ``run_spmd`` runs as rank 0 alone, on this
    thread; any other function as it is) and account for it (see the
    module doc)."""
    meter = StepMeter()
    with substrate.recording() as rec, meter.metering(), \
            substrate.instrument(0, meter.rank):
        fn(*args, **kwargs)
    return meter.cost(rec, trip_counts)


def scan_recorded_step(fn: Callable, *args, **kwargs
                       ) -> Dict[str, Dict[str, float]]:
    """The counterpart of the reference's ``core.trace.scan_lowered_hlo``:
    run ``fn`` on ``meta`` inputs as ``analyze_step`` does and count its
    collective calls, ``{function: {"count": calls, "bytes": the bytes
    of the tensors they were given}}`` (the reference counts the
    collectives of its compiled program)."""
    cost = analyze_step(fn, *args, **kwargs)
    return {k: {"count": v["count"], "bytes": v["tensor_bytes"]}
            for k, v in cost.collectives.items()}


def measure_rank(fn: Callable, *args, rank: int = 0,
                 trip_counts: Sequence[int] = (), **kwargs):
    """Run ``fn(*args, **kwargs)`` for real and read the same meters off
    rank ``rank`` of its ``run_spmd`` calls, inside that rank's thread:
    flops, charged bytes, wire bytes and the peak of live bytes.
    Returns (``fn``'s result, ``ModuleCost``)."""
    meter = StepMeter()
    with substrate.instrument(rank, meter.rank):
        out = fn(*args, **kwargs)
    return out, meter.cost(None, trip_counts)
