"""The CollectiveEngine: a dynamically composed, tiered, per-function-
protocol communication library (paper §2+§3+§4 as one object).

Counterpart of ``repro.core.engine``: planned dispatch of the
reference's nine functions over one axis — ``all_reduce`` (ring,
bidirectional ring, Rabenseifner, recursive doubling) with its
start/progress/wait arms (the blocking call is literally
``wait(start(x))``), ``reduce_scatter``, ``all_gather``, ``all_to_all``
(Bruck, pairwise), ``broadcast`` (binomial tree, van de Geijn),
``permute``, ``send_recv``, ``barrier`` and the error-feedback
``compressed_all_reduce`` — plus ``checkpoint_fence``, the two-phase
gradient-sync arms (``sync_gradient_*``), the ZeRO-1 seam
(``zero_reduce_scatter_*``, ``zero_all_gather_*``), persistent bindings
(``bind_persistent``), ``sync_gradients`` (one collective per leaf),
``sync_gradients_bucketed`` (fused dtype-grouped buckets) and
``EngineConfig``.  The reference's two kernel switches
(``use_quantize_kernel``, ``use_local_reduce_kernel``) have no
counterpart: the ring combine and the int8 ops always go through their
``ops``, which take the CUDA kernels on the card and the plain versions
on the CPU.  A composed all-reduce over several axes takes the
topology-composed schedules of ``protocols.twophase``: hierarchical when
one axis is "pod", two-phase over two axes, else one planned
all-reduce an axis.

``mode="monolithic"`` is the conventional baseline: every function
present (no composition), every function at the conventional tier,
every call through the one generic path (``protocols.xla``) — the
"TCP/IP stack" of the paper's Fig 2.

Every blocking call of the functions other than ``all_reduce`` records
its wire bytes by phase (``CommStats.rank_phase_bytes``, the start and
wait shares of ``plan.phase_wire_bytes`` for the protocol that ran), as
the two-phase arms do.

Construction mirrors the paper's pipeline:

  1. scan the application          -> ``trace.scan_step``       (§2.2)
  2. compose the thin library      -> ``compose.compose``        (§2)
  3. assign per-function tiers     -> ``layers.assign_tiers``    (§3)
  4. plan per-function protocols   -> ``plan.CommPlan``          (§4)

Collective methods run inside a rank of ``substrate.run_spmd``.  One
engine serves every rank of a session (the ranks are threads); its
mutable state is the invoked-function set and ``CommStats``, both
updated under locks.
"""

from __future__ import annotations

import dataclasses
import math
import threading
from typing import (Any, Callable, Dict, List, Mapping, Optional,
                    Sequence, Tuple)

import torch

from repro_torch.core import compose as compose_mod
from repro_torch.core import compression, costmodel, layers, registry
from repro_torch.core import plan as plan_mod
from repro_torch.core.compose import ComposedLibrary
from repro_torch.core.protocols import common as c
from repro_torch.core.protocols import (bruck, recursive, ring, tree,
                                        twophase, xla)
from repro_torch.runtime import substrate
from repro_torch.core.topology import Topology, topology_from_mesh
from repro_torch.tree import flatten, map_tree, unflatten

#: stats key the gradient-sync paths record wire-payload bytes under.
SYNC_STATS_KEY = "sync_gradients"


def _as_axes(axis_name) -> Tuple[str, ...]:
    return (axis_name,) if isinstance(axis_name, str) else tuple(axis_name)


def scale_by(y: torch.Tensor, scale: float) -> torch.Tensor:
    """``y * scale`` with the scale rounded to y's dtype first, as the
    reference's ``y * jnp.asarray(scale, y.dtype)`` does."""
    s = torch.tensor(scale, dtype=y.dtype).item()
    return y * s


@dataclasses.dataclass
class EngineConfig:
    mode: str = "composed"               # "composed" | "monolithic"
    tier_policy: layers.TierPolicy = dataclasses.field(
        default_factory=layers.TierPolicy)
    sanitize_checked: bool = False       # L2+: finite-guard op
    force_protocol: Mapping[str, str] = dataclasses.field(default_factory=dict)
    plan: bool = True                    # False: per-call selection

    def __post_init__(self):
        if self.mode not in ("composed", "monolithic"):
            raise ValueError(f"unknown engine mode: {self.mode!r}")


@dataclasses.dataclass
class InFlight:
    """A started-but-unfinished collective.  ``finish`` runs the
    remaining pipeline stage(s); ``scale`` is the mean factor the wait
    arm applies after the last stage.  Consume exactly once."""

    fn: str
    axes: Tuple[str, ...]
    finish: Callable[[], torch.Tensor]
    protocol: str = costmodel.XLA_DEFAULT
    start_bytes: int = 0
    wait_bytes: int = 0
    scale: Optional[float] = None
    waited: bool = False
    stepper: Any = None


@dataclasses.dataclass
class SyncInFlight:
    """An in-flight gradient-sync collective: one bucket (or leaf) whose
    start phase has run.  ``sync_gradient_wait`` consumes it: the
    remaining stages, the compressed path's cross-axis reductions, the
    mean scale and (compressed only) the error-feedback residual."""

    inner: Any                  # InFlight | compression.CompressedInFlight
    compress: bool
    axes: Tuple[str, ...]
    scale: Optional[float]
    waited: bool = False


class CollectiveEngine:
    """One application ↔ one engine (paper §2.1)."""

    def __init__(self, topology: Topology,
                 library: Optional[ComposedLibrary] = None,
                 frequencies: Optional[Mapping[str, float]] = None,
                 config: Optional[EngineConfig] = None) -> None:
        self.topology = topology
        self.config = config or EngineConfig()
        self.stats = layers.CommStats()
        self._initialized = False
        self._finalized = False
        self.last_init_rebuilt = False
        self._invoked = set()
        self._lock = threading.Lock()
        if self.config.mode == "monolithic":
            # the conventional library: everything present, uniform depth
            self.library = compose_mod.compose(registry.ALL_FUNCTIONS)
            self.frequencies = dict(registry.DEFAULT_FREQUENCIES)
            self.tiers = layers.conventional_tiers(registry.ALL_FUNCTIONS)
        else:
            if library is None:
                raise ValueError("a composed engine needs a ComposedLibrary "
                                 "(use repro_torch.comm.Session)")
            self.library = library
            self.frequencies = dict(frequencies
                                    or registry.DEFAULT_FREQUENCIES)
            self.tiers = layers.assign_tiers(
                {fn: self.frequencies.get(
                    fn, registry.DEFAULT_FREQUENCIES.get(fn, 1.0))
                 for fn in library.provided},
                self.config.tier_policy)
        self._build_plan()

    # -- introspection ---------------------------------------------------

    @property
    def composed(self) -> bool:
        return self.config.mode == "composed"

    def tier(self, fn: str) -> int:
        return self.tiers.get(fn, layers.CONVENTIONAL_TIER)

    def average_layer_number(self) -> float:
        freqs = {fn: self.frequencies.get(
            fn, registry.DEFAULT_FREQUENCIES.get(fn, 1.0))
            for fn in self.tiers}
        return layers.average_layer_number(self.tiers, freqs)

    def protocol_for(self, fn: str, nbytes: float, axis: str) -> str:
        return self.plan.protocol_for(fn, nbytes, axis)

    def describe(self) -> str:
        rows = [f"CollectiveEngine(mode={self.config.mode}, "
                f"avg_layer={self.average_layer_number():.3f})",
                f"  library: {self.library.describe()}",
                f"  plan: {self.plan.describe()}"]
        for fn in sorted(self.library.provided):
            rows.append(f"  {fn:<22s} tier={layers.TIER_NAMES[self.tier(fn)]}")
        return "\n".join(rows)

    # -- planning: protocol table + pre-bound tier wrappers --------------

    def _build_plan(self) -> None:
        self.plan = plan_mod.CommPlan(
            self.topology, composed=self.composed,
            force=self.config.force_protocol, enabled=self.config.plan,
            warm_functions=tuple(self.library.provided))
        self._rebind_dispatch()

    def _rebind_dispatch(self) -> None:
        self._dispatch: Dict[str, Callable] = {}
        for fn in self.library.provided:
            impl = self._impl_for(fn)
            if impl is not None:
                self._dispatch[fn] = self._bind(fn, impl)

    def _bind(self, fn: str, impl: Callable) -> Callable:
        return layers.wrap_tier(fn, self.tier(fn), impl, self.stats,
                                sanitize=self.config.sanitize_checked)

    def dispatcher(self, fn: str) -> Callable:
        d = self._dispatch.get(fn)
        if d is None:
            impl = self._impl_for(fn)
            if impl is None:
                raise NotImplementedError(
                    f"{fn!r} has no schedule in the port yet")
            d = self._bind(fn, impl)
        return d

    def _impl_for(self, fn: str) -> Optional[Callable]:
        """The protocol-level implementation (before the tier wrap) of
        ``fn``; None for functions with no tensor schedule (init,
        finalize, the rank queries, the checkpoint fence)."""
        starts = {registry.REDUCE_SCATTER: self._reduce_scatter_start,
                  registry.ALL_GATHER: self._all_gather_start,
                  registry.ALL_TO_ALL: self._all_to_all_start,
                  registry.BROADCAST: self._broadcast_start,
                  registry.PERMUTE: self._permute_start,
                  registry.SEND_RECV: self._send_recv_start}
        if fn in starts:
            start = starts[fn]
            return lambda x, axis, **kw: self._run(start(x, axis, **kw))
        return {registry.ALL_REDUCE: self._allreduce_impl,
                registry.BARRIER: self._barrier_impl,
                registry.COMPRESSED_ALL_REDUCE: self._compressed_impl,
                }.get(fn)

    # -- plumbing --------------------------------------------------------

    def _check(self, fn: str) -> None:
        with self._lock:
            self._invoked.add(fn)
        self.library.require(fn)

    @property
    def invoked_functions(self) -> frozenset:
        """Engine-level functions invoked through this engine — the §2.2
        scan at the API layer (protocol lowering turns all_reduce into
        hops, so the hop record alone cannot attribute them)."""
        with self._lock:
            return frozenset(self._invoked)

    def _axis_size(self, axis: str) -> int:
        if axis in self.topology.axis_sizes:
            return self.topology.axis_sizes[axis]
        return c.axis_size(axis)

    def mean_scale(self, axis_name) -> float:
        """1 / prod(axis sizes): the one authority every mean-reduction
        path divides through."""
        scale = 1.0
        for ax in _as_axes(axis_name):
            scale /= self._axis_size(ax)
        return scale

    @staticmethod
    def _chunked(x: torch.Tensor, p: int):
        flat, n = c.pad_flat(x, p)
        return flat.reshape(p, -1), n, tuple(x.shape)

    # -- all_reduce --------------------------------------------------------

    def all_reduce(self, x: torch.Tensor, axis_name) -> torch.Tensor:
        fn = registry.ALL_REDUCE
        self._check(fn)
        axes = _as_axes(axis_name)
        return self.dispatcher(fn)(x, axes if len(axes) > 1 else axes[0])

    def _allreduce_impl(self, x: torch.Tensor, axes) -> torch.Tensor:
        axes = _as_axes(axes)
        if not self.composed:
            return self._allreduce_mono(x, axes)
        if len(axes) > 1:
            return self._allreduce_multiaxis_start(x, axes).finish()
        return self._allreduce_1d(x, axes[0])

    @staticmethod
    def _allreduce_mono(x: torch.Tensor, axes) -> torch.Tensor:
        """The generic path, one axis after another."""
        for ax in axes:
            x = xla.all_reduce(x, ax)
        return x

    def _allreduce_1d(self, x: torch.Tensor, axis: str,
                      proto: Optional[str] = None) -> torch.Tensor:
        return self._allreduce_1d_start(x, axis, proto=proto).finish()

    def _allreduce_1d_start(self, x: torch.Tensor, axis: str,
                            proto: Optional[str] = None) -> InFlight:
        """Launch the first pipeline stage of a 1-axis all-reduce; the
        token's ``finish`` runs the remaining stage(s)."""
        fn = registry.ALL_REDUCE
        p = self._axis_size(axis)
        if p == 1:
            return InFlight(fn, (axis,), lambda: x, protocol="local")
        nb = layers.nbytes(x)
        if proto is None:
            proto = self.protocol_for(fn, nb, axis)
        sb, wb = plan_mod.phase_wire_bytes(proto, p, nb)
        if proto == costmodel.XLA_DEFAULT:
            y = xla.all_reduce(x, axis)
            return InFlight(fn, (axis,), lambda: y, proto, sb, wb)
        if proto == costmodel.RECURSIVE_DOUBLING:
            y = recursive.recursive_doubling_all_reduce(x, axis)
            return InFlight(fn, (axis,), lambda: y, proto, sb, wb)
        x2d, n, shape = self._chunked(x, p)
        if proto == costmodel.RING:
            shard = ring.ring_all_reduce_start(x2d, axis)
            run = ring.RingAllGatherRun(shard, axis)
        elif proto == costmodel.BIDIR_RING:
            shard = ring.bidir_ring_all_reduce_start(x2d, axis)
            run = ring.BidirRingAllGatherRun(shard, axis)
        elif proto == costmodel.RECURSIVE_HALVING:
            shard = recursive.halving_reduce_scatter_flat(x2d, axis)
            run = recursive.DoublingAllGatherRun(shard, axis)
        else:
            raise ValueError(f"no all_reduce schedule for protocol "
                             f"{proto!r} in the port")
        fin = lambda: c.unpad(run.result().reshape(-1), n, shape)
        return InFlight(fn, (axis,), fin, proto, sb, wb, stepper=run)

    def _allreduce_multiaxis_start(self, x: torch.Tensor,
                                   axes: Tuple[str, ...]) -> InFlight:
        """The first stage of a composed all-reduce over several axes:
        hierarchical when "pod" is one of them (the intra-pod RS), two-
        phase over two axes (the RS along the first), else the first
        axis's planned all-reduce (``_allreduce_seq_start``)."""
        fn = registry.ALL_REDUCE
        nb = layers.nbytes(x)
        if "pod" in axes:
            intra = tuple(a for a in axes if a != "pod")
            if not intra:
                return self._allreduce_1d_start(x, "pod")
            flat, sizes = twophase.hierarchical_start(x, intra)
            fin = lambda: twophase.hierarchical_finish(
                flat, sizes, intra, "pod", x.shape)
            # phase shares follow the full intra-pod extent (the RS spans
            # every intra axis before the pod hop)
            sb, wb = plan_mod.phase_wire_bytes(
                costmodel.HIERARCHICAL, self.multiaxis_extent(axes), nb)
            return InFlight(fn, axes, fin, costmodel.HIERARCHICAL, sb, wb)
        if len(axes) == 2:
            p0 = self._axis_size(axes[0])
            x2d, n, shape = self._chunked(x, p0)
            shard = twophase.two_phase_start(x2d, axes[0])
            fin = lambda: c.unpad(twophase.two_phase_finish(
                shard, axes[0], axes[1], x2d.shape[0], x2d.shape[1]),
                n, shape)
            sb, wb = plan_mod.phase_wire_bytes(costmodel.TWO_PHASE_2D, p0,
                                               nb)
            return InFlight(fn, axes, fin, costmodel.TWO_PHASE_2D, sb, wb)
        return self._allreduce_seq_start(x, tuple((ax, None) for ax in axes))

    def multiaxis_extent(self, axes) -> int:
        """The extent a multi-axis schedule bills its phases over: the
        intra-pod axes' product for the hierarchical schedule, the first
        axis's size otherwise."""
        if "pod" in axes:
            return math.prod(self._axis_size(a) for a in axes if a != "pod")
        return self._axis_size(axes[0])

    def _allreduce_seq_start(self, x: torch.Tensor,
                             protos: Tuple[Tuple[str, Optional[str]], ...]
                             ) -> InFlight:
        """Sequential per-axis chain: start the first axis's protocol; the
        wait arm finishes it and runs the remaining axes blocking (they
        depend on the first axis's result, so only the first stage can
        overlap)."""
        (ax0, pr0), rest = protos[0], protos[1:]
        tok0 = self._allreduce_1d_start(x, ax0, proto=pr0)

        def fin():
            y = tok0.finish()
            for ax, pr in rest:
                y = self._allreduce_1d(y, ax, proto=pr)
            return y

        # unplanned later axes resolve to what the cost model will pick
        # a call, so the phase accounting matches the real schedule
        nb = layers.nbytes(x)
        wait_extra = sum(
            sum(plan_mod.phase_wire_bytes(
                pr or self.protocol_for(registry.ALL_REDUCE, nb, ax),
                self._axis_size(ax), nb))
            for ax, pr in rest)
        return InFlight(registry.ALL_REDUCE, tuple(a for a, _ in protos),
                        fin, tok0.protocol, tok0.start_bytes,
                        tok0.wait_bytes + wait_extra)

    # -- nonblocking two-phase arms ----------------------------------------

    def all_reduce_start(self, x: torch.Tensor, axis_name, *,
                         mean: bool = False) -> InFlight:
        fn = registry.ALL_REDUCE
        self._check(fn)
        axes = _as_axes(axis_name)
        x = layers.tier_input(fn, self.tier(fn), x,
                              axes if len(axes) > 1 else axes[0],
                              self.stats,
                              sanitize=self.config.sanitize_checked)
        if not self.composed:
            # the generic path has no stage seam: it runs whole in start,
            # so blocking and two-phase calls give the same bits
            y = self._allreduce_mono(x, axes)
            sb = sum(plan_mod.phase_wire_bytes(
                costmodel.XLA_DEFAULT, self._axis_size(ax),
                layers.nbytes(x))[0] for ax in axes)
            tok = InFlight(fn, axes, lambda: y, costmodel.XLA_DEFAULT, sb, 0)
        elif len(axes) == 1:
            tok = self._allreduce_1d_start(x, axes[0])
        else:
            tok = self._allreduce_multiaxis_start(x, axes)
        if mean:
            tok.scale = self.mean_scale(axes)
        self._record_phase(fn, "start", tok.start_bytes)
        return tok

    def all_reduce_wait(self, token: InFlight) -> torch.Tensor:
        return self._wait_inflight(token)

    def all_reduce_progress(self, token: InFlight, stages: int = 1) -> int:
        return self._progress_inflight(token, stages)

    def _progress_inflight(self, token: InFlight, stages: int = 1) -> int:
        """Retire up to ``stages`` wait-phase protocol stages without
        completing the collective; returns stages taken.  Each hop bills
        ``wait_bytes * k / remaining`` so the phases sum to the blocking
        path's wire bytes."""
        if token.waited:
            raise RuntimeError(
                f"cannot progress an already-waited {token.fn} token")
        run = token.stepper
        if run is None or run.remaining <= 0:
            return 0
        remaining_before = run.remaining
        k = run.step(stages)
        if k:
            moved = token.wait_bytes * k // remaining_before
            token.wait_bytes -= moved
            self._record_phase(token.fn, "progress", moved)
        return k

    def _wait_inflight(self, token: InFlight) -> torch.Tensor:
        if token.waited:
            raise RuntimeError(
                f"in-flight {token.fn} token was already waited — each "
                f"start() produces exactly one wait()able reduction")
        token.waited = True
        self._record_phase(token.fn, "wait", token.wait_bytes)
        y = token.finish()
        if token.scale is not None:
            y = scale_by(y, token.scale)
        return layers.tier_output(self.tier(token.fn), y)

    # -- compressed all-reduce ---------------------------------------------

    def compressed_all_reduce(self, x: torch.Tensor, axis_name: str,
                              state: Optional[compression.EFState] = None):
        fn = registry.COMPRESSED_ALL_REDUCE
        self._check(fn)
        return self.dispatcher(fn)(x, axis_name, state=state)

    def _compressed_impl(self, x, axis: str, state=None):
        return compression.compressed_all_reduce(x, axis, state)

    def compressed_all_reduce_start(self, x: torch.Tensor, axis_name: str,
                                    state: Optional[compression.EFState]
                                    = None):
        fn = registry.COMPRESSED_ALL_REDUCE
        self._check(fn)
        x = layers.tier_input(fn, self.tier(fn), x, axis_name, self.stats,
                              sanitize=self.config.sanitize_checked)
        tok = compression.compressed_all_reduce_start(x, axis_name, state)
        sb, _ = plan_mod.phase_wire_bytes(
            costmodel.RING, tok.p, compressed_wire_bytes(x.numel()))
        self._record_phase(fn, "start", sb)
        return tok

    def compressed_all_reduce_progress(self, token, stages: int = 1) -> int:
        fn = registry.COMPRESSED_ALL_REDUCE
        if token.p == 1:
            return 0
        if token.wait_bytes_left is None:
            _, wb = plan_mod.phase_wire_bytes(
                costmodel.RING, token.p, compressed_wire_bytes(token.n))
            token.wait_bytes_left = wb
        remaining_before = (token.ag_run.remaining
                            if token.ag_run is not None else token.p - 1)
        if remaining_before <= 0:
            return 0
        k = compression.compressed_all_reduce_progress(token, stages)
        if k:
            moved = token.wait_bytes_left * k // remaining_before
            token.wait_bytes_left -= moved
            self._record_phase(fn, "progress", moved)
        return k

    def compressed_all_reduce_wait(self, token):
        fn = registry.COMPRESSED_ALL_REDUCE
        if token.wait_bytes_left is not None:
            wb = token.wait_bytes_left
        else:
            _, wb = plan_mod.phase_wire_bytes(
                costmodel.RING, token.p, compressed_wire_bytes(token.n))
        self._record_phase(fn, "wait", wb)
        return layers.tier_output(self.tier(fn),
                                  compression.compressed_all_reduce_wait(
                                      token))

    def _record_phase(self, fn: str, phase: str, nbytes: int) -> None:
        self.stats.record_phase(fn, phase, nbytes, c.rank())

    # -- the rest of the function set -------------------------------------
    #
    # Each function below has a start arm that runs its schedule's first
    # stage(s) and returns an ``InFlight`` (the ``_start`` methods); the
    # blocking call is ``_run`` of that token.  Monolithic engines route
    # every one through ``protocols.xla``; composed ones through the
    # planned protocol, and through ``xla`` where the protocol cannot run
    # (a dimension that does not split over the axis).

    def _run(self, tok: InFlight) -> torch.Tensor:
        """A blocking call: both phases of ``tok`` recorded, then run."""
        self._record_phase(tok.fn, "start", tok.start_bytes)
        self._record_phase(tok.fn, "wait", tok.wait_bytes)
        return tok.finish()

    def _generic(self, fn: str, axis: str, nbytes: int, run: Callable
                 ) -> InFlight:
        """A token of the generic path: ``run()`` now, whole in start,
        billed as the cost model bills ``XLA_DEFAULT`` for ``fn``."""
        y = run()
        sb, wb = plan_mod.phase_wire_bytes(costmodel.XLA_DEFAULT,
                                           self._axis_size(axis), nbytes, fn)
        return InFlight(fn, (axis,), lambda: y, costmodel.XLA_DEFAULT,
                        sb, wb)

    @staticmethod
    def _local(fn: str, axis: str, y: torch.Tensor) -> InFlight:
        return InFlight(fn, (axis,), lambda: y, protocol="local")

    def reduce_scatter(self, x: torch.Tensor, axis_name: str, dim: int = 0
                       ) -> torch.Tensor:
        """Tiled semantics: the output is ``x`` with ``dim`` shrunk by
        p."""
        fn = registry.REDUCE_SCATTER
        self._check(fn)
        return self.dispatcher(fn)(x, axis_name, dim=dim)

    def _reduce_scatter_start(self, x, axis: str, dim: int = 0,
                              proto: Optional[str] = None) -> InFlight:
        fn = registry.REDUCE_SCATTER
        p = self._axis_size(axis)
        if p == 1:
            return self._local(fn, axis, x)
        nb = layers.nbytes(x)
        if not self.composed or x.shape[dim] % p:
            return self._generic(fn, axis, nb,
                                 lambda: xla.reduce_scatter(x, axis, dim))
        if proto is None:
            proto = self.protocol_for(fn, nb, axis)
        xm = torch.movedim(x, dim, 0)
        x2d = xm.reshape(p, -1)
        if proto == costmodel.RECURSIVE_HALVING:
            shard = recursive.halving_reduce_scatter_flat(x2d, axis)
        elif proto == costmodel.BIDIR_RING:
            shard = ring.bidir_ring_reduce_scatter_flat(x2d, axis)
        else:
            shard = ring.ring_reduce_scatter_flat(x2d, axis)
        out = torch.movedim(shard.reshape(
            (xm.shape[0] // p,) + tuple(xm.shape[1:])), 0, dim)
        sb, wb = plan_mod.phase_wire_bytes(proto, p, nb, fn)
        return InFlight(fn, (axis,), lambda: out, proto, sb, wb)

    def all_gather(self, x: torch.Tensor, axis_name: str, dim: int = 0
                   ) -> torch.Tensor:
        """Tiled semantics: the output is ``x`` with ``dim`` grown by
        p."""
        fn = registry.ALL_GATHER
        self._check(fn)
        return self.dispatcher(fn)(x, axis_name, dim=dim)

    def _all_gather_start(self, x, axis: str, dim: int = 0,
                          proto: Optional[str] = None) -> InFlight:
        fn = registry.ALL_GATHER
        p = self._axis_size(axis)
        if p == 1:
            return self._local(fn, axis, x)
        full = layers.nbytes(x) * p       # planned at the gathered size
        if not self.composed:
            return self._generic(fn, axis, full,
                                 lambda: xla.all_gather(x, axis, dim))
        if proto is None:
            proto = self.protocol_for(fn, full, axis)
        xm = torch.movedim(x, dim, 0)
        shard = xm.reshape(-1)
        if proto == costmodel.BRUCK:
            buf = recursive.doubling_all_gather_flat(shard, axis)
        elif proto == costmodel.BIDIR_RING:
            buf = ring.bidir_ring_all_gather_flat(shard, axis)
        else:
            buf = ring.ring_all_gather_flat(shard, axis)
        out = torch.movedim(buf.reshape(
            (p * xm.shape[0],) + tuple(xm.shape[1:])), 0, dim)
        sb, wb = plan_mod.phase_wire_bytes(proto, p, full, fn)
        return InFlight(fn, (axis,), lambda: out, proto, sb, wb)

    def all_to_all(self, x: torch.Tensor, axis_name: str,
                   split_dim: int = 0, concat_dim: int = 0) -> torch.Tensor:
        """Tiled semantics of ``lax.all_to_all``."""
        fn = registry.ALL_TO_ALL
        self._check(fn)
        return self.dispatcher(fn)(x, axis_name, split_dim=split_dim,
                                   concat_dim=concat_dim)

    def _all_to_all_start(self, x, axis: str, split_dim: int = 0,
                          concat_dim: int = 0,
                          proto: Optional[str] = None) -> InFlight:
        fn = registry.ALL_TO_ALL
        p = self._axis_size(axis)
        if p == 1:
            return self._local(fn, axis, x)
        nb = layers.nbytes(x)
        if not self.composed or x.shape[split_dim] % p:
            return self._generic(fn, axis, nb, lambda: xla.all_to_all(
                x, axis, split_dim, concat_dim))
        if proto is None:
            proto = self.protocol_for(fn, nb, axis)
        exchange = (bruck.bruck_all_to_all if proto == costmodel.BRUCK
                    else bruck.pairwise_all_to_all)
        out = xla.tiled_all_to_all(x, axis, split_dim, concat_dim, exchange)
        sb, wb = plan_mod.phase_wire_bytes(proto, p, nb, fn)
        return InFlight(fn, (axis,), lambda: out, proto, sb, wb)

    def broadcast(self, x: torch.Tensor, axis_name: str, root: int = 0
                  ) -> torch.Tensor:
        fn = registry.BROADCAST
        self._check(fn)
        return self.dispatcher(fn)(x, axis_name, root=root)

    def _broadcast_start(self, x, axis: str, root: int = 0,
                         proto: Optional[str] = None) -> InFlight:
        """Stage-split broadcast: van de Geijn starts with its binomial
        scatter and finishes with the ring all-gather; the binomial tree
        has no seam and runs whole in start."""
        fn = registry.BROADCAST
        p = self._axis_size(axis)
        nb = layers.nbytes(x)
        if not self.composed:
            return self._generic(fn, axis, nb,
                                 lambda: xla.broadcast(x, axis, root))
        if proto is None:
            proto = self.protocol_for(fn, nb, axis)
        if proto == costmodel.RING and c.is_pow2(p) and p > 1:
            sb, wb = plan_mod.phase_wire_bytes(proto, p, nb, fn)
            x2d, n, shape = self._chunked(x, p)
            chunk = tree.scatter_allgather_start(x2d, axis, root)
            fin = lambda: c.unpad(tree.scatter_allgather_finish(
                chunk, axis, root).reshape(-1), n, shape)
            return InFlight(fn, (axis,), fin, proto, sb, wb)
        y = tree.binomial_broadcast(x, axis, root)
        sb, wb = plan_mod.phase_wire_bytes(costmodel.BINOMIAL_TREE, p, nb,
                                           fn)
        return InFlight(fn, (axis,), lambda: y, costmodel.BINOMIAL_TREE,
                        sb, wb)

    def permute(self, x: torch.Tensor, axis_name: str, shift: int = 1
                ) -> torch.Tensor:
        fn = registry.PERMUTE
        self._check(fn)
        return self.dispatcher(fn)(x, axis_name, shift=shift)

    def _permute_start(self, x, axis: str, shift: int = 1) -> InFlight:
        """One hop in both modes (the reference's ``xla.permute``),
        billed as the plan's protocol for it."""
        return self._hop(registry.PERMUTE, x, axis,
                         lambda: xla.permute(x, axis, shift))

    def send_recv(self, x: torch.Tensor, axis_name: str,
                  pairs: Sequence[Tuple[int, int]]) -> torch.Tensor:
        """Explicit (src, dst) exchange — the MPI_Send/MPI_Recv analogue;
        a rank that no pair sends to receives zeros."""
        fn = registry.SEND_RECV
        self._check(fn)
        return self.dispatcher(fn)(x, axis_name, pairs=tuple(pairs))

    def _send_recv_start(self, x, axis: str, pairs=()) -> InFlight:
        return self._hop(registry.SEND_RECV, x, axis,
                         lambda: c.ppermute(x, axis, list(pairs)))

    def _hop(self, fn: str, x, axis: str, run: Callable) -> InFlight:
        p = self._axis_size(axis)
        nb = layers.nbytes(x)
        proto = self.protocol_for(fn, nb, axis)
        y = run()
        sb, wb = plan_mod.phase_wire_bytes(proto, p, nb, fn)
        return InFlight(fn, (axis,), lambda: y, proto, sb, wb)

    def barrier(self, axis_name, token: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        """A zero-valued sum over every axis, then a fence (the
        reference's ``psum * 0`` and optimization barrier)."""
        fn = registry.BARRIER
        self._check(fn)
        dev = substrate.current_mesh().device
        t = token if token is not None else torch.zeros(
            (), dtype=torch.float32, device=dev if dev is not None
            else "meta")
        axes = _as_axes(axis_name)
        return self.dispatcher(fn)(t, axes if len(axes) > 1 else axes[0])

    def _barrier_impl(self, t, axes):
        for ax in _as_axes(axes):
            t = xla.all_reduce(t, ax) * 0.0
        return layers.fence(t)

    def checkpoint_fence(self, tree_: Any) -> Any:
        """Fence every tensor of ``tree_`` (a synchronize of the current
        CUDA stream; the reference's optimization barrier)."""
        self._check(registry.CHECKPOINT_FENCE)
        self.stats.event("checkpoint_fence")
        return map_tree(layers.fence, tree_)

    # -- setup / rank queries ----------------------------------------------

    def axis_index(self, axis_name: str) -> int:
        self._check(registry.AXIS_INDEX)
        return c.axis_index(axis_name)

    def axis_size(self, axis_name: str) -> int:
        self._check(registry.AXIS_SIZE)
        return self._axis_size(axis_name)

    def init(self, mesh=None) -> "CollectiveEngine":
        """MPI_Init analogue: bind to ``mesh``'s topology, reset stats,
        and re-plan (topology change => plan rebuild)."""
        self._check(registry.INIT)
        if mesh is not None:
            self.topology = topology_from_mesh(mesh)
        self.stats = layers.CommStats()
        self.last_init_rebuilt = self.plan.maybe_rebuild(self.topology)
        self._rebind_dispatch()
        self._initialized = True
        return self

    @property
    def plan_rebuilds(self) -> int:
        return self.plan.stats.rebuilds

    def finalize(self) -> str:
        """MPI_Finalize analogue: flush stats, mark the engine dead."""
        self._check(registry.FINALIZE)
        self._finalized = True
        return self.stats.summary()

    # -- gradient synchronisation ------------------------------------------

    def sync_gradients(self, grads: Any, axis_name, *, mean: bool = True,
                       compress: bool = False, ef_state: Any = None):
        """Sum (or mean) a gradient tree over the data-parallel axes, one
        collective per leaf, in the tree's leaf order.  With
        ``compress=True`` uses the int8 error-feedback protocol and
        threads ``ef_state`` (a tree of EFState matching ``grads``; None
        to init; its residuals are updated in place).  Returns
        (synced_grads, new_ef_state)."""
        axes = _as_axes(axis_name)
        scale = self.mean_scale(axes) if mean else 1.0
        leaves, paths = flatten(grads)

        if not compress:
            out = []
            for g in leaves:
                self.stats.record(SYNC_STATS_KEY, layers.nbytes(g))
                y = self.all_reduce(g, axes if len(axes) > 1 else axes[0])
                out.append(scale_by(y, scale) if mean else y)
            return unflatten(paths, out), ef_state

        if ef_state is None:
            states = [compression.EFState.zeros_like(g) for g in leaves]
        else:
            states, state_paths = flatten(ef_state)
            if state_paths != paths:
                raise ValueError("ef_state does not match the gradient tree")
        out = []
        for g, s in zip(leaves, states):
            # compressed protocol runs on the first axis; remaining axes
            # use the uncompressed all-reduce.
            self.stats.record(SYNC_STATS_KEY,
                              compressed_wire_bytes(g.numel()))
            y, s2 = self.compressed_all_reduce(g, axes[0], s)
            # Leaf by leaf, the new residual overwrites the old one (the
            # reference returns a new tree): a second tree of f32
            # residuals is never alive.
            s.residual.copy_(s2.residual)
            for ax in axes[1:]:
                y = self.all_reduce(y, ax)
            out.append(scale_by(y, scale) if mean else y)
        return unflatten(paths, out), unflatten(paths, states)


    def sync_gradients_bucketed(
        self, grads: Any, axis_name, *, mean: bool = True,
        bucket_bytes: Optional[int] = plan_mod.DEFAULT_BUCKET_BYTES,
        compress: bool = False, ef_state: Any = None,
    ):
        """Fused, dtype-grouped, size-capped gradient sync: leaves are
        grouped by dtype (bf16 stays bf16 on the wire), each group is
        split into buckets of at most ``bucket_bytes``, and each bucket is
        one collective with its own planned protocol.

        ``ef_state`` (compress only) is a tuple of per-bucket flat f32
        residuals matching ``plan.plan_buckets`` on these leaves (None to
        init; ``compression.bucket_ef_zeros`` builds it; its residuals are
        updated in place).  Returns (synced_grads, new_ef_state)."""
        leaves, paths = flatten(grads)
        if not leaves:
            return grads, ef_state
        axes = _as_axes(axis_name)
        buckets = plan_mod.plan_buckets(leaves, bucket_bytes)
        scale = self.mean_scale(axes) if mean else 1.0
        out: List[Optional[torch.Tensor]] = [None] * len(leaves)
        new_ef: List[Any] = []
        if compress:
            if ef_state is None:
                ef_state = compression.bucket_ef_zeros(
                    buckets, device=leaves[0].device)
            else:
                check_bucket_ef(ef_state, buckets)
        for bi, bucket in enumerate(buckets):
            flat = plan_mod.gather_bucket(leaves, bucket)
            if compress:
                self.stats.record(SYNC_STATS_KEY,
                                  compressed_wire_bytes(bucket.size))
                st = compression.EFState(residual=ef_state[bi])
                y, st2 = self.compressed_all_reduce(flat, axes[0], st)
                for ax in axes[1:]:
                    y = self.all_reduce(y, ax)
                # in place, as the per-leaf path does: a second set of
                # f32 residuals is never alive
                ef_state[bi].copy_(st2.residual)
                new_ef.append(ef_state[bi])
            else:
                self.stats.record(SYNC_STATS_KEY, bucket.nbytes)
                y = self.all_reduce(flat, axes if len(axes) > 1 else axes[0])
            if mean:
                y = scale_by(y, scale)
            plan_mod.scatter_bucket(y, bucket, out)
        return (unflatten(paths, out),
                tuple(new_ef) if compress else ef_state)

    # -- two-phase gradient sync (what the overlapped trainer drives) -----

    def sync_gradient_start(self, g: torch.Tensor, axis_name, *,
                            mean: bool = True, compress: bool = False,
                            ef_residual: Optional[torch.Tensor] = None
                            ) -> SyncInFlight:
        """Issue the start phase of ONE gradient tensor's sync (a fused
        bucket or a leaf).  Records wire bytes under ``SYNC_STATS_KEY``
        as the blocking ``sync_gradients[_bucketed]`` paths do, so
        overlapped and blocking runs report the same traffic."""
        axes = _as_axes(axis_name)
        scale = self.mean_scale(axes) if mean else None
        if compress:
            self.stats.record(SYNC_STATS_KEY,
                              compressed_wire_bytes(g.numel()))
            state = (compression.EFState(residual=ef_residual)
                     if ef_residual is not None else None)
            inner = self.compressed_all_reduce_start(g, axes[0], state)
        else:
            self.stats.record(SYNC_STATS_KEY, layers.nbytes(g))
            inner = self.all_reduce_start(
                g, axes if len(axes) > 1 else axes[0])
        return SyncInFlight(inner=inner, compress=compress, axes=axes,
                            scale=scale)

    def sync_gradient_progress(self, token: SyncInFlight,
                               stages: int = 1) -> int:
        """Advance one in-flight gradient sync by up to ``stages``
        wait-phase protocol stages without finalizing it (the schedule
        IR's ``progress`` op).  EF residuals and the mean scale stay
        untouched: they belong to wait."""
        if token.waited:
            raise RuntimeError(
                "cannot progress an already-waited gradient sync")
        if token.compress:
            return self.compressed_all_reduce_progress(token.inner, stages)
        return self._progress_inflight(token.inner, stages)

    def sync_gradient_wait(self, token: SyncInFlight):
        """Finalize one in-flight gradient sync: remaining stages, the
        compressed path's cross-axis reductions, the mean scale and the
        EF-residual update (residuals change here and ONLY here).
        Returns (synced, new_ef_residual | None)."""
        if token.waited:
            raise RuntimeError("in-flight gradient sync was already waited")
        token.waited = True
        new_residual = None
        if token.compress:
            y, st = self.compressed_all_reduce_wait(token.inner)
            for ax in token.axes[1:]:
                y = self.all_reduce(y, ax)
            if st is not None:
                new_residual = st.residual
        else:
            y = self._wait_inflight(token.inner)
        if token.scale is not None:
            y = scale_by(y, token.scale)
        return y, new_residual

    # -- the ZeRO-1 seam: RS-only grad sync + updated-param all-gather --
    #
    # Every planned all-reduce protocol decomposes into a reduce-scatter
    # arm and an all-gather arm; ZeRO-1 stops the gradient sync at that
    # seam (each rank keeps its reduced chunk and runs the elementwise
    # optimizer update on it) and all-gathers the *updated params*
    # instead.  The RS half below IS the planned all-reduce's own start
    # phase — same protocol, same padding, same stage order — so the
    # chunk is bit-identical to the matching rows of the all-reduce.

    def zero_protocols(self, nbytes: int, axis: str) -> Tuple[str, str]:
        """(rs_protocol, ag_protocol) of the ZeRO seam for an ``nbytes``
        payload on ``axis``: the PLANNED all-reduce protocol's halves.
        Seamless protocols (recursive doubling) have no RS/AG split: the
        RS arm then runs the whole planned all-reduce and slices, and the
        gather side takes the ring all-gather."""
        ar = self.protocol_for(registry.ALL_REDUCE, nbytes, axis)
        ag = {costmodel.RING: costmodel.RING,
              costmodel.BIDIR_RING: costmodel.BIDIR_RING,
              costmodel.RECURSIVE_HALVING: costmodel.RECURSIVE_DOUBLING,
              }.get(ar, costmodel.RING)
        return ar, ag

    def _zero_rs_start(self, x: torch.Tensor, axis: str) -> InFlight:
        """The RS half of the planned all-reduce of ``x`` on one axis; the
        token's finish yields this rank's reduced padded-flat chunk.  No
        stats here: the public and persistent arms record."""
        fn = registry.REDUCE_SCATTER
        p = self._axis_size(axis)
        if p == 1:
            flat = x.reshape(-1)
            return InFlight(fn, (axis,), lambda: flat, protocol="local")
        nb = layers.nbytes(x)
        proto = self.zero_protocols(nb, axis)[0]
        sb, _ = plan_mod.phase_wire_bytes(proto, p, nb, fn)
        x2d, _, _ = self._chunked(x, p)
        if proto == costmodel.RING:
            chunk = ring.ring_reduce_scatter_flat(x2d, axis)
        elif proto == costmodel.BIDIR_RING:
            chunk = ring.bidir_ring_reduce_scatter_flat(x2d, axis)
        elif proto == costmodel.RECURSIVE_HALVING:
            chunk = recursive.halving_reduce_scatter_flat(x2d, axis)
        else:
            # no seam: the planned all-reduce whole, then this rank's rows
            # (the same bits, billed at the full all-reduce's share)
            y = self._allreduce_1d(x, axis, proto=proto)
            y2d, _, _ = self._chunked(y, p)
            chunk = c.dyn_chunk(y2d, c.axis_index(axis))
        return InFlight(fn, (axis,), lambda: chunk, proto, sb, 0)

    def _zero_ag_start(self, shard: torch.Tensor, axis: str) -> InFlight:
        """The AG half: the per-rank updated chunks back into the full
        padded-flat vector (data movement only: every gather order gives
        the same bits).  ``finish`` yields the flat (p*chunk,) vector."""
        fn = registry.ALL_GATHER
        p = self._axis_size(axis)
        flat = shard.reshape(-1)
        if p == 1:
            return InFlight(fn, (axis,), lambda: flat, protocol="local")
        full = layers.nbytes(shard) * p
        proto = self.zero_protocols(full, axis)[1]
        sb, _ = plan_mod.phase_wire_bytes(proto, p, full, fn)
        if proto == costmodel.RECURSIVE_DOUBLING:
            buf = recursive.doubling_all_gather_flat(flat, axis)
        elif proto == costmodel.BIDIR_RING:
            buf = ring.bidir_ring_all_gather_flat(flat, axis)
        else:
            buf = ring.ring_all_gather_flat(flat, axis)
        return InFlight(fn, (axis,), lambda: buf.reshape(-1), proto, sb, 0)

    def zero_reduce_scatter_start(self, g: torch.Tensor, axis_name, *,
                                  mean: bool = True) -> InFlight:
        """ZeRO-1 gradient sync stopped at the RS/AG seam: only the
        reduce-scatter half of the PLANNED all-reduce runs; the wait arm
        yields this rank's reduced padded-flat chunk with the mean scale
        applied.  ``SYNC_STATS_KEY`` records the RS phase share alone."""
        fn = registry.REDUCE_SCATTER
        self._check(fn)
        axes = _as_axes(axis_name)
        if len(axes) != 1:
            raise ValueError(f"zero_reduce_scatter runs over exactly one "
                             f"data axis, got {axes}")
        g = layers.tier_input(fn, self.tier(fn), g, axes[0], self.stats,
                              sanitize=self.config.sanitize_checked)
        tok = self._zero_rs_start(g, axes[0])
        if mean:
            tok.scale = self.mean_scale(axes)
        self.stats.record(SYNC_STATS_KEY, tok.start_bytes)
        self._record_phase(fn, "start", tok.start_bytes)
        return tok

    def zero_reduce_scatter_wait(self, token: InFlight) -> torch.Tensor:
        return self._wait_inflight(token)

    def zero_all_gather_start(self, shard: torch.Tensor,
                              axis_name) -> InFlight:
        """Start the updated-param all-gather of a ZeRO step; the wait
        arm yields the full padded-flat vector (callers unpad)."""
        fn = registry.ALL_GATHER
        self._check(fn)
        axes = _as_axes(axis_name)
        if len(axes) != 1:
            raise ValueError(f"zero_all_gather runs over exactly one "
                             f"data axis, got {axes}")
        shard = layers.tier_input(fn, self.tier(fn), shard, axes[0],
                                  self.stats,
                                  sanitize=self.config.sanitize_checked)
        tok = self._zero_ag_start(shard, axes[0])
        self._record_phase(fn, "start", tok.start_bytes)
        return tok

    def zero_all_gather_wait(self, token: InFlight) -> torch.Tensor:
        return self._wait_inflight(token)

    # -- persistent bindings (MPI Advance's MPIX_*_init analogue) ----------

    def bind_persistent(self, fn: str, shape: Sequence[int], dtype,
                        axis_name, *, mean: bool = False,
                        sync_stats: bool = False,
                        **kw) -> "PersistentBinding":
        """Resolve everything one collective call site needs (protocol,
        tier stack, mean scale) ONCE for a fixed (shape, dtype, axis)
        signature.  The binding's ``call`` does no lookup; its
        ``start``/``wait``/``progress`` arms split the same schedule, so
        ``call(x)`` and ``wait(start(x))`` give the same bits.  ``kw``:
        the function's own options (``dim``, ``split_dim`` /
        ``concat_dim``, ``root``, ``shift``, ``pairs``) and ``zero``.

        ``sync_stats=True`` marks a gradient-sync call site: every call
        or start records its wire bytes under ``SYNC_STATS_KEY`` as the
        planned ``sync_gradients*`` paths do.  ``zero=True`` binds the
        ZeRO-1 seam arms of ``reduce_scatter`` (the planned all-reduce's
        RS half; output: this rank's padded-flat chunk) and
        ``all_gather`` (the chunk back to the padded-flat vector).
        Every function binds over one axis but ``all_reduce``, which
        also binds over several: the generic path axis by axis when
        monolithic; composed, the hierarchical or two-phase schedule as
        one protocol tag (``"+".join(axes)``), else one planned protocol
        an axis."""
        axes = _as_axes(axis_name)
        self._check(fn)
        zero = bool(kw.pop("zero", False))
        if zero and fn not in (registry.REDUCE_SCATTER, registry.ALL_GATHER):
            raise ValueError(f"zero=True binds the ZeRO-1 seam arms; only "
                             f"reduce_scatter/all_gather support it, "
                             f"not {fn!r}")
        if sync_stats and fn != registry.ALL_REDUCE and \
                not (zero and fn == registry.REDUCE_SCATTER):
            raise ValueError(f"sync_stats=True marks a gradient-sync "
                             f"all_reduce handle, not {fn!r}")
        for ax in axes:
            if ax not in self.topology.axis_sizes:
                raise ValueError(
                    f"cannot bind persistent {fn!r}: axis {ax!r} is not in "
                    f"the engine topology "
                    f"({sorted(self.topology.axis_sizes)})")
        if mean and fn != registry.ALL_REDUCE and \
                not (zero and fn == registry.REDUCE_SCATTER):
            raise ValueError(f"mean=True is only supported for all_reduce, "
                             f"not {fn!r}")
        if len(axes) != 1 and fn != registry.ALL_REDUCE:
            raise ValueError(f"{fn!r} binds over exactly one axis, "
                             f"got {axes}")
        shape = tuple(int(s) for s in shape)
        itemsize = torch.empty((), dtype=dtype).element_size()
        nbytes = math.prod(shape) * itemsize
        sync_nbytes = nbytes            # what sync_stats records per call
        ax0 = axes[0]
        p0 = self._axis_size(ax0)
        xla_tag = costmodel.XLA_DEFAULT
        start_impl: Optional[Callable] = None

        protocols = None
        if fn == registry.ALL_REDUCE:
            if not self.composed:
                proto = xla_tag
                target = lambda x: self._allreduce_mono(x, axes)
            elif len(axes) == 1:
                proto = self.protocol_for(fn, nbytes, ax0)
                target = lambda x: self._allreduce_1d(x, ax0, proto=proto)
                start_impl = lambda x: self._allreduce_1d_start(
                    x, ax0, proto=proto)
            elif "pod" in axes or len(axes) == 2:
                # these schedules are fixed by the axis set: one protocol
                # tag for the whole binding
                proto = (costmodel.HIERARCHICAL if "pod" in axes
                         else costmodel.TWO_PHASE_2D)
                start_impl = lambda x: self._allreduce_multiaxis_start(
                    x, axes)
                target = lambda x, _s=start_impl: _s(x).finish()
                protocols = (("+".join(axes), proto),)
            else:
                protocols = tuple((ax, self.protocol_for(fn, nbytes, ax))
                                  for ax in axes)
                start_impl = lambda x, _p=protocols: \
                    self._allreduce_seq_start(x, _p)
                target = lambda x, _s=start_impl: _s(x).finish()
                proto = protocols[0][1]
        elif fn == registry.REDUCE_SCATTER and zero:
            proto = self.zero_protocols(nbytes, ax0)[0]
            target = lambda x: self._zero_rs_start(x, ax0).finish()
            start_impl = lambda x: self._zero_rs_start(x, ax0)
            sync_nbytes = plan_mod.phase_wire_bytes(proto, p0, nbytes, fn)[0]
        elif fn == registry.ALL_GATHER and zero:
            # the binding shape is the CHUNK; planning happens at the
            # gathered size
            proto = self.zero_protocols(nbytes * p0, ax0)[1]
            target = lambda x: self._zero_ag_start(x, ax0).finish()
            start_impl = lambda x: self._zero_ag_start(x, ax0)
        elif fn == registry.BARRIER:
            proto = xla_tag
            target = lambda t: self._barrier_impl(t, ax0)
        else:
            # (start arm, its options, whether a protocol can be forced)
            arms = {registry.REDUCE_SCATTER:
                        (self._reduce_scatter_start, ("dim",), True),
                    registry.ALL_GATHER:
                        (self._all_gather_start, ("dim",), True),
                    registry.ALL_TO_ALL:
                        (self._all_to_all_start,
                         ("split_dim", "concat_dim"), True),
                    registry.BROADCAST:
                        (self._broadcast_start, ("root",), True),
                    registry.PERMUTE:
                        (self._permute_start, ("shift",), False),
                    registry.SEND_RECV:
                        (self._send_recv_start, ("pairs",), False)}
            if fn not in arms:
                raise ValueError(f"{fn!r} does not support persistent "
                                 "binding")
            arm, opts, planned = arms[fn]
            fkw = {k: kw.pop(k) for k in opts if k in kw}
            if fn == registry.SEND_RECV:
                if "pairs" not in fkw:
                    raise TypeError("persistent send_recv needs pairs=")
                fkw["pairs"] = tuple(tuple(pr) for pr in fkw["pairs"])
            proto = self.protocol_for(
                fn, nbytes * p0 if fn == registry.ALL_GATHER else nbytes,
                ax0)
            if planned:
                fkw["proto"] = proto
            start_impl = lambda x: arm(x, ax0, **fkw)
            target = lambda x: self._run(start_impl(x))
        if kw:
            raise TypeError(f"unknown bind options for {fn!r}: {sorted(kw)}")
        if protocols is None:
            protocols = ((ax0, proto),) if len(axes) == 1 else tuple(
                (ax, proto) for ax in axes)
        base_target = target            # unscaled schedule (wait finalizes)
        scale = self.mean_scale(axes) if mean else None
        if scale is not None:
            def target(x, _inner=target, _s=scale):
                return scale_by(_inner(x), _s)

        tier = self.tier(fn)
        axis_label = axes if len(axes) > 1 else ax0
        if tier >= 2:
            wrapped = layers.wrap_tier(
                fn, tier, lambda x, _axis, **_: target(x), self.stats,
                sanitize=self.config.sanitize_checked)
            call = lambda x, _w=wrapped: _w(x, axis_label)
        else:
            call = target
        if sync_stats:
            def call(x, _inner=call, _nb=sync_nbytes):
                self.stats.record(SYNC_STATS_KEY, _nb)
                return _inner(x)

        if start_impl is None:
            # no seam: the schedule runs whole in start, billed as the
            # generic path bills it
            def start_impl(x, _t=base_target):
                y = _t(x)
                sb = 0 if fn == registry.BARRIER else sum(
                    plan_mod.phase_wire_bytes(
                        xla_tag, self._axis_size(ax), nbytes)[0]
                    for ax in axes)
                return InFlight(fn, axes, lambda: y, xla_tag, sb, 0)

        def start(x, _impl=start_impl, _tier=tier, _nb=sync_nbytes,
                  _s=scale):
            if sync_stats:
                self.stats.record(SYNC_STATS_KEY, _nb)
            x = layers.tier_input(fn, _tier, x, axis_label, self.stats,
                                  sanitize=self.config.sanitize_checked)
            tok = _impl(x)
            if _s is not None:
                tok.scale = _s
            self._record_phase(fn, "start", tok.start_bytes)
            return tok

        return PersistentBinding(
            fn=fn, axes=axes, protocols=protocols, tier=tier,
            nbytes=nbytes, mean_scale=scale,
            fingerprint=self.topology.fingerprint(), call=call,
            start=start, wait=self._wait_inflight,
            progress=self._progress_inflight, sync_stats=sync_stats)


@dataclasses.dataclass(frozen=True)
class PersistentBinding:
    """A fully-resolved collective call site, the output of
    ``CollectiveEngine.bind_persistent``.  ``call`` takes the tensor and
    nothing else; ``start``/``wait``/``progress`` are the two-phase arms
    of the same schedule (``call(x)`` gives ``wait(start(x))``'s bits);
    ``wait`` is where unpad and the mean scale happen.  ``fingerprint``
    is the topology it was resolved against."""

    fn: str
    axes: Tuple[str, ...]
    protocols: Tuple[Tuple[str, str], ...]   # (axis-label, protocol)
    tier: int
    nbytes: int
    mean_scale: Optional[float]
    fingerprint: Any
    call: Callable
    start: Optional[Callable] = None      # x -> InFlight
    wait: Optional[Callable] = None       # InFlight -> tensor
    progress: Optional[Callable] = None   # (InFlight, stages) -> int
    sync_stats: bool = False              # records SYNC_STATS_KEY per call

    def describe(self) -> str:
        protos = ", ".join(f"{a}:{p}" for a, p in self.protocols)
        return (f"{self.fn}@{'+'.join(self.axes)} "
                f"[{protos}] tier=L{self.tier} {self.nbytes}B"
                + (f" mean={self.mean_scale:.4g}"
                   if self.mean_scale is not None else ""))


def check_bucket_ef(ef_state, buckets) -> None:
    """Raise unless ``ef_state`` is the bucketed EF layout of
    ``buckets`` (one flat residual per bucket, of the bucket's size)."""
    if (len(ef_state) != len(buckets)
            or any(e.shape[-1] != b.size for e, b in zip(ef_state, buckets))):
        raise ValueError(
            f"ef_state layout {[e.shape[-1] for e in ef_state]} does not "
            f"match the bucket plan {[b.size for b in buckets]} — was it "
            f"built with the same bucket_bytes?")


def compressed_wire_bytes(size: int) -> int:
    """Payload bytes per hop of the int8 protocol: 1 byte/value + one f32
    scale per quantization block."""
    return int(size) + 4 * math.ceil(int(size) / compression.QBLOCK)

