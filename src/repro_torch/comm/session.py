"""Sessions-style communicator facade: ONE entity over substrate, plan,
and engine (the paper's single-entity thesis applied to the public API).

Counterpart of ``repro.comm.session``: ``Session`` (construction from a
mesh or a topology, ``probe``, ``from_application(config=...)``,
``schedule_for``, ``timeline_diff``, ``remesh``, ``finalize``,
``describe``, ``mode="monolithic"`` for the conventional baseline), the
``Communicator`` it hands out (``split``, ``all_reduce`` and its
start/progress/wait arms, ``reduce_scatter``, ``all_gather``,
``all_to_all``, ``broadcast``, ``permute``, ``send_recv``, ``barrier``,
``checkpoint_fence``, the gradient-sync and ZeRO-1 arms,
``compressed_all_reduce``, ``sync_gradients[_bucketed]``,
``sync_schedule``, ``zero_sync_schedule``, ``persistent``,
``axis_index``, ``mean_scale``) and ``PersistentHandle``; for the
elastic controllers ``adopt`` (wrap a built engine), ``activate`` (the
session's mesh as the active one) and ``remesh_over`` (plan the
survivors' mesh, then ``remesh``).

    sess = Session((2,), ("data",), device="cuda")   # builds the mesh
    sess = Session(mesh=my_mesh)                     # adopts a mesh
    comm = sess.world             # communicator over every mesh axis
    dcomm = sess.split("data")    # per-axis sub-communicator
    h = dcomm.persistent("all_reduce", (1024,), torch.float32, mean=True)

Invalidation has exactly ONE path: ``Session.remesh(mesh)`` re-``init``s
the engine (the topology-fingerprint rule decides the CommPlan rebuild)
and revokes and rebinds every outstanding persistent handle;
``remesh_over`` only plans the mesh it hands to ``remesh``.

Collective methods run inside a rank of ``substrate.run_spmd``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
import weakref
from typing import Callable, Dict, Mapping, Optional, Sequence, Tuple

import torch

from repro_torch.core import compose as compose_mod
from repro_torch.core import costmodel, layers, registry, trace
from repro_torch.core import plan as plan_mod
from repro_torch.core import schedule as schedule_mod
from repro_torch.core.compose import ComposedLibrary
from repro_torch.core.engine import (CollectiveEngine, EngineConfig,
                                     PersistentBinding,
                                     compressed_wire_bytes, scale_by)
from repro_torch.core.topology import (Topology, topology_from_mesh,
                                       topology_from_mesh_shape)
from repro_torch.runtime import substrate


class HandleRevokedError(RuntimeError):
    """A persistent handle was invoked after revocation (its axis is gone
    from the new topology, or its session was finalized), or an in-flight
    token from an earlier binding epoch was waited after a re-mesh."""


class InFlightHandleError(RuntimeError):
    """A re-mesh was asked for while a handle had a started but never
    waited collective: rebinding would silently drop that reduction."""


class SessionFinalizedError(RuntimeError):
    pass


@dataclasses.dataclass
class HandleInFlight:
    """Comm-level in-flight token: the engine token plus the binding
    epoch it was started under (``PersistentHandle.wait`` refuses a token
    of a stale epoch)."""

    handle: "PersistentHandle"
    epoch: int
    inner: object            # engine-level InFlight


# ---------------------------------------------------------------------------
# Persistent handles
# ---------------------------------------------------------------------------


class PersistentHandle:
    """A bound collective: ``handle(x)`` runs the pre-resolved schedule.

    Bound at creation against the session's topology; on
    ``Session.remesh`` revoked and rebound against the new one
    (``revocations`` counts fingerprint changes, ``epoch`` counts binds);
    if rebinding is impossible (axis vanished, session finalized) it
    stays revoked and calling it raises ``HandleRevokedError``.  One
    handle serves every rank of the session (ranks are threads), so its
    in-flight count is kept under a lock."""

    def __init__(self, comm: "Communicator", fn: str,
                 shape: Sequence[int], dtype, *, mean: bool = False,
                 **kw) -> None:
        self._comm = comm
        self.fn = fn
        self.shape = tuple(int(s) for s in shape)
        self.dtype = dtype
        self.mean = bool(mean)
        self._kw = dict(kw)
        self.binding: Optional[PersistentBinding] = None
        self._target: Optional[Callable] = None
        self._stale_reason: Optional[str] = None
        self._permanent = False   # finalized session: no rebind can revive
        self.epoch = 0            # successful (re)binds
        self.revocations = 0      # fingerprint-change revocations
        self._pending = 0         # started-but-not-yet-waited collectives
        self._lock = threading.Lock()
        self._bind()

    # -- lifecycle (driven by the owning Session) ----------------------

    def _bind(self) -> None:
        binding = self._comm._engine.bind_persistent(
            self.fn, self.shape, self.dtype, self._comm._axis_arg,
            mean=self.mean, **self._kw)
        self.binding = binding
        self._target = binding.call
        self._stale_reason = None
        self.epoch += 1

    def _revoke(self, reason: str, permanent: bool = False) -> None:
        self._target = None
        self._stale_reason = reason
        self._permanent = self._permanent or permanent

    def _rebind(self, *, fingerprint_changed: bool) -> None:
        if fingerprint_changed:
            self.revocations += 1
        try:
            self._bind()
        except ValueError as e:     # axis gone from the new topology
            self._revoke(str(e))

    # -- the hot path --------------------------------------------------

    def __call__(self, x):
        with substrate.collective(self.fn, x):
            return self._call(x)

    def _call(self, x):
        target = self._target
        if target is None:
            raise HandleRevokedError(
                f"persistent {self.fn} handle is revoked "
                f"({self._stale_reason}); "
                + ("its session is finalized — bind a new handle on a new "
                   "session" if self._permanent else
                   "the owning session rebinding it on the next re-mesh "
                   "will revive it"))
        return target(x)

    # -- the two-phase arms (MPIX_Start / MPIX_Wait) -------------------

    def start(self, x) -> HandleInFlight:
        """Run the collective's first pipeline stage(s) and return an
        in-flight token.  Revocation is checked once, here."""
        if self._target is None:
            raise HandleRevokedError(
                f"persistent {self.fn} handle is revoked "
                f"({self._stale_reason}); cannot start")
        epoch = self.epoch
        with substrate.collective(self.fn, x):
            inner = self.binding.start(x)
        with self._lock:
            self._pending += 1
        return HandleInFlight(handle=self, epoch=epoch, inner=inner)

    def _check_token(self, token: HandleInFlight, what: str) -> None:
        if token.handle is not self:
            raise ValueError(f"token for {token.handle.fn} handle "
                             f"{what} on a different handle ({self.fn})")
        if self.revoked or token.epoch != self.epoch:
            raise HandleRevokedError(
                f"in-flight {self.fn} collective was started under binding "
                f"epoch {token.epoch} but the handle is now "
                + (f"revoked ({self._stale_reason})" if self.revoked else
                   f"at epoch {self.epoch} (re-mesh between start and "
                   f"{what})") + " — the started reduction was dropped, "
                "not silently completed; re-issue start() on the rebound "
                "handle")

    def progress(self, token: HandleInFlight, stages: int = 1) -> int:
        """Advance the in-flight collective by up to ``stages`` wait-phase
        stages without completing it; the token stays waitable.  Returns
        the stages retired (0 for seamless protocols)."""
        self._check_token(token, "progressed")
        with substrate.collective(self.fn):
            return self.binding.progress(token.inner, stages)

    def wait(self, token: HandleInFlight):
        """Run the remaining stages and finalize (unpad + mean scale).  A
        token started under an earlier binding epoch raises."""
        self._check_token(token, "waited")
        with self._lock:
            self._pending -= 1
        with substrate.collective(self.fn):
            return self.binding.wait(token.inner)

    @property
    def inflight(self) -> int:
        """Started-but-never-waited collectives on the current binding."""
        return self._pending

    def abandon_inflight(self) -> int:
        """Drop the in-flight count (after an aborted step whose tokens
        were discarded).  Returns how many were abandoned."""
        with self._lock:
            n, self._pending = self._pending, 0
        return n

    # -- introspection -------------------------------------------------

    @property
    def revoked(self) -> bool:
        return self._target is None

    @property
    def protocols(self) -> Tuple[Tuple[str, str], ...]:
        return self.binding.protocols if self.binding else ()

    def describe(self) -> str:
        state = f"REVOKED({self._stale_reason})" if self.revoked else "bound"
        what = self.binding.describe() if self.binding else self.fn
        return (f"PersistentHandle({what}, {state}, epoch={self.epoch}, "
                f"revocations={self.revocations})")


def _compute_ops(compute) -> list:
    out = []
    for entry in compute:
        tag, overlappable = (entry if isinstance(entry, tuple)
                             else (entry, True))
        out.append(schedule_mod.ComputeOp(tag=str(tag),
                                          overlappable=bool(overlappable)))
    return out


def _itemsize(dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def _sync_fn(compress: bool) -> str:
    """The collective a gradient sync runs."""
    return (registry.COMPRESSED_ALL_REDUCE if compress
            else registry.ALL_REDUCE)


class Communicator:
    """An axis-scoped view of a session: every collective runs over the
    communicator's own axes — no axis arguments, no engine exposure.
    ``strict=False`` accepts axes the session's topology lacks; their
    sizes resolve against the calling rank's live mesh (what the
    ``collectives`` facade needs for its default session)."""

    def __init__(self, session: "Session", axes: Sequence[str], *,
                 strict: bool = True) -> None:
        axes = tuple(axes)
        if not axes:
            raise ValueError("a communicator needs at least one axis")
        if strict:
            unknown = [a for a in axes if a not in session.axis_names]
            if unknown:
                raise ValueError(f"unknown axes {unknown}; session has "
                                 f"{list(session.axis_names)}")
        self.session = session
        self.axes = axes
        self._axis_arg = axes[0] if len(axes) == 1 else axes

    @property
    def _engine(self) -> CollectiveEngine:
        return self.session.engine

    @property
    def mesh(self):
        return self.session.mesh

    @property
    def size(self) -> int:
        return math.prod(self._engine._axis_size(a) for a in self.axes)

    def _single_axis(self, what: str) -> str:
        if len(self.axes) != 1:
            raise ValueError(f"{what} needs a single-axis communicator; "
                             f"split({self.axes}) first")
        return self.axes[0]

    def split(self, *axes: str) -> "Communicator":
        """Sub-communicator over a subset of the session's axes."""
        return Communicator(self.session, axes)

    def all_reduce(self, x, *, mean: bool = False):
        with substrate.collective(registry.ALL_REDUCE, x):
            y = self._engine.all_reduce(x, self._axis_arg)
        if mean:
            y = scale_by(y, self.mean_scale())
        return y

    def all_reduce_start(self, x, *, mean: bool = False):
        with substrate.collective(registry.ALL_REDUCE, x):
            return self._engine.all_reduce_start(x, self._axis_arg,
                                                 mean=mean)

    def all_reduce_wait(self, token):
        with substrate.collective(registry.ALL_REDUCE):
            return self._engine.all_reduce_wait(token)

    def all_reduce_progress(self, token, stages: int = 1) -> int:
        with substrate.collective(registry.ALL_REDUCE):
            return self._engine.all_reduce_progress(token, stages)

    def sync_gradient_start(self, g, *, mean: bool = True,
                            compress: bool = False, ef_residual=None):
        """Two-phase arm of one gradient tensor's sync (a fused bucket or
        a leaf); wire bytes are recorded as the blocking paths do."""
        with substrate.collective(_sync_fn(compress), g):
            return self._engine.sync_gradient_start(
                g, self._axis_arg, mean=mean, compress=compress,
                ef_residual=ef_residual)

    def sync_gradient_progress(self, token, stages: int = 1) -> int:
        with substrate.collective(_sync_fn(token.compress)):
            return self._engine.sync_gradient_progress(token, stages)

    def sync_gradient_wait(self, token):
        """Finalize one in-flight gradient sync.  Returns (synced,
        new_ef_residual | None)."""
        with substrate.collective(_sync_fn(token.compress)):
            return self._engine.sync_gradient_wait(token)

    # -- the ZeRO-1 seam: RS-only grad sync + param all-gather ---------

    def zero_reduce_scatter_start(self, g, *, mean: bool = True):
        """Only the reduce-scatter half of the PLANNED all-reduce; the
        wait arm yields this rank's reduced padded-flat chunk."""
        with substrate.collective(registry.REDUCE_SCATTER, g):
            return self._engine.zero_reduce_scatter_start(
                g, self._single_axis("zero_reduce_scatter"), mean=mean)

    def zero_reduce_scatter_wait(self, token):
        with substrate.collective(registry.REDUCE_SCATTER):
            return self._engine.zero_reduce_scatter_wait(token)

    def zero_all_gather_start(self, shard):
        """Start the updated-param all-gather of a ZeRO step; the wait
        arm yields the full padded-flat vector (callers unpad)."""
        with substrate.collective(registry.ALL_GATHER, shard):
            return self._engine.zero_all_gather_start(
                shard, self._single_axis("zero_all_gather"))

    def zero_all_gather_wait(self, token):
        with substrate.collective(registry.ALL_GATHER):
            return self._engine.zero_all_gather_wait(token)

    def reduce_scatter(self, x, dim: int = 0):
        with substrate.collective(registry.REDUCE_SCATTER, x):
            return self._engine.reduce_scatter(
                x, self._single_axis("reduce_scatter"), dim=dim)

    def all_gather(self, x, dim: int = 0):
        with substrate.collective(registry.ALL_GATHER, x):
            return self._engine.all_gather(
                x, self._single_axis("all_gather"), dim=dim)

    def all_to_all(self, x, split_dim: int = 0, concat_dim: int = 0):
        with substrate.collective(registry.ALL_TO_ALL, x):
            return self._engine.all_to_all(
                x, self._single_axis("all_to_all"),
                split_dim=split_dim, concat_dim=concat_dim)

    def broadcast(self, x, root: int = 0):
        with substrate.collective(registry.BROADCAST, x):
            return self._engine.broadcast(
                x, self._single_axis("broadcast"), root=root)

    def permute(self, x, shift: int = 1):
        with substrate.collective(registry.PERMUTE, x):
            return self._engine.permute(
                x, self._single_axis("permute"), shift=shift)

    def send_recv(self, x, pairs):
        with substrate.collective(registry.SEND_RECV, x):
            return self._engine.send_recv(
                x, self._single_axis("send_recv"), pairs)

    def compressed_all_reduce(self, x, state=None):
        with substrate.collective(registry.COMPRESSED_ALL_REDUCE, x):
            return self._engine.compressed_all_reduce(
                x, self._single_axis("compressed_all_reduce"), state)

    def barrier(self, token=None):
        with substrate.collective(registry.BARRIER):
            return self._engine.barrier(self._axis_arg, token)

    def checkpoint_fence(self, tree):
        return self._engine.checkpoint_fence(tree)

    def axis_index(self) -> int:
        return self._engine.axis_index(self._single_axis("axis_index"))

    def mean_scale(self) -> float:
        return self._engine.mean_scale(self.axes)

    def sync_gradients(self, grads, *, mean: bool = True,
                       compress: bool = False, ef_state=None):
        return self._engine.sync_gradients(
            grads, self._axis_arg, mean=mean, compress=compress,
            ef_state=ef_state)

    def sync_gradients_bucketed(self, grads, *, mean: bool = True,
                                bucket_bytes=plan_mod.DEFAULT_BUCKET_BYTES,
                                compress: bool = False, ef_state=None):
        return self._engine.sync_gradients_bucketed(
            grads, self._axis_arg, mean=mean, bucket_bytes=bucket_bytes,
            compress=compress, ef_state=ef_state)

    # -- schedule IR ---------------------------------------------------

    def sync_schedule(self, specs, *, compress: bool = False,
                      compute=(), meta=None) -> schedule_mod.Schedule:
        """The canonical *blocking* gradient-sync program over this
        communicator's axes.  ``specs`` are ``(name, n_elems, dtype)``
        triples, one per work unit (a fused bucket or a leaf) in layout
        order; each unit carries the planner's protocol, its (start,
        wait) stage split and the cost model's per-phase wire bytes, so
        ``predicted_phase_bytes`` compares with ``CommStats.phase_bytes``.
        ``compute`` entries (``tag`` or ``(tag, overlappable)``) become
        compute barriers ahead of the comm region."""
        eng = self._engine
        p0 = eng.topology.axis_sizes.get(self.axes[0], 1)
        units = []
        for idx, (name, n_elems, dtype) in enumerate(specs):
            n_elems = int(n_elems)
            nbytes = n_elems * _itemsize(dtype)
            if compress:
                # int8 ring over the first axis; cross-axis reductions run
                # blocking inside wait (not phase-attributed)
                fn = registry.COMPRESSED_ALL_REDUCE
                proto = costmodel.RING
                ss, ws = plan_mod.protocol_stage_counts(proto, p0)
                sb, wb = plan_mod.phase_wire_bytes(
                    proto, p0, compressed_wire_bytes(n_elems))
            elif len(self.axes) > 1:
                # multi-axis schedules are fixed by the axis set; their
                # phases are billed over the extent the engine bills
                # (the intra-pod product for the hierarchical schedule:
                # the reference bills the first axis, the same for pods
                # as wide as the intra extent)
                fn = registry.ALL_REDUCE
                proto = (costmodel.HIERARCHICAL if "pod" in self.axes
                         else costmodel.TWO_PHASE_2D)
                pm = eng.multiaxis_extent(self.axes)
                ss, ws = plan_mod.protocol_stage_counts(proto, pm)
                sb, wb = plan_mod.phase_wire_bytes(proto, pm, nbytes)
            else:
                fn = registry.ALL_REDUCE
                entry = eng.plan.entry_for(fn, nbytes, self.axes[0])
                proto = entry.protocol
                ss, ws = entry.start_stages, entry.wait_stages
                sb, wb = plan_mod.phase_wire_bytes(proto, p0, nbytes, fn)
            units.append(schedule_mod.sync_unit(
                name=str(name), index=idx, fn=fn, axes=self.axes,
                protocol=proto, start_stages=ss, wait_stages=ws,
                start_bytes=sb, wait_bytes=wb))
        return schedule_mod.build_sync_schedule(
            units, compute=_compute_ops(compute), meta=meta)

    def zero_sync_schedule(self, specs, *, kind: str, compute=(),
                           meta=None) -> schedule_mod.Schedule:
        """One half of a ZeRO-1 step as a blocking program over this
        single-axis communicator (the optimizer update sits between the
        halves): ``kind="rs"`` has one ``reduce_scatter`` unit per leaf
        (the planned all-reduce's RS half); ``kind="ag"`` one
        ``all_gather`` unit per leaf, whose ``specs`` carry the GATHERED
        (padded p*chunk) element counts.  Units carry the split the
        engine's ZeRO arms record, so predicted == measured."""
        if kind not in ("rs", "ag"):
            raise ValueError(f"kind must be 'rs' or 'ag', got {kind!r}")
        ax = self._single_axis("zero_sync_schedule")
        eng = self._engine
        p0 = eng.topology.axis_sizes.get(ax, 1)
        units = []
        for idx, (name, n_elems, dtype) in enumerate(specs):
            nbytes = int(n_elems) * _itemsize(dtype)
            rs_proto, ag_proto = eng.zero_protocols(nbytes, ax)
            if kind == "rs":
                fn, proto = registry.REDUCE_SCATTER, rs_proto
            else:
                fn, proto = registry.ALL_GATHER, ag_proto
            ss, ws = plan_mod.protocol_stage_counts(proto, p0, fn)
            sb, wb = plan_mod.phase_wire_bytes(proto, p0, nbytes, fn)
            units.append(schedule_mod.sync_unit(
                name=str(name), index=idx, fn=fn, axes=self.axes,
                protocol=proto, start_stages=ss, wait_stages=ws,
                start_bytes=sb, wait_bytes=wb))
        return schedule_mod.build_sync_schedule(
            units, compute=_compute_ops(compute), meta=meta)

    # -- persistent handles --------------------------------------------

    def persistent(self, fn: str, shape: Sequence[int], dtype, *,
                   mean: bool = False, **kw) -> PersistentHandle:
        """Bind ``fn`` over this communicator's axes for a fixed (shape,
        dtype): protocol, tier stack and mean scale resolved now.  The
        session owns the handle's lifecycle (revoked and rebound on
        re-mesh).  ``sync_stats=True`` marks a gradient-sync handle;
        ``zero=True`` binds a ZeRO-1 seam arm."""
        handle = PersistentHandle(self, fn, shape, dtype, mean=mean, **kw)
        self.session._register(handle)
        return handle

    def describe(self) -> str:
        sizes = dict(self._engine.topology.axis_sizes)
        return ("Communicator(" + " x ".join(
            f"{a}={sizes.get(a, '?')}" for a in self.axes) + ")")


class Session:
    """An initialized communication session: owns the mesh, the
    topology/cost model, the ``CommPlan`` and the ``CollectiveEngine``;
    hands out ``Communicator``s.  ``mode="monolithic"`` (or a
    monolithic ``config``) is the conventional-stack baseline: every
    function present, the generic protocols, uniform tier depth."""

    def __init__(self, mesh_shape: Optional[Sequence[int]] = None,
                 axis_names: Optional[Sequence[str]] = None, *,
                 mesh: Optional[substrate.Mesh] = None,
                 device="cuda",
                 topology: Optional[Topology] = None,
                 mode: str = "composed",
                 config: Optional[EngineConfig] = None,
                 library: Optional[ComposedLibrary] = None,
                 frequencies: Optional[Mapping[str, float]] = None,
                 _engine: Optional[CollectiveEngine] = None) -> None:
        if mesh_shape is not None:
            if mesh is not None:
                raise ValueError("pass mesh_shape or mesh, not both")
            if axis_names is None:
                raise ValueError("mesh_shape needs axis_names")
            mesh = substrate.make_mesh(tuple(mesh_shape), tuple(axis_names),
                                       device=device)
        self._mesh = mesh
        self._handles: "weakref.WeakSet[PersistentHandle]" = \
            weakref.WeakSet()
        self._finalized = False
        self.generation = 0          # fingerprint-changing remeshes
        self.trace_report: Optional[trace.TraceReport] = None
        if _engine is not None:      # adopt(): wrap an existing engine
            self._engine = _engine
            return
        if topology is None:
            if mesh is None:
                raise ValueError("Session needs mesh_shape+axis_names, "
                                 "mesh=, or topology=")
            topology = topology_from_mesh(mesh)
        cfg = config or EngineConfig(mode=mode)
        if cfg.mode == "monolithic":
            self._engine = CollectiveEngine(topology, config=cfg)
        else:
            self._engine = CollectiveEngine(
                topology,
                library=library or compose_mod.compose(
                    registry.ALL_FUNCTIONS),
                frequencies=frequencies, config=cfg)
        if mesh is not None and not mesh.abstract:
            self._engine.init(mesh)

    @classmethod
    def adopt(cls, engine: CollectiveEngine,
              mesh: Optional[substrate.Mesh] = None) -> "Session":
        """Wrap an already-built engine (for callers still holding a
        ``CollectiveEngine``): the session takes over its lifecycle but
        does not re-``init`` it."""
        return cls(mesh=mesh, _engine=engine)

    @classmethod
    def probe(cls, mesh_shape: Sequence[int] = (4,),
              axis_names: Sequence[str] = ("data",)) -> "Session":
        """A device-less session over an abstract mesh for the paper's
        §2.2 application scan: build the probe step against
        ``probe.world`` / ``probe.mesh``, then hand both to
        ``Session.from_application``.  Nothing computes, nothing is
        allocated."""
        mesh = substrate.abstract_mesh(tuple(mesh_shape), tuple(axis_names))
        return cls(mesh=mesh, topology=topology_from_mesh_shape(
            tuple(axis_names), tuple(mesh_shape)))

    @classmethod
    def from_application(cls, step_fn: Callable, *abstract_args,
                         mesh: substrate.Mesh,
                         probe: Optional["Session"] = None,
                         config: Optional[EngineConfig] = None,
                         steps_hint: float = 1e4,
                         extra_functions: Sequence[str] = (),
                         **abstract_kwargs) -> "Session":
        """The §2.2 flow as one call: scan ``step_fn`` (run on ``meta``
        inputs over the probe's abstract mesh), compose the thin library
        covering exactly what it invokes, and initialize a session for
        ``mesh`` with ``config``.

        ``probe`` is the ``Session.probe(...)`` the step was built
        against; its engine records the engine-level functions the step
        invoked (protocol lowering hides e.g. all_reduce behind hops)."""
        report = trace.scan_step(step_fn, *abstract_args, **abstract_kwargs)
        extra = set(extra_functions)
        if probe is not None:
            extra |= set(probe.engine.invoked_functions)
        library = compose_mod.compose_from_trace(report, extra=extra)
        freqs = dict(registry.DEFAULT_FREQUENCIES)
        freqs.update({fn: c * steps_hint
                      for fn, c in report.frequencies().items()})
        sess = cls(mesh=mesh, config=config, library=library,
                   frequencies=freqs)
        sess.trace_report = report
        return sess

    @property
    def engine(self) -> CollectiveEngine:
        """The private implementation layer (held for introspection)."""
        return self._engine

    @property
    def mesh(self) -> Optional[substrate.Mesh]:
        return self._mesh

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return tuple(self._engine.topology.axis_sizes)

    @property
    def world(self) -> Communicator:
        return Communicator(self, self.axis_names)

    def split(self, *axes: str) -> Communicator:
        return Communicator(self, axes)

    # -- schedule IR ---------------------------------------------------

    def schedule_for(self, step_fn: Callable, *abstract_args,
                     passes=None, **abstract_kwargs
                     ) -> schedule_mod.Schedule:
        """The application's comm program as a schedule: run ``step_fn``
        on ``meta`` inputs under the recording transport (the §2.2 scan),
        lift its hops into schedule IR and annotate every unit through
        this session's ``CommPlan``.  ``passes`` — ``(name, pass)`` pairs,
        e.g. ``plan.canonical_overlap_passes(depth)`` — are applied with
        per-pass timings in ``schedule.meta["pass_us"]``.  Nothing
        computes."""
        report = trace.scan_step(step_fn, *abstract_args, **abstract_kwargs)
        sched = report.to_schedule(plan=self._engine.plan,
                                   topology=self._engine.topology)
        if passes:
            sched, timings = plan_mod.run_passes(sched, passes)
            sched.meta["pass_us"] = timings
        return sched

    def timeline_diff(self, schedule: schedule_mod.Schedule, rank: int = 0
                      ) -> Dict[str, Dict[str, int]]:
        """The schedule's predicted phase bytes (per rank) against what
        rank ``rank`` recorded in this session's engine
        (``CommStats.rank_phase_bytes``), per ``"<fn>.<phase>"`` key."""
        return schedule_mod.timeline_diff(schedule, dict(
            self._engine.stats.rank_phase_bytes.get(rank, {})))

    # -- lifecycle -------------------------------------------------------

    def _register(self, handle: PersistentHandle) -> None:
        if self._finalized:
            raise SessionFinalizedError("session is finalized")
        self._handles.add(handle)

    @property
    def handles(self) -> Tuple[PersistentHandle, ...]:
        return tuple(self._handles)

    def remesh(self, mesh: substrate.Mesh) -> bool:
        """THE invalidation path: bind the session to a new mesh of
        thread ranks.  Re-``init``s the engine (the topology-fingerprint
        rule, over every axis: "data", "model", "pod", decides whether
        the CommPlan rebuilds), then revokes every outstanding persistent
        handle and rebinds it against the new topology (a handle's mean
        scale follows its axes' new sizes).  Returns whether the plan was
        rebuilt.  Refuses while a handle has a started but never waited
        collective."""
        if self._finalized:
            raise SessionFinalizedError("session is finalized")
        handles = list(self._handles)
        pending = [h for h in handles if h.inflight]
        if pending:
            raise InFlightHandleError(
                "remesh would drop in-flight collectives: "
                + "; ".join(f"{h.fn}{list(h.shape)} handle (epoch "
                            f"{h.epoch}) has {h.inflight} start(s) "
                            f"never waited" for h in pending)
                + " — wait() the outstanding tokens (or "
                "handle.abandon_inflight() if they were discarded) "
                "before re-meshing")
        for h in handles:
            h._revoke("re-mesh in progress")
        self._engine.init(mesh)
        rebuilt = self._engine.last_init_rebuilt
        self._mesh = mesh
        if rebuilt:
            self.generation += 1
        for h in handles:
            h._rebind(fingerprint_changed=rebuilt)
        return rebuilt

    def remesh_over(self, members: Sequence[int], *,
                    model_parallel: Optional[int] = None,
                    pods: Optional[int] = None):
        """Plan the survivors' mesh and ``remesh`` onto it in one call —
        the serving tier's recovery surface.  ``members``: the surviving
        member ids, in the order their ranks take.  ``model_parallel`` /
        ``pods``: the ORIGINAL layout to aim back at (defaults read off
        the current mesh).  The new mesh keeps the axis names and device
        and stands for the first ``prod(shape)`` members.  Returns
        ``(mesh, plan_rebuilt)``."""
        from repro_torch.runtime import elastic    # no import cycle
        if self._mesh is None or self._mesh.abstract:
            raise ValueError("remesh_over needs a session over a concrete "
                             "mesh")
        sizes = self._mesh.shape
        mp = model_parallel if model_parallel is not None \
            else sizes.get("model", 1)
        pd = pods if pods is not None else sizes.get("pod", 1)
        members = list(members)
        shape = elastic.plan_mesh_shape(len(members), mp, pods=pd,
                                        ndim=len(sizes))
        mesh = elastic.make_mesh_from_shape(
            shape, self._mesh.axis_names,
            members=members[:math.prod(shape)], device=self._mesh.device)
        return mesh, self.remesh(mesh)

    def activate(self):
        """Context manager making the session's mesh the active one
        (``substrate.set_mesh``: its card the current CUDA device)."""
        if self._mesh is None or self._mesh.abstract:
            return contextlib.nullcontext()
        return substrate.set_mesh(self._mesh)

    def finalize(self) -> str:
        """MPI_Session_finalize: permanently revoke handles, flush stats."""
        if self._finalized:
            raise SessionFinalizedError("session is finalized")
        for h in self._handles:
            h._revoke("session finalized", permanent=True)
        self._finalized = True
        return self._engine.finalize()

    def average_layer_number(self, include_handles: bool = True) -> float:
        """Frequency-weighted average dispatch depth (paper §3).  Bound
        persistent handles resolve their whole stack at bind time, so the
        functions they cover count at L0."""
        eng = self._engine
        tiers = dict(eng.tiers)
        if include_handles:
            for h in self._handles:
                if not h.revoked and h.fn in tiers:
                    tiers[h.fn] = 0
        freqs = {fn: eng.frequencies.get(
            fn, registry.DEFAULT_FREQUENCIES.get(fn, 1.0)) for fn in tiers}
        return layers.average_layer_number(tiers, freqs)

    def describe(self) -> str:
        rows = [f"Session(axes={list(self.axis_names)}, "
                f"handles={len(self._handles)}, "
                f"generation={self.generation}, "
                f"avg_layer={self.average_layer_number():.3f})",
                "  " + self._engine.describe().replace("\n", "\n  ")]
        for h in self._handles:
            rows.append(f"  {h.describe()}")
        return "\n".join(rows)


__all__ = ["Communicator", "HandleInFlight", "HandleRevokedError",
           "InFlightHandleError", "PersistentHandle", "Session",
           "SessionFinalizedError"]
