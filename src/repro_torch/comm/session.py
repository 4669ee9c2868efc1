"""Sessions-style communicator facade: ONE entity over substrate, plan,
and engine (the paper's single-entity thesis applied to the public API).

Counterpart of ``repro.comm.session``, cut to this slice: ``Session``
(construction from a mesh or a topology, ``probe``,
``from_application(config=...)``, ``finalize``, ``describe``) and the
``Communicator`` it hands out (``split``, ``all_reduce`` and its
start/progress/wait arms, ``compressed_all_reduce``, ``sync_gradients``,
``axis_index``, ``mean_scale``).  ``remesh``, ``persistent`` handles and
``schedule_for`` arrive with later slices.

    sess = Session((2,), ("data",), device="cuda")   # builds the mesh
    sess = Session(mesh=my_mesh)                     # adopts a mesh
    comm = sess.world             # communicator over every mesh axis
    dcomm = sess.split("data")    # per-axis sub-communicator

Collective methods run inside a rank of ``substrate.run_spmd``.
"""

from __future__ import annotations

from typing import Callable, Mapping, Optional, Sequence, Tuple

from repro_torch.core import compose as compose_mod
from repro_torch.core import registry, trace
from repro_torch.core.compose import ComposedLibrary
from repro_torch.core.engine import CollectiveEngine, EngineConfig, scale_by
from repro_torch.core.topology import (Topology, topology_from_mesh,
                                       topology_from_mesh_shape)
from repro_torch.runtime import substrate


class SessionFinalizedError(RuntimeError):
    pass


class Communicator:
    """An axis-scoped view of a session: every collective runs over the
    communicator's own axes — no axis arguments, no engine exposure."""

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
        return self._engine.topology.size(self.axes)

    def _single_axis(self, what: str) -> str:
        if len(self.axes) != 1:
            raise ValueError(f"{what} needs a single-axis communicator; "
                             f"split({self.axes}) first")
        return self.axes[0]

    def split(self, *axes: str) -> "Communicator":
        """Sub-communicator over a subset of the session's axes."""
        return Communicator(self.session, axes)

    def all_reduce(self, x, *, mean: bool = False):
        y = self._engine.all_reduce(x, self._axis_arg)
        if mean:
            y = scale_by(y, self.mean_scale())
        return y

    def all_reduce_start(self, x, *, mean: bool = False):
        return self._engine.all_reduce_start(x, self._axis_arg, mean=mean)

    def all_reduce_wait(self, token):
        return self._engine.all_reduce_wait(token)

    def all_reduce_progress(self, token, stages: int = 1) -> int:
        return self._engine.all_reduce_progress(token, stages)

    def compressed_all_reduce(self, x, state=None):
        return self._engine.compressed_all_reduce(
            x, self._single_axis("compressed_all_reduce"), state)

    def axis_index(self) -> int:
        return self._engine.axis_index(self._single_axis("axis_index"))

    def mean_scale(self) -> float:
        return self._engine.mean_scale(self.axes)

    def sync_gradients(self, grads, *, mean: bool = True,
                       compress: bool = False, ef_state=None):
        return self._engine.sync_gradients(
            grads, self._axis_arg, mean=mean, compress=compress,
            ef_state=ef_state)

    def describe(self) -> str:
        sizes = dict(self._engine.topology.axis_sizes)
        return ("Communicator(" + " x ".join(
            f"{a}={sizes.get(a, '?')}" for a in self.axes) + ")")


class Session:
    """An initialized communication session: owns the mesh, the
    topology/cost model, the ``CommPlan`` and the ``CollectiveEngine``;
    hands out ``Communicator``s."""

    def __init__(self, mesh_shape: Optional[Sequence[int]] = None,
                 axis_names: Optional[Sequence[str]] = None, *,
                 mesh: Optional[substrate.Mesh] = None,
                 device="cuda",
                 topology: Optional[Topology] = None,
                 config: Optional[EngineConfig] = None,
                 library: Optional[ComposedLibrary] = None,
                 frequencies: Optional[Mapping[str, float]] = None) -> None:
        if mesh_shape is not None:
            if mesh is not None:
                raise ValueError("pass mesh_shape or mesh, not both")
            if axis_names is None:
                raise ValueError("mesh_shape needs axis_names")
            mesh = substrate.make_mesh(tuple(mesh_shape), tuple(axis_names),
                                       device=device)
        self._mesh = mesh
        self._finalized = False
        self.trace_report: Optional[trace.TraceReport] = None
        if topology is None:
            if mesh is None:
                raise ValueError("Session needs mesh_shape+axis_names, "
                                 "mesh=, or topology=")
            topology = topology_from_mesh(mesh)
        self._engine = CollectiveEngine(
            topology,
            library=library or compose_mod.compose(registry.ALL_FUNCTIONS),
            frequencies=frequencies, config=config or EngineConfig())
        if mesh is not None and not mesh.abstract:
            self._engine.init(mesh)

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

    def finalize(self) -> str:
        """MPI_Session_finalize: flush stats."""
        if self._finalized:
            raise SessionFinalizedError("session is finalized")
        self._finalized = True
        return self._engine.finalize()

    def average_layer_number(self) -> float:
        return self._engine.average_layer_number()

    def describe(self) -> str:
        return (f"Session(axes={list(self.axis_names)}, "
                f"avg_layer={self.average_layer_number():.3f})\n  "
                + self._engine.describe().replace("\n", "\n  "))


__all__ = ["Communicator", "Session", "SessionFinalizedError"]
