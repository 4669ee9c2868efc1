"""Model-internal collective facade: the one place model code (tensor-
or expert-parallel forward passes, the trainer's ``auto`` sync) gets its
collectives from.

Counterpart of ``repro.comm.collectives``.  Such collectives run inside
a rank, where no Session object is in scope, but they still go through
the single entity: a process-level default communicator backed by a
monolithic engine, whose protocols are the generic path
(``core.protocols.xla``, the port's stand-in for ``lax.psum`` and its
kin), so every call is visible to the engine's stats and library.

``install(session)`` routes the calls through another session (a
composed one: its plan); ``install(None)`` restores the monolithic
default.
"""

from __future__ import annotations

import threading
from typing import Optional

from repro_torch.comm.session import Communicator, Session

_default: Optional[Session] = None
_installed: Optional[Session] = None
_lock = threading.Lock()         # ranks are threads: build one default


def _session() -> Session:
    global _default
    if _installed is not None:
        return _installed
    with _lock:
        if _default is None:
            from repro_torch.core.topology import Topology
            _default = Session(topology=Topology(axis_sizes={},
                                                 axis_links={}),
                               mode="monolithic")
    return _default


def session() -> Session:
    """The session model-internal collectives go through now: the
    installed one, else the monolithic default."""
    return _session()


def install(session: Optional[Session]) -> None:
    """Route model-internal collectives through ``session`` (None
    restores the monolithic default)."""
    global _installed
    _installed = session


def _comm(axis: str) -> Communicator:
    # the default session's topology is empty: strict=False resolves the
    # axis against the calling rank's live mesh, as the lax calls of the
    # reference resolve theirs
    return Communicator(_session(), (axis,), strict=False)


def psum(x, axis: str):
    """Sum over a mesh axis."""
    return _comm(axis).all_reduce(x)


def pmean(x, axis: str):
    """Mean over a mesh axis: psum / live axis size (the reference's
    ``psum(x) / psum(1)``)."""
    c = _comm(axis)
    return c.all_reduce(x) / c.session.engine.axis_size(axis)


def all_gather(x, axis: str, dim: int = 0):
    """Tiled all-gather over a mesh axis (``lax.all_gather(tiled=True)``)."""
    return _comm(axis).all_gather(x, dim=dim)


def psum_scatter(x, axis: str, dim: int = 0):
    """Tiled reduce-scatter over a mesh axis (``lax.psum_scatter(
    tiled=True)``): rank i gets block i along ``dim`` of the sum.  The
    reference has no such call of its own (GSPMD inserts it where a
    gradient leaves an all-gathered weight); the port's data-split
    ``auto`` step makes it (``parallel.sharding``)."""
    return _comm(axis).reduce_scatter(x, dim=dim)


def all_to_all(x, axis: str, split_dim: int = 0, concat_dim: int = 0):
    return _comm(axis).all_to_all(x, split_dim=split_dim,
                                  concat_dim=concat_dim)


def axis_index(axis: str) -> int:
    """This rank's coordinate along a mesh axis (MPI_Comm_rank)."""
    return _session().engine.axis_index(axis)


def axis_size(axis: str) -> int:
    """Extent of a mesh axis (MPI_Comm_size); the live axis when the
    session's topology does not know it."""
    return _session().engine.axis_size(axis)
