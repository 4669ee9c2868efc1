"""Model-internal collective facade: the one place model code (tensor-
or expert-parallel forward passes) gets its collectives from.

Counterpart of ``repro.comm.collectives``.  The reference's default
session is the monolithic XLA baseline, which arrives with the port of
``xla.py``; until then a caller installs a composed session first
(``install(session)``), and every call goes through it.  The dense
models of this slice call none of these.
"""

from __future__ import annotations

from typing import Optional

from repro_torch.comm.session import Communicator, Session

_installed: Optional[Session] = None


def install(session: Optional[Session]) -> None:
    """Route model-internal collectives through ``session`` (None
    uninstalls)."""
    global _installed
    _installed = session


def _session() -> Session:
    if _installed is None:
        raise RuntimeError("no session installed: call "
                           "collectives.install(session) first")
    return _installed


def _comm(axis: str) -> Communicator:
    return Communicator(_session(), (axis,))


def psum(x, axis: str):
    """Sum over a mesh axis."""
    return _comm(axis).all_reduce(x)


def pmean(x, axis: str):
    """Mean over a mesh axis: psum / axis size."""
    c = _comm(axis)
    return c.all_reduce(x) / c.session.engine.axis_size(axis)


def axis_index(axis: str) -> int:
    """This rank's coordinate along a mesh axis (MPI_Comm_rank)."""
    return _session().engine.axis_index(axis)


def axis_size(axis: str) -> int:
    """Extent of a mesh axis (MPI_Comm_size)."""
    return _session().engine.axis_size(axis)
