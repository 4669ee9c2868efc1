"""repro_torch.comm — the Sessions-style communicator facade.

``Session`` owns mesh + cost model + CommPlan + engine as one entity;
``Communicator``s (``session.world``, ``session.split(axis)``) carry the
axis scope.  ``repro_torch.comm.collectives`` is the model-internal
facade.  Counterpart of ``repro.comm``.
"""

from repro_torch.comm import collectives
from repro_torch.comm.session import (Communicator, HandleRevokedError,
                                      InFlightHandleError, PersistentHandle,
                                      Session, SessionFinalizedError)

__all__ = ["Communicator", "HandleRevokedError", "InFlightHandleError",
           "PersistentHandle", "Session", "SessionFinalizedError",
           "collectives"]
