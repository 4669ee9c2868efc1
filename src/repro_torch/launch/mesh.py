"""Production mesh definitions (counterpart of ``repro.launch.mesh``).

Single pod: 256 ranks as (data=16, model=16).
Multi-pod:  2 pods = 512 ranks as (pod=2, data=16, model=16); the "pod"
axis rides InfiniBand, every other NVLink (``core.topology``).

The port's ranks are threads on one card, and 256 of them on one card
are no deployment: a production mesh is abstract (no device), and steps
run over it only under ``substrate.recording()``, as the dry-run
(``repro_torch.launch.dryrun``) runs them.  ``make_host_mesh`` is the
substrate's.
"""

from __future__ import annotations

from repro_torch.runtime import substrate
from repro_torch.runtime.substrate import make_host_mesh

__all__ = ["make_production_mesh", "make_host_mesh"]


def make_production_mesh(*, multi_pod: bool = False) -> substrate.Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return substrate.abstract_mesh(shape, axes)
