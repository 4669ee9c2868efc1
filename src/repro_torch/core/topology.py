"""MPI-network analogue: a model of the physical network under a mesh.

The paper (§4) argues the network should be designed *for* the protocol
and the protocol *for* each function — a "single entity".  On a GPU
cluster the network is fixed (NVLink/NVSwitch inside a node, InfiniBand
between nodes), so the co-design runs the other way: the protocol layer
reads an explicit topology model and specializes per function.  This
module is that model; counterpart of ``repro.core.topology``, whose TPU
constants it replaces with an H100 link model.

Link constants, modelled from the H100 SXM data sheet (not measured):
  NVLink 4 through NVSwitch: 900 GB/s per GPU in both directions
  together, so 450 GB/s each way, and any ring closes at full bandwidth
  (``wraparound=True``); per-hop latency modelled at 1 us.
  InfiniBand NDR between nodes: one 400 Gb/s port per GPU, 50 GB/s each
  way, rings do not close at link speed; latency modelled at 5 us.
Only an axis named ``pod`` (the cross-node axis) rides InfiniBand.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Mapping, Sequence

NVLINK_BW = 450e9       # bytes/s per GPU per direction (modelled)
IB_BW = 50e9            # bytes/s per GPU per direction (modelled)
NVLINK_ALPHA = 1e-6     # seconds per hop (modelled)
IB_ALPHA = 5e-6         # seconds per hop (modelled)


@dataclasses.dataclass(frozen=True)
class Link:
    """A class of links along one mesh axis."""

    bandwidth: float  # bytes/s, per direction
    alpha: float      # seconds per message
    wraparound: bool  # ring closes at link speed (bidir rings get 2x)
    duplex: bool = True


@dataclasses.dataclass(frozen=True)
class Topology:
    """Physical interpretation of a named mesh.

    ``axis_sizes`` maps mesh axis name -> number of ranks along it.
    ``axis_links`` maps axis name -> the Link class connecting neighbours
    along that axis.  Axes within a node ride NVLink; the ``pod`` axis
    (if present) rides InfiniBand.
    """

    axis_sizes: Mapping[str, int]
    axis_links: Mapping[str, Link]

    @property
    def num_devices(self) -> int:
        return math.prod(self.axis_sizes.values())

    def size(self, axes: str | Sequence[str]) -> int:
        if isinstance(axes, str):
            axes = (axes,)
        return math.prod(self.axis_sizes[a] for a in axes)

    def link(self, axis: str) -> Link:
        return self.axis_links[axis]

    def is_cross_pod(self, axis: str) -> bool:
        return axis == "pod"

    def with_axis_sizes(self, sizes: Mapping[str, int]) -> "Topology":
        """The same physical network with some axes resized.  Unknown
        axis names are rejected: a new axis would need a link model."""
        unknown = set(sizes) - set(self.axis_sizes)
        if unknown:
            raise KeyError(f"unknown axes {sorted(unknown)}; "
                           f"have {sorted(self.axis_sizes)}")
        merged = dict(self.axis_sizes)
        merged.update(sizes)
        return Topology(axis_sizes=merged, axis_links=dict(self.axis_links))

    def fingerprint(self) -> tuple:
        """Hashable identity of the modelled network: the protocol-plan
        cache key component — equal fingerprints must cost identically."""
        return tuple(sorted(
            (name, size, self.axis_links[name])
            for name, size in self.axis_sizes.items()))

    def describe(self) -> str:
        parts = []
        for name, n in self.axis_sizes.items():
            link = self.axis_links[name]
            kind = "IB" if self.is_cross_pod(name) else "NVLink"
            parts.append(
                f"{name}={n} [{kind} {link.bandwidth / 1e9:.1f} GB/s, "
                f"alpha={link.alpha * 1e6:.1f}us, "
                f"{'ring closes' if link.wraparound else 'line'}]"
            )
        return " x ".join(parts)


def nvlink_link() -> Link:
    return Link(bandwidth=NVLINK_BW, alpha=NVLINK_ALPHA, wraparound=True)


def ib_link() -> Link:
    return Link(bandwidth=IB_BW, alpha=IB_ALPHA, wraparound=False)


def topology_from_mesh_shape(
    axis_names: Sequence[str], axis_sizes: Sequence[int]
) -> Topology:
    """Build the link model for a mesh: an axis named ``pod`` is
    InfiniBand, every other axis NVLink."""
    sizes = dict(zip(axis_names, axis_sizes))
    links = {
        name: ib_link() if name == "pod" else nvlink_link()
        for name in axis_names
    }
    return Topology(axis_sizes=sizes, axis_links=links)


def topology_from_mesh(mesh) -> Topology:
    return topology_from_mesh_shape(tuple(mesh.axis_names),
                                    tuple(mesh.axis_sizes))
