"""MPI-protocol selection: alpha-beta cost model over the topology.

Paper §4: "we can design a transport protocol for *every* MPI function".
Here each collective function gets a menu of protocols; this module costs
each (protocol, message size, axis topology) combination analytically and
picks the winner.  The chosen protocol runs as an explicit chain of
point-to-point hops (``repro_torch.core.protocols``).  Counterpart of
``repro.core.costmodel``, unchanged but for this paragraph; the link
constants come from ``repro_torch.core.topology`` (an H100 model).

Costs follow the classic alpha-beta model (Thakur et al., Hockney):
    time = (#steps) * alpha + (bytes moved per device / link bw)
with per-axis alpha/bw read from the Topology ("MPI-network").
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Sequence, Tuple

from repro_torch.core.topology import Topology

# Protocol identifiers. Each maps to an implementation in repro.core.protocols.
XLA_DEFAULT = "xla_default"            # the "TCP/IP" generic path
RING = "ring"
BIDIR_RING = "bidir_ring"
RECURSIVE_DOUBLING = "recursive_doubling"
RECURSIVE_HALVING = "recursive_halving"  # Rabenseifner RS+AG
BRUCK = "bruck"
PAIRWISE = "pairwise"
BINOMIAL_TREE = "binomial_tree"
TWO_PHASE_2D = "two_phase_2d"
HIERARCHICAL = "hierarchical"          # cross-pod: intra-pod RS, inter-pod AR, intra-pod AG
PIPELINE = "pipeline"                  # p2p shift: one ppermute hop


def _axis(topo: Topology, axis: str) -> Tuple[int, float, float]:
    link = topo.link(axis)
    return topo.axis_sizes[axis], link.alpha, link.bandwidth


def _ring_factor(p: int) -> float:
    return (p - 1) / p


# ---------------------------------------------------------------------------
# All-reduce (n = message bytes per device)
# ---------------------------------------------------------------------------

def cost_allreduce_ring(n: float, topo: Topology, axis: str) -> float:
    p, a, bw = _axis(topo, axis)
    return 2 * (p - 1) * a + 2 * _ring_factor(p) * n / bw


def cost_allreduce_bidir_ring(n: float, topo: Topology, axis: str) -> float:
    # Both ring directions carry half the message each -> halve the beta term.
    p, a, bw = _axis(topo, axis)
    if not topo.link(axis).wraparound:
        return math.inf
    return 2 * (p - 1) * a + _ring_factor(p) * n / bw


def cost_allreduce_recursive_doubling(n: float, topo: Topology, axis: str) -> float:
    # log p exchanges of the FULL message: latency-optimal, bandwidth-poor.
    p, a, bw = _axis(topo, axis)
    if p & (p - 1):
        return math.inf
    steps = int(math.log2(p))
    return steps * a + steps * n / bw


def cost_allreduce_rabenseifner(n: float, topo: Topology, axis: str) -> float:
    # recursive-halving RS + recursive-doubling AG.
    p, a, bw = _axis(topo, axis)
    if p & (p - 1):
        return math.inf
    steps = int(math.log2(p))
    return 2 * steps * a + 2 * _ring_factor(p) * n / bw


def cost_allreduce_two_phase_2d(
    n: float, topo: Topology, axes: Sequence[str]
) -> float:
    # RS along axis0, AR along axis1 on the 1/p0 shard, AG along axis0.
    (ax0, ax1) = axes
    p0, a0, bw0 = _axis(topo, ax0)
    c_rs = (p0 - 1) * a0 + _ring_factor(p0) * n / bw0
    c_ar = cost_allreduce_bandwidth_optimal(n / p0, topo, ax1)
    c_ag = (p0 - 1) * a0 + _ring_factor(p0) * n / bw0
    return c_rs + c_ar + c_ag


def cost_allreduce_bandwidth_optimal(n: float, topo: Topology, axis: str) -> float:
    return min(
        cost_allreduce_ring(n, topo, axis),
        cost_allreduce_bidir_ring(n, topo, axis),
        cost_allreduce_rabenseifner(n, topo, axis),
    )


# ---------------------------------------------------------------------------
# Reduce-scatter / all-gather (n = FULL message bytes before scatter)
# ---------------------------------------------------------------------------

def cost_reduce_scatter_ring(n: float, topo: Topology, axis: str) -> float:
    p, a, bw = _axis(topo, axis)
    return (p - 1) * a + _ring_factor(p) * n / bw


def cost_reduce_scatter_halving(n: float, topo: Topology, axis: str) -> float:
    p, a, bw = _axis(topo, axis)
    if p & (p - 1):
        return math.inf
    return math.log2(p) * a + _ring_factor(p) * n / bw


def cost_allgather_ring(n: float, topo: Topology, axis: str) -> float:
    return cost_reduce_scatter_ring(n, topo, axis)


def cost_allgather_bruck(n: float, topo: Topology, axis: str) -> float:
    p, a, bw = _axis(topo, axis)
    if p & (p - 1):
        return math.inf
    steps = int(math.log2(p))
    # round k moves 2^k * (n/p) bytes -> total (p-1)/p * n, in log p steps.
    return steps * a + _ring_factor(p) * n / bw


# ---------------------------------------------------------------------------
# All-to-all (n = bytes each device holds, i.e. sends (p-1)/p of it)
# ---------------------------------------------------------------------------

def cost_alltoall_pairwise(n: float, topo: Topology, axis: str) -> float:
    p, a, bw = _axis(topo, axis)
    return (p - 1) * a + _ring_factor(p) * n / bw


def cost_alltoall_bruck(n: float, topo: Topology, axis: str) -> float:
    p, a, bw = _axis(topo, axis)
    if p & (p - 1):
        return math.inf
    steps = int(math.log2(p))
    return steps * a + (n / 2) * steps / bw


# ---------------------------------------------------------------------------
# Broadcast
# ---------------------------------------------------------------------------

def cost_broadcast_binomial(n: float, topo: Topology, axis: str) -> float:
    p, a, bw = _axis(topo, axis)
    steps = math.ceil(math.log2(p))
    return steps * (a + n / bw)


def cost_broadcast_scatter_allgather(n: float, topo: Topology, axis: str) -> float:
    # van de Geijn: binomial scatter (log p rounds) + ring all-gather.  The
    # schedule (protocols.tree.scatter_allgather_broadcast) needs pow2 p.
    p, a, bw = _axis(topo, axis)
    if p & (p - 1):
        return math.inf
    steps = math.ceil(math.log2(p))
    return (steps + p - 1) * a + 2 * _ring_factor(p) * n / bw


# ---------------------------------------------------------------------------
# Point-to-point (pipeline send/recv: one ppermute hop)
# ---------------------------------------------------------------------------

def cost_p2p_hop(n: float, topo: Topology, axis: str) -> float:
    _, a, bw = _axis(topo, axis)
    return a + n / bw


# ---------------------------------------------------------------------------
# Hierarchical (cross-pod) all-reduce
# ---------------------------------------------------------------------------

def cost_allreduce_hierarchical(
    n: float, topo: Topology, intra_axes: Sequence[str], pod_axis: str
) -> float:
    p_intra = topo.size(list(intra_axes))
    # Phase 1: intra-pod reduce-scatter (use the fastest intra protocol on
    # the concatenated axis -- approximate with ring on the first axis using
    # total intra size).
    ax0 = intra_axes[0]
    _, a, bw = _axis(topo, ax0)
    c1 = (p_intra - 1) * a + (p_intra - 1) / p_intra * n / bw
    # Phase 2: inter-pod all-reduce on the 1/p_intra shard over DCN.
    c2 = cost_allreduce_ring(n / p_intra, topo, pod_axis)
    # Phase 3: intra-pod all-gather.
    c3 = c1
    return c1 + c2 + c3


# ---------------------------------------------------------------------------
# Selection: "a protocol for every function" (paper §4)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ProtocolChoice:
    protocol: str
    est_seconds: float
    alternatives: Tuple[Tuple[str, float], ...]  # sorted (name, cost)


_MENU: Dict[str, Dict[str, Callable]] = {
    "all_reduce": {
        RING: cost_allreduce_ring,
        BIDIR_RING: cost_allreduce_bidir_ring,
        RECURSIVE_DOUBLING: cost_allreduce_recursive_doubling,
        RECURSIVE_HALVING: cost_allreduce_rabenseifner,
    },
    "reduce_scatter": {
        RING: cost_reduce_scatter_ring,
        RECURSIVE_HALVING: cost_reduce_scatter_halving,
    },
    "all_gather": {
        RING: cost_allgather_ring,
        BRUCK: cost_allgather_bruck,
    },
    "all_to_all": {
        PAIRWISE: cost_alltoall_pairwise,
        BRUCK: cost_alltoall_bruck,
    },
    "broadcast": {
        BINOMIAL_TREE: cost_broadcast_binomial,
        RING: cost_broadcast_scatter_allgather,
    },
    "permute": {
        PIPELINE: cost_p2p_hop,
    },
    "send_recv": {
        PIPELINE: cost_p2p_hop,
    },
}


def protocol_menu(collective: str) -> Dict[str, Callable]:
    return dict(_MENU.get(collective, {}))


def protocol_functions() -> Tuple[str, ...]:
    """Collectives with a protocol menu (the plannable function set)."""
    return tuple(_MENU)


def choose_protocol(
    collective: str,
    nbytes: float,
    topo: Topology,
    axis: str,
) -> ProtocolChoice:
    """Pick the analytically-cheapest protocol for one collective call site."""
    menu = _MENU.get(collective)
    if not menu:
        return ProtocolChoice(XLA_DEFAULT, math.inf, ())
    scored = sorted(
        ((name, fn(nbytes, topo, axis)) for name, fn in menu.items()),
        key=lambda kv: kv[1],
    )
    best, cost = scored[0]
    return ProtocolChoice(best, cost, tuple(scored))


def crossover_bytes(
    collective: str, topo: Topology, axis: str, lo: float = 1.0, hi: float = 1 << 34
) -> Dict[str, Tuple[float, float]]:
    """Map protocol -> (min_bytes, max_bytes) interval where it wins.

    Used by tests (the latency-optimal protocol must win small messages, the
    bandwidth-optimal one large messages) and by bench_protocols.
    """
    intervals: Dict[str, Tuple[float, float]] = {}
    n = lo
    while n <= hi:
        choice = choose_protocol(collective, n, topo, axis)
        a, b = intervals.get(choice.protocol, (n, n))
        intervals[choice.protocol] = (min(a, n), max(b, n))
        n *= 2
    return intervals
