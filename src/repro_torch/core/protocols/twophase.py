"""Topology-composed protocols: 2D-torus two-phase and cross-pod
hierarchical all-reduce.

Counterpart of ``repro.core.protocols.twophase``, same hops and sums.
These exist *because* protocol and network are one entity (paper §4):
they read the mesh structure (two fast dimensions; a slow pod axis) and
schedule accordingly — a generic single-axis protocol cannot express
them.

Both schedules are stage-split for the engine's nonblocking start/wait
arms: ``*_start`` runs the first pipeline phase (the intra reduce-
scatter, whose output is the in-flight shard) and ``*_finish`` runs the
rest.  The blocking entry points compose the two stages, so the
overlapped and blocking paths are bit-identical by construction.  Every
ring combine goes through ``ring``'s ``sum_chunks`` op (the CUDA kernel
on the card); recursive doubling's adds are the reference's plain ``+``.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from repro_torch.core.protocols import common as c
from repro_torch.core.protocols import recursive, ring


def two_phase_start(x2d: torch.Tensor, axis0: str) -> torch.Tensor:
    """Phase 1 of the 2D two-phase all-reduce: RS along axis0.  Returns
    the in-flight 1/p0 shard."""
    return ring.bidir_ring_reduce_scatter_flat(x2d, axis0)


def two_phase_finish(shard: torch.Tensor, axis0: str, axis1: str,
                     p0: int, chunk: int) -> torch.Tensor:
    """Phases 2+3: AR(axis1) on the shard, then AG(axis0).  Returns flat
    (p0 * chunk,)."""
    p1 = c.axis_size(axis1)
    shard2d, n = c.pad_flat(shard, p1)
    reduced = ring.bidir_ring_all_reduce_flat(shard2d.reshape(p1, -1), axis1)
    shard = c.unpad(reduced.reshape(-1), n, shard.shape)
    gathered = ring.bidir_ring_all_gather_flat(shard, axis0)
    return gathered.reshape(p0 * chunk)


def two_phase_all_reduce_2d(x2d: torch.Tensor, axis0: str,
                            axis1: str) -> torch.Tensor:
    """All-reduce over axis0 x axis1 using both dimensions:
    RS(axis0) -> AR(axis1) on the 1/p0 shard -> AG(axis0).

    x2d: (p0, chunk) view of the payload.  Returns flat (p0 * chunk,)."""
    shard = two_phase_start(x2d, axis0)
    return two_phase_finish(shard, axis0, axis1, x2d.shape[0], x2d.shape[1])


def hierarchical_start(x: torch.Tensor, intra_axes: Sequence[str]
                       ) -> Tuple[torch.Tensor, List[Tuple[int, int]]]:
    """Phase 1 of the cross-pod all-reduce: reduce-scatter over each intra
    axis in turn.  Returns (in-flight flat shard, per-level (p, n) padding
    bookkeeping the finish phase unwinds)."""
    flat = x.reshape(-1)
    sizes: List[Tuple[int, int]] = []
    for ax in intra_axes:
        p = c.axis_size(ax)
        padded, n = c.pad_flat(flat, p)
        flat = ring.bidir_ring_reduce_scatter_flat(padded.reshape(p, -1), ax)
        flat = flat.reshape(-1)
        sizes.append((p, n))
    return flat, sizes


def hierarchical_finish(flat: torch.Tensor, sizes: Sequence[Tuple[int, int]],
                        intra_axes: Sequence[str], pod_axis: str, shape
                        ) -> torch.Tensor:
    """Phases 2+3: inter-pod AR of the shard (the slow axis moves
    p_intra-x fewer bytes), then intra-pod AG in reverse axis order."""
    p_pod = c.axis_size(pod_axis)
    if p_pod > 1:
        if c.is_pow2(p_pod):
            flat = recursive.recursive_doubling_all_reduce(flat, pod_axis)
        else:
            padded, n = c.pad_flat(flat, p_pod)
            flat = ring.ring_all_reduce_flat(
                padded.reshape(p_pod, -1), pod_axis).reshape(-1)[:n]
    for ax, (_, n) in zip(reversed(list(intra_axes)), reversed(list(sizes))):
        gathered = ring.bidir_ring_all_gather_flat(flat, ax)
        flat = gathered.reshape(-1)[:n]
    return flat.reshape(shape)


def hierarchical_all_reduce(x: torch.Tensor, intra_axes: Sequence[str],
                            pod_axis: str) -> torch.Tensor:
    """Cross-pod all-reduce: intra-pod RS, inter-pod AR of the 1/p_intra
    shard, intra-pod AG.

    x: any shape; returns the same shape, summed over intra_axes+pod_axis."""
    flat, sizes = hierarchical_start(x, intra_axes)
    return hierarchical_finish(flat, sizes, intra_axes, pod_axis, x.shape)
