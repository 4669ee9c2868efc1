"""Ring protocols: bandwidth-optimal RS / AG / AR along one axis.

Counterpart of ``repro.core.protocols.ring``, same hops and sums.  Uni-
and bidirectional variants.  The bidirectional ring splits the payload
in half and drives both ring directions at once, halving the beta term —
only valid when the axis's links close the ring (Topology.wraparound).

Every ring all-reduce is two pipeline stages — reduce-scatter then
all-gather — and the engine's start/wait arms split exactly at that
seam; the blocking ``*_all_reduce_flat`` entry points compose the two.

The RS combine step (summing the received partial into the local chunk)
is ``repro_torch.kernels.local_reduce.ops.sum_chunks``: the hand-written
CUDA kernel on the card, its plain version on the CPU.  It starts at
zero and adds the two chunks in f32, so for f32 it gives ``a + b`` bit
for bit, and for bf16 the f32 sum rounded once, which is what a bf16
``a + b`` computes.
"""

from __future__ import annotations

import torch

from repro_torch.core.protocols import common as c
from repro_torch.kernels.local_reduce import ops as lr_ops


def _combine(acc: torch.Tensor, contrib: torch.Tensor) -> torch.Tensor:
    """The RS combine step: acc + contrib through the k-way chunk
    reduction (f32 accumulation, cast back)."""
    return lr_ops.sum_chunks([acc, contrib], dtype=acc.dtype)


def ring_reduce_scatter_flat(x2d: torch.Tensor,
                             axis_name: str) -> torch.Tensor:
    """x2d: (p, chunk) per rank.  Returns this rank's fully-reduced chunk:
    rank i ends with sum_j x2d[rank j][i].  p-1 steps."""
    p = x2d.shape[0]
    if p == 1:
        return x2d[0]
    i = c.axis_index(axis_name)
    fwd = c.fwd_perm(p)
    acc = c.dyn_chunk(x2d, i - 1)
    for s in range(1, p):
        acc = c.ppermute(acc, axis_name, fwd)
        acc = _combine(acc, c.dyn_chunk(x2d, i - s - 1))
    return acc


class RingAllGatherRun:
    """Steppable ring all-gather: one ``step()`` is one ring hop.
    ``result()`` drains the remaining hops."""

    def __init__(self, shard: torch.Tensor, axis_name: str):
        p = c.axis_size(axis_name)
        self.axis_name = axis_name
        self.p = p
        self.done = 0
        self.total = max(0, p - 1)
        self.cur = shard
        if p == 1:
            self.buf = shard[None]
            return
        self.i = c.axis_index(axis_name)
        self.fwd = c.fwd_perm(p)
        self.buf = c.dyn_put(shard.new_zeros((p,) + tuple(shard.shape)),
                             shard, self.i)

    @property
    def remaining(self) -> int:
        return self.total - self.done

    def step(self, stages: int = 1) -> int:
        stages = min(int(stages), self.remaining)
        for _ in range(stages):
            self.done += 1
            # now holds the shard of (i - done)
            self.cur = c.ppermute(self.cur, self.axis_name, self.fwd)
            self.buf = c.dyn_put(self.buf, self.cur, self.i - self.done)
        return stages

    def result(self) -> torch.Tensor:
        self.step(self.remaining)
        return self.buf


def ring_all_gather_flat(shard: torch.Tensor,
                         axis_name: str) -> torch.Tensor:
    """shard: (chunk,) -> (p, chunk) with row j = rank j's shard."""
    return RingAllGatherRun(shard, axis_name).result()


def bidir_ring_reduce_scatter_flat(x2d: torch.Tensor,
                                   axis_name: str) -> torch.Tensor:
    """Split each chunk in half; the forward ring reduces the low halves,
    the backward ring the high halves.  An odd chunk takes the plain
    ring."""
    p = x2d.shape[0]
    if p == 1:
        return x2d[0]
    chunk = x2d.shape[1]
    if chunk % 2:
        return ring_reduce_scatter_flat(x2d, axis_name)
    i = c.axis_index(axis_name)
    half = chunk // 2
    lo, hi = x2d[:, :half], x2d[:, half:]
    fwd, bwd = c.fwd_perm(p), c.bwd_perm(p)
    acc_f = c.dyn_chunk(lo, i - 1)
    acc_b = c.dyn_chunk(hi, i + 1)
    for s in range(1, p):
        acc_f = c.ppermute(acc_f, axis_name, fwd)
        acc_b = c.ppermute(acc_b, axis_name, bwd)
        acc_f = _combine(acc_f, c.dyn_chunk(lo, i - s - 1))
        acc_b = _combine(acc_b, c.dyn_chunk(hi, i + s + 1))
    return torch.cat([acc_f, acc_b])


class BidirRingAllGatherRun:
    """Steppable bidirectional ring all-gather: one ``step()`` is one
    double-hop, so the stage count is ``ceil((p-1)/2)``."""

    def __init__(self, shard: torch.Tensor, axis_name: str):
        p = c.axis_size(axis_name)
        self.axis_name = axis_name
        self.p = p
        self.done = 0
        self.n_f = p // 2
        self.n_b = (p - 1) // 2
        self.total = max(self.n_f, self.n_b)
        if p == 1:
            self.buf = shard[None]
            return
        self.i = c.axis_index(axis_name)
        self.fwd, self.bwd = c.fwd_perm(p), c.bwd_perm(p)
        self.buf = c.dyn_put(shard.new_zeros((p,) + tuple(shard.shape)),
                             shard, self.i)
        self.cur_f = shard  # fwd: after s hops holds shard of (i - s)
        self.cur_b = shard  # bwd: after s hops holds shard of (i + s)

    @property
    def remaining(self) -> int:
        return self.total - self.done

    def step(self, stages: int = 1) -> int:
        stages = min(int(stages), self.remaining)
        for _ in range(stages):
            self.done += 1
            s = self.done
            if s <= self.n_f:
                self.cur_f = c.ppermute(self.cur_f, self.axis_name, self.fwd)
                self.buf = c.dyn_put(self.buf, self.cur_f, self.i - s)
            if s <= self.n_b:
                self.cur_b = c.ppermute(self.cur_b, self.axis_name, self.bwd)
                self.buf = c.dyn_put(self.buf, self.cur_b, self.i + s)
        return stages

    def result(self) -> torch.Tensor:
        self.step(self.remaining)
        return self.buf


def bidir_ring_all_gather_flat(shard: torch.Tensor,
                               axis_name: str) -> torch.Tensor:
    return BidirRingAllGatherRun(shard, axis_name).result()


# ---------------------------------------------------------------------------
# Stage-split all-reduce: start = RS stage, finish = AG stage.
# ---------------------------------------------------------------------------

def ring_all_reduce_start(x2d: torch.Tensor, axis_name: str) -> torch.Tensor:
    return ring_reduce_scatter_flat(x2d, axis_name)


def ring_all_reduce_finish(shard: torch.Tensor,
                           axis_name: str) -> torch.Tensor:
    return ring_all_gather_flat(shard, axis_name)


def bidir_ring_all_reduce_start(x2d: torch.Tensor,
                                axis_name: str) -> torch.Tensor:
    return bidir_ring_reduce_scatter_flat(x2d, axis_name)


def bidir_ring_all_reduce_finish(shard: torch.Tensor,
                                 axis_name: str) -> torch.Tensor:
    return bidir_ring_all_gather_flat(shard, axis_name)


def ring_all_reduce_flat(x2d: torch.Tensor, axis_name: str) -> torch.Tensor:
    """RS + AG: the classic bandwidth-optimal all-reduce."""
    shard = ring_all_reduce_start(x2d, axis_name)
    return ring_all_reduce_finish(shard, axis_name)


def bidir_ring_all_reduce_flat(x2d: torch.Tensor,
                               axis_name: str) -> torch.Tensor:
    shard = bidir_ring_all_reduce_start(x2d, axis_name)
    return bidir_ring_all_reduce_finish(shard, axis_name)
