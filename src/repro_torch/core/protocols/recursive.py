"""Recursive doubling / halving protocols (power-of-two axes).

Counterpart of ``repro.core.protocols.recursive``, same hops and sums.

- recursive_doubling_all_reduce: log p rounds of full-message XOR
  exchange — latency-optimal, for small messages.
- recursive halving reduce-scatter + recursive doubling all-gather
  (Rabenseifner): log p latency with ring-class bandwidth, for mid sizes.
"""

from __future__ import annotations

import torch

from repro_torch.core.protocols import common as c


def recursive_doubling_all_reduce(x: torch.Tensor,
                                  axis_name: str) -> torch.Tensor:
    """Full-message exchange with partner i^k for k = 1,2,4,...  Requires
    a power-of-two axis size.  Any shape (no chunking)."""
    p = c.axis_size(axis_name)
    if p == 1:
        return x
    if not c.is_pow2(p):
        raise ValueError(f"recursive doubling needs a power-of-two axis, "
                         f"got {p}")
    k = 1
    while k < p:
        other = c.ppermute(x, axis_name, c.xor_perm(p, k))
        x = x + other
        k *= 2
    return x


def halving_reduce_scatter_flat(x2d: torch.Tensor,
                                axis_name: str) -> torch.Tensor:
    """Recursive-halving reduce-scatter.  x2d: (p, chunk).  Rank i ends
    with reduced chunk i.  log p steps, (p-1)/p * n bytes."""
    p = x2d.shape[0]
    if p == 1:
        return x2d[0]
    if not c.is_pow2(p):
        raise ValueError(f"recursive halving needs a power-of-two axis, "
                         f"got {p}")
    i = c.axis_index(axis_name)
    cur = x2d.reshape(-1)
    k = p // 2
    while k >= 1:
        half = cur.shape[0] // 2
        lower, upper = cur[:half], cur[half:]
        bit = (i & k) != 0  # set: we own the upper half, send the lower
        send = lower if bit else upper
        recv = c.ppermute(send, axis_name, c.xor_perm(p, k))
        keep = upper if bit else lower
        cur = keep + recv
        k //= 2
    return cur


class DoublingAllGatherRun:
    """Steppable recursive-doubling all-gather: one ``step()`` is one
    doubling round, so the stage count is ``log2 p``."""

    def __init__(self, shard: torch.Tensor, axis_name: str):
        p = c.axis_size(axis_name)
        self.axis_name = axis_name
        self.p = p
        self.cur = shard
        self.done = 0
        if p == 1:
            self.total = 0
            return
        if not c.is_pow2(p):
            raise ValueError(f"recursive doubling needs a power-of-two "
                             f"axis, got {p}")
        self.i = c.axis_index(axis_name)
        self.k = 1
        self.total = (p - 1).bit_length()

    @property
    def remaining(self) -> int:
        return self.total - self.done

    def step(self, stages: int = 1) -> int:
        stages = min(int(stages), self.remaining)
        for _ in range(stages):
            recv = c.ppermute(self.cur, self.axis_name,
                              c.xor_perm(self.p, self.k))
            bit = (self.i & self.k) != 0  # set: our block is the upper half
            self.cur = (torch.cat([recv, self.cur]) if bit
                        else torch.cat([self.cur, recv]))
            self.k *= 2
            self.done += 1
        return stages

    def result(self) -> torch.Tensor:
        self.step(self.remaining)
        return self.cur


def doubling_all_gather_flat(shard: torch.Tensor,
                             axis_name: str) -> torch.Tensor:
    """shard: (chunk,) -> flat (p*chunk,) in rank order."""
    return DoublingAllGatherRun(shard, axis_name).result()


def rabenseifner_all_reduce_flat(x2d: torch.Tensor,
                                 axis_name: str) -> torch.Tensor:
    shard = halving_reduce_scatter_flat(x2d, axis_name)
    return doubling_all_gather_flat(shard, axis_name)
