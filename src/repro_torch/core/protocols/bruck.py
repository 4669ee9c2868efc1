"""All-to-all protocols: Bruck (latency-optimal) and pairwise exchange.

Counterpart of ``repro.core.protocols.bruck``, same hops.  All-to-all
is the dominant collective of expert-parallel MoE dispatch.  Both move
data only, so every order of hops gives the same bits.
"""

from __future__ import annotations

import torch

from repro_torch.core.protocols import common as c


def bruck_all_to_all(x: torch.Tensor, axis_name: str) -> torch.Tensor:
    """x: (p, ...) where block j is destined to rank j.  Returns (p, ...)
    where block j came from rank j.  ceil(log2 p) rounds, each moving the
    blocks whose position has the round's bit set."""
    p = x.shape[0]
    if p == 1:
        return x
    i = c.axis_index(axis_name)
    # local upward rotation: the block destined to d sits at (d - i) % p
    x = torch.roll(x, -i, dims=0)
    k = 1
    while k < p:
        idxs = torch.tensor([q for q in range(p) if q & k],
                            device=x.device)
        recv = c.ppermute(x[idxs], axis_name, c.fwd_perm(p, shift=k))
        x[idxs] = recv
        k *= 2
    # position q now holds the block from source (i - q) % p
    return torch.roll(torch.flip(x, dims=(0,)), i + 1, dims=0)


def pairwise_all_to_all(x: torch.Tensor, axis_name: str) -> torch.Tensor:
    """x: (p, ...) block j destined to rank j.  p-1 rounds; at round s,
    send block i+s to rank i+s and receive from rank i-s."""
    p = x.shape[0]
    if p == 1:
        return x
    i = c.axis_index(axis_name)
    out = torch.zeros_like(x)
    c.dyn_put(out, c.dyn_chunk(x, i), i)     # the own block stays
    for s in range(1, p):
        recv = c.ppermute(c.dyn_chunk(x, i + s), axis_name,
                          c.fwd_perm(p, shift=s))
        c.dyn_put(out, recv, i - s)
    return out


def bruck_stage_counts(p: int):
    """(start, wait) split of the Bruck exchange: all ceil(log2 p)
    rounds in start, nothing deferrable to wait."""
    if p <= 1:
        return (0, 0)
    return ((p - 1).bit_length(), 0)


def pairwise_stage_counts(p: int):
    """(start, wait) split of the pairwise exchange: p-1 rounds, all in
    start."""
    if p <= 1:
        return (0, 0)
    return (p - 1, 0)
