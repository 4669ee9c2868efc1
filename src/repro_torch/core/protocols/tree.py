"""Binomial-tree broadcast and reduce, and the van de Geijn broadcast.

Counterpart of ``repro.core.protocols.tree``, same hops and sums.
Broadcast is a cold function in training (weight init, config fan-out),
so the binomial tree optimises latency at ceil(log2 p) rounds; the
scatter-allgather broadcast is the bandwidth-optimal large-message
protocol.  Rank-dependent choices are plain branches (a rank's index is
a Python int); every round goes through ``ppermute`` with the
reference's filler edges (``complete_perm``).
"""

from __future__ import annotations

import torch

from repro_torch.core.protocols import common as c
from repro_torch.core.protocols import ring


def binomial_broadcast(x: torch.Tensor, axis_name: str, root: int = 0
                       ) -> torch.Tensor:
    """After the call every rank holds root's value.  Round k: effective
    ranks r < k send to r + k."""
    p = c.axis_size(axis_name)
    if p == 1:
        return x
    r = (c.axis_index(axis_name) - root) % p    # effective rank; root -> 0
    k = 1
    while k < p:
        perm = c.complete_perm(
            [((j + root) % p, (j + k + root) % p)
             for j in range(min(k, p - k))], p)
        recv = c.ppermute(x, axis_name, perm)
        if k <= r < 2 * k:
            x = recv
        k *= 2
    return x


def scatter_allgather_start(x2d: torch.Tensor, axis_name: str,
                            root: int = 0) -> torch.Tensor:
    """The van de Geijn broadcast's first stage: the binomial scatter of
    root's chunks (log2 p rounds, halving the payload each round).
    Returns this rank's chunk (effective rank r owns chunk r)."""
    p = x2d.shape[0]
    if not c.is_pow2(p):
        raise ValueError(f"scatter-allgather broadcast needs a "
                         f"power-of-two axis, got {p}")
    r = (c.axis_index(axis_name) - root) % p
    # at distance k, effective rank s (s % 2k == 0) holds chunks
    # [s, s+2k) and sends the upper half [s+k, s+2k) to rank s+k
    buf = x2d
    k = p // 2
    while k >= 1:
        perm = c.complete_perm(
            [((s + root) % p, (s + k + root) % p)
             for s in range(0, p, 2 * k)], p)
        sending = r % (2 * k) == 0
        start = r + k if sending else min(r, p - k)
        recv = c.ppermute(buf[start:start + k], axis_name, perm)
        if r % (2 * k) == k:
            at = min(r, p - k)
            buf = buf.clone()          # the sent view stays untouched
            buf[at:at + k] = recv
        k //= 2
    return c.dyn_chunk(buf, r)


def scatter_allgather_finish(chunk: torch.Tensor, axis_name: str,
                             root: int = 0) -> torch.Tensor:
    """The remaining stage: ring all-gather of the scattered chunks.  The
    gather keys rows by absolute rank; rank d holds chunk (d - root) % p,
    so a roll restores the chunk order."""
    gathered = ring.ring_all_gather_flat(chunk, axis_name)
    return torch.roll(gathered, -root, dims=0)


def scatter_allgather_broadcast(x2d: torch.Tensor, axis_name: str,
                                root: int = 0) -> torch.Tensor:
    """x2d: (p, chunk), root's rows are the payload.  Returns root's x2d
    on every rank.  Needs a power-of-two p (callers fall back to
    ``binomial_broadcast``); the blocking path is start then finish, as
    the engine's start/wait arms split it."""
    if x2d.shape[0] == 1:
        return x2d
    chunk = scatter_allgather_start(x2d, axis_name, root)
    return scatter_allgather_finish(chunk, axis_name, root)


def binomial_reduce_to_root(x: torch.Tensor, axis_name: str, root: int = 0
                            ) -> torch.Tensor:
    """Sum to root; other ranks end with partial sums (callers broadcast
    or discard).  The broadcast's rounds in reverse: leaves reduce
    first."""
    p = c.axis_size(axis_name)
    if p == 1:
        return x
    r = (c.axis_index(axis_name) - root) % p
    ks = []
    k = 1
    while k < p:
        ks.append(k)
        k *= 2
    for k in reversed(ks):
        perm = c.complete_perm(
            [((j + k + root) % p, (j + root) % p)
             for j in range(min(k, p - k))], p)
        recv = c.ppermute(x, axis_name, perm)
        if r < k:
            x = x + recv
    return x
