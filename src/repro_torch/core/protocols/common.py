"""Shared helpers for protocol implementations.

Counterpart of ``repro.core.protocols.common``.  Every protocol runs
INSIDE a rank of ``substrate.run_spmd``; ``axis_name`` names an axis of
its mesh.  The schedules are built from ``ppermute``, the substrate's one
point-to-point primitive, so the pattern the cost model prices is the
pattern that runs.  A rank's index is a Python int, so rank-dependent
choices are plain branches.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.runtime import substrate


def axis_size(axis_name: str) -> int:
    return substrate.axis_size(axis_name)


def axis_index(axis_name: str) -> int:
    return substrate.axis_index(axis_name)


def rank() -> Optional[int]:
    """The caller's rank in its mesh, None outside one."""
    return substrate.current_rank()


def ppermute(x: torch.Tensor, axis_name: str, perm) -> torch.Tensor:
    """``lax.ppermute``: the received tensor is the caller's own copy."""
    return substrate.ppermute(x, axis_name, perm)


def fwd_perm(p: int, shift: int = 1):
    return [(j, (j + shift) % p) for j in range(p)]


def bwd_perm(p: int, shift: int = 1):
    return [(j, (j - shift) % p) for j in range(p)]


def xor_perm(p: int, k: int):
    return [(j, j ^ k) for j in range(p)]


def complete_perm(pairs, p: int):
    """Extend a partial (src, dst) permutation to a full one over p ranks
    (the reference's helper).  ``ppermute`` carries partial permutations
    (a rank nobody sends to receives zeros), so the port needs no filler
    edges; it keeps them where the reference has them, so every rank
    hands a tensor to the transport in every round, as the reference's
    byte accounting bills."""
    pairs = list(pairs)
    srcs = {s for s, _ in pairs}
    dsts = {d for _, d in pairs}
    free_src = [j for j in range(p) if j not in srcs]
    free_dst = [j for j in range(p) if j not in dsts]
    return pairs + list(zip(free_src, free_dst))


def pad_flat(x: torch.Tensor, multiple: int) -> Tuple[torch.Tensor, int]:
    """Flatten ``x`` and zero-pad to a multiple.  Returns (flat, size)."""
    flat = x.reshape(-1)
    n = flat.shape[0]
    rem = (-n) % multiple
    if rem:
        flat = torch.cat([flat, flat.new_zeros(rem)])
    return flat, n


def unpad(flat: torch.Tensor, n: int, shape) -> torch.Tensor:
    return flat[:n].reshape(shape)


def dyn_chunk(x2d: torch.Tensor, idx: int) -> torch.Tensor:
    """x2d: (p, c) -> row idx mod p (a view)."""
    return x2d[idx % x2d.shape[0]]


def dyn_put(x2d: torch.Tensor, row: torch.Tensor, idx: int) -> torch.Tensor:
    """Write row idx mod p IN PLACE (the reference returns an updated
    copy; every caller owns ``x2d``) and return ``x2d``."""
    x2d[idx % x2d.shape[0]] = row
    return x2d


def is_pow2(p: int) -> bool:
    return p > 0 and (p & (p - 1)) == 0
