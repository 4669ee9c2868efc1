"""The generic path: one unspecialised schedule per function (the
"TCP/IP stack" analogue).

Counterpart of ``repro.core.protocols.xla``.  The reference's
conventional baseline is one generic protocol for everything: in JAX,
``lax.psum`` / ``psum_scatter`` / ``all_gather`` / ``all_to_all`` /
``ppermute``, whose lowering XLA chooses without per-function
specialisation.  PyTorch has no compiler that inserts collectives, so
the port writes that generic path out once, over the same transport
(``ppermute``) and the same ring combine (``sum_chunks``) as the
composed protocols, with no choice made by size:

  all_reduce      — a plain ring reduce-scatter then ring all-gather
                    (stands in for ``lax.psum``): ``2 (p-1) n / p`` bytes
                    a rank, what the cost model bills ``XLA_DEFAULT``;
  reduce_scatter  — the ring reduce-scatter (``lax.psum_scatter``);
  all_gather      — the ring all-gather (``lax.all_gather``);
  all_to_all      — the direct pairwise exchange (``lax.all_to_all``);
  broadcast       — the reference's masked sum: an all-reduce of root's
                    value and zeros elsewhere;
  permute         — one ``ppermute`` (``lax.ppermute``).

The monolithic engine routes every call here; the composed engine uses
it where a specialised protocol cannot run (a dimension not divisible
by the axis).  Tiled semantics as in ``lax``: ``reduce_scatter`` and
``all_to_all`` need the split dimension divisible by the axis size.
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.core.protocols import bruck, ring
from repro_torch.core.protocols import common as c


def all_reduce(x: torch.Tensor, axis_name: str) -> torch.Tensor:
    p = c.axis_size(axis_name)
    if p == 1:
        return x
    flat, n = c.pad_flat(x, p)
    shard = ring.ring_reduce_scatter_flat(flat.reshape(p, -1), axis_name)
    return c.unpad(ring.ring_all_gather_flat(shard, axis_name).reshape(-1),
                   n, x.shape)


def _divisible(x: torch.Tensor, dim: int, p: int, what: str) -> None:
    if x.shape[dim] % p:
        raise ValueError(f"{what}: dimension {dim} of shape "
                         f"{tuple(x.shape)} does not split over {p} ranks")


def reduce_scatter(x: torch.Tensor, axis_name: str,
                   dim: int = 0) -> torch.Tensor:
    """Tiled: rank i gets block i (along ``dim``) of the sum."""
    p = c.axis_size(axis_name)
    if p == 1:
        return x
    _divisible(x, dim, p, "reduce_scatter")
    xm = torch.movedim(x, dim, 0)
    shard = ring.ring_reduce_scatter_flat(xm.reshape(p, -1), axis_name)
    out = shard.reshape((xm.shape[0] // p,) + tuple(xm.shape[1:]))
    return torch.movedim(out, 0, dim)


def all_gather(x: torch.Tensor, axis_name: str, dim: int = 0
               ) -> torch.Tensor:
    """Tiled: the ranks' ``x`` concatenated along ``dim`` in rank
    order."""
    p = c.axis_size(axis_name)
    if p == 1:
        return x
    xm = torch.movedim(x, dim, 0)
    buf = ring.ring_all_gather_flat(xm.reshape(-1), axis_name)
    out = buf.reshape((p * xm.shape[0],) + tuple(xm.shape[1:]))
    return torch.movedim(out, 0, dim)


def tiled_all_to_all(x: torch.Tensor, axis_name: str, split_dim: int,
                     concat_dim: int,
                     exchange: Callable[[torch.Tensor, str], torch.Tensor]
                     ) -> torch.Tensor:
    """``lax.all_to_all(tiled=True)`` around a block exchange: split
    ``split_dim`` into p blocks (block j goes to rank j), ``exchange``
    them ((p, ...) -> (p, ...), row j from rank j), and concatenate the
    received blocks in rank order along ``concat_dim``."""
    p = c.axis_size(axis_name)
    if p == 1:
        return x
    _divisible(x, split_dim, p, "all_to_all")
    xm = torch.movedim(x, split_dim, 0)
    blocks = xm.reshape((p, xm.shape[0] // p) + tuple(xm.shape[1:]))
    ob = exchange(blocks, axis_name)
    ob = torch.movedim(ob, 1, split_dim + 1)    # the split back in place
    ob = torch.movedim(ob, 0, concat_dim)       # p beside the concat dim
    shape = list(ob.shape)
    shape[concat_dim:concat_dim + 2] = [shape[concat_dim]
                                        * shape[concat_dim + 1]]
    return ob.reshape(shape)


def all_to_all(x: torch.Tensor, axis_name: str, split_dim: int = 0,
               concat_dim: int = 0) -> torch.Tensor:
    return tiled_all_to_all(x, axis_name, split_dim, concat_dim,
                            bruck.pairwise_all_to_all)


def broadcast(x: torch.Tensor, axis_name: str, root: int = 0
              ) -> torch.Tensor:
    """The reference's generic emulation: root's value selected by a
    masked sum."""
    mine = x if c.axis_index(axis_name) == root else torch.zeros_like(x)
    return all_reduce(mine, axis_name)


def permute(x: torch.Tensor, axis_name: str, shift: int = 1
            ) -> torch.Tensor:
    p = c.axis_size(axis_name)
    return c.ppermute(x, axis_name, c.fwd_perm(p, shift))
