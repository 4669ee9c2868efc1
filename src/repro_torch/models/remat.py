"""Rematerialization of a training block (the reference's
``jax.checkpoint`` around each scanned block).

``checkpointed(fn, *args, policy=)`` runs ``fn(*args)`` so that its
backward recomputes the block's activations instead of keeping them:

  nothing — ``jax.checkpoint_policies.nothing_saveable``: only the
            block's inputs are kept; the whole forward runs again in the
            backward.
  dots    — ``dots_with_no_batch_dims_saveable``: the outputs of the 2-D
            products are kept as well and everything else, batched
            products (``bmm``) included, is recomputed.  ``x @ W`` on a
            (B, S, D) input lowers to ``aten.mm`` (``addmm`` with a
            bias), the counterpart of a ``dot_general`` without batch
            dims; attention's and SSD's ``einsum`` lower to ``bmm``.

The recompute is the same op sequence on the same inputs, so on the CPU
the loss and every gradient are bit-equal to a run without remat.  Three
things this port must keep in mind where it checkpoints:

- On CUDA, autograd runs the backward's nodes on a worker thread of its
  own, one per device, so the recomputed forward runs there and not on
  the rank's thread: thread-local state that a forward reads (the
  substrate's ``_local.rank`` / ``.recorder``, the staged backward's
  tape) is another thread's there.  A checkpointed block must read none.
- A layer over a "model" axis issues collectives in its forward and cuts
  the residual for the staged backward (``parallel.sharding``): a
  recompute inside the backward would re-cut and wait for a peer from
  autograd's thread, the deadlock the staged backward exists to avoid.
  Such layers are never checkpointed (``transformer.apply_stage``).
- The recompute must give the forward's bits: a nondeterministic op in a
  checkpointed block (an atomic float ``index_add_`` with more than one
  nonzero addend a row, a top-k near tie fed other bits) would give the
  gradients of another forward.
"""

from __future__ import annotations

import functools
from typing import Callable

import torch
from torch.utils import checkpoint as _ckpt

POLICIES = ("nothing", "dots")

#: The ops whose outputs policy "dots" keeps: the 2-D products.
DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def dots_policy(ctx, op, *args, **kwargs) -> _ckpt.CheckpointPolicy:
    """Keep the outputs of the 2-D products, recompute everything else."""
    if op in DOTS:
        return _ckpt.CheckpointPolicy.MUST_SAVE
    return _ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def checkpointed(fn: Callable, *args, policy: str = "nothing", **kwargs):
    """``fn(*args, **kwargs)``, its activations recomputed in the
    backward under ``policy`` (one of ``POLICIES``).  The blocks draw no
    random numbers, so no RNG state is stashed for the recompute."""
    if policy == "nothing":
        kw = {}
    elif policy == "dots":
        kw = {"context_fn": functools.partial(
            _ckpt.create_selective_checkpoint_contexts, dots_policy)}
    else:
        raise ValueError(f"unknown remat_policy {policy!r}; known: "
                         f"{POLICIES}")
    return _ckpt.checkpoint(fn, *args, use_reentrant=False,
                            preserve_rng_state=False, **kw, **kwargs)


def active(enabled: bool, train: bool) -> bool:
    """Whether a block checkpoints: remat on, the training forward, and
    a graph being recorded (never a prefill or decode, which write their
    caches in place, nor a forward under ``no_grad``)."""
    return enabled and train and torch.is_grad_enabled()
