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
the loss and every gradient are bit-equal to a run without remat.

Two ways to checkpoint, for two kinds of layer:

- ``checkpointed``, over ``torch.utils.checkpoint``, for a layer without
  a "model" axis.  On CUDA, autograd runs the backward's nodes on a
  worker thread of its own, one per device, so the recomputed forward
  runs there and not on the rank's thread: a block checkpointed so must
  read no thread-local state (the substrate's ``_local.rank`` /
  ``.recorder``, the staged backward's tape).
- ``staged``, for a layer over "model" (``tp``), which issues
  collectives in its forward, reads its model coordinate and cuts the
  residual for the staged backward (``parallel.sharding``): a recompute
  on autograd's thread would re-cut and wait for a peer there, the
  deadlock the staged backward exists to avoid.  The block runs without
  a graph and is recorded on the tape as a segment
  (``sharding.StagedBackward.block``); when the staged backward reaches
  it, the rank's own thread reruns it under a tape of its own, so its
  collectives run again in the same order on every model rank, and runs
  that tape's backward.  Policy "dots" keeps the 2-D products' outputs
  there too: ``Dots`` records them in the forward and hands them back,
  in order, in the rerun.  Each model-axis all-reduce of a block's
  forward (its *g*s) so runs twice a step.

The recompute must give the forward's bits: a nondeterministic op in a
checkpointed block (an atomic float ``index_add_`` with more than one
nonzero addend a row, a top-k near tie fed other bits) would give the
gradients of another forward.  The staged rerun checks its outputs
against the forward's, bit for bit, and raises where they differ.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Callable, List, Optional, Tuple

import torch
from torch.utils import checkpoint as _ckpt
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.parallel import sharding as S

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
    _check(policy)
    kw = {} if policy == "nothing" else {"context_fn": functools.partial(
        _ckpt.create_selective_checkpoint_contexts, dots_policy)}
    return _ckpt.checkpoint(fn, *args, use_reentrant=False,
                            preserve_rng_state=False, **kw, **kwargs)


def _check(policy: str) -> None:
    if policy not in POLICIES:
        raise ValueError(f"unknown remat_policy {policy!r}; known: "
                         f"{POLICIES}")


class _Products(TorchDispatchMode):
    """Records the 2-D products' outputs (``saved is None``: into
    ``out``) or hands them back in order (from ``saved``)."""

    def __init__(self, out: List[Tuple], saved: Optional[List[Tuple]]):
        super().__init__()
        self.out, self.saved = out, saved

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func not in DOTS:
            return func(*args, **(kwargs or {}))
        shapes = tuple(tuple(a.shape) for a in args
                       if isinstance(a, torch.Tensor))
        if self.saved is None:
            y = func(*args, **(kwargs or {}))
            self.out.append((func, shapes, y))
            return y
        if not self.saved:
            raise RuntimeError("a checkpointed block's rerun makes more 2-D "
                               "products than its forward")
        want, want_shapes, y = self.saved.pop(0)
        if (want, want_shapes) != (func, shapes):
            raise RuntimeError(
                f"a checkpointed block's rerun makes {func} of {shapes} "
                f"where its forward made {want} of {want_shapes}")
        return y


class Dots:
    """Policy "dots" on the staged tape: the forward's 2-D products'
    outputs (``DOTS``), kept in order and handed back, one each, to the
    rerun's same products."""

    def __init__(self) -> None:
        self.saved: List[Tuple] = []

    @contextlib.contextmanager
    def recording(self):
        with _Products(self.saved, None):
            yield

    @contextlib.contextmanager
    def replaying(self):
        saved, self.saved = self.saved, []
        with _Products([], saved):
            yield
        if saved:
            raise RuntimeError("a checkpointed block's rerun makes fewer "
                               "2-D products than its forward")


def staged(fn: Callable, x: torch.Tensor, policy: str = "nothing"):
    """``fn(x) -> (y, auxes)`` for a block over "model", checkpointed on
    the staged backward's tape under ``policy`` (see the module doc):
    returns ``(y, auxes)``."""
    _check(policy)
    return S.checkpoint_block(fn, x, Dots() if policy == "dots" else None)


def active(enabled: bool, train: bool) -> bool:
    """Whether a block checkpoints: remat on, the training forward, and
    a graph being recorded (never a prefill or decode, which write their
    caches in place, nor a forward under ``no_grad``)."""
    return enabled and train and torch.is_grad_enabled()
