"""Protocol-injected features (paper §4): compressed gradient all-reduce.

Counterpart of ``repro.core.compression``.  ``compressed_all_reduce`` is
an int8-on-the-wire ring all-reduce with error feedback.  Its hot loop
(quantize, dequantize, and the fused receive step dequant-add) goes
through ``repro_torch.kernels.quantize.ops``: the hand-written CUDA
kernels on the card, their plain versions on the CPU.  This module holds
the protocol schedule.

The receive step of the reduce-scatter is ``dequant_add(chunk, q,
scale)`` = chunk + q·scale rounded once, and the error-feedback residual
is ``dequant_add(xf, q, -scale)`` = xf - q·scale rounded once.  The
reference writes both as a dequantize followed by an add or subtract,
and XLA contracts each pair into one fused multiply-add wherever the
reference is compiled; these are its bits.  On the card each is one
launch of the CUDA ``dequant_add``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch

from repro_torch.core.protocols import common as c
from repro_torch.kernels.quantize import ops as qops

QBLOCK = 256  # quantization block: one scale per QBLOCK values


# ---------------------------------------------------------------------------
# Error feedback
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class EFState:
    """Error-feedback residual carried across steps (one per gradient
    leaf, f32, the leaf's shape)."""

    residual: torch.Tensor

    @staticmethod
    def zeros_like(x: torch.Tensor) -> "EFState":
        return EFState(residual=torch.zeros(x.shape, dtype=torch.float32,
                                            device=x.device))


def bucket_ef_zeros(buckets, device=None) -> tuple:
    """Error-feedback residual layout for dtype-grouped gradient buckets
    (``plan.plan_buckets``): one flat f32 residual per bucket, whatever
    the bucket's wire dtype (as the reference lays it out)."""
    return tuple(torch.zeros((b.size,), dtype=torch.float32, device=device)
                 for b in buckets)


# ---------------------------------------------------------------------------
# The protocol: int8-on-the-wire ring all-reduce
# ---------------------------------------------------------------------------

def compressed_ring_reduce_scatter_flat(x2d: torch.Tensor, axis_name: str,
                                        block: int = QBLOCK) -> torch.Tensor:
    """The int8 ring's first pipeline stage: pass quantized partial sums
    around the ring.  x2d: (p, chunk) float with chunk % block == 0.
    Returns this rank's in-flight f32 reduced chunk."""
    p = x2d.shape[0]
    chunk = x2d.shape[1]
    if chunk % block:
        raise ValueError(f"chunk {chunk} is not a multiple of {block}")
    i = c.axis_index(axis_name)
    fwd = c.fwd_perm(p)
    acc = c.dyn_chunk(x2d, i - 1).float()
    for s in range(1, p):
        q, scale = qops.quantize(acc, block)
        q = c.ppermute(q, axis_name, fwd)
        scale = c.ppermute(scale, axis_name, fwd)
        acc = qops.dequant_add(c.dyn_chunk(x2d, i - s - 1).float(), q,
                               scale, block)
    return acc


class CompressedAllGatherRun:
    """Steppable int8 ring all-gather: one ``step()`` circulates the
    quantized payload one ring hop (q + block scales on the wire).
    ``result()`` drains the remaining hops."""

    def __init__(self, acc: torch.Tensor, axis_name: str, p: int,
                 block: int = QBLOCK, out_dtype=torch.float32):
        chunk = acc.shape[0]
        self.axis_name = axis_name
        self.p = p
        self.block = block
        self.out_dtype = out_dtype
        self.done = 0
        self.total = max(0, p - 1)
        self.i = c.axis_index(axis_name)
        self.fwd = c.fwd_perm(p)
        self.q, self.scale = qops.quantize(acc, block)
        buf = acc.new_zeros((p, chunk), dtype=torch.float32)
        self.buf = c.dyn_put(
            buf, qops.dequantize(self.q, self.scale, block), self.i)

    @property
    def remaining(self) -> int:
        return self.total - self.done

    def step(self, stages: int = 1) -> int:
        stages = min(int(stages), self.remaining)
        for _ in range(stages):
            self.done += 1
            self.q = c.ppermute(self.q, self.axis_name, self.fwd)
            self.scale = c.ppermute(self.scale, self.axis_name, self.fwd)
            self.buf = c.dyn_put(
                self.buf, qops.dequantize(self.q, self.scale, self.block),
                self.i - self.done)
        return stages

    def result(self) -> torch.Tensor:
        self.step(self.remaining)
        return self.buf.to(self.out_dtype)


def compressed_ring_all_gather_flat(acc: torch.Tensor, axis_name: str,
                                    p: int, block: int = QBLOCK,
                                    out_dtype=torch.float32) -> torch.Tensor:
    """The int8 ring's remaining stage.  acc: (chunk,) f32 -> (p, chunk)
    out_dtype."""
    return CompressedAllGatherRun(acc, axis_name, p, block,
                                  out_dtype=out_dtype).result()


def compressed_ring_all_reduce_flat(x2d: torch.Tensor, axis_name: str,
                                    block: int = QBLOCK) -> torch.Tensor:
    """Ring RS+AG where every hop carries int8 payload + f32 block
    scales.  x2d: (p, chunk) float; chunk % block == 0."""
    p = x2d.shape[0]
    if p == 1:
        return x2d[0]
    acc = compressed_ring_reduce_scatter_flat(x2d, axis_name, block)
    return compressed_ring_all_gather_flat(acc, axis_name, p, block,
                                           out_dtype=x2d.dtype)


@dataclasses.dataclass
class CompressedInFlight:
    """A started-but-unfinished compressed all-reduce: the in-flight
    reduced chunk plus everything the finalization stage needs.  Created
    by ``compressed_all_reduce_start``, consumed exactly once by
    ``compressed_all_reduce_wait``."""

    acc: torch.Tensor         # in-flight reduced chunk (f32)
    xf: torch.Tensor          # local f32 contribution (EF residual source)
    p: int
    n: int                    # unpadded element count
    orig_shape: Tuple[int, ...]
    orig_dtype: Any
    axis_name: str
    block: int
    has_state: bool
    waited: bool = False
    ag_run: Any = None
    wait_bytes_left: Optional[int] = None


def compressed_all_reduce_start(x: torch.Tensor, axis_name: str,
                                state: Optional[EFState] = None,
                                block: int = QBLOCK) -> CompressedInFlight:
    """Launch the int8 ring reduce-scatter and return the in-flight
    token.  No EF state is touched here."""
    p = c.axis_size(axis_name)
    xf = x.float().reshape(-1)
    if state is not None:
        xf = xf + state.residual.reshape(-1)
    flat, _ = c.pad_flat(xf, p * block)
    x2d = flat.reshape(p, -1)
    if p == 1:
        acc = x2d[0]   # nothing on the wire; no (lossy) quantize round-trip
    else:
        acc = compressed_ring_reduce_scatter_flat(x2d, axis_name, block)
    return CompressedInFlight(
        acc=acc, xf=xf, p=p, n=xf.shape[0], orig_shape=tuple(x.shape),
        orig_dtype=x.dtype, axis_name=axis_name, block=block,
        has_state=state is not None)


def compressed_all_reduce_progress(tok: CompressedInFlight,
                                   stages: int = 1) -> int:
    """Advance the in-flight compressed all-reduce by up to ``stages``
    int8 ring hops without completing it."""
    if tok.waited:
        raise RuntimeError(
            "cannot progress an already-waited compressed_all_reduce token")
    if tok.p == 1:
        return 0
    if tok.ag_run is None:
        tok.ag_run = CompressedAllGatherRun(
            tok.acc, tok.axis_name, tok.p, tok.block)
    return tok.ag_run.step(stages)


def compressed_all_reduce_wait(tok: CompressedInFlight
                               ) -> Tuple[torch.Tensor, Optional[EFState]]:
    """Run the int8 ring all-gather, unpad, and update the error-feedback
    residual — the residual changes here and ONLY here."""
    if tok.waited:
        raise RuntimeError(
            "in-flight compressed_all_reduce token was already waited — "
            "each start() produces exactly one wait()able reduction")
    tok.waited = True
    if tok.p == 1:
        reduced = tok.acc
    elif tok.ag_run is not None:
        reduced = tok.ag_run.result()
    else:
        reduced = compressed_ring_all_gather_flat(
            tok.acc, tok.axis_name, tok.p, tok.block)
    y = c.unpad(reduced.reshape(-1), tok.n, tok.xf.shape)

    new_state = None
    if tok.has_state:
        # Residual: what quantization dropped from OUR contribution.
        padded = c.pad_flat(tok.xf, tok.block)[0]
        q, scale = qops.quantize(padded, tok.block)
        res = qops.dequant_add(padded, q, -scale,
                               tok.block)[: tok.xf.shape[0]]
        new_state = EFState(residual=res.reshape(tok.orig_shape))
    return y.reshape(tok.orig_shape).to(tok.orig_dtype), new_state


def compressed_all_reduce(x: torch.Tensor, axis_name: str,
                          state: Optional[EFState] = None,
                          block: int = QBLOCK
                          ) -> Tuple[torch.Tensor, Optional[EFState]]:
    """Error-feedback compressed all-reduce over one mesh axis.  Returns
    (summed x, updated EF state); ``state=None`` runs without error
    feedback.  The blocking path is literally start + wait."""
    return compressed_all_reduce_wait(
        compressed_all_reduce_start(x, axis_name, state, block))
