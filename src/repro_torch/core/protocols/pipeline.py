"""Point-to-point schedules: pipeline-parallel send/recv (MPI_Send/Recv).

Counterpart of ``repro.core.protocols.pipeline``.  A GPipe-style
microbatch pipeline over an axis of thread ranks: the per-tick
stage-to-stage transfer is one ``ppermute`` hop, the p2p protocol of
the engine.  The reference's ``lax.scan`` over ticks is a Python loop.
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.core.protocols import common as c


def send_next(x: torch.Tensor, axis_name: str) -> torch.Tensor:
    """One pipeline hop: stage s -> stage s+1.  The wraparound edge (last
    -> first) is the reference's filler; stage 0 never reads it."""
    p = c.axis_size(axis_name)
    return c.ppermute(x, axis_name, c.complete_perm(
        [(j, j + 1) for j in range(p - 1)], p))


def send_prev(x: torch.Tensor, axis_name: str) -> torch.Tensor:
    p = c.axis_size(axis_name)
    return c.ppermute(x, axis_name, c.complete_perm(
        [(j + 1, j) for j in range(p - 1)], p))


def gpipe_forward(stage_fn: Callable[[torch.Tensor, torch.Tensor],
                                     torch.Tensor],
                  stage_params: torch.Tensor,
                  microbatches: torch.Tensor,
                  axis_name: str) -> torch.Tensor:
    """Run ``n_micro`` microbatches (meaningful on stage 0) through ``p``
    stages, one stage's params a rank.  Returns (n_micro, mb, ...) of
    final-stage outputs: meaningful on the last stage, zeros elsewhere.
    Bubble fraction (p-1)/(n_micro+p-1)."""
    p = c.axis_size(axis_name)
    stage = c.axis_index(axis_name)
    n_micro = microbatches.shape[0]
    out_buf = torch.zeros_like(microbatches)
    recv = torch.zeros_like(microbatches[0])
    for t in range(n_micro + p - 1):
        # stage 0 injects microbatch t (while t < n_micro); others
        # consume what they received
        x_in = (microbatches[min(max(t, 0), n_micro - 1)] if stage == 0
                else recv)
        y = stage_fn(stage_params, x_in)
        # the last stage stores its result once the pipe has filled
        if stage == p - 1 and t >= p - 1:
            out_buf[min(t - (p - 1), n_micro - 1)] = y
        recv = send_next(y, axis_name)
    return out_buf


def p2p_stage_counts(p: int):
    """(start, wait) split of a pipeline hop: one ``ppermute`` in start,
    nothing in wait; zero on a single-rank axis."""
    if p <= 1:
        return (0, 0)
    return (1, 0)
