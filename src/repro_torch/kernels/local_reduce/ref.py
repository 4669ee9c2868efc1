"""Plain PyTorch version of the k-way chunk reduction.

The tests and the CPU path use it; ``chip_smoke.py`` holds the CUDA
kernel against it on the card.  The sum starts at zero and adds the k
inputs in order, in float32, then casts once: the order of the TPU
kernel ``repro.kernels.local_reduce.kernel.sum_chunks_3d`` and of the
CUDA kernel."""

from __future__ import annotations

from typing import Sequence

import torch


def sum_chunks(chunks: Sequence[torch.Tensor], dtype=None) -> torch.Tensor:
    """k same-shape tensors -> their sum accumulated in f32, in
    ``dtype`` (default: the inputs' dtype)."""
    dtype = dtype or chunks[0].dtype
    acc = torch.zeros(chunks[0].shape, dtype=torch.float32,
                      device=chunks[0].device)
    for x in chunks:
        acc = acc + x.float()
    return acc.to(dtype)
