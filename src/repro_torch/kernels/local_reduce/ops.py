"""Public k-way chunk reduction (the ring reduce-scatter combine).

``sum_chunks`` dispatches on the tensors' device: a CUDA tensor goes to
the hand-written kernel (``kernel.sum_chunks``) or raises; a CPU tensor
goes to the plain version (``ref.sum_chunks``); a ``meta`` tensor gets an
empty result of the right shape and dtype, for the application scan
(``repro_torch.core.trace``), which runs the step without computing.
There is no fallback from one to another.

``counter`` counts kernel launches made through this op and nothing
else; it is thread-safe, since ranks launch from threads.  Read it as
``counter.value`` or through ``repro_torch.kernels.counter.counts()``.
"""

from __future__ import annotations

from typing import Sequence, Union

import torch

from repro_torch.kernels.counter import LaunchCounter
from repro_torch.kernels.local_reduce import kernel, ref

counter = LaunchCounter("sum_chunks")



def sum_chunks(chunks: Union[torch.Tensor, Sequence[torch.Tensor]],
               dtype=None) -> torch.Tensor:
    """``chunks``: a (k, ...) tensor or k same-shape tensors -> their sum
    accumulated in f32 in order j = 0..k-1, cast to ``dtype`` (default:
    the inputs' dtype)."""
    if isinstance(chunks, torch.Tensor):
        chunks = list(chunks.unbind(0))
    chunks = list(chunks)
    dev = chunks[0].device
    if dev.type == "cuda":
        out = kernel.sum_chunks(chunks, dtype)
        counter.add()
        return out
    if dev.type == "cpu":
        return ref.sum_chunks(chunks, dtype)
    if dev.type == "meta":
        return torch.empty(chunks[0].shape, dtype=dtype or chunks[0].dtype,
                           device=dev)
    raise ValueError(f"sum_chunks has no path for device {dev}")
