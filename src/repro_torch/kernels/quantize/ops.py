"""Public blockwise int8 quantize / dequantize / dequant-add (flat API of
``repro.kernels.quantize.ops``).

Each op dispatches on the tensors' device: a CUDA tensor goes to the
hand-written kernel (``kernel``) or raises; a CPU tensor goes to the
plain version (``ref``); a ``meta`` tensor gets empty results of the
right shapes and dtypes, for the application scan
(``repro_torch.core.trace``), which runs the step without computing.
There is no fallback from one to another.

``counters`` holds one thread-safe launch count per kernel, added to
where the kernel launches and nowhere else; read them through
``repro_torch.kernels.counter.counts()``.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels.counter import LaunchCounter
from repro_torch.kernels.quantize import kernel, ref

QBLOCK = ref.QBLOCK

counters = {name: LaunchCounter(name)
            for name in ("quantize", "dequantize", "dequant_add")}



def _check(n: int, block: int) -> None:
    if block != QBLOCK:
        raise ValueError(f"block={block}: the kernels are built for "
                         f"{QBLOCK}")
    if n % block:
        raise ValueError(f"{n} values are not a multiple of block={block}")


def _no_path(dev):
    return ValueError(f"quantize ops have no path for device {dev}")


def quantize(x: torch.Tensor, block: int = QBLOCK
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flat x (n,), n % block == 0 -> (q int8 (n,), scales f32
    (n/block,)); x is quantized in f32 whatever its dtype."""
    _check(x.numel(), block)
    dev = x.device
    if dev.type == "cuda":
        out = kernel.quantize(x.reshape(-1).float())
        counters["quantize"].add()
        return out
    if dev.type == "cpu":
        return ref.quantize(x, block)
    if dev.type == "meta":
        n = x.numel()
        return (torch.empty(n, dtype=torch.int8, device=dev),
                torch.empty(n // block, dtype=torch.float32, device=dev))
    raise _no_path(dev)


def dequantize(q: torch.Tensor, scale: torch.Tensor, block: int = QBLOCK,
               dtype=torch.float32) -> torch.Tensor:
    """(q int8 (n,), scales (n/block,)) -> (n,) ``dtype`` (the kernel
    computes f32)."""
    _check(q.numel(), block)
    dev = q.device
    if dev.type == "cuda":
        if dtype != torch.float32:
            raise TypeError(f"dtype {dtype}: the kernel writes float32")
        out = kernel.dequantize(q, scale)
        counters["dequantize"].add()
        return out
    if dev.type == "cpu":
        return ref.dequantize(q, scale, block, dtype)
    if dev.type == "meta":
        return torch.empty(q.numel(), dtype=dtype, device=dev)
    raise _no_path(dev)


def dequant_add(acc: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
                block: int = QBLOCK) -> torch.Tensor:
    """f32 acc + q·scale rounded once (a fused multiply-add), of acc's
    shape."""
    _check(q.numel(), block)
    dev = acc.device
    if dev.type == "cuda":
        out = kernel.dequant_add(acc, q, scale)
        counters["dequant_add"].add()
        return out
    if dev.type == "cpu":
        return ref.dequant_add(acc, q, scale, block)
    if dev.type == "meta":
        return torch.empty_like(acc, dtype=torch.float32)
    raise _no_path(dev)
