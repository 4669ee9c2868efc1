"""Plain PyTorch version of blockwise symmetric int8 quantization.

The tests and the CPU path use it; ``chip_smoke.py`` holds the CUDA
kernels against it on the card.  The arithmetic is that of
``repro.kernels.quantize`` as XLA compiles it (the reference's jitted
steps, and its Pallas kernels in interpret mode):

- the scale is ``amax`` times the f32-rounded reciprocal of 127: XLA
  rewrites a division by a constant into that product;
- the codes are a true division, rounded half to even, clamped to ±127;
- ``dequantize`` is the f32 product ``q·scale``;
- ``dequant_add`` is ``acc + q·scale`` rounded ONCE: XLA contracts the
  product and the sum into a fused multiply-add.  Eager PyTorch would
  round twice, so ``fma_f32`` computes the single rounding exactly.
"""

from __future__ import annotations

from typing import Tuple

import torch

QBLOCK = 256
INV127 = torch.tensor(1.0 / 127.0, dtype=torch.float32)
# Values a slice.  ``chip_smoke.py`` runs these plain versions on the
# card at the gradient sync's sizes (a whole training step of two
# replicas next to its kernel run); slices keep the f64 temporaries of
# ``dequant_add`` to a few hundred MB there.
SLICE = 1 << 24


def quantize(x: torch.Tensor, block: int = QBLOCK
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (n,) with n % block == 0 -> (q int8 (n,), scales f32
    (n/block,)).  Blocks are independent: SLICE values at a time."""
    xb = x.reshape(-1, block)
    q = torch.empty(xb.shape, dtype=torch.int8, device=x.device)
    scale = torch.empty(xb.shape[0], dtype=torch.float32, device=x.device)
    inv127 = INV127.to(x.device)
    rows = max(SLICE // block, 1)
    for lo in range(0, xb.shape[0], rows):
        sl = slice(lo, lo + rows)
        xs = xb[sl].float()
        amax = xs.abs().amax(dim=1, keepdim=True)
        s = torch.where(amax > 0, amax * inv127, torch.ones_like(amax))
        q[sl] = torch.clamp(torch.round(xs / s), -127, 127).to(torch.int8)
        scale[sl] = s[:, 0]
    return q.reshape(-1), scale


def dequantize(q: torch.Tensor, scale: torch.Tensor, block: int = QBLOCK,
               dtype=torch.float32) -> torch.Tensor:
    qb = q.reshape(-1, block).float()
    return (qb * scale[:, None]).to(dtype).reshape(-1)


def fma_f32(a: torch.Tensor, b: torch.Tensor,
            c: torch.Tensor) -> torch.Tensor:
    """``a*b + c`` for f32 operands, rounded once to f32 (what a fused
    multiply-add gives).  In f64 the product is exact; the sum is made
    round-to-odd from its exact error (TwoSum), and a round-to-odd value
    with 53 bits rounds to the 24 of f32 as the exact sum would."""
    p = a.double() * b.double()
    c = c.double()
    s = p + c
    bp = s - c
    err = (p - bp) + (c - (s - bp))
    even = (s.view(torch.int64) & 1) == 0
    nudge = (err != 0) & even & torch.isfinite(s)
    toward = torch.where(err > 0, torch.full_like(s, float("inf")),
                         torch.full_like(s, float("-inf")))
    return torch.where(nudge, torch.nextafter(s, toward), s).float()


def dequant_add(acc: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
                block: int = QBLOCK) -> torch.Tensor:
    """Fused receive-side op of the compressed ring: acc + q·scale,
    rounded once, in f32 and acc's shape.  SLICE values at a time, so
    its f64 temporaries stay small."""
    qb, ab = q.reshape(-1, block), acc.reshape(-1, block)
    sb = scale.reshape(-1, 1)
    out = torch.empty(ab.shape, dtype=torch.float32, device=acc.device)
    rows = max(SLICE // block, 1)
    for lo in range(0, qb.shape[0], rows):
        sl = slice(lo, lo + rows)
        out[sl] = fma_f32(qb[sl].float(), sb[sl].expand(-1, block), ab[sl])
    return out.reshape(acc.shape)
