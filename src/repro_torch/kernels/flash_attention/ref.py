"""Plain PyTorch flash-attention forward: the kernel's reference.

Exact softmax attention in float32 on the model's ``(B, S, H, D)``
layout, GQA folded by head grouping (query head ``h`` reads KV head
``h // group``), causal mask by absolute position (query ``i`` sits at
``q_offset + i``).  A query row that sees no key gives 0 (the ``l == 0``
guard of the TPU kernel).  The CPU path of ``ops.attention`` and the
yardstick the CUDA kernel is held against on the card.
"""

from __future__ import annotations

import math

import torch


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, sm_scale: float | None = None,
              q_offset: int = 0) -> torch.Tensor:
    b, sq, h, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    group = h // hkv
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)
    qg = q.reshape(b, sq, hkv, group, d).float() * scale
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float())
    if causal:
        qpos = torch.arange(sq, device=q.device) + int(q_offset)
        kpos = torch.arange(skv, device=q.device)
        s = s.masked_fill(kpos[None, :] > qpos[:, None], -math.inf)
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    l = torch.where(l == 0.0, torch.ones_like(l), l)
    out = torch.einsum("bhgqk,bkhd->bhgqd", p, v.float()) / l
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, d).to(q.dtype)
