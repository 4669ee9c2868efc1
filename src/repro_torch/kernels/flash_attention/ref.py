"""Plain PyTorch flash-attention forward: the kernel's reference.

Exact softmax attention in float32 on the model's ``(B, S, H, D)``
layout (values may have their own head dim ``Dv``, as MLA's do), GQA folded by head grouping (query head ``h`` reads KV head
``h // group``), causal mask by absolute position (query ``i`` sits at
``q_offset + i``).  A query row that sees no key gives 0 (the ``l == 0``
guard of the TPU kernel).  The CPU path of ``ops.attention`` and the
yardstick the CUDA kernels are held against on the card.

``attention_bf16_products`` is the tensor-core variant's arithmetic
written out in plain torch (bf16 operands, f32 accumulation, online
softmax over 64-key tiles, P rounded to bf16): the tests hold it to
``attention`` to show that the variant's rounding fits the tolerance the
kernel is held to.
"""

from __future__ import annotations

import math

import torch


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, sm_scale: float | None = None,
              q_offset: int = 0) -> torch.Tensor:
    b, sq, h, d = q.shape
    skv, hkv, dv = k.shape[1], k.shape[2], v.shape[-1]
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
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, dv).to(q.dtype)


def attention_bf16_products(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, *, causal: bool = True,
                            sm_scale: float | None = None,
                            q_offset: int = 0, block_k: int = 64,
                            key_split: int = 1) -> torch.Tensor:
    """What the tensor-core kernel computes, key tile by key tile: q, K
    and V rounded to bf16; scores as exact products summed in f32, scaled
    into the exp2 domain; an online softmax in f32; P rounded to bf16
    before P·V, summed in f32; O / l rounded once to q's dtype.  Keys
    past the last query's position never enter, not even as a masked
    product: the kernel's loads zero-fill them.

    ``key_split`` = n runs the online softmax as n consumers, consumer c
    taking tiles c, c + n, ..., and merges their (m, l, O) at the end,
    each weighed by exp2(m_c - max m) (0 for a consumer that saw no key):
    the kernel's schedule for short queries at D 64 (n = 3, its
    consumers)."""
    b, sq, h, d = q.shape
    skv, hkv, dv = k.shape[1], k.shape[2], v.shape[-1]
    group = h // hkv
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)
    c = torch.tensor(scale, dtype=torch.float32) * math.log2(math.e)
    bf = torch.bfloat16
    kv_end = min(skv, int(q_offset) + sq) if causal else skv
    qg = q.to(bf).float().reshape(b, sq, hkv, group, d)
    kb, vb = k[:, :kv_end].to(bf).float(), v[:, :kv_end].to(bf).float()
    qpos = torch.arange(sq, device=q.device) + int(q_offset)
    parts = []
    for first in range(key_split):
        m = torch.full((b, hkv, group, sq), -math.inf, device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros(b, hkv, group, sq, dv, device=q.device)
        for k0 in range(first * block_k, kv_end, key_split * block_k):
            s = torch.einsum("bqhgd,bkhd->bhgqk", qg, kb[:, k0:k0 + block_k])
            kpos = torch.arange(k0, k0 + s.shape[-1], device=q.device)
            if causal:
                s = s.masked_fill(kpos[None, :] > qpos[:, None], -math.inf)
            s = s * c
            m_new = torch.maximum(m, s.amax(dim=-1))
            mu = torch.where(m_new == -math.inf, torch.zeros_like(m_new),
                             m_new)
            alpha = torch.exp2(m - mu)
            p = torch.exp2(s - mu[..., None])
            l = l * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bhgqk,bkhd->bhgqd", p.to(bf).float(),
                vb[:, k0:k0 + block_k])
            m = m_new
        parts.append((m, l, acc))
    if key_split == 1:
        _, l, acc = parts[0]
    else:
        top = torch.stack([m for m, _, _ in parts]).amax(dim=0)
        l, acc = torch.zeros_like(parts[0][1]), torch.zeros_like(parts[0][2])
        for m, lp, accp in parts:
            w = torch.where(m == -math.inf, torch.zeros_like(m),
                            torch.exp2(m - top))
            l = l + lp * w
            acc = acc + accp * w[..., None]
    out = acc / torch.where(l == 0.0, torch.ones_like(l), l)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, dv).to(q.dtype)
