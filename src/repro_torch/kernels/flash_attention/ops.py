"""Public attention op: ``(B, S, H, D)`` layout, GQA-aware.

``attention`` is what the model layers call.  It dispatches on the
tensors' device: a CUDA tensor goes to the hand-written kernel
(``kernel.flash_attention``) or raises; a CPU tensor goes to the plain
version (``ref.attention``); a ``meta`` one (the dry-run's) gets its
output's shape and counts the products' flops.  There is no fallback
from one to the other.

``counter`` counts kernel launches made through this op (and nothing
else), so a run can show its prefill went through the kernel;
``tc_counter`` counts those of them that ran the tensor-core variant, as
the C entry reports it (``kernel.VARIANTS``).  Both are thread-safe,
since ranks launch from threads.  Read them as ``.value`` or through
``repro_torch.kernels.counter.counts()`` ("flash_attention",
"flash_attention_tc").
"""

from __future__ import annotations

import torch

from repro_torch.core import trace
from repro_torch.kernels.counter import LaunchCounter
from repro_torch.kernels.flash_attention import kernel, ref

counter = LaunchCounter("flash_attention")
tc_counter = LaunchCounter("flash_attention_tc")


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, sm_scale: float | None = None,
              q_offset: int = 0) -> torch.Tensor:
    """q: (B, Sq, H, D); k: (B, Skv, Hkv, D); v: (B, Skv, Hkv, Dv) ->
    (B, Sq, H, Dv) in q's dtype; ``q_offset`` is the absolute position of
    query 0.  The softmax runs in float32; on the card a bf16 query with
    head dims in ``kernel.WGMMA_HEAD_DIMS`` ((64, 64), (128, 128), (192,
    192) or MLA's (192, 128)) takes bf16 products (K, V and P rounded to
    bf16, as the reference's kernel does for a bf16 cache), every other
    query f32 ones."""
    if q.device.type == "cuda":
        out, variant = kernel.launch(q, k, v, causal=causal,
                                     sm_scale=sm_scale, q_offset=q_offset)
        counter.add()
        if variant == "wgmma":
            tc_counter.add()
        return out
    if q.device.type == "cpu":
        return ref.attention(q, k, v, causal=causal, sm_scale=sm_scale,
                             q_offset=q_offset)
    if q.device.type == "meta":
        # the dry-run's step: the kernel's output and the flops of its
        # two products over every (query, key) pair, as the plain
        # version counts them, without its score tiles
        b, sq, h, d = q.shape
        trace.add_flops(2 * b * h * sq * k.shape[1] * (d + v.shape[-1]))
        return q.new_empty((b, sq, h, v.shape[-1]))
    raise ValueError(f"flash attention has no path for device {q.device}")
