"""qwen3-moe-30b-a3b [moe] — 48L d2048 32H (GQA kv=4) 128 experts top-8
(expert ff 768) vocab151936 [hf:Qwen/Qwen3-30B-A3B].

Qwen3 specifics: explicit head_dim=128, per-head q/k RMS norm, no shared
expert, normalized top-k routing, untied head.
"""

import torch

from repro_torch.models.layers import AttentionCfg
from repro_torch.models.moe import MoECfg
from repro_torch.models.transformer import (LayerSpec, StageSpec,
                                            TransformerCfg)

ARCH_ID = "qwen3-moe-30b-a3b"
FAMILY = "moe"
SKIP_SHAPES = ("long_500k",)
USES_EMBEDS = False


def config(param_dtype=torch.bfloat16) -> TransformerCfg:
    d = 2_048
    return TransformerCfg(
        name=ARCH_ID, d_model=d, vocab_size=151_936,
        stages=(StageSpec((LayerSpec("attn", "moe"),), repeat=48),),
        attn=AttentionCfg(d_model=d, num_heads=32, num_kv_heads=4,
                          head_dim=128, qk_norm=True, rope_theta=1e6),
        moe=MoECfg(d_model=d, d_ff=768, num_experts=128, top_k=8,
                   norm_topk=True),
        param_dtype=param_dtype,
    )


def reduced(param_dtype=torch.float32) -> TransformerCfg:
    d = 64
    return TransformerCfg(
        name=ARCH_ID + "-reduced", d_model=d, vocab_size=256,
        stages=(StageSpec((LayerSpec("attn", "moe"),), repeat=2),),
        attn=AttentionCfg(d_model=d, num_heads=4, num_kv_heads=2,
                          head_dim=16, qk_norm=True, rope_theta=1e6),
        moe=MoECfg(d_model=d, d_ff=32, num_experts=8, top_k=2),
        param_dtype=param_dtype, block_k=16,
    )
