"""mistral-large-123b [dense] — 88L d12288 96H (GQA kv=8) ff28672 vocab32768.

[hf:mistralai/Mistral-Large-Instruct-2407].  Llama-style blocks: GQA,
SwiGLU, RMSNorm.
"""

import torch

from repro_torch.models.layers import AttentionCfg, MLPCfg
from repro_torch.models.transformer import (LayerSpec, StageSpec,
                                            TransformerCfg)

ARCH_ID = "mistral-large-123b"
FAMILY = "dense"
SKIP_SHAPES = ("long_500k",)
USES_EMBEDS = False


def config(param_dtype=torch.bfloat16) -> TransformerCfg:
    d = 12_288
    return TransformerCfg(
        name=ARCH_ID, d_model=d, vocab_size=32_768,
        stages=(StageSpec((LayerSpec("attn", "dense"),), repeat=88),),
        attn=AttentionCfg(d_model=d, num_heads=96, num_kv_heads=8,
                          head_dim=128, rope_theta=1e6),
        mlp=MLPCfg(d, 28_672, "swiglu"),
        param_dtype=param_dtype,
    )


def reduced(param_dtype=torch.float32) -> TransformerCfg:
    d = 64
    return TransformerCfg(
        name=ARCH_ID + "-reduced", d_model=d, vocab_size=256,
        stages=(StageSpec((LayerSpec("attn", "dense"),), repeat=2),),
        attn=AttentionCfg(d_model=d, num_heads=4, num_kv_heads=2,
                          head_dim=16, rope_theta=1e6),
        mlp=MLPCfg(d, 128, "swiglu"),
        param_dtype=param_dtype, block_k=16,
    )
