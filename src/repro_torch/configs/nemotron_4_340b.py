"""nemotron-4-340b [dense] — 96L d18432 96H (GQA kv=8) ff73728 vocab256000.

Squared-ReLU MLP (two matrices), LayerNorm, GQA with head_dim 192
[arXiv:2402.16819].
"""

import torch

from repro_torch.models.layers import AttentionCfg, MLPCfg
from repro_torch.models.transformer import (LayerSpec, StageSpec,
                                            TransformerCfg)

ARCH_ID = "nemotron-4-340b"
FAMILY = "dense"
SKIP_SHAPES = ("long_500k",)
USES_EMBEDS = False


def config(param_dtype=torch.bfloat16) -> TransformerCfg:
    d = 18_432
    return TransformerCfg(
        name=ARCH_ID, d_model=d, vocab_size=256_000,
        stages=(StageSpec((LayerSpec("attn", "dense"),), repeat=96),),
        attn=AttentionCfg(d_model=d, num_heads=96, num_kv_heads=8,
                          head_dim=192, rope_theta=1e4),
        mlp=MLPCfg(d, 73_728, "squared_relu"),
        norm="layernorm",
        param_dtype=param_dtype,
    )


def reduced(param_dtype=torch.float32) -> TransformerCfg:
    d = 64
    return TransformerCfg(
        name=ARCH_ID + "-reduced", d_model=d, vocab_size=256,
        stages=(StageSpec((LayerSpec("attn", "dense"),), repeat=2),),
        attn=AttentionCfg(d_model=d, num_heads=4, num_kv_heads=2,
                          head_dim=16),
        mlp=MLPCfg(d, 128, "squared_relu"),
        norm="layernorm",
        param_dtype=param_dtype, block_k=16,
    )
