"""granite-34b [dense] — 88L d6144 48H (MQA kv=1) ff24576 vocab49152.

Code model, llama-style blocks with multi-query attention and a
non-gated GELU MLP [arXiv:2405.04324].  The reference launcher's default
architecture.
"""

import torch

from repro_torch.models.layers import AttentionCfg, MLPCfg
from repro_torch.models.transformer import (LayerSpec, StageSpec,
                                            TransformerCfg)

ARCH_ID = "granite-34b"
FAMILY = "dense"
SKIP_SHAPES = ("long_500k",)
USES_EMBEDS = False


def config(param_dtype=torch.bfloat16) -> TransformerCfg:
    d = 6_144
    return TransformerCfg(
        name=ARCH_ID, d_model=d, vocab_size=49_152,
        stages=(StageSpec((LayerSpec("attn", "dense"),), repeat=88),),
        attn=AttentionCfg(d_model=d, num_heads=48, num_kv_heads=1,
                          head_dim=128, rope_theta=1e4),
        mlp=MLPCfg(d, 24_576, "gelu"),
        param_dtype=param_dtype,
    )


def reduced(param_dtype=torch.float32) -> TransformerCfg:
    d = 64
    return TransformerCfg(
        name=ARCH_ID + "-reduced", d_model=d, vocab_size=256,
        stages=(StageSpec((LayerSpec("attn", "dense"),), repeat=2),),
        attn=AttentionCfg(d_model=d, num_heads=4, num_kv_heads=1,
                          head_dim=16),
        mlp=MLPCfg(d, 128, "gelu"),
        param_dtype=param_dtype, block_k=16,
    )
