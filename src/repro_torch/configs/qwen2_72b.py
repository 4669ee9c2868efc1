"""qwen2-72b [dense] — 80L d8192 64H (GQA kv=8) ff29568 vocab152064.

GQA with QKV bias [arXiv:2407.10671].
"""

import torch

from repro_torch.models.layers import AttentionCfg, MLPCfg
from repro_torch.models.transformer import (LayerSpec, StageSpec,
                                            TransformerCfg)

ARCH_ID = "qwen2-72b"
FAMILY = "dense"
SKIP_SHAPES = ("long_500k",)
USES_EMBEDS = False


def config(param_dtype=torch.bfloat16) -> TransformerCfg:
    d = 8_192
    return TransformerCfg(
        name=ARCH_ID, d_model=d, vocab_size=152_064,
        stages=(StageSpec((LayerSpec("attn", "dense"),), repeat=80),),
        attn=AttentionCfg(d_model=d, num_heads=64, num_kv_heads=8,
                          head_dim=128, qkv_bias=True, rope_theta=1e6),
        mlp=MLPCfg(d, 29_568, "swiglu"),
        param_dtype=param_dtype,
    )


def reduced(param_dtype=torch.float32) -> TransformerCfg:
    d = 64
    return TransformerCfg(
        name=ARCH_ID + "-reduced", d_model=d, vocab_size=256,
        stages=(StageSpec((LayerSpec("attn", "dense"),), repeat=2),),
        attn=AttentionCfg(d_model=d, num_heads=4, num_kv_heads=2,
                          head_dim=16, qkv_bias=True, rope_theta=1e6),
        mlp=MLPCfg(d, 128, "swiglu"),
        param_dtype=param_dtype, block_k=16,
    )
