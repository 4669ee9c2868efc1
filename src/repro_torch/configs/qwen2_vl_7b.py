"""qwen2-vl-7b [vlm] — 28L d3584 28H (GQA kv=4) ff18944 vocab152064.

M-RoPE (t/h/w sections), dynamic-resolution vision frontend stubbed:
``models.frontends.vision_patch_embeds`` feeds precomputed patch
embeddings + 3D positions [arXiv:2409.12191].  No embedding table: the
decoder takes ``inputs_embeds``.  Full attention -> long_500k skipped.
"""

import torch

from repro_torch.models.layers import AttentionCfg, MLPCfg
from repro_torch.models.transformer import (LayerSpec, StageSpec,
                                            TransformerCfg)

ARCH_ID = "qwen2-vl-7b"
FAMILY = "vlm"
SKIP_SHAPES = ("long_500k",)       # pure full attention
USES_EMBEDS = True                 # stub frontend feeds inputs_embeds


def config(param_dtype=torch.bfloat16) -> TransformerCfg:
    d, heads, kv, dh = 3584, 28, 4, 128
    return TransformerCfg(
        name=ARCH_ID, d_model=d, vocab_size=152_064,
        stages=(StageSpec((LayerSpec("attn", "dense"),), repeat=28),),
        attn=AttentionCfg(d_model=d, num_heads=heads, num_kv_heads=kv,
                          head_dim=dh, qkv_bias=True, rope_theta=1e6,
                          mrope_sections=(16, 24, 24)),
        mlp=MLPCfg(d, 18_944, "swiglu"),
        embed_inputs=False,        # patch/text embeddings arrive precomputed
        param_dtype=param_dtype,
    )


def reduced(param_dtype=torch.float32) -> TransformerCfg:
    d = 64
    return TransformerCfg(
        name=ARCH_ID + "-reduced", d_model=d, vocab_size=256,
        stages=(StageSpec((LayerSpec("attn", "dense"),), repeat=2),),
        attn=AttentionCfg(d_model=d, num_heads=4, num_kv_heads=2, head_dim=16,
                          qkv_bias=True, rope_theta=1e6,
                          mrope_sections=(2, 3, 3)),
        mlp=MLPCfg(d, 128, "swiglu"),
        embed_inputs=False, param_dtype=param_dtype, block_k=16,
    )
