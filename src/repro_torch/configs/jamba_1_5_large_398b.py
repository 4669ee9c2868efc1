"""jamba-1.5-large-398b [hybrid] — 72L d8192 64H (GQA kv=8) ff24576
vocab65536, MoE 16e top-2, Mamba:attention 7:1 interleave
[arXiv:2403.19887].

Stage pattern: 9 repeats of 8 layers — attention at block index 0,
Mamba elsewhere, MoE FFN on every other layer (odd indices).  SSM layers
use the Mamba2/SSD block (d_state=128), as the reference's do.
SSM-dominant -> long_500k RUNS.  It prefills one-shot (its Mamba layers
have no chunked path), at prompt lengths that are a multiple of the SSD
chunk (256).
"""

import torch

from repro_torch.models.layers import AttentionCfg, MLPCfg
from repro_torch.models.mamba import MambaCfg
from repro_torch.models.moe import MoECfg
from repro_torch.models.transformer import (LayerSpec, StageSpec,
                                            TransformerCfg)

ARCH_ID = "jamba-1.5-large-398b"
FAMILY = "hybrid"
SKIP_SHAPES = ()
USES_EMBEDS = False


def _pattern():
    layers = []
    for i in range(8):
        mixer = "attn" if i == 0 else "mamba"
        ffn = "moe" if i % 2 == 1 else "dense"
        layers.append(LayerSpec(mixer, ffn))
    return tuple(layers)


def config(param_dtype=torch.bfloat16) -> TransformerCfg:
    d = 8_192
    return TransformerCfg(
        name=ARCH_ID, d_model=d, vocab_size=65_536,
        stages=(StageSpec(_pattern(), repeat=9),),
        attn=AttentionCfg(d_model=d, num_heads=64, num_kv_heads=8,
                          head_dim=128, rope_theta=1e4),
        mamba=MambaCfg(d_model=d, d_state=128, expand=2, headdim=64,
                       chunk=256),
        mlp=MLPCfg(d, 24_576, "swiglu"),
        moe=MoECfg(d_model=d, d_ff=24_576, num_experts=16, top_k=2),
        param_dtype=param_dtype,
    )


def reduced(param_dtype=torch.float32) -> TransformerCfg:
    d = 64
    pattern = (LayerSpec("attn", "dense"), LayerSpec("mamba", "moe"),
               LayerSpec("mamba", "dense"), LayerSpec("mamba", "moe"))
    return TransformerCfg(
        name=ARCH_ID + "-reduced", d_model=d, vocab_size=256,
        stages=(StageSpec(pattern, repeat=2),),
        attn=AttentionCfg(d_model=d, num_heads=4, num_kv_heads=2,
                          head_dim=16),
        mamba=MambaCfg(d_model=d, d_state=16, expand=2, headdim=16, chunk=8),
        mlp=MLPCfg(d, 128, "swiglu"),
        moe=MoECfg(d_model=d, d_ff=64, num_experts=4, top_k=2),
        param_dtype=param_dtype, block_k=16,
    )
