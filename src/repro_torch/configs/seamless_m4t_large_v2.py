"""seamless-m4t-large-v2 [audio] — enc-dec 24L+24L d1024 16H ff8192
vocab256206 [arXiv:2308.11596].

The speech frontend (w2v-BERT conformer) is stubbed:
``models.frontends.audio_frame_embeds`` provides precomputed frame
embeddings; the system under test is the transformer backbone.  Full
attention -> long_500k skipped; decode shapes exercise the text decoder
with self+cross attention.
"""

import torch

from repro_torch.models.encdec import EncDecCfg
from repro_torch.models.layers import AttentionCfg, MLPCfg

ARCH_ID = "seamless-m4t-large-v2"
FAMILY = "audio"
SKIP_SHAPES = ("long_500k",)
USES_EMBEDS = True                 # encoder takes frame embeddings


def config(param_dtype=torch.bfloat16) -> EncDecCfg:
    d = 1_024
    attn = AttentionCfg(d_model=d, num_heads=16, num_kv_heads=16,
                        head_dim=64, rope_theta=1e4)
    return EncDecCfg(
        name=ARCH_ID, d_model=d, vocab_size=256_206,
        enc_layers=24, dec_layers=24,
        attn=attn,
        cross=AttentionCfg(d_model=d, num_heads=16, num_kv_heads=16,
                           head_dim=64, causal=False),
        mlp=MLPCfg(d, 8_192, "gelu"),
        norm="layernorm",
        param_dtype=param_dtype,
    )


def reduced(param_dtype=torch.float32) -> EncDecCfg:
    d = 64
    attn = AttentionCfg(d_model=d, num_heads=4, num_kv_heads=4, head_dim=16)
    return EncDecCfg(
        name=ARCH_ID + "-reduced", d_model=d, vocab_size=256,
        enc_layers=2, dec_layers=2,
        attn=attn,
        cross=AttentionCfg(d_model=d, num_heads=4, num_kv_heads=4,
                           head_dim=16, causal=False),
        mlp=MLPCfg(d, 128, "gelu"),
        norm="layernorm",
        param_dtype=param_dtype, block_k=16,
    )
