"""mamba2-1.3b [ssm] — 48L d2048, attention-free, ssm_state=128
[arXiv:2405.21060].

Pure SSD stack (no FFN blocks, as in the Mamba reference models).
Attention-free -> long_500k RUNS at O(1) decode state.  Its prompts are
a multiple of the SSD chunk (256) long, as the reference's
``ssd_chunked`` requires.
"""

import torch

from repro_torch.models.mamba import MambaCfg
from repro_torch.models.transformer import (LayerSpec, StageSpec,
                                            TransformerCfg)

ARCH_ID = "mamba2-1.3b"
FAMILY = "ssm"
SKIP_SHAPES = ()
USES_EMBEDS = False


def config(param_dtype=torch.bfloat16) -> TransformerCfg:
    d = 2_048
    return TransformerCfg(
        name=ARCH_ID, d_model=d, vocab_size=50_280,
        stages=(StageSpec((LayerSpec("mamba", "none"),), repeat=48),),
        mamba=MambaCfg(d_model=d, d_state=128, expand=2, headdim=64,
                       chunk=256),
        tie_embeddings=True,
        param_dtype=param_dtype,
    )


def reduced(param_dtype=torch.float32) -> TransformerCfg:
    d = 64
    return TransformerCfg(
        name=ARCH_ID + "-reduced", d_model=d, vocab_size=256,
        stages=(StageSpec((LayerSpec("mamba", "none"),), repeat=3),),
        mamba=MambaCfg(d_model=d, d_state=16, expand=2, headdim=16, chunk=8),
        tie_embeddings=True,
        param_dtype=param_dtype, block_k=16,
    )
