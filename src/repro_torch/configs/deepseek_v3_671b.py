"""deepseek-v3-671b [moe] — 61L d7168 128H MLA, MoE 1 shared + 256 routed
top-8 (expert ff 2048, dense ff 18432 on the first 3 layers), MTP head,
vocab 129280 [arXiv:2412.19437].

Two stages: 3 ``("mla", "dense")`` layers, then 58 ``("mla", "moe")``
layers with sigmoid-scored routing; the MTP block is one more layer of
the last stage's spec.
"""

import torch

from repro_torch.models.layers import MLPCfg
from repro_torch.models.mla import MLACfg
from repro_torch.models.moe import MoECfg
from repro_torch.models.transformer import (LayerSpec, StageSpec,
                                            TransformerCfg)

ARCH_ID = "deepseek-v3-671b"
FAMILY = "moe"
SKIP_SHAPES = ("long_500k",)
USES_EMBEDS = False


def config(param_dtype=torch.bfloat16) -> TransformerCfg:
    d = 7_168
    return TransformerCfg(
        name=ARCH_ID, d_model=d, vocab_size=129_280,
        stages=(StageSpec((LayerSpec("mla", "dense"),), repeat=3),
                StageSpec((LayerSpec("mla", "moe"),), repeat=58)),
        mla=MLACfg(d_model=d, num_heads=128, q_lora=1_536, kv_lora=512,
                   dh_nope=128, dh_rope=64, dh_v=128),
        mlp=MLPCfg(d, 18_432, "swiglu"),
        moe=MoECfg(d_model=d, d_ff=2_048, num_experts=256, top_k=8,
                   num_shared=1, shared_d_ff=2_048, scoring="sigmoid",
                   norm_topk=True),
        mtp=True,
        param_dtype=param_dtype,
    )


def reduced(param_dtype=torch.float32) -> TransformerCfg:
    d = 64
    return TransformerCfg(
        name=ARCH_ID + "-reduced", d_model=d, vocab_size=256,
        stages=(StageSpec((LayerSpec("mla", "dense"),), repeat=1),
                StageSpec((LayerSpec("mla", "moe"),), repeat=2)),
        mla=MLACfg(d_model=d, num_heads=4, q_lora=32, kv_lora=16,
                   dh_nope=16, dh_rope=8, dh_v=16),
        mlp=MLPCfg(d, 128, "swiglu"),
        moe=MoECfg(d_model=d, d_ff=32, num_experts=8, top_k=2,
                   num_shared=1, shared_d_ff=32, scoring="sigmoid"),
        mtp=True,
        param_dtype=param_dtype, block_k=16,
    )
