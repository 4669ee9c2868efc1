"""The port's CUDA kernels on the card, against their plain versions.

Flash attention is held to a tolerance (below); the gradient-sync
kernels (``sum_chunks``, ``quantize``, ``dequantize``, ``dequant_add``)
bit for bit, at the sizes the data-parallel sync of granite-34b gives
them: the ``lm_head`` gradient's bidirectional-ring combine chunk at two
ranks (n/4 of 6144 x 49152) and its compressed-ring chunk (n/2), a
6144-value norm, and a ragged length.

The composed sync's ZeRO seam (reduce-scatter and all-gather) and its
bucketed ring run on CUDA thread ranks, each ring hop's combine a launch
of the CUDA ``sum_chunks``, and give the bits of the same calls on CPU
ranks.

The elastic paths on CUDA thread ranks: the reduced granite-34b under
``ElasticController`` (ZeRO-1, 4 -> 2 ranks) gives, bit for bit, the
losses of a run started on the 2 survivors from the same checkpoint on
the card, and the CPU's elastic losses within 1e-4 (the card's GEMMs
sum in another order than the CPU's, so bits cannot cross devices),
and so does its model-sharded twin on (data 2, model 2) -> (1, 2);
the reduced qwen2-72b under ``ServeController`` (data 4 -> 2) gives the
CPU's greedy streams; a rank that raises on the card surfaces from
``run_spmd`` as a ``RankFailure`` naming it.

The whole collective library (composed and monolithic), and the
two-phase and hierarchical all-reduce, on CUDA thread ranks give the
bits of the same calls on CPU ranks; one model-parallel train step of
the reduced granite-34b on a (data 2, model 2) mesh of CUDA thread ranks
finishes (its backward's model-axis all-reduces run on the rank
threads) with the CPU's loss; and the reduced
qwen2-72b and qwen3-moe-30b-a3b in bf16 decode the same requests'
logits bit for bit at batch 8 and at batch 4.  The reduced MoE layer
on the card routes as on the CPU and agrees within 1e-4.  The reduced
mamba2-1.3b and jamba-1.5-large-398b, served one-shot through the
scheduler on the card, give the CPU's greedy streams.  The reduced
qwen2-vl-7b (embeddings and M-RoPE positions in) and
seamless-m4t-large-v2 (frames in; encoder, cross-attention) prefill and
decode on the card within 1e-3 of the CPU, their flash launches counted.

These tests need a CUDA device (the hand-written kernels have no CPU
mode) and skip elsewhere.  They import neither JAX nor the JAX package,
so they run on a machine that has only the port's dependencies:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

Flash attention has two variants, chosen by the query's type and the
head dims: a bf16 query at (D, Dv) = (64, 64), (128, 128), (192, 192) or
MLA's (192, 128) runs on the tensor cores (``wgmma``), causal or not, any
other (an f32 query, or the reduced head dim 16) on the CUDA cores in
f32 (``simt``).  ``kernel.launch`` returns the
variant that ran and ``ops.tc_counter`` counts the tensor-core launches,
so these tests pick a variant by the dtype of q and check that it ran.

Tolerance: a share of the plain output's largest magnitude.  The plain
version computes in float32 and rounds once to q's dtype.  The
tensor-core variant also rounds K, V and P to bf16 (2**-9 of each value
at most, errors that average over a row's keys) besides the output's
own rounding; written out in plain torch that arithmetic holds 2**-6 of
the largest value at these shapes
(``tests/test_torch_flash_attention_tc.py``), and a bf16 output is held
to 2**-6 of it here too.  The f32 variant differs only by summation order and is
held to 1e-4, which a dropped key tile, a mis-masked edge or
probabilities rounded to bf16 exceed.
"""

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels.flash_attention import kernel, ops, ref
from repro_torch.kernels.local_reduce import ops as lops
from repro_torch.kernels.local_reduce import ref as lref
from repro_torch.kernels.quantize import ops as qops
from repro_torch.kernels.quantize import ref as qref
from repro_torch.models import build_model
from repro_torch.tree import leaves, map_tree

pytestmark = pytest.mark.cuda

REL_TOL = {torch.bfloat16: 2.0 ** -6, torch.float32: 1e-4}


def _assert_matches(got, want):
    want = want.float()
    tol = REL_TOL[got.dtype] * want.abs().max().item()
    torch.testing.assert_close(got.float(), want, atol=tol, rtol=0)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _qkv(seed, sq, skv, h, hkv, d, q_dtype, kv_dtype, device, dv=None):
    rng = np.random.RandomState(seed)
    q = torch.from_numpy(rng.randn(1, sq, h, d).astype(np.float32))
    k = torch.from_numpy(rng.randn(1, skv, hkv, d).astype(np.float32))
    v = torch.from_numpy(rng.randn(1, skv, hkv, dv or d).astype(np.float32))
    return (q.to(device, q_dtype), k.to(device, kv_dtype),
            v.to(device, kv_dtype))


@pytest.mark.parametrize("h,hkv,d", [(64, 8, 128), (96, 8, 192)])
@pytest.mark.parametrize("q_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("kv_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sq,skv,off", [(256, 4096, 0), (256, 4096, 256),
                                        (256, 4096, 3840), (1000, 1000, 0)])
def test_kernel_matches_plain_at_serving_shapes(cuda, h, hkv, d, q_dtype,
                                                kv_dtype, sq, skv, off):
    """64 -> 8 heads at D 128 (qwen2-72b) and 96 -> 8 at D 192
    (nemotron-4-340b): chunks over a 4096-token cache and a one-shot
    prefill whose length is not a multiple of the tile; a bf16 query on
    the tensor cores, an f32 one on the CUDA cores."""
    q, k, v = _qkv(sq + off, sq, skv, h, hkv, d, q_dtype, kv_dtype, cuda)
    before = (ops.counter.value, ops.tc_counter.value)
    got = ops.attention(q, k, v, q_offset=off)
    assert ops.counter.value == before[0] + 1
    assert ops.tc_counter.value == before[1] + (q_dtype == torch.bfloat16)
    assert got.dtype == q_dtype
    _assert_matches(got, ref.attention(q, k, v, q_offset=off))


@pytest.mark.parametrize("q_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("kv_dtype", [torch.float32, torch.bfloat16])
def test_mla_one_shot_prefill_matches_plain(cuda, q_dtype, kv_dtype):
    """deepseek-v3's materialized MLA prefill: 128 heads (K/V per head),
    192-dim scores against 128-dim values, 1000 tokens; a bf16 query on
    the tensor cores, an f32 one on the CUDA cores."""
    q, k, v = _qkv(5, 1000, 1000, 128, 128, 192, q_dtype, kv_dtype, cuda,
                   dv=128)
    before = (ops.counter.value, ops.tc_counter.value)
    got = ops.attention(q, k, v)
    assert (ops.counter.value, ops.tc_counter.value) == (
        before[0] + 1, before[1] + (q_dtype == torch.bfloat16))
    assert got.shape == (1, 1000, 128, 128) and got.dtype == q_dtype
    _assert_matches(got, ref.attention(q, k, v))


@pytest.mark.parametrize("kv_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,hkv", [(16, 16), (8, 1)])
@pytest.mark.parametrize("sq,skv,off", [(77, 300, 100), (130, 4096, 3841),
                                        (1000, 1000, 0), (5, 4096, 3841),
                                        (200, 523, 0), (333, 1000, 667)])
def test_mla_head_dims_on_the_tensor_cores_at_ragged_shapes(
        cuda, kv_dtype, h, hkv, sq, skv, off):
    """(192, 128), causal: Sq, Skv and offsets that are not tile
    multiples, a KV head a query head (MLA's, one head's query tiles back
    to back) and GQA 8/1 (the launch order of the other head dims), both
    cache types; each launch on the tensor cores."""
    q, k, v = _qkv(sq + off + h, sq, skv, h, hkv, 192, torch.bfloat16,
                   kv_dtype, cuda, dv=128)
    before = (ops.counter.value, ops.tc_counter.value)
    got = ops.attention(q, k, v, q_offset=off, sm_scale=192 ** -0.5)
    assert (ops.counter.value, ops.tc_counter.value) == (before[0] + 1,
                                                          before[1] + 1)
    _assert_matches(got, ref.attention(q, k, v, q_offset=off,
                                       sm_scale=192 ** -0.5))


@pytest.mark.parametrize("s", [1000, 77])
def test_mla_layout_on_the_tensor_cores(cuda, s):
    """MLA's own views at 128 / 128 heads (``models/mla.py``): q and k
    from ``torch.cat`` of the 128-dim no-position part and the 64-dim
    rotary part (k's shared across heads by ``expand``), v the last 128
    of each head's 256-wide row of the up-projection, a view 256 bytes
    past its allocation's base with a head stride of 256 elements."""
    h, rng = 128, np.random.RandomState(s)
    x = lambda *shape: torch.from_numpy(rng.randn(*shape).astype(
        np.float32)).to(cuda, torch.bfloat16)
    kv = x(1, s, h, 256)
    krope = x(1, s, 64)
    k_nope, v = kv[..., :128], kv[..., 128:]
    k = torch.cat([k_nope, krope[:, :, None, :].expand(1, s, h, 64)], -1)
    q = torch.cat([x(1, s, h, 128), x(1, s, h, 64)], -1)
    assert not v.is_contiguous() and v.stride(2) == 256
    assert v.data_ptr() - kv.data_ptr() == 256
    before = ops.tc_counter.value
    got = ops.attention(q, k, v, sm_scale=192 ** -0.5)
    assert ops.tc_counter.value == before + 1
    assert got.shape == (1, s, h, 128)
    _assert_matches(got, ref.attention(q, k, v, sm_scale=192 ** -0.5))


@pytest.mark.parametrize("h,hkv,d,causal,dv", [(4, 2, 16, True, 16),
                                               (8, 1, 16, False, 16),
                                               (64, 8, 128, False, 128),
                                               (16, 2, 192, False, 192),
                                               (16, 16, 192, True, 128),
                                               (16, 16, 64, False, 64),
                                               (8, 2, 64, True, 64)])
def test_kernel_matches_plain_f32(cuda, h, hkv, d, causal, dv):
    q, k, v = _qkv(h, 77, 77, h, hkv, d, torch.float32, torch.float32, cuda,
                   dv=dv)
    got = kernel.flash_attention(q, k, v, causal=causal)
    want = ref.attention(q, k, v, causal=causal)
    torch.testing.assert_close(got, want, atol=1e-4, rtol=0)


def test_kernel_takes_strided_cache_views(cuda):
    """The serving path hands the kernel one layer of a stacked arena: a
    view whose token stride spans every layer."""
    q, k, v = _qkv(3, 64, 256, 8, 2, 128, torch.bfloat16, torch.float32,
                   cuda)
    stack_k = torch.zeros(1, 256, 3, 2, 128, device=cuda)
    stack_v = torch.zeros_like(stack_k)
    stack_k[:, :, 1], stack_v[:, :, 1] = k, v
    got = kernel.flash_attention(q, stack_k[:, :, 1], stack_v[:, :, 1],
                                 q_offset=64)
    _assert_matches(got, ref.attention(q, k, v, q_offset=64))


@pytest.mark.parametrize("d", [128, 192, 64])
@pytest.mark.parametrize("kv_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,hkv", [(8, 1), (64, 8)])
@pytest.mark.parametrize("sq,skv,off", [(77, 300, 100), (130, 4096, 3841),
                                        (64, 1000, 936), (200, 523, 0),
                                        (5, 4096, 3841)])
def test_tensor_core_kernel_at_ragged_shapes(cuda, d, kv_dtype, h, hkv, sq,
                                             skv, off):
    """Offsets that are not tile multiples, Sq and Skv that are not
    multiples of 64, GQA 8/1 and 64/8, both cache types, D 64, 128 and
    192."""
    q, k, v = _qkv(sq + off + h, sq, skv, h, hkv, d, torch.bfloat16,
                   kv_dtype, cuda)
    before = ops.tc_counter.value
    got = ops.attention(q, k, v, q_offset=off)
    assert ops.tc_counter.value == before + 1
    _assert_matches(got, ref.attention(q, k, v, q_offset=off))


@pytest.mark.parametrize("d", [64, 128, 192])
@pytest.mark.parametrize("kv_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,hkv", [(16, 16), (8, 1)])
@pytest.mark.parametrize("sq,skv", [(1, 1024), (4, 1024), (1, 37),
                                    (77, 300), (1024, 1024), (130, 523)])
def test_tensor_core_kernel_non_causal_at_ragged_shapes(cuda, d, kv_dtype,
                                                        h, hkv, sq, skv):
    """Non-causal (the encoder-decoder's encoder and cross-attention):
    every query sees all Skv keys, Sq = 1 (a cross-attention decode step)
    and Sq < Skv, Skv not a multiple of 64; each launch on the tensor
    cores, counted by ``ops.tc_counter``."""
    q, k, v = _qkv(sq + skv + d, sq, skv, h, hkv, d, torch.bfloat16,
                   kv_dtype, cuda)
    before = (ops.counter.value, ops.tc_counter.value)
    got = ops.attention(q, k, v, causal=False)
    assert (ops.counter.value, ops.tc_counter.value) == (before[0] + 1,
                                                          before[1] + 1)
    _assert_matches(got, ref.attention(q, k, v, causal=False))


@pytest.mark.parametrize("kv_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,hkv", [(16, 16), (8, 1)])
@pytest.mark.parametrize("sq,skv,causal", [(1, 900, False), (4, 900, False),
                                           (1, 1000, False), (4, 1000, False),
                                           (4, 37, False), (4, 64, False),
                                           (64, 900, False), (4, 900, True)])
def test_short_queries_split_the_keys_at_d64(cuda, kv_dtype, h, hkv, sq, skv,
                                             causal):
    """D 64 with Sq <= 64 (a cross-attention decode step or prompt): the
    three consumers take the key tiles of the same rows in turn and
    merge at the end.  1000 keys are 16 tiles, so one consumer takes a
    tile more (900: 15, 5 each); at 37 and 64 keys the others see none
    and must weigh 0, never NaN; Sq 64 fills a consumer's rows; causal
    at offset 896 masks the last tile.  One tensor-core launch a call,
    against plain and against the split arithmetic in plain torch."""
    off = skv - sq if causal else 0
    q, k, v = _qkv(sq + skv + h, sq, skv, h, hkv, 64, torch.bfloat16,
                   kv_dtype, cuda)
    before = (ops.counter.value, ops.tc_counter.value)
    got = ops.attention(q, k, v, causal=causal, q_offset=off)
    assert (ops.counter.value, ops.tc_counter.value) == (before[0] + 1,
                                                          before[1] + 1)
    assert torch.isfinite(got).all()
    _assert_matches(got, ref.attention(q, k, v, causal=causal, q_offset=off))
    _assert_matches(got, ref.attention_bf16_products(
        q, k, v, causal=causal, q_offset=off, key_split=3))


@pytest.mark.parametrize("d", [128, 192])
@pytest.mark.parametrize("kv_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,hkv", [(8, 1), (64, 8)])
def test_tensor_core_kernel_takes_strided_arena_views(cuda, d, kv_dtype, h,
                                                      hkv):
    """One layer of a stacked (B, S, layers, Hkv, D) arena, batch 2, as
    the serve path hands it; the keys past the chunk hold NaN, as pages
    not yet written may, and must never reach the output."""
    sq, skv, off = 100, 640, 300
    q, k, v = _qkv(h + 5, 2 * sq, skv, h, hkv, d, torch.bfloat16,
                   kv_dtype, cuda)
    q = q.reshape(2, sq, h, d)
    k = k.expand(2, -1, -1, -1).contiguous()
    v = v.expand(2, -1, -1, -1).contiguous()
    stack_k = torch.full((2, skv, 3, hkv, d), float("nan"), device=cuda,
                         dtype=kv_dtype)
    stack_v = stack_k.clone()
    stack_k[:, :off + sq, 2], stack_v[:, :off + sq, 2] = (k[:, :off + sq],
                                                          v[:, :off + sq])
    out, variant = kernel.launch(q, stack_k[:, :, 2], stack_v[:, :, 2],
                                 q_offset=off)
    assert variant == "wgmma"
    assert torch.isfinite(out).all()
    _assert_matches(out, ref.attention(q, k[:, :off + sq], v[:, :off + sq],
                                       q_offset=off))


@pytest.mark.parametrize("q_dtype,d,dv,variant", [
    (torch.bfloat16, 128, 128, "wgmma"), (torch.float32, 128, 128, "simt"),
    (torch.bfloat16, 16, 16, "simt"), (torch.float32, 16, 16, "simt"),
    (torch.bfloat16, 192, 192, "wgmma"), (torch.float32, 192, 192, "simt"),
    (torch.bfloat16, 192, 128, "wgmma"), (torch.float32, 192, 128, "simt"),
    (torch.bfloat16, 64, 64, "wgmma"), (torch.float32, 64, 64, "simt")])
def test_variant_follows_the_query_type(cuda, q_dtype, d, dv, variant):
    q, k, v = _qkv(d, 70, 90, 8, 2, d, q_dtype, torch.float32, cuda, dv=dv)
    before = (ops.counter.value, ops.tc_counter.value)
    ops.attention(q, k, v, q_offset=20)
    assert ops.counter.value == before[0] + 1
    assert ops.tc_counter.value == before[1] + (variant == "wgmma")
    got, ran = kernel.launch(q, k, v, q_offset=20)
    assert ran == variant
    _assert_matches(got, ref.attention(q, k, v, q_offset=20))


def test_kernel_refuses_unsupported_head_dim(cuda):
    q, k, v = _qkv(0, 8, 8, 4, 2, 32, torch.float32, torch.float32, cuda)
    with pytest.raises(ValueError, match="D in"):
        kernel.flash_attention(q, k, v)
    # a pair the library is not built for, though each dim is
    q, k, v = _qkv(0, 8, 8, 4, 2, 128, torch.bfloat16, torch.float32, cuda,
                   dv=192)
    with pytest.raises(ValueError, match="D in"):
        kernel.flash_attention(q, k, v)


def test_reduced_model_prefill_on_card_matches_cpu(cuda):
    model = build_model(get_config("qwen2-72b", reduced=True))
    cpu_params = model.init(torch.Generator().manual_seed(0))
    toks = np.random.RandomState(1).randint(0, 256, size=(2, 40))
    logits = []
    for dev in ("cpu", "cuda"):
        params = map_tree(lambda t: t.to(dev), cpu_params)
        caches = model.init_caches(2, 64, dtype=torch.float32, device=dev)
        lg, _ = model.prefill(params, {"tokens": torch.tensor(toks,
                                                              device=dev)},
                              caches)
        logits.append(lg.cpu())
    torch.testing.assert_close(logits[1], logits[0], atol=1e-3, rtol=0)


@pytest.mark.parametrize("arch", ["qwen2-vl-7b", "seamless-m4t-large-v2"])
def test_embeddings_archs_prefill_and_decode_on_card_match_cpu(cuda, arch):
    """The reduced qwen2-vl-7b (inputs_embeds and the stub's M-RoPE
    positions, then 3 decode steps at explicit (3, B, 1) positions) and
    seamless-m4t-large-v2 (frames and a prompt, then 3 decode steps)
    through ``Model.prefill`` / ``Model.decode_step`` on the card and on
    the CPU from the same weights and inputs: every step's logits within
    1e-3 (f32; the card sums in another order), and the card's flash
    launches (f32 q: the CUDA-core variant at the reduced D 16): qwen2-vl
    one a layer a prefill; seamless one an encoder layer and two a
    decoder layer a prefill, one a decoder layer a step."""
    from repro_torch.models import frontends
    model = build_model(get_config(arch, reduced=True))
    cfg = model.cfg
    cpu_params = model.init(torch.Generator().manual_seed(0))
    rng = np.random.RandomState(3)
    b, n, steps = 2, 24, 3
    if model.kind == "encdec":
        frames = torch.from_numpy((rng.randn(b, 40, cfg.d_model) * 0.05
                                   ).astype(np.float32))
        toks = torch.from_numpy(rng.randint(0, 256, (b, n + steps)))
        pre = {"frame_embeds": frames, "tokens": toks[:, :n]}
        dec = [{"tokens": toks[:, t:t + 1]} for t in range(n, n + steps)]
        want = (cfg.enc_layers + 2 * cfg.dec_layers
                + steps * cfg.dec_layers)
        kw = {"enc_len": 40}
    else:
        embeds = torch.from_numpy((rng.randn(b, n + steps, cfg.d_model)
                                   * 0.02).astype(np.float32))
        pos = frontends.vision_positions(b, n + steps)
        pre = {"inputs_embeds": embeds[:, :n], "positions": pos[:, :, :n]}
        dec = [{"inputs_embeds": embeds[:, t:t + 1],
                "positions": pos[:, :, t:t + 1]} for t in range(n, n + steps)]
        want = cfg.num_layers
        kw = {}
    logits = []
    for dev in ("cpu", cuda):
        params = map_tree(lambda t: t.to(dev), cpu_params)
        caches = model.init_caches(b, n + steps, dtype=torch.float32,
                                   device=dev, **kw)
        before = ops.counter.value
        lg, caches = model.prefill(
            params, map_tree(lambda t: t.to(dev), pre), caches)
        got = [lg.cpu()]
        for step in dec:
            lg, caches = model.decode_step(
                params, map_tree(lambda t: t.to(dev), step), caches)
            got.append(lg.cpu())
        logits.append(got)
        if dev == cuda:
            assert ops.counter.value - before == want
    for cpu, card in zip(*logits):
        torch.testing.assert_close(card, cpu, atol=1e-3, rtol=0)


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "jamba-1.5-large-398b"])
def test_state_space_serving_on_card_gives_the_cpu_streams(cuda, arch):
    """Reduced mamba2 and jamba served one-shot through the scheduler on
    the card (jamba's attention layer through the kernel) and on the
    CPU from the same weights: the same greedy streams."""
    from repro_torch.serve import BatchScheduler, Request, ServeCfg
    model = build_model(get_config(arch, reduced=True))
    cpu_params = model.init(torch.Generator().manual_seed(0))
    rng = np.random.RandomState(2)
    prompts = [rng.randint(0, 256, size=8 * rng.randint(1, 7)).tolist()
               for _ in range(6)]
    streams = []
    for dev in ("cpu", cuda):
        sched = BatchScheduler(model, map_tree(lambda t: t.to(dev),
                                               cpu_params),
                               ServeCfg(max_len=96, batch=3, page_tokens=32,
                                        cache_dtype=torch.float32),
                               device=dev)
        for rid, p in enumerate(prompts):
            sched.submit(Request(rid=rid, prompt=p, max_new=6))
        streams.append({r.rid: r.generated for r in sched.run()})
        sched.pool.check_integrity()
    assert streams[1] == streams[0]


def test_moe_layer_on_card_matches_cpu(cuda):
    """The reduced qwen3-moe-30b-a3b's MoE layer (f32) on the card
    against the CPU: the same routing plan, the output and the aux loss
    within 1e-4 of the largest value (the GEMMs sum in another order);
    and the whole reduced model's prefill logits within 1e-3."""
    from repro_torch.models import moe as M
    cfg = get_config("qwen3-moe-30b-a3b", reduced=True)
    gen = torch.Generator().manual_seed(0)
    params = M.init_moe(gen, cfg.moe, torch.float32, "cpu")
    x = torch.randn(2, 40, cfg.d_model, generator=gen)
    C = M.capacity_of(80, cfg.moe)
    out = {}
    for dev in ("cpu", cuda):
        p = map_tree(lambda t: t.to(dev), params)
        plan = M.route(x.reshape(-1, cfg.d_model).to(dev), p["router"],
                       cfg.moe, C)
        y, aux = M.moe_forward(p, cfg.moe, x.to(dev))
        out[str(dev)] = [t.cpu() for t in plan[:4] + (y, aux)]
    for i in (0, 2, 3):
        assert torch.equal(out["cuda"][i], out["cpu"][i])
    for i in (1, 4, 5):
        want = out["cpu"][i]
        torch.testing.assert_close(out["cuda"][i], want, rtol=0,
                                   atol=1e-4 * want.abs().max().item())
    model = build_model(cfg)
    cpu_params = model.init(torch.Generator().manual_seed(1))
    toks = np.random.RandomState(2).randint(0, 256, size=(2, 40))
    logits = []
    for dev in ("cpu", "cuda"):
        p = map_tree(lambda t: t.to(dev), cpu_params)
        caches = model.init_caches(2, 64, dtype=torch.float32, device=dev)
        lg, _ = model.prefill(p, {"tokens": torch.tensor(toks, device=dev)},
                              caches)
        logits.append(lg.cpu())
    torch.testing.assert_close(logits[1], logits[0], atol=1e-3, rtol=0)


LM_HEAD = 6144 * 49152
SYNC_SIZES = [LM_HEAD // 4, LM_HEAD // 2, 6144, 1_000_003]


def _bits_equal(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    view = {1: torch.int8, 2: torch.int16, 4: torch.int32}[a.element_size()]
    assert torch.equal(a.view(view), b.view(view))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", SYNC_SIZES[:1] + SYNC_SIZES[2:])
def test_sum_chunks_kernel_matches_plain_bits(cuda, n, dtype):
    gen = torch.Generator(device=cuda).manual_seed(n)
    x = torch.randn(3, n, generator=gen, device=cuda).to(dtype)
    for k in (2, 3):
        before = lops.counter.value
        got = lops.sum_chunks(list(x[:k]), dtype)
        assert lops.counter.value == before + 1
        _bits_equal(got, lref.sum_chunks(list(x[:k]), dtype))
    # 4-byte offset views: not 16-byte aligned, so the scalar path
    flat = x.reshape(-1)
    a, b = flat[1:n // 2], flat[n // 2 + 1:n]
    m = min(a.numel(), b.numel())
    _bits_equal(lops.sum_chunks([a[:m], b[:m]]),
                lref.sum_chunks([a[:m], b[:m]]))


DTYPE_PAIRS = [(torch.bfloat16, torch.bfloat16),
               (torch.bfloat16, torch.float32),
               (torch.float32, torch.bfloat16),
               (torch.float32, torch.float32)]


@pytest.mark.parametrize("k", range(1, 9))
@pytest.mark.parametrize("in_dtype,out_dtype", DTYPE_PAIRS)
def test_sum_chunks_bits_at_every_offset_and_length(cuda, in_dtype,
                                                    out_dtype, k):
    """Lengths of every residue mod 8, chunks at 0, 1 and 8 elements past
    a 16-byte boundary (the scalar head and tail around the vector
    body), and chunks at different offsets (the scalar path)."""
    gen = torch.Generator(device=cuda).manual_seed(k)
    x = torch.randn(k, 1040, generator=gen, device=cuda).to(in_dtype)
    for n in [1, 3, 7, 8, 9] + list(range(1000, 1008)):
        for off in (0, 1, 8):
            chunks = [x[j, off:off + n] for j in range(k)]
            _bits_equal(lops.sum_chunks(chunks, out_dtype),
                        lref.sum_chunks(chunks, out_dtype))
        mixed = [x[j, j % 3:j % 3 + n] for j in range(k)]
        _bits_equal(lops.sum_chunks(mixed, out_dtype),
                    lref.sum_chunks(mixed, out_dtype))


def _quant_input(n, cuda):
    n = -(-n // qref.QBLOCK) * qref.QBLOCK       # the sync pads to blocks
    gen = torch.Generator(device=cuda).manual_seed(n)
    x = torch.randn(n, generator=gen, device=cuda)
    x = x.view(-1, qref.QBLOCK) * torch.rand(
        n // qref.QBLOCK, 1, generator=gen, device=cuda) * 10
    x[0] = 0.0                                   # all-zero block
    if x.shape[0] > 1:                           # exact .5 ties, scale 1
        x[1] = (torch.arange(qref.QBLOCK, device=cuda) % 9 - 4) + 0.5
        x[1, 0] = 127.0
    return x.reshape(-1)


@pytest.mark.parametrize("n", SYNC_SIZES)
def test_quantize_kernels_match_plain_bits(cuda, n):
    x = _quant_input(n, cuda)
    q, s = qops.quantize(x)
    wq, ws = qref.quantize(x)
    _bits_equal(q, wq)
    _bits_equal(s, ws)
    _bits_equal(qops.dequantize(q, s), qref.dequantize(q, s))
    acc = torch.randn(x.numel(), generator=torch.Generator(
        device=cuda).manual_seed(1), device=cuda)
    _bits_equal(qops.dequant_add(acc, q, s), qref.dequant_add(acc, q, s))
    _bits_equal(qops.dequant_add(acc, q, -s), qref.dequant_add(acc, q, -s))


# ---------------------------------------------------------------------------
# The ZeRO seam and the bucketed ring on CUDA thread ranks
# ---------------------------------------------------------------------------

def _ranks_run(device, p, fn, inputs, proto="ring"):
    """``fn`` on ``p`` thread ranks on ``device`` (a session whose
    all-reduce is forced onto ``proto``); returns the per-rank results
    on the CPU and the combine launches."""
    from repro_torch.comm import Session
    from repro_torch.core.engine import EngineConfig
    from repro_torch.runtime import substrate
    sess = Session(mesh=substrate.make_mesh((p,), ("data",), device=device),
                   config=EngineConfig(force_protocol={"all_reduce": proto}))
    d = sess.split("data")
    before = lops.counter.value
    out = substrate.run_spmd(
        lambda x: fn(d, x), [(map_tree(lambda t: t.to(device), x),)
                             for x in inputs], sess.mesh)
    return map_tree(lambda t: t.cpu(), out), lops.counter.value - before


def _grad_inputs(p, dtype):
    gen = torch.Generator().manual_seed(p)
    return [{"a": torch.randn(4096, 3, generator=gen).to(dtype),
             "b": torch.randn(1001, generator=gen).to(dtype),
             "c": torch.randn(77, 5, generator=gen).to(dtype)}
            for _ in range(p)]


@pytest.mark.parametrize("proto", ["ring", "bidir_ring"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_zero_seam_on_cuda_ranks_matches_cpu_bits(cuda, dtype, proto):
    """The ZeRO reduce-scatter (through the CUDA ``sum_chunks``) and the
    all-gather of its chunks on 2 CUDA thread ranks, against the same
    calls on CPU ranks."""
    p = 2

    def zero(d, x):
        chunks = {k: d.zero_reduce_scatter_wait(d.zero_reduce_scatter_start(v))
                  for k, v in x.items()}
        gathered = {k: d.zero_all_gather_wait(d.zero_all_gather_start(v))
                    for k, v in chunks.items()}
        return chunks, gathered

    inputs = _grad_inputs(p, dtype)
    want, cpu_launches = _ranks_run("cpu", p, zero, inputs, proto)
    got, launches = _ranks_run(cuda, p, zero, inputs, proto)
    assert cpu_launches == 0 and launches > 0
    for g, w in zip(leaves(got), leaves(want)):
        _bits_equal(g, w)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bucketed_ring_on_cuda_ranks_matches_cpu_bits(cuda, dtype):
    """The bucketed sync (ring, 3 ranks, several buckets) on CUDA thread
    ranks: every ring hop's combine is one CUDA ``sum_chunks`` launch."""
    p = 3

    def bucketed(d, x):
        return d.sync_gradients_bucketed(x, bucket_bytes=16 * 1024)[0]

    inputs = _grad_inputs(p, dtype)
    want, _ = _ranks_run("cpu", p, bucketed, inputs)
    got, launches = _ranks_run(cuda, p, bucketed, inputs)
    from repro_torch.core import plan as plan_mod
    n_buckets = len(plan_mod.plan_buckets(leaves(inputs[0]), 16 * 1024))
    assert n_buckets > 1
    assert launches == n_buckets * (p - 1) * p      # p-1 hops a rank
    for g, w in zip(leaves(got), leaves(want)):
        _bits_equal(g, w)


def _elastic_train(device, tmp, model_parallel=1):
    """ZeRO-1 of the reduced granite-34b on 4 ranks ((4,), or (2, 2)
    with a model axis) under ``ElasticController`` with ``lose@3:2``:
    (report, losses of a run started on the survivors from the step-2
    checkpoint)."""
    from repro_torch.configs import get_config as gc
    from repro_torch.data import SyntheticLMDataset
    from repro_torch.launch.train import build_session
    from repro_torch.optim import make_optimizer
    from repro_torch.runtime import substrate
    from repro_torch.runtime.controller import ElasticController, FaultPlan
    from repro_torch.train import trainer
    cfg = gc("granite-34b", reduced=True)
    model = build_model(cfg, model_parallel=model_parallel)
    opt = make_optimizer("adamw", lr=1e-3, clip_norm=0.0)
    tcfg = trainer.TrainCfg(zero=True)
    sess = trainer.TrainSession(model, opt, tcfg)
    ds = SyntheticLMDataset(vocab_size=cfg.vocab_size, seq_len=64,
                            global_batch=4)
    data = 4 // model_parallel

    def host_mesh(dev):
        return substrate.make_host_mesh(data, model_parallel=model_parallel,
                                        device=dev)
    mesh = host_mesh(device)
    # both devices start from the same weights, drawn on the CPU: the
    # controller restores this step-0 checkpoint instead of drawing its
    # own (a CUDA generator draws other numbers than a CPU one)
    from repro_torch.checkpoint import save_checkpoint
    cpu_mesh = host_mesh("cpu")
    save_checkpoint(str(tmp), 0, sess.gather(sess.init_state(
        torch.Generator().manual_seed(0), mesh=cpu_mesh), cpu_mesh),
        sharded=True)
    ctl = ElasticController(
        sess, ds, mesh, total_steps=5, ckpt_dir=str(tmp), ckpt_every=2,
        ckpt_keep=0, ckpt_sharded=True,
        comm=build_session(mesh, model, opt, ds, tcfg),
        fault_plan=FaultPlan.parse("lose@3:2", seed=0),
        watchdog_timeout=600.0)
    report = ctl.run()
    assert all(t.device.type == torch.device(device).type
               for st in ctl.states for t in leaves(st["params"]))
    mesh2 = substrate.make_mesh(
        report.mesh_history[-1], mesh.axis_names, device=device,
        members=report.recoveries[0].healthy_after)
    from repro_torch.checkpoint import restore_checkpoint
    states = sess.scatter(restore_checkpoint(
        str(tmp), sess.abstract_state(mesh=mesh2), step=2,
        allow_resize_1d=True), mesh2)
    step = sess.step_fn(build_session(mesh2, model, opt, ds, tcfg).world)
    baseline = {}
    for s in range(2, 5):
        states, m = step(states, ds.host_batch(s))
        baseline[s] = m["loss"].item()
    return report, baseline


def test_elastic_train_on_cuda_ranks(cuda, tmp_path):
    report, baseline = _elastic_train(cuda, tmp_path / "cuda")
    assert report.mesh_history == [(4,), (2,)]
    assert report.plan_rebuilds == 1
    assert {s: report.losses[s] for s in baseline} == baseline
    cpu, _ = _elastic_train("cpu", tmp_path / "cpu")
    for s in range(5):
        assert abs(report.losses[s] - cpu.losses[s]) <= \
            1e-4 * abs(cpu.losses[s]), s


def test_elastic_tp_train_on_cuda_ranks(cuda, tmp_path):
    """The same on (data 2, model 2): the model-sharded step-2
    checkpoint restores onto (1, 2) on the card, bit for bit the
    survivors' run, and the losses are the CPU's within 1e-4."""
    report, baseline = _elastic_train(cuda, tmp_path / "cuda", 2)
    assert report.mesh_history == [(2, 2), (1, 2)]
    assert report.plan_rebuilds == 1
    assert {s: report.losses[s] for s in baseline} == baseline
    cpu, _ = _elastic_train("cpu", tmp_path / "cpu", 2)
    for s in range(5):
        assert abs(report.losses[s] - cpu.losses[s]) <= \
            1e-4 * abs(cpu.losses[s]), s


def test_elastic_serve_on_cuda_gives_the_cpu_streams(cuda):
    from repro_torch.comm import Session
    from repro_torch.runtime import substrate
    from repro_torch.runtime.controller import FaultPlan
    from repro_torch.serve import Request, ServeCfg, ServeController
    model = build_model(get_config("qwen2-72b", reduced=True))
    cpu_params = model.init(torch.Generator().manual_seed(0))
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, 256, size=rng.randint(3, 50)).tolist()
               for _ in range(12)]

    def run(device, params):
        ctl = ServeController(
            model, params, ServeCfg(max_len=64, batch=8, page_tokens=8,
                                    cache_dtype=torch.float32),
            comm=Session(mesh=substrate.make_host_mesh(
                4, device=device)).world,
            fault_plan=FaultPlan.parse("lose@3:2", seed=0),
            watchdog_timeout=600.0)
        for rid, p in enumerate(prompts):
            ctl.submit(Request(rid=rid, prompt=p, max_new=6))
        report = ctl.run()
        ctl.sched.pool.check_integrity()
        return report

    got = run(cuda, map_tree(lambda t: t.to(cuda), cpu_params))
    want = run("cpu", cpu_params)
    assert got.mesh_history == [(4,), (2,)] and got.batch_history == [8, 4]
    assert got.tokens() == want.tokens()


def test_a_rank_raising_on_the_card_is_named(cuda):
    from repro_torch.runtime import health, substrate

    def body(r):
        x = torch.ones(1024, device=cuda) * r
        if r == 1:
            raise RuntimeError("CUDA error: GPU has fallen off the bus")
        return substrate.ppermute(x, "data", [(0, 2), (2, 0)])

    mesh = substrate.make_mesh((3,), ("data",), device=cuda,
                               members=(5, 6, 7))
    with pytest.raises(substrate.RankFailure) as ei:
        substrate.run_spmd(body, [(r,) for r in range(3)], mesh, timeout=60)
    assert (ei.value.rank, ei.value.member) == (1, 6)
    assert health.classify_failure(ei.value) == (6,)


# ---------------------------------------------------------------------------
# The collective library and decode at a fixed row count, on the card
# ---------------------------------------------------------------------------

LIB_CALLS = [("all_reduce", {}), ("reduce_scatter", {"dim": 0}),
             ("all_gather", {"dim": 1}),
             ("all_to_all", {"split_dim": 0, "concat_dim": 1}),
             ("broadcast", {"root": 1}), ("permute", {"shift": 1}),
             ("send_recv", {"pairs": [(0, 2), (3, 1)]})]


@pytest.mark.parametrize("mode", ["composed", "monolithic"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_collective_library_on_cuda_ranks_matches_cpu_bits(cuda, dtype,
                                                           mode):
    """Every function of the library on 4 CUDA thread ranks, each ring
    combine a launch of the CUDA ``sum_chunks`` (composed sums forced
    onto the ring: the plan picks recursive protocols at this size),
    against the same calls on CPU ranks, bit for bit."""
    from repro_torch.comm import Session
    from repro_torch.core.engine import EngineConfig
    from repro_torch.runtime import substrate
    p = 4
    gen = torch.Generator().manual_seed(16)
    xs = [torch.randn(8 * p, 12, generator=gen).to(dtype) for _ in range(p)]

    def run(device):
        sess = Session(mesh=substrate.make_mesh((p,), ("data",),
                                                device=device),
                       config=EngineConfig(mode=mode, force_protocol={
                           "all_reduce": "ring", "reduce_scatter": "ring"}))
        d = sess.split("data")
        before = lops.counter.value
        out = substrate.run_spmd(
            lambda x: [getattr(d, fn)(x, **kw) for fn, kw in LIB_CALLS],
            [(x.to(device),) for x in xs], sess.mesh)
        return map_tree(lambda t: t.cpu(), out), \
            lops.counter.value - before

    want, cpu_launches = run("cpu")
    got, launches = run(cuda)
    assert cpu_launches == 0 and launches > 0
    for g, w in zip(leaves(got), leaves(want)):
        _bits_equal(g, w)


def test_decode_logits_equal_at_batch_8_and_4_on_card(cuda):
    """The reduced qwen2-72b in bf16 on the card: the same requests'
    decode logits at batch 8 and as two batches of 4 are bit-identical
    (every decode call runs ``DECODE_ROWS`` rows)."""
    _decode_rows_at_8_and_4("qwen2-72b", cuda)


def test_moe_decode_logits_equal_at_batch_8_and_4_on_card(cuda):
    """The reduced qwen3-moe-30b-a3b in bf16 on the card, as above: a
    decode block of 8 rows has expert capacity 8, so no token drops and
    a row's logits do not depend on the others."""
    _decode_rows_at_8_and_4("qwen3-moe-30b-a3b", cuda)


def _decode_rows_at_8_and_4(arch, cuda):
    from repro_torch.serve import BatchScheduler, Request, ServeCfg, engine
    model = build_model(get_config(arch, reduced=True,
                                   param_dtype=torch.bfloat16))
    params = model.init(torch.Generator(device=cuda).manual_seed(0))
    rng = np.random.RandomState(1)
    prompts = [rng.randint(0, 256, size=rng.randint(3, 40)).tolist()
               for _ in range(8)]
    pick = engine._pick_tokens

    def run(rids, batch):
        rows, decoding = {}, []

        def recording(lg, cfg, rids_, pos):
            if decoding:                  # a decode call: the next rows
                take = decoding[0][:lg.shape[0]]
                del decoding[0][:lg.shape[0]]
                for j, key in enumerate(take):
                    if key is not None:
                        rows[key] = lg[j].float().cpu()
            return pick(lg, cfg, rids_, pos)

        engine._pick_tokens = recording
        try:
            sched = BatchScheduler(model, params, ServeCfg(
                max_len=64, batch=batch, page_tokens=8,
                cache_dtype=torch.bfloat16), device=cuda)
            run_decode = sched._decode

            def decode(params_, tok, rids_, pos, slot_rids, active):
                decoding.append([(r, q) if a else None for r, a, q in zip(
                    slot_rids, active, pos.tolist())])
                try:
                    return run_decode(params_, tok, rids_, pos, slot_rids,
                                      active)
                finally:
                    decoding.pop()

            sched._decode = decode
            for r in rids:
                sched.submit(Request(rid=r, prompt=prompts[r], max_new=8))
            out = {r.rid: r.generated for r in sched.run()}
        finally:
            engine._pick_tokens = pick
        return out, rows

    s8, rows8 = run(range(8), 8)
    lo, rows_lo = run(range(4), 4)
    hi, rows_hi = run(range(4, 8), 4)
    assert s8 == {**lo, **hi}
    rows4 = {**rows_lo, **rows_hi}
    assert rows8.keys() == rows4.keys() and len(rows8) == 8 * 7
    for k in rows8:
        assert torch.equal(rows8[k], rows4[k]), k


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("axes,shape", [(("data", "model"), (2, 2)),
                                        (("data", "model"), (4, 2)),
                                        (("pod", "data"), (2, 2)),
                                        (("pod", "data"), (3, 2))])
def test_multiaxis_all_reduce_on_cuda_ranks_matches_cpu_bits(cuda, dtype,
                                                             axes, shape):
    """Two-phase and hierarchical all-reduce on CUDA thread ranks (every
    ring combine a launch of the CUDA ``sum_chunks``), blocking and
    start/wait, against the same calls on CPU ranks (the plain combine),
    bit for bit."""
    from repro_torch.comm import Session
    from repro_torch.runtime import substrate
    n = int(np.prod(shape))
    gen = torch.Generator().manual_seed(n)
    xs = [torch.randn(6144 + 7, generator=gen).to(dtype) for _ in range(n)]

    def run(device):
        sess = Session(mesh=substrate.make_mesh(shape, axes, device=device))
        w = sess.world
        before = lops.counter.value
        out = substrate.run_spmd(
            lambda x: (w.all_reduce(x),
                       w.all_reduce_wait(w.all_reduce_start(x))),
            [(x.to(device),) for x in xs], sess.mesh)
        return map_tree(lambda t: t.cpu(), out), \
            lops.counter.value - before

    want, cpu_launches = run("cpu")
    got, launches = run(cuda)
    assert cpu_launches == 0 and launches > 0
    for g, w in zip(leaves(got), leaves(want)):
        _bits_equal(g, w)


@pytest.mark.parametrize("sync", ["composed", "compressed"])
def test_model_parallel_train_step_on_cuda_ranks(cuda, sync):
    """One step of the reduced granite-34b on a (data 2, model 2) mesh
    of CUDA thread ranks: the staged backward's model-axis all-reduces
    run on the rank threads, so the step finishes well inside the
    transport's timeout (a backward node waiting for a peer rank would
    deadlock on the one CUDA autograd thread).  The loss is the CPU's
    within 1e-4, the data replicas are identical, and the gradients of
    the leaves both model ranks hold are bit-equal across "model" on the
    card too (``check_model_replicas``)."""
    import time
    from repro_torch.data import SyntheticLMDataset
    from repro_torch.launch.train import build_session
    from repro_torch.optim import make_optimizer
    from repro_torch.runtime import substrate
    from repro_torch.train import trainer
    cfg = get_config("granite-34b", reduced=True)
    model = build_model(cfg, model_parallel=2)
    full = model.init(torch.Generator().manual_seed(0))
    ds = SyntheticLMDataset(vocab_size=cfg.vocab_size, seq_len=32,
                            global_batch=4)
    losses = {}
    for device in ("cpu", cuda):
        mesh = substrate.make_host_mesh(2, model_parallel=2, device=device)
        opt = make_optimizer("adamw", lr=1e-3)
        tcfg = trainer.TrainCfg(sync_mode=sync, check_model_replicas=True)
        sess = build_session(mesh, model, opt, ds, tcfg)
        states = trainer.init_states(model, opt, map_tree(
            lambda t: t.to(device), full), tcfg, mesh)
        step = trainer.make_train_step(model, opt, tcfg, comm=sess.world)
        t0 = time.perf_counter()
        states, metrics = step(states, ds.host_batch(0))
        seconds = time.perf_counter() - t0
        losses[str(device)] = metrics["loss"].item()
        assert seconds < substrate.DEFAULT_TIMEOUT / 10, seconds
        for a, b in zip(leaves(states[0]["params"]),
                        leaves(states[2]["params"])):   # data 1, model 0
            _bits_equal(a, b)
    assert abs(losses["cuda"] - losses["cpu"]) <= 1e-4 * abs(losses["cpu"])


def test_adafactor_update_on_card_matches_cpu(cuda):
    """One Adafactor update of a stacked bf16 leaf of 8 layers (mapped
    one layer at a time, each its own means and RMS clip, which a clip
    threshold of 0.5 engages) on the card and on the CPU: the f32
    statistics within 1e-6 of the largest value (the sums run in another
    order), each bf16 param within 1e-6 of the largest value or one bf16
    ulp of its own (the f32 updates before rounding differ in their last
    bits, which can tip a rounding), at most 1 in 1000 values so."""
    from repro_torch.optim import make_optimizer
    rng = np.random.RandomState(6)
    p = torch.from_numpy(rng.randn(8, 512, 1024).astype(np.float32))
    g = torch.from_numpy((rng.randn(8, 512, 1024) * 3).astype(np.float32))
    out = {}
    for device in ("cpu", cuda):
        opt = make_optimizer("adafactor", lr=1e-2, clip_threshold=0.5)
        params = {"w": p.to(device, torch.bfloat16)}
        state = opt.init(params)
        params, state, _ = opt.update({"w": g.to(device, torch.bfloat16)},
                                      state, params)
        out[str(device)] = (params["w"].float().cpu(),
                            {k: v.cpu() for k, v in state["f"]["w"].items()})
    (pc, sc), (pg, sg) = out["cpu"], out["cuda"]
    assert sorted(sg) == ["vc", "vr"]
    for k in sc:
        err = (sg[k] - sc[k]).abs().max().item()
        assert err <= 1e-6 * sc[k].abs().max().item(), k
    err = (pg - pc).abs()
    near = err <= 1e-6 * pc.abs().max()
    ulp = torch.ldexp(torch.ones_like(pc), torch.frexp(pc)[1] - 8)  # bf16
    assert bool((near | (err <= ulp)).all())
    assert (~near).float().mean().item() <= 1e-3
