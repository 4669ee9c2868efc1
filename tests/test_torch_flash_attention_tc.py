"""The tensor-core flash variant's arithmetic fits the kernel's tolerance.

On the card a bf16 query with head dim 128 runs the tensor-core kernel
(``csrc/flash_attention_wgmma.cu``): q, K, V and P rounded to bf16, f32
accumulation, an online softmax over 64-key tiles.  It is held to the
plain f32 version within ``REL_TOL`` x max|plain|, the limit of
``chip_smoke.py`` and ``tests/test_torch_cuda.py``.  The kernel cannot run
here, so these tests run its arithmetic written out in plain torch
(``ref.attention_bf16_products``) on the same seeded inputs and hold it
to the port's plain version and to the JAX package's ``chunk_attention``
(chunked prefill) and ``flash_attention_jnp`` (one-shot prefill): shapes
with GQA 8/1, 64/8 and 96/8 (nemotron-4-340b's, at D 192; the others at
D 128), 512-1024 keys, offsets 0, 100 and late,
query counts that are not tile multiples, and both cache dtypes; at
D 64 without the causal mask (seamless-m4t-large-v2's encoder over its
frames and its cross-attention of a prompt and of a decode step); and
at MLA's head dims (192, 128) (deepseek-v3's materialized prefill, 16/16
heads here), with v the strided tail of each head's 256-wide row, as
``models/mla.py`` slices the up-projection; and the short-query schedule
at D 64, whose consumers split the key tiles and merge at the end
(``key_split``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as JL
from repro_torch.kernels.flash_attention import ref

REL_TOL = 2.0 ** -6     # of max|plain|, for a bf16 output
JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _inputs(seed, sq, skv, h, hkv, kv_dtype, q_gain=1.0, d=None):
    d = d or (192 if h == 96 else 128)      # nemotron-4-340b's head dim
    rng = np.random.RandomState(seed)
    q = (q_gain * rng.randn(1, sq, h, d)).astype(np.float32)
    k = rng.randn(1, skv, hkv, d).astype(np.float32)
    v = rng.randn(1, skv, hkv, d).astype(np.float32)
    # q as served (bf16); the cache in its own dtype
    return (torch.from_numpy(q).to(torch.bfloat16),
            torch.from_numpy(k).to(kv_dtype),
            torch.from_numpy(v).to(kv_dtype))


def _within(got, want):
    want = np.asarray(want, np.float32)
    err = np.abs(got.float().numpy() - want).max()
    tol = REL_TOL * np.abs(want).max()
    assert err <= tol, (err, tol)
    return err / np.abs(want).max()


# (H, Hkv, Sq, Skv, q_offset, cache dtype, q gain): chunks of queries
# against the whole cache; q gain 4 makes the softmax peaked.
CHUNK_CASES = [
    (8, 1, 77, 512, 0, torch.float32, 1.0),
    (8, 1, 130, 1024, 100, torch.bfloat16, 1.0),
    (8, 1, 64, 1024, 960, torch.float32, 4.0),
    (64, 8, 100, 1024, 924, torch.float32, 1.0),
    (64, 8, 61, 512, 100, torch.bfloat16, 1.0),
    (64, 8, 200, 768, 568, torch.bfloat16, 4.0),
    (96, 8, 100, 1024, 924, torch.float32, 1.0),
    (96, 8, 200, 768, 568, torch.bfloat16, 4.0),
]


@pytest.mark.parametrize("h,hkv,sq,skv,off,kv_dtype,gain", CHUNK_CASES)
def test_bf16_products_match_plain_and_chunk_attention(h, hkv, sq, skv, off,
                                                       kv_dtype, gain):
    q, k, v = _inputs(sq + off + h, sq, skv, h, hkv, kv_dtype, gain)
    got = ref.attention_bf16_products(q, k, v, q_offset=off)
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    plain = ref.attention(q, k, v, q_offset=off)
    _within(got, plain.float().numpy())
    q_pos = jnp.arange(sq)[None, :] + off
    want = JL.chunk_attention(jnp.asarray(q.float().numpy(), jnp.bfloat16),
                              jnp.asarray(k.float().numpy(), JDT[kv_dtype]),
                              jnp.asarray(v.float().numpy(), JDT[kv_dtype]),
                              q_pos)
    _within(got, np.asarray(want.astype(jnp.float32)))


@pytest.mark.parametrize("h,hkv,seq,kv_dtype", [
    (8, 1, 600, torch.float32), (64, 8, 515, torch.bfloat16),
    (96, 8, 515, torch.float32)])
def test_bf16_products_match_plain_and_flash_attention_jnp(h, hkv, seq,
                                                           kv_dtype):
    """One-shot prefill (offset 0, Sq = Skv, not a tile multiple)."""
    q, k, v = _inputs(seq + h, seq, seq, h, hkv, kv_dtype)
    got = ref.attention_bf16_products(q, k, v)
    _within(got, ref.attention(q, k, v).float().numpy())
    want = JL.flash_attention_jnp(
        jnp.asarray(q.float().numpy(), jnp.bfloat16),
        jnp.asarray(k.float().numpy(), JDT[kv_dtype]),
        jnp.asarray(v.float().numpy(), JDT[kv_dtype]), block_k=128)
    _within(got, np.asarray(want.astype(jnp.float32)))


@pytest.mark.parametrize("sq,skv,kv_dtype", [
    (1000, 1000, torch.bfloat16), (4, 1000, torch.float32),
    (1, 1000, torch.bfloat16), (77, 300, torch.float32)])
def test_bf16_products_non_causal_d64_match_plain_and_flash_attention_jnp(
        sq, skv, kv_dtype):
    """16 / 16 heads at D 64, every key visible to every query."""
    q, k, v = _inputs(sq + skv, sq, skv, 16, 16, kv_dtype, d=64)
    got = ref.attention_bf16_products(q, k, v, causal=False)
    _within(got, ref.attention(q, k, v, causal=False).float().numpy())
    want = JL.flash_attention_jnp(
        jnp.asarray(q.float().numpy(), jnp.bfloat16),
        jnp.asarray(k.float().numpy(), JDT[kv_dtype]),
        jnp.asarray(v.float().numpy(), JDT[kv_dtype]), causal=False,
        block_k=128)
    _within(got, np.asarray(want.astype(jnp.float32)))


@pytest.mark.parametrize("split", [2, 3])
@pytest.mark.parametrize("sq,skv,kv_dtype", [
    (1, 900, torch.bfloat16), (4, 900, torch.bfloat16),
    (4, 900, torch.float32)])
def test_bf16_products_with_the_keys_split_match_unsplit_and_jnp(
        sq, skv, kv_dtype, split):
    """The kernel's short-query schedule at D 64: its consumers (three;
    two as well) take the 64-key tiles in turn (900 keys are 15 tiles:
    with two the first takes one more) and merge (m, l, O) at the end.
    16 / 16 heads, non-causal, against the unsplit arithmetic and
    ``flash_attention_jnp``."""
    q, k, v = _inputs(sq + skv, sq, skv, 16, 16, kv_dtype, d=64)
    got = ref.attention_bf16_products(q, k, v, causal=False,
                                      key_split=split)
    _within(got, ref.attention_bf16_products(q, k, v, causal=False
                                             ).float().numpy())
    want = JL.flash_attention_jnp(
        jnp.asarray(q.float().numpy(), jnp.bfloat16),
        jnp.asarray(k.float().numpy(), JDT[kv_dtype]),
        jnp.asarray(v.float().numpy(), JDT[kv_dtype]), causal=False,
        block_k=128)
    _within(got, np.asarray(want.astype(jnp.float32)))


def test_bf16_products_split_where_a_consumer_sees_no_key():
    """37 keys are one tile: the second and third consumers see none (m
    = -inf, l = 0) and weigh 0 in the merge, so the split gives the
    unsplit bits, and never NaN."""
    q, k, v = _inputs(41, 4, 37, 16, 16, torch.bfloat16, d=64)
    got = ref.attention_bf16_products(q, k, v, causal=False, key_split=3)
    assert torch.isfinite(got).all()
    assert torch.equal(got, ref.attention_bf16_products(q, k, v,
                                                        causal=False))


def test_bf16_products_are_exact_where_nothing_rounds():
    """A query at position 0 sees one key, whose probability is 1: with
    a bf16 cache nothing is rounded but the output, so the emulation
    gives the plain version's bits."""
    q, k, v = _inputs(7, 1, 64, 4, 1, torch.bfloat16)
    got = ref.attention_bf16_products(q, k, v, q_offset=0)
    want = ref.attention(q, k, v, q_offset=0)
    assert torch.equal(got, want)


def test_bf16_products_never_read_keys_past_the_last_query():
    """Keys past the chunk's last position never enter, not even inside
    the last tile as masked products: garbage there (NaN, as unwritten
    pages may hold) leaves the result unchanged."""
    q, k, v = _inputs(3, 40, 512, 8, 1, torch.float32)
    want = ref.attention_bf16_products(q, k, v, q_offset=100)
    k[:, 140:], v[:, 140:] = float("nan"), float("nan")
    got = ref.attention_bf16_products(q, k, v, q_offset=100)
    assert torch.equal(got, want)


def _mla_inputs(seed, sq, skv, kv_dtype, h=16):
    """q and k at D 192; v the last 128 of each head's 256-wide row of
    one (1, Skv, H, 256) tensor: a view at element offset 128 whose head
    stride is 256, as MLA splits ``ckv @ w_ukv`` into k_nope and v."""
    rng = np.random.RandomState(seed)
    q = torch.from_numpy(rng.randn(1, sq, h, 192).astype(np.float32))
    k = torch.from_numpy(rng.randn(1, skv, h, 192).astype(np.float32))
    kv = torch.from_numpy(rng.randn(1, skv, h, 256).astype(np.float32))
    return q.to(torch.bfloat16), k.to(kv_dtype), kv.to(kv_dtype)[..., 128:]


@pytest.mark.parametrize("sq,skv,off,kv_dtype", [
    (515, 515, 0, torch.bfloat16), (515, 515, 0, torch.float32),
    (77, 300, 100, torch.bfloat16), (77, 300, 100, torch.float32)])
def test_bf16_products_at_mla_head_dims_match_plain_and_flash_attention_jnp(
        sq, skv, off, kv_dtype):
    """(192, 128), causal, MLA's scale 1/sqrt(192): a one-shot whose
    length is not a tile multiple, and a 77-query chunk at offset 100
    over 300 keys (keys past its last position unseen)."""
    q, k, v = _mla_inputs(sq + off, sq, skv, kv_dtype)
    assert v.storage_offset() == 128 and v.stride(2) == 256
    scale = 192 ** -0.5
    got = ref.attention_bf16_products(q, k, v, q_offset=off, sm_scale=scale)
    assert got.dtype == torch.bfloat16 and got.shape == (1, sq, 16, 128)
    _within(got, ref.attention(q, k, v, q_offset=off,
                               sm_scale=scale).float().numpy())
    want = JL.flash_attention_jnp(
        jnp.asarray(q.float().numpy(), jnp.bfloat16),
        jnp.asarray(k.float().numpy(), JDT[kv_dtype]),
        jnp.asarray(v.float().numpy(), JDT[kv_dtype]), q_offset=off,
        block_k=128, sm_scale=scale)
    _within(got, np.asarray(want.astype(jnp.float32)))
