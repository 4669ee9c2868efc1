"""The port's flash-attention op against the JAX package.

On CPU tensors ``repro_torch.kernels.flash_attention.ops.attention`` takes
its plain path (``ref.py``), so these tests hold that plain version — the
function the CUDA kernel is held against on the card — to the reference's
three implementations of the same function: ``chunk_attention`` (chunked
prefill), ``flash_attention_jnp`` (one-shot prefill) and the Pallas kernel
in interpret mode.  Inputs come from a seeded numpy generator and go to
both packages as the same arrays.  Head dims: 16 (reduced), 64
(seamless-m4t-large-v2: its non-causal encoder and cross-attention, and
its causal self-attention), 128, 192 (nemotron-4-340b) and MLA's
192-dim scores against 128-dim values
(deepseek-v3, 128 heads, one KV head a query head), which the Pallas
kernel does not take (its output has q's head dim).

Tolerances: float32 at atol 1e-5 (the two sides sum in different orders);
bfloat16 at 2e-2 (one bf16 ulp of O(1) outputs, plus the reference's
one-shot path rounding P to bf16 before P·V).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import ops as jops
from repro.models import layers as JL
from repro_torch.kernels.flash_attention import kernel as tkernel
from repro_torch.kernels.flash_attention import ops as tops
from repro_torch.kernels.flash_attention import ref as tref
from repro_torch.models import layers as TL

F32_ATOL = 1e-5
BF16_ATOL = 2e-2


def _qkv(seed, b, sq, skv, h, hkv, d, dv=None):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, sq, h, d).astype(np.float32),
            rng.randn(b, skv, hkv, d).astype(np.float32),
            rng.randn(b, skv, hkv, dv or d).astype(np.float32))


# (D, Dv) of a head layout, by its query head count: the reduced configs'
# 16, qwen2-72b's 128, nemotron-4-340b's 192, deepseek-v3's MLA.
HEAD_DIMS = {4: (16, 16), 8: (16, 16), 64: (128, 128), 96: (192, 192),
             128: (192, 128)}


def _t(x, dtype=torch.float32):
    return torch.from_numpy(x).to(dtype)


def _j(x, dtype=jnp.float32):
    return jnp.asarray(x).astype(dtype)


def _close(port, ref, atol):
    np.testing.assert_allclose(port.float().numpy(),
                               np.asarray(ref, np.float32), atol=atol,
                               rtol=0)


# (H, Hkv, D, Sq, Smax, q_offset, dtypes): GQA 4/2 and 8/1 at small
# widths, the qwen2-72b head layout (64 -> 8, D=128) and nemotron-4-340b's
# (96 -> 8, D=192) on a short cache.
# dtypes: all f32; bf16 q with an f32 cache (the full-width serving
# contract); all bf16.
CHUNK_CASES = [(4, 2, 16, 8, 32, 0, "f32"), (4, 2, 16, 8, 32, 8, "f32"),
               (8, 1, 16, 16, 64, 32, "f32"), (64, 8, 128, 16, 48, 16, "f32"),
               (4, 2, 16, 8, 32, 8, "bf16_q"), (4, 2, 16, 8, 32, 8, "bf16"),
               (64, 8, 128, 16, 48, 16, "bf16_q"),
               (64, 8, 128, 16, 48, 16, "bf16"),
               (96, 8, 192, 16, 48, 16, "f32"),
               (96, 8, 192, 16, 48, 16, "bf16_q")]


@pytest.mark.parametrize("h,hkv,d,sq,smax,off,dtypes", CHUNK_CASES)
def test_plain_flash_matches_chunk_attention(h, hkv, d, sq, smax, off,
                                             dtypes):
    """Chunked prefill: a chunk at ``off`` against the whole cache."""
    q, k, v = _qkv(h * smax + off, 1, sq, smax, h, hkv, d)
    qdt = torch.float32 if dtypes == "f32" else torch.bfloat16
    kvdt = torch.bfloat16 if dtypes == "bf16" else torch.float32
    jq = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
    q_pos = jnp.arange(sq)[None, :] + off
    want = JL.chunk_attention(_j(q, jq[qdt]), _j(k, jq[kvdt]),
                              _j(v, jq[kvdt]), q_pos)
    got = TL.chunk_attention(_t(q, qdt), _t(k, kvdt), _t(v, kvdt), off)
    assert got.dtype == qdt
    _close(got, want, F32_ATOL if dtypes == "f32" else BF16_ATOL)


@pytest.mark.parametrize("h,hkv,causal,seq", [
    (4, 2, True, 37), (8, 1, True, 64), (64, 8, True, 37),
    (4, 2, False, 37), (64, 8, False, 64), (96, 8, True, 37),
    (128, 128, True, 37), (128, 128, False, 64)])
def test_plain_flash_matches_flash_attention_jnp(h, hkv, causal, seq):
    """One-shot prefill, including a length that is not a multiple of
    the reference's 16-key block; head dims by ``HEAD_DIMS``."""
    d, dv = HEAD_DIMS[h]
    q, k, v = _qkv(seq + h, 2, seq, seq, h, hkv, d, dv)
    want = JL.flash_attention_jnp(_j(q), _j(k), _j(v), causal=causal,
                                  block_k=16)
    got = TL.flash_attention(_t(q), _t(k), _t(v), causal=causal)
    _close(got, want, F32_ATOL)


def test_plain_flash_bf16_matches_flash_attention_jnp():
    q, k, v = _qkv(5, 1, 40, 40, 8, 2, 16)
    want = JL.flash_attention_jnp(_j(q, jnp.bfloat16), _j(k, jnp.bfloat16),
                                  _j(v, jnp.bfloat16), block_k=16)
    got = TL.flash_attention(_t(q, torch.bfloat16), _t(k, torch.bfloat16),
                             _t(v, torch.bfloat16))
    assert got.dtype == torch.bfloat16
    _close(got, want, BF16_ATOL)


# (H, Hkv, Sq, Skv, q_offset) at D=128 (D=192 for nemotron-4-340b's 96
# heads), tile-sized for the Pallas kernel.
PALLAS_CASES = [(4, 2, 128, 128, 0), (8, 1, 128, 128, 0),
                (64, 8, 128, 128, 0), (4, 2, 128, 256, 128),
                (96, 8, 128, 256, 128)]


@pytest.mark.parametrize("h,hkv,sq,skv,off", PALLAS_CASES)
def test_plain_flash_matches_pallas_kernel_interpret(h, hkv, sq, skv, off):
    q, k, v = _qkv(h + off, 1, sq, skv, h, hkv, 192 if h == 96 else 128)
    want = jops.attention(_j(q), _j(k), _j(v), causal=True, q_offset=off,
                          force_kernel=True, block_q=128, block_k=128)
    got = tops.attention(_t(q), _t(k), _t(v), causal=True, q_offset=off)
    _close(got, want, F32_ATOL)


# (H, Hkv, Sq, Skv, causal) at D 64, seamless-m4t-large-v2's heads: the
# non-causal encoder (Sq = Skv), cross-attention of a prompt and of a
# decode step (Sq != Skv), and the causal self-attention.
D64_CASES = [(16, 16, 128, 128, False), (16, 16, 4, 128, False),
             (16, 16, 1, 128, False), (8, 8, 128, 128, True),
             (4, 2, 8, 256, False)]


@pytest.mark.parametrize("h,hkv,sq,skv,causal", D64_CASES)
def test_plain_flash_d64_matches_pallas_kernel_interpret(h, hkv, sq, skv,
                                                         causal):
    q, k, v = _qkv(sq + skv + h, 1, sq, skv, h, hkv, 64)
    want = jops.attention(_j(q), _j(k), _j(v), causal=causal,
                          force_kernel=True, block_q=128, block_k=128)
    got = tops.attention(_t(q), _t(k), _t(v), causal=causal)
    _close(got, want, F32_ATOL)


@pytest.mark.parametrize("h,hkv,sq,skv,causal", D64_CASES + [
    (16, 16, 37, 37, False), (16, 16, 3, 45, False)])
def test_plain_flash_d64_matches_flash_attention_jnp(h, hkv, sq, skv,
                                                     causal):
    """Also at lengths that are not a multiple of the reference's 16-key
    block."""
    q, k, v = _qkv(sq + skv, 2, sq, skv, h, hkv, 64)
    want = JL.flash_attention_jnp(_j(q), _j(k), _j(v), causal=causal,
                                  block_k=16)
    got = TL.flash_attention(_t(q), _t(k), _t(v), causal=causal)
    _close(got, want, F32_ATOL)


def test_kernel_head_dims_include_d64():
    assert (64, 64) in tkernel.HEAD_DIMS


def test_cpu_tensors_take_the_plain_path_without_launching():
    q, k, v = _qkv(0, 1, 8, 8, 4, 2, 128)
    before = tops.counter.value
    got = tops.attention(_t(q), _t(k), _t(v))
    assert tops.counter.value == before
    want = tref.attention(_t(q), _t(k), _t(v))
    assert torch.equal(got, want)


def test_cuda_kernel_refuses_cpu_tensors():
    q, k, v = _qkv(0, 1, 8, 8, 4, 2, 128)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tkernel.flash_attention(_t(q), _t(k), _t(v))

# The kernel itself, on the card: tests/test_torch_cuda.py.
