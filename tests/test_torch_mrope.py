"""Qwen2-VL's M-RoPE, the vision stub's positions and the embeddings
batches of the port against the JAX package, on the CPU.

- ``layers.mrope_cos_sin`` and the text-only fallback of ``_rope_for``
  ((B, S) positions rotating all three components) within 1e-6 of the
  reference's (f32 angles; the two packages evaluate cos / sin with
  their own libraries);
- an M-RoPE attention layer's prefill and decode step with explicit
  (3, B, S) positions within 1e-5 of the reference's;
- ``frontends.vision_positions`` (the stub's 3-D positions) equal to the
  reference's ``vision_patch_embeds`` positions bit for bit, and the
  stubs' embeddings of the shapes, dtypes and scales the reference's
  have;
- ``SyntheticLMDataset(with_embeds=True, mrope=True)`` byte-equal to the
  reference's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data.pipeline import SyntheticLMDataset as JDataset
from repro.models import frontends as JF
from repro.models import layers as JL
from repro_torch.data import SyntheticLMDataset
from repro_torch.models import frontends, layers as L

COS_SIN_TOL = 1e-6
LAYER_TOL = 1e-5


def _positions(seed, b, s, hi=3000):
    return np.random.RandomState(seed).randint(0, hi, (3, b, s)).astype(
        np.int32)


@pytest.mark.parametrize("dim,sections,theta", [
    (128, (16, 24, 24), 1e6), (16, (2, 3, 3), 1e6), (64, (8, 12, 12), 1e4)])
def test_mrope_cos_sin_matches_reference(dim, sections, theta):
    pos = _positions(dim, 2, 40)
    jc, js = JL.mrope_cos_sin(jnp.asarray(pos), dim, sections, theta)
    tc, ts = L.mrope_cos_sin(torch.from_numpy(pos), dim, sections, theta)
    assert tc.shape == (2, 40, dim // 2) and tc.dtype == torch.float32
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=COS_SIN_TOL,
                               rtol=0)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=COS_SIN_TOL,
                               rtol=0)


def test_mrope_refuses_sections_that_do_not_cover_the_head():
    with pytest.raises(ValueError, match="sum to"):
        L.mrope_cos_sin(torch.zeros(3, 1, 4, dtype=torch.int32), 16,
                        (2, 3, 2))


def _mrope_cfgs():
    j = JL.AttentionCfg(d_model=64, num_heads=4, num_kv_heads=2,
                        head_dim=16, qkv_bias=True, rope_theta=1e6,
                        mrope_sections=(2, 3, 3))
    t = L.AttentionCfg(d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
                       qkv_bias=True, rope_theta=1e6,
                       mrope_sections=(2, 3, 3))
    return j, t


def test_text_only_fallback_matches_reference():
    """(B, S) positions under M-RoPE: t == h == w, in both packages."""
    jcfg, tcfg = _mrope_cfgs()
    pos = np.random.RandomState(1).randint(0, 500, (2, 24)).astype(np.int32)
    jc, js = JL._rope_for(jcfg, jnp.asarray(pos), 2, 24)
    tc, ts = L._rope_for(tcfg, torch.from_numpy(pos))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=COS_SIN_TOL,
                               rtol=0)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=COS_SIN_TOL,
                               rtol=0)
    three = torch.from_numpy(np.broadcast_to(pos, (3, 2, 24)).copy())
    assert all(torch.equal(a, b) for a, b in zip(
        L._rope_for(tcfg, torch.from_numpy(pos)), L._rope_for(tcfg, three)))


def _layer_params(cfg_j):
    jp, _ = JL.init_attention(jax.random.PRNGKey(3), cfg_j)
    jp = {k: np.array(v) for k, v in jp.items()}
    rng = np.random.RandomState(4)
    for name in ("bq", "bk", "bv"):       # nonzero biases
        jp[name] = (rng.randn(*jp[name].shape) * 0.1).astype(np.float32)
    return jp, {k: torch.from_numpy(v) for k, v in jp.items()}


def test_mrope_attention_prefill_and_decode_match_reference():
    jcfg, tcfg = _mrope_cfgs()
    jp, tp = _layer_params(jcfg)
    b, s = 2, 20
    rng = np.random.RandomState(5)
    x = rng.randn(b, s + 2, 64).astype(np.float32)
    pos = frontends.vision_positions(b, s + 2).numpy()
    jcache = JL.init_kv_cache(b, s + 2, jcfg, jnp.float32)
    tcache = L.init_kv_cache(b, s + 2, tcfg, torch.float32, "cpu")
    jout, jcache = JL.attention_forward(
        jp, jcfg, jnp.asarray(x[:, :s]), positions=jnp.asarray(pos[..., :s]),
        kv_cache=jcache, block_k=16)
    tout, tcache = L.attention_forward(
        tp, tcfg, torch.from_numpy(x[:, :s]),
        positions=torch.from_numpy(pos[..., :s]), kv_cache=tcache,
        block_k=16)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout),
                               atol=LAYER_TOL, rtol=0)
    for t in (s, s + 1):
        jout, jcache = JL.attention_decode(
            jp, jcfg, jnp.asarray(x[:, t:t + 1]), jcache,
            positions=jnp.asarray(pos[..., t:t + 1]))
        tout, tcache = L.attention_decode(
            tp, tcfg, torch.from_numpy(x[:, t:t + 1]), tcache,
            positions=torch.from_numpy(pos[..., t:t + 1]))
        np.testing.assert_allclose(tout.numpy(), np.asarray(jout),
                                   atol=LAYER_TOL, rtol=0)
    for name in ("k", "v", "len"):
        np.testing.assert_allclose(tcache[name].numpy(),
                                   np.asarray(jcache[name]), atol=LAYER_TOL,
                                   rtol=0)


def test_explicit_positions_move_the_rotation():
    """The same inputs at the stub's image positions and at text
    positions give different outputs: the positions reach the layer."""
    _, tcfg = _mrope_cfgs()
    _, tp = _layer_params(_mrope_cfgs()[0])
    x = torch.from_numpy(np.random.RandomState(6).randn(1, 16, 64).astype(
        np.float32))
    image, _ = L.attention_forward(
        tp, tcfg, x, positions=frontends.vision_positions(1, 16))
    text, _ = L.attention_forward(tp, tcfg, x)
    assert not torch.allclose(image, text)


@pytest.mark.parametrize("b,seq", [(2, 32), (3, 7), (1, 1), (2, 100),
                                   (8, 2048)])
def test_vision_positions_equal_the_reference_bit_for_bit(b, seq):
    want = np.asarray(JF.vision_patch_embeds(jax.random.PRNGKey(0), b, seq,
                                             8)["positions"])
    got = frontends.vision_positions(b, seq)
    assert got.dtype == torch.int32 and tuple(got.shape) == (3, b, seq)
    assert np.array_equal(got.numpy(), want)
    stub = frontends.vision_patch_embeds(torch.Generator().manual_seed(0), b,
                                         seq, 8)
    assert torch.equal(stub["positions"], got)


def test_stub_embeddings_have_the_reference_shapes_and_scales():
    gen = torch.Generator().manual_seed(0)
    vis = frontends.vision_patch_embeds(gen, 4, 64, 32, torch.bfloat16)
    jvis = JF.vision_patch_embeds(jax.random.PRNGKey(0), 4, 64, 32,
                                  jnp.bfloat16)
    assert tuple(vis["inputs_embeds"].shape) == jvis["inputs_embeds"].shape
    assert vis["inputs_embeds"].dtype == torch.bfloat16
    aud = frontends.audio_frame_embeds(gen, 4, 64, 32)
    jaud = JF.audio_frame_embeds(jax.random.PRNGKey(0), 4, 64, 32)
    assert tuple(aud.shape) == jaud.shape and aud.dtype == torch.float32
    # N(0, 0.02^2) and N(0, 0.05^2): the standard deviations within 10%
    for got, want in ((vis["inputs_embeds"].float(), 0.02), (aud, 0.05)):
        assert abs(got.std().item() - want) < 0.1 * want
    again = frontends.audio_frame_embeds(torch.Generator().manual_seed(0),
                                         4, 64, 32)
    first = frontends.audio_frame_embeds(torch.Generator().manual_seed(0),
                                         4, 64, 32)
    assert torch.equal(again, first)


@pytest.mark.parametrize("mrope", [False, True])
def test_embeds_dataset_is_byte_equal_to_the_reference(mrope):
    kw = dict(vocab_size=256, seq_len=24, global_batch=3, seed=5,
              embed_dim=16, with_embeds=True, mrope=mrope)
    got, want = SyntheticLMDataset(**kw), JDataset(**kw)
    for step in (0, 3):
        g, w = got.host_batch(step), want.host_batch(step)
        assert sorted(g) == sorted(w)
        assert ("positions" in g) == mrope
        for k in w:
            assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape
            assert g[k].tobytes() == w[k].tobytes(), k


def test_token_dataset_is_unchanged_by_the_embeds_options():
    plain = SyntheticLMDataset(256, 16, 2, seed=1).host_batch(2)
    with_e = SyntheticLMDataset(256, 16, 2, seed=1, embed_dim=8,
                                with_embeds=True).host_batch(2)
    for k in ("tokens", "labels"):
        assert plain[k].tobytes() == with_e[k].tobytes()
