"""The encoder-decoder (seamless-m4t-large-v2's backbone) of the port
against ``repro.models.encdec``, on the CPU.

The reference's reduced config is initialised by JAX and carried into the
port with ``params_from_numpy`` (the same tree: ``embed``, ``encoder``,
``decoder``, ``enc_norm``, ``dec_norm``, ``lm_head``); inputs come from a
seeded numpy generator and go to both packages as the same arrays.

- ``encode`` (non-causal self-attention with RoPE over the frames),
  ``cross_attention_forward``, ``prefill`` and ``decode_step`` within
  1e-5 of the reference's, caches and the stored ``memory`` compared
  leaf by leaf;
- the non-causal encoder differs from the same stack run causally;
- the training path never reaches the forward-only flash op: with
  ``flash_attention.ops.attention`` patched to raise, ``loss_and_grads``
  of both embeddings archs runs (on the CPU the flash op's plain path is
  differentiable, so without the patch a training path that called it
  would pass here and fail only on the card);
- the refusals: no model axis (``sharding.layout``), no depth cut
  (``with_num_layers``), no chunked prefill.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import build_model as jbuild_model
from repro.models import encdec as JED
from repro.models import layers as JL
from repro_torch.configs import get_config, with_num_layers
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.models import build_model
from repro_torch.models import encdec as ED
from repro_torch.models import layers as L
from repro_torch.models.convert import params_from_numpy
from repro_torch.parallel import sharding as S
from repro_torch.tree import flatten, map_tree

ARCH = "seamless-m4t-large-v2"
B, FRAMES, PROMPT, STEPS = 2, 24, 6, 3
TOL = 1e-5
# Decode over a bf16 cache: each package rounds its own f32 K and V
# (equal to about 1e-7) to bf16, and a value near a rounding boundary
# lands one bf16 step (2**-8 relative) apart; the logits move by far
# less than one such step.
BF16_CACHE_TOL = 2e-3


@functools.lru_cache(maxsize=None)
def _pair():
    jcfg = jget_config(ARCH, reduced=True)
    jm = jbuild_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = build_model(get_config(ARCH, reduced=True))
    tp = params_from_numpy(jax.device_get(jp), tm.cfg, device="cpu")
    return jm, jp, tm, tp


def _inputs(seed=0):
    rng = np.random.RandomState(seed)
    return ((rng.randn(B, FRAMES, 64) * 0.05).astype(np.float32),
            rng.randint(0, 256, (B, PROMPT + STEPS)))


def _rel(got, want):
    want = np.asarray(want, np.float64)
    got = np.asarray(got, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def test_params_tree_has_the_reference_names():
    jm, jp, tm, tp = _pair()
    _, jpaths = flatten(jax.device_get(jp))
    _, tpaths = flatten(tp)
    assert jpaths == tpaths
    assert set(tp) == {"embed", "encoder", "decoder", "enc_norm",
                       "dec_norm", "lm_head"}
    assert set(tp["encoder"]) == {"norm1", "attn", "norm2", "mlp"}
    assert set(tp["decoder"]) == {"norm1", "self_attn", "norm_x", "cross",
                                  "norm2", "mlp"}
    assert tm.kind == "encdec" and jm.kind == "encdec"


def test_encode_matches_reference():
    jm, jp, tm, tp = _pair()
    frames, _ = _inputs()
    want = JED.encode(jp, jm.cfg, jnp.asarray(frames))
    got = ED.encode(tp, tm.cfg, torch.from_numpy(frames))
    assert got.shape == (B, FRAMES, 64)
    assert _rel(got.numpy(), want) <= TOL


def test_encoder_is_not_causal():
    """The encoder attends every frame: changing the last frame moves
    the first frame's memory row (a causal encoder would leave it), and
    the decoder's self-attention stays causal (its first position does
    not see the second token)."""
    _, _, tm, tp = _pair()
    frames, toks = (torch.from_numpy(x) for x in _inputs())
    moved = frames.clone()
    moved[:, -1] = moved[:, -1].flip(-1)      # a new last frame
    first = ED.encode(tp, tm.cfg, frames)[:, 0]
    assert (ED.encode(tp, tm.cfg, moved)[:, 0] - first).abs().max() > 1e-3
    memory = ED.encode(tp, tm.cfg, frames)
    other = toks.clone()
    other[:, 1] = (other[:, 1] + 1) % 256
    logits = [ED.decode_train(tp, tm.cfg, t, memory)[:, 0]
              for t in (toks, other)]
    assert torch.equal(logits[0], logits[1])


def test_cross_attention_matches_reference():
    jm, jp, tm, tp = _pair()
    rng = np.random.RandomState(1)
    x = rng.randn(B, 5, 64).astype(np.float32)
    memory = rng.randn(B, FRAMES, 64).astype(np.float32)
    jparams = jax.tree_util.tree_map(lambda t: t[0], jp["decoder"]["cross"])
    tparams = map_tree(lambda t: t[0], tp["decoder"]["cross"])
    want = JL.cross_attention_forward(jparams, jm.cfg.cross, jnp.asarray(x),
                                      jnp.asarray(memory), block_k=16)
    for train in (False, True):
        got = L.cross_attention_forward(tparams, tm.cfg.cross,
                                        torch.from_numpy(x),
                                        torch.from_numpy(memory),
                                        train=train, block_k=16)
        assert _rel(got.numpy(), want) <= TOL


def test_cross_attention_with_bias_matches_reference():
    """qkv_bias on the cross config: the biases go in per head, as in the
    reference."""
    jcfg = JL.AttentionCfg(d_model=64, num_heads=4, num_kv_heads=2,
                           head_dim=16, qkv_bias=True, causal=False)
    tcfg = L.AttentionCfg(d_model=64, num_heads=4, num_kv_heads=2,
                          head_dim=16, qkv_bias=True, causal=False)
    jp, _ = JL.init_cross_attention(jax.random.PRNGKey(2), jcfg)
    rng = np.random.RandomState(2)
    jp = {k: np.array(v) for k, v in jp.items()}
    for name in ("bq", "bk", "bv"):
        jp[name] = (rng.randn(*jp[name].shape) * 0.1).astype(np.float32)
    x = rng.randn(B, 3, 64).astype(np.float32)
    memory = rng.randn(B, 17, 64).astype(np.float32)
    want = JL.cross_attention_forward(jp, jcfg, jnp.asarray(x),
                                      jnp.asarray(memory))
    got = L.cross_attention_forward({k: torch.from_numpy(v) for k, v in
                                     jp.items()}, tcfg, torch.from_numpy(x),
                                    torch.from_numpy(memory))
    assert _rel(got.numpy(), want) <= TOL


def _compare_caches(tc, jc):
    tl, tpaths = flatten(tc)
    jl, jpaths = flatten(jax.device_get(jc))
    assert tpaths == jpaths
    for path, t, j in zip(tpaths, tl, jl):
        assert tuple(t.shape) == j.shape, path
        if np.abs(j).max():
            assert _rel(t.numpy(), j) <= TOL, path
        else:
            assert t.abs().max().item() == 0, path


@pytest.mark.parametrize("cache_dtype,decode_tol", [
    ("float32", TOL), ("bfloat16", BF16_CACHE_TOL)])
def test_prefill_and_decode_match_reference(cache_dtype, decode_tol):
    """prefill of the frames and a prompt, then STEPS decode steps: the
    logits, the stacked self-attention caches and the stored memory (in
    the cache's dtype; a bf16 memory is cast back to the param dtype by
    each decode step) leaf by leaf.  The prefill's logits within TOL at
    either cache dtype (its self-attention reads the fresh f32 K/V)."""
    jm, jp, tm, tp = _pair()
    frames, toks = _inputs(3)
    jdt = getattr(jnp, cache_dtype)
    tdt = getattr(torch, cache_dtype)
    jc = jm.init_caches(B, PROMPT + STEPS, enc_len=FRAMES, dtype=jdt)
    tc = tm.init_caches(B, PROMPT + STEPS, enc_len=FRAMES, dtype=tdt,
                        device="cpu")
    _compare_caches(tc, jc)
    jl, jc = jm.prefill(jp, {"frame_embeds": jnp.asarray(frames),
                             "tokens": jnp.asarray(toks[:, :PROMPT])}, jc)
    tl, tc = tm.prefill(tp, {"frame_embeds": torch.from_numpy(frames),
                             "tokens": torch.from_numpy(toks[:, :PROMPT])},
                        tc)
    assert tc["memory"].dtype == tdt
    assert _rel(tl.numpy(), jl) <= TOL
    if cache_dtype == "float32":
        _compare_caches(tc, jc)
    for t in range(PROMPT, PROMPT + STEPS):
        jl, jc = jm.decode_step(jp, {"tokens": jnp.asarray(toks[:, t:t + 1])},
                                jc)
        tl, tc = tm.decode_step(
            tp, {"tokens": torch.from_numpy(toks[:, t:t + 1])}, tc)
        assert _rel(tl.numpy(), jl) <= decode_tol
    if cache_dtype == "float32":
        _compare_caches(tc, jc)
    else:
        assert _rel(tc["memory"].float().numpy(), np.asarray(
            jc["memory"].astype(jnp.float32))) <= BF16_CACHE_TOL
    assert tc["self"]["len"].tolist() == [[PROMPT + STEPS] * B] * 2


def test_logits_and_loss_match_reference():
    jm, jp, tm, tp = _pair()
    frames, toks = _inputs(4)
    labels = np.roll(toks, -1, axis=1)
    jb = {"frame_embeds": jnp.asarray(frames), "tokens": jnp.asarray(toks),
          "labels": jnp.asarray(labels)}
    tb = {"frame_embeds": torch.from_numpy(frames),
          "tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labels)}
    assert _rel(tm.logits(tp, tb).numpy(), jm.logits(jp, jb)) <= TOL
    jloss, jmet = jm.loss(jp, jb)
    tloss, tmet = tm.loss(tp, tb)
    assert set(tmet) == set(jmet) == {"nll", "loss"}
    assert abs(tloss.item() - float(jloss)) <= TOL * abs(float(jloss))


@pytest.mark.parametrize("arch", ["seamless-m4t-large-v2", "qwen2-vl-7b"])
def test_training_path_never_calls_the_flash_op(arch, monkeypatch):
    cfg = get_config(arch, reduced=True)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    rng = np.random.RandomState(0)
    if model.kind == "encdec":
        batch = {"frame_embeds": torch.from_numpy(
            (rng.randn(B, 20, 64) * 0.05).astype(np.float32)),
            "tokens": torch.from_numpy(rng.randint(0, 256, (B, 12)))}
    else:
        from repro_torch.models import frontends
        batch = frontends.vision_patch_embeds(torch.Generator().manual_seed(1),
                                              B, 12, cfg.d_model)
    batch["labels"] = torch.from_numpy(rng.randint(0, 256, (B, 12)))

    def refuse(*args, **kwargs):
        raise AssertionError("the training path called the forward-only "
                             "flash op")

    monkeypatch.setattr(flash_ops, "attention", refuse)
    loss, grads = model.loss_and_grads(params, batch)
    assert np.isfinite(loss.item())
    assert all(torch.isfinite(g).all() for g in flatten(grads)[0])
    with pytest.raises(AssertionError, match="forward-only"):
        model.logits(params, batch)


def test_refusals():
    """The depth cut refuses the enc-dec; both embeddings archs split over
    "model" (the enc-dec's self- and cross-attention by heads, its
    vocabulary in halves; qwen2-vl-7b's head alone, its inputs_embeds
    entering whole)."""
    cfg = get_config(ARCH)
    lay = S.layout(cfg, 2)
    assert (lay.heads, lay.kv_heads, lay.d_ff, lay.vocab) == (8, 8, 4096,
                                                              128103)
    local = build_model(cfg, model_parallel=2).local_cfg
    assert (local.attn.num_heads, local.cross.num_heads,
            local.vocab_size) == (8, 8, 128103)
    with pytest.raises(ValueError, match="encoder-decoder"):
        with_num_layers(cfg, 4)
    vl = get_config("qwen2-vl-7b")
    lay = S.layout(vl, 2)
    assert (lay.heads, lay.kv_heads, lay.vocab) == (14, 2, 76032)
    assert "embed" not in build_model(vl, model_parallel=2).abstract_params()
    assert not build_model(cfg).supports_chunked_prefill
    assert build_model(vl).supports_chunked_prefill
    assert build_model(cfg).kind == "encdec"
    assert build_model(vl).kind == "decoder"
