"""The port's qwen2 model against the JAX package on the same weights.

The reference's reduced qwen2-72b (GQA 4/2, QKV bias, SwiGLU, 2 layers)
is initialised by JAX, carried into the port with ``params_from_numpy``,
and both packages run one-shot prefill, chunked prefill and decode on the
same tokens.  Logits and caches agree at float32 atol 1e-4 (the packages
sum in different orders through several layers).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import build_model as jax_build
from repro_torch.configs import get_config, with_num_layers
from repro_torch.models import build_model
from repro_torch.models.convert import params_from_numpy
from repro_torch.tree import flatten

ATOL = 1e-4
MAX_LEN = 32


@pytest.fixture(scope="module")
def pair():
    jm = jax_build(jax_config("qwen2-72b", reduced=True))
    jp = jm.init(jax.random.PRNGKey(0))
    tm = build_model(get_config("qwen2-72b", reduced=True))
    tp = params_from_numpy(jax.device_get(jp), tm.cfg, device="cpu")
    return jm, jp, tm, tp


def _caches(jm, tm, batch):
    return (jm.init_caches(batch, MAX_LEN, dtype=jnp.float32),
            tm.init_caches(batch, MAX_LEN, dtype=torch.float32,
                           device="cpu"))


def _assert_trees_close(jtree, ttree):
    jl, jpaths = flatten(jax.device_get(jtree))
    tl, tpaths = flatten(ttree)
    assert jpaths == tpaths
    for path, a, b in zip(jpaths, jl, tl):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=ATOL,
                                   rtol=0, err_msg="/".join(path))


def _tokens(seed, shape):
    return np.random.RandomState(seed).randint(0, 256, size=shape)


def test_prefill_logits_and_caches_match(pair):
    jm, jp, tm, tp = pair
    toks = _tokens(0, (2, 11))
    jc, tc = _caches(jm, tm, 2)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks, jnp.int32)}, jc)
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks)}, tc)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=0)
    _assert_trees_close(jc, tc)


def test_prefill_chunks_match(pair):
    """Two 8-token chunks of a 13-token prompt: the second right-padded,
    ``valid_len`` clamping the counters, ``last_index`` picking the
    prompt's last token."""
    jm, jp, tm, tp = pair
    prompt = _tokens(1, (13,))
    jc, tc = _caches(jm, tm, 1)
    for c, (valid_len, last) in enumerate([(8, 7), (13, 4)]):
        chunk = np.zeros((1, 8), np.int64)
        part = prompt[c * 8:(c + 1) * 8]
        chunk[0, :len(part)] = part
        jl, jc = jm.prefill_chunk(
            jp, {"tokens": jnp.asarray(chunk, jnp.int32)}, jc,
            q_offset=jnp.int32(c * 8), valid_len=jnp.int32(valid_len),
            last_index=jnp.int32(last))
        tl, tc = tm.prefill_chunk(
            tp, {"tokens": torch.from_numpy(chunk)}, tc, q_offset=c * 8,
            valid_len=valid_len, last_index=last)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL,
                                   rtol=0)
        _assert_trees_close(jc, tc)


def test_decode_steps_match(pair):
    """Ragged batch: rows prefilled to different lengths, then three
    decode steps each write at their own position."""
    jm, jp, tm, tp = pair
    jc, tc = _caches(jm, tm, 2)
    toks = _tokens(2, (2, 9))
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks, jnp.int32)}, jc)
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks)}, tc)
    # make the batch ragged: row 1 forgets its last 3 positions
    for stage in ("stage0",):
        lens = np.asarray(jc[stage]["layer0"]["len"]).copy()
        lens[:, 1] -= 3
        jc[stage]["layer0"]["len"] = jnp.asarray(lens)
        tc[stage]["layer0"]["len"] = torch.from_numpy(lens)
    for step in range(3):
        nxt = _tokens(10 + step, (2, 1))
        jl, jc = jm.decode_step(jp, {"tokens": jnp.asarray(nxt, jnp.int32)},
                                jc)
        tl, tc = tm.decode_step(tp, {"tokens": torch.from_numpy(nxt)}, tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL,
                                   rtol=0)
        _assert_trees_close(jc, tc)


def test_param_tree_and_count_match_reference(pair):
    jm, jp, tm, tp = pair
    assert tm.param_count() == jm.param_count()
    _, jpaths = flatten(jax.device_get(jp))
    assert flatten(tm.init(torch.Generator().manual_seed(0)))[1] == jpaths


def test_params_from_numpy_rejects_a_misshapen_tree(pair):
    jm, jp, tm, tp = pair
    tree = jax.device_get(jp)
    tree["lm_head"] = np.zeros((3, 3), np.float32)
    with pytest.raises(ValueError, match="lm_head"):
        params_from_numpy(tree, tm.cfg, device="cpu")
    del tree["lm_head"]
    with pytest.raises(ValueError, match="missing"):
        params_from_numpy(tree, tm.cfg, device="cpu")


def test_depth_cut_keeps_published_widths():
    full = get_config("qwen2-72b")
    cut = with_num_layers(full, 4)
    assert cut.num_layers == 4 and cut.stages[0].repeat == 4
    assert (cut.d_model, cut.vocab_size, cut.attn, cut.mlp) == \
        (full.d_model, full.vocab_size, full.attn, full.mlp)
    per_layer = (build_model(full).param_count()
                 - build_model(cut).param_count()) // 76
    assert build_model(cut).param_count() == \
        2 * 152_064 * 8_192 + 8_192 + 4 * per_layer
    with pytest.raises(ValueError):
        with_num_layers(full, 81)


def test_cuda_entry_points_raise_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the no-CUDA refusal")
    tm = build_model(get_config("qwen2-72b", reduced=True))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tm.init_caches(1, 8, dtype=torch.float32)
