"""The port's Mamba2 block (``models.mamba``) and the state-space families
(mamba2-1.3b, jamba-1.5-large-398b) against the reference, on the CPU.

- ``ssd_chunked`` with and without an initial state (y and the final
  state), ``_causal_conv`` with and without a tail, ``mamba_forward``
  over a cache (output, conv tail, state) and three ``mamba_decode``
  steps after it, against ``repro.models.mamba`` on the same weights and
  inputs from a seed, in f32: within 1e-5 of the largest reference
  value.  The gradients of ``mamba_forward``'s output with respect to
  every parameter within 1e-4.
- Refusals: both packages refuse a sequence length that is not a
  multiple of the SSD chunk (the reference asserts, the port raises a
  ``ValueError``); a chunked call on a Mamba layer raises; a model with
  Mamba layers does not split over "model".  ``supports_chunked_prefill``
  is False for both families and True for the others.
- Serving: the port's ``BatchScheduler`` against the reference's
  scheduler on reduced mamba2 and jamba, at batch 3 and 8 with prompts
  of multiples of 8 tokens: equal greedy streams.  mamba2's pool holds
  no token leaf (zero-byte pages, still counted and freed), an
  overcommitted pool parks and resumes its state, the ``ssm`` leaf stays
  f32 under a bf16 cache, and a request admitted into a slot starts
  from a zeroed state.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import build_model as jbuild_model
from repro.models import mamba as JM
from repro.models import transformer as JT
from repro.serve.engine import BatchScheduler as JaxScheduler
from repro.serve.engine import Request as JaxRequest
from repro.serve.engine import ServeCfg as JaxServeCfg
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.models import build_model
from repro_torch.models import mamba as M
from repro_torch.models import transformer as T
from repro_torch.models.convert import params_from_numpy
from repro_torch.serve import BatchScheduler, Request, ServeCfg
from repro_torch.serve.paging import PagePool
from repro_torch.tree import flatten, map_tree, unflatten

TOL = 1e-5
GRAD_TOL = 1e-4
SSM_ARCHS = ("mamba2-1.3b", "jamba-1.5-large-398b")
SERVE_LEN, SERVE_PT = 96, 32


def _rel(got, want) -> float:
    want = np.asarray(want, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - want).max()
                 / max(np.abs(want).max(), 1e-30))


@pytest.fixture(scope="module")
def block():
    """(reference MambaCfg, its params, port MambaCfg, the same params):
    reduced mamba2's block."""
    jcfg = jget_config("mamba2-1.3b", reduced=True).mamba
    jp, _ = JM.init_mamba(jax.random.PRNGKey(3), jcfg)
    tcfg = get_config("mamba2-1.3b", reduced=True).mamba
    fields = dataclasses.asdict(tcfg)
    assert fields.pop("head_shards") == 1       # the port's: no model axis
    assert fields == dataclasses.asdict(jcfg)
    tp = map_tree(lambda a: torch.from_numpy(np.array(a)),
                  jax.device_get(jp))
    return jcfg, jp, tcfg, tp


def _randn(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def test_init_gives_the_reference_tree_and_dtypes(block):
    jcfg, jp, tcfg, _ = block
    for dtype, jdtype in ((torch.bfloat16, jnp.bfloat16),
                          (torch.float32, jnp.float32)):
        tp = M.init_mamba(torch.Generator().manual_seed(0), tcfg, dtype,
                          "cpu", (2,))
        want = jax.eval_shape(lambda k: JM.init_mamba(k, jcfg, jdtype)[0],
                              jax.random.PRNGKey(0))
        got, paths = flatten(tp)
        ref, ref_paths = flatten(want)
        assert paths == ref_paths
        for path, g, w in zip(paths, got, ref):
            assert tuple(g.shape) == (2,) + tuple(w.shape), path
            assert str(g.dtype).split(".")[-1] == str(w.dtype), path
    # the constants are the reference's
    tp = M.init_mamba(torch.Generator().manual_seed(0), tcfg, torch.float32,
                      "cpu")
    for k in ("A_log", "D", "conv_b"):
        assert _rel(tp[k].numpy(), jp[k]) <= 1e-7, k


@pytest.mark.parametrize("with_h0", [False, True])
def test_ssd_chunked_matches_reference(with_h0):
    b, s, h, p, g, n, q = 2, 24, 4, 8, 2, 6, 8
    x, bm, cm = _randn(0, b, s, h, p), _randn(1, b, s, g, n), \
        _randn(2, b, s, g, n)
    dt = np.abs(_randn(3, b, s, h)) * 0.5
    a = -np.exp(_randn(4, h))
    h0 = _randn(5, b, h, p, n) if with_h0 else None
    jy, jh = JM.ssd_chunked(*(jnp.asarray(t) for t in (x, dt, a, bm, cm)),
                            q, None if h0 is None else jnp.asarray(h0))
    ty, th = M.ssd_chunked(*(torch.from_numpy(t) for t in (x, dt, a, bm,
                                                          cm)),
                           q, None if h0 is None else torch.from_numpy(h0))
    assert th.dtype == torch.float32
    assert _rel(ty.numpy(), jy) <= TOL
    assert _rel(th.numpy(), jh) <= TOL


@pytest.mark.parametrize("with_tail", [False, True])
def test_causal_conv_matches_reference(block, with_tail):
    jcfg, jp, tcfg, tp = block
    c = tcfg.conv_channels
    xbc = _randn(6, 2, 16, c)
    tail = _randn(7, 2, tcfg.d_conv - 1, c) if with_tail else None
    want = JM._causal_conv(jnp.asarray(xbc), jp["conv_w"], jp["conv_b"],
                           None if tail is None else jnp.asarray(tail))
    got = M._causal_conv(torch.from_numpy(xbc), tp["conv_w"], tp["conv_b"],
                         None if tail is None else torch.from_numpy(tail))
    assert _rel(got.numpy(), want) <= TOL


def test_forward_over_a_cache_then_decode_match_reference(block):
    jcfg, jp, tcfg, tp = block
    b = 3
    jc = JM.init_mamba_cache(b, jcfg, jnp.float32)
    tc = M.init_mamba_cache(b, tcfg, torch.float32, "cpu")
    # a first segment leaves a conv tail and a state behind
    for seed in (8, 9):
        x = _randn(seed, b, 16, tcfg.d_model)
        jo, jc = JM.mamba_forward(jp, jcfg, jnp.asarray(x), cache=jc)
        to, tc = M.mamba_forward(tp, tcfg, torch.from_numpy(x), cache=tc)
        assert _rel(to.numpy(), jo) <= TOL
        assert sorted(tc) == sorted(jc) == ["conv", "ssm"]
        for k in jc:
            assert tuple(tc[k].shape) == tuple(jc[k].shape), k
            assert _rel(tc[k].numpy(), jc[k]) <= TOL, k
    for t in range(3):
        x = _randn(10 + t, b, 1, tcfg.d_model)
        jo, jc = JM.mamba_decode(jp, jcfg, jnp.asarray(x), jc)
        to, tc = M.mamba_decode(tp, tcfg, torch.from_numpy(x), tc)
        assert _rel(to.numpy(), jo) <= TOL, t
        for k in jc:
            assert _rel(tc[k].numpy(), jc[k]) <= TOL, (t, k)


def test_forward_gradients_match_reference(block):
    jcfg, jp, tcfg, tp = block
    x = _randn(20, 2, 16, tcfg.d_model)
    ct = _randn(21, 2, 16, tcfg.d_model)

    def jloss(p):
        return jnp.sum(JM.mamba_forward(p, jcfg, jnp.asarray(x))[0]
                       * jnp.asarray(ct))

    jg = jax.device_get(jax.grad(jloss)(jp))
    ps, paths = flatten(tp)
    xs = [t.detach().clone().requires_grad_(True) for t in ps]
    out, _ = M.mamba_forward(unflatten(paths, xs), tcfg, torch.from_numpy(x))
    grads = torch.autograd.grad((out * torch.from_numpy(ct)).sum(), xs)
    want, want_paths = flatten(jg)
    assert want_paths == paths
    for path, w, g in zip(paths, want, grads):
        assert _rel(g.numpy(), w) <= GRAD_TOL, "/".join(path)


def test_both_packages_refuse_a_length_off_the_chunk(block):
    jcfg, jp, tcfg, tp = block
    x = _randn(30, 1, 5, tcfg.d_model)
    with pytest.raises(AssertionError):
        JM.mamba_forward(jp, jcfg, jnp.asarray(x))
    with pytest.raises(ValueError, match="not a multiple of the SSD chunk"):
        M.mamba_forward(tp, tcfg, torch.from_numpy(x))


def test_chunked_calls_are_refused_and_the_model_axis_splits_heads():
    cfg = get_config("jamba-1.5-large-398b", reduced=True)
    spec = cfg.stages[0].layers[1]
    assert spec.mixer == "mamba"
    p = T.init_layer(torch.Generator().manual_seed(0), cfg, spec, "cpu")
    cache = M.init_mamba_cache(1, cfg.mamba, torch.float32, "cpu")
    x = torch.zeros(1, 8, cfg.d_model)
    with pytest.raises(ValueError, match="no chunked-prefill path"):
        T.apply_layer(p, cfg, spec, x, cache=cache, chunked=True,
                      valid_len=8)
    jcfg = jget_config("jamba-1.5-large-398b", reduced=True)
    jspec = jcfg.stages[0].layers[1]
    jp, _ = JT.init_layer(jax.random.PRNGKey(0), jcfg, jspec)
    with pytest.raises(ValueError, match="no chunked-prefill path"):
        JT.apply_layer(jp, jcfg, jspec, jnp.zeros((1, 8, cfg.d_model)),
                       cache=JM.init_mamba_cache(1, jcfg.mamba, jnp.float32),
                       chunked=True, valid_len=8)
    for arch in SSM_ARCHS:
        model = build_model(get_config(arch, reduced=True), model_parallel=2)
        m = model.local_cfg.mamba
        assert (m.head_shards, m.nheads, m.d_inner, m.d_bc) == (2, 4, 64, 8)
        assert dict(model.layout.sections)["in_proj"] == (128, 128, 16, 16,
                                                          8)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_supports_chunked_prefill_follows_the_mixers(arch):
    cfg = get_config(arch, reduced=True)
    # the state-space archs and the encoder-decoder prefill one-shot
    assert build_model(cfg).supports_chunked_prefill == (
        arch not in SSM_ARCHS and arch != "seamless-m4t-large-v2")
    assert (build_model(cfg).supports_chunked_prefill
            == jbuild_model(jget_config(arch, reduced=True))
            .supports_chunked_prefill)


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", params=SSM_ARCHS)
def weights(request):
    """(arch, reference model, its params, port model, the same
    params)."""
    arch = request.param
    jm = jbuild_model(jget_config(arch, reduced=True))
    jp = jax.jit(jm.init)(jax.random.PRNGKey(1))
    tm = build_model(get_config(arch, reduced=True))
    return arch, jm, jp, tm, params_from_numpy(jax.device_get(jp), tm.cfg,
                                               device="cpu")


def _prompts(n, seed):
    """Prompts of 8-48 tokens: multiples of the reduced SSD chunk."""
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 256, size=8 * rng.randint(1, 7)).tolist()
            for _ in range(n)]


def _serve(tm, tp, prompts, batch, max_new=5, **kw):
    cfg = ServeCfg(max_len=SERVE_LEN, batch=batch,
                   cache_dtype=kw.pop("cache_dtype", torch.float32),
                   page_tokens=SERVE_PT, **kw)
    sched = BatchScheduler(tm, tp, cfg, device="cpu")
    for rid, p in enumerate(prompts):
        sched.submit(Request(rid=rid, prompt=list(p), max_new=max_new))
    return sched, {r.rid: r.generated for r in sched.run()}


@pytest.mark.parametrize("batch", [3, 8])
def test_greedy_streams_match_reference(weights, batch):
    _, jm, jp, tm, tp = weights
    prompts = _prompts(batch + 2, seed=batch)
    jcfg = JaxServeCfg(max_len=SERVE_LEN, batch=batch,
                       cache_dtype=jnp.float32, page_tokens=SERVE_PT)
    jsched = JaxScheduler(jm, jp, jcfg)
    for rid, p in enumerate(prompts):
        jsched.submit(JaxRequest(rid=rid, prompt=list(p), max_new=5))
    want = {r.rid: r.generated for r in jsched.run()}
    sched, got = _serve(tm, tp, prompts, batch)
    assert got == want
    assert not sched.shed and sched.pool.pages_allocated == 0
    sched.pool.check_integrity()


def test_mamba2_pool_has_no_token_leaf():
    tm = build_model(get_config("mamba2-1.3b", reduced=True))
    pool = PagePool(tm, ServeCfg(max_len=SERVE_LEN, batch=3,
                                 cache_dtype=torch.float32,
                                 page_tokens=SERVE_PT), device="cpu")
    lay = pool.layout
    assert lay.token_leaf_ids == [] and pool.pool == []
    assert lay.page_bytes() == 0 and lay.row_bytes() == 0
    assert {p[-1]: (l.shape, l.batch_axis) for p, l in
            zip(lay.paths, lay.leaves)} == {
        "conv": ((3, 1, 3, 160), 1), "ssm": ((3, 1, 8, 16, 16), 1)}
    assert [tuple(s.shape) for s in pool.state] == [(3, 3, 3, 160),
                                                    (3, 3, 8, 16, 16)]
    # zero-byte pages are still allocated, counted and freed
    assert pool.has_room(SERVE_LEN * 3) and not pool.has_room(
        SERVE_LEN * 3 + 1)
    pool.splice_row(0, 1, tm.init_caches(1, SERVE_LEN, dtype=torch.float32,
                                         device="cpu"), 40)
    assert pool.pages_allocated == 2 and pool.resident_bytes() == \
        pool.contiguous_bytes(0)
    pool.check_integrity()
    assert pool.release(0) == 2 and pool.pages_free == pool.pages_total


def test_overcommitted_pool_parks_and_resumes_the_state(weights):
    _, _, _, tm, tp = weights
    prompts = _prompts(5, seed=13)
    _, want = _serve(tm, tp, prompts, 3, max_new=12)
    sched, got = _serve(tm, tp, prompts, 3, max_new=12, pool_pages=4)
    assert got == want
    sched.pool.check_integrity()


def test_ssm_leaf_stays_f32_under_a_bf16_cache(weights):
    arch, _, _, tm, tp = weights
    pool = PagePool(tm, ServeCfg(max_len=SERVE_LEN, batch=3,
                                 cache_dtype=torch.bfloat16,
                                 page_tokens=SERVE_PT), device="cpu")
    dtypes = {p[-1]: s.dtype for p, s in zip(
        [pool.layout.paths[i] for i in pool.layout.state_leaf_ids],
        pool.state)}
    assert dtypes["ssm"] == torch.float32 and dtypes["conv"] == \
        torch.bfloat16
    assert all(s.dtype == torch.float32 for s, i in zip(
        pool.fresh_state1(), pool.layout.state_leaf_ids)
        if pool.layout.paths[i][-1] == "ssm")
    # and a bf16-cache run serves every request
    sched, got = _serve(tm, tp, _prompts(4, seed=3), 3,
                        cache_dtype=torch.bfloat16)
    assert len(got) == 4 and all(len(t) == 5 for t in got.values())
    assert all(s.dtype == torch.float32 for s, i in zip(
        sched.pool.state, sched.pool.layout.state_leaf_ids)
        if sched.pool.layout.paths[i][-1] == "ssm")


def test_admission_starts_from_a_zeroed_state(weights):
    _, _, _, tm, tp = weights
    first, second = _prompts(2, seed=17)
    # one slot: the second request takes the slot the first leaves
    sched, got = _serve(tm, tp, [first, second], 1)
    _, alone = _serve(tm, tp, [second], 1)
    assert got[1] == alone[0]
    pool = sched.pool
    assert all(not t.any() for t in pool.fresh_state1())
    # the slot's state after admission is the prompt's own prefill
    sched = BatchScheduler(tm, tp, dataclasses.replace(
        sched.cfg), device="cpu")
    sched.pool.state = [torch.full_like(s, 7.0) for s in sched.pool.state]
    sched.submit(Request(rid=0, prompt=second, max_new=3))
    caches = tm.init_caches(1, SERVE_LEN, dtype=torch.float32, device="cpu")
    _, caches = tm.prefill(tp, {"tokens": torch.tensor([second])}, caches)
    flat, _ = flatten(caches)
    for got_state, i in zip(sched.pool.read_state(0),
                            sched.pool.layout.state_leaf_ids):
        assert torch.equal(got_state, flat[i]), sched.pool.layout.paths[i]
