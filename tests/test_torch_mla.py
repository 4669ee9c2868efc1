"""The port's MLA (``models.mla``) and the families that come with it
(deepseek-v3-671b, nemotron-4-340b, mistral-large-123b) against the
reference, on the CPU.

- ``mla_forward`` materialized (the flash op's plain path, and the
  differentiable ``train_attention``), ``mla_forward(chunked=True)`` over
  two page chunks with ``valid_len``, and ``mla_decode`` over a ragged
  batch, against ``repro.models.mla`` on the same weights: outputs and
  caches within 1e-5 of the largest reference value (f32; the absorbed
  and materialized forms sum in different orders, so each is held to the
  reference's own form).
- The materialized one-shot at deepseek-v3's published head dims (dh_nope
  128, dh_rope 64, dh_v 128: flash at (192, 128)) with the flash op
  doing the tensor-core kernel's arithmetic
  (``ref.attention_bf16_products``) against the reference's f32
  ``mla_forward`` within ``BF16_PRODUCTS_TOL``.
- The paging probe classifies ``ckv``/``krope`` as token leaves and
  ``len`` as a state leaf, with the reference's axes and pool shapes.
- Reduced deepseek-v3 served through ``BatchScheduler``: greedy streams
  equal to the reference's scheduler at batch 3 and 8 (the port decodes
  one padded block of ``DECODE_ROWS`` = 8 rows, the reference every row
  at once); chunked and back-to-back prefill give the same streams.
- Reduced nemotron-4-340b and mistral-large-123b trained on (data 2,
  model 2) against the unsplit data-parallel run, 3 composed steps:
  losses within ``TP_LOSS_RTOL`` and gradient norms within
  ``TP_NORM_RTOL`` (the tolerances ``chip_smoke.py`` [train_tp] holds the
  card's bf16 model split to); nemotron's LayerNorm bias stays whole on
  every model rank and its squared-ReLU MLP splits ``w_up`` by columns
  and ``w_down`` by rows.
- MLA on a "model" axis is refused; ``params_from_numpy`` refuses a
  misshapen MTP leaf.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import build_model as jbuild_model
from repro.models import mla as JMLA
from repro.serve.engine import BatchScheduler as JaxScheduler
from repro.serve.engine import Request as JaxRequest
from repro.serve.engine import ServeCfg as JaxServeCfg
from repro.serve.paging import PagePool as JaxPagePool
from repro_torch.configs import get_config
from repro_torch.data import SyntheticLMDataset
from repro_torch.kernels.flash_attention import ref as flash_ref
from repro_torch.launch.train import build_session
from repro_torch.models import build_model
from repro_torch.models import mla as MLA
from repro_torch.models.convert import params_from_numpy
from repro_torch.optim import make_optimizer
from repro_torch.parallel import sharding
from repro_torch.runtime import substrate
from repro_torch.serve import BatchScheduler, Request, ServeCfg
from repro_torch.serve.paging import PagePool
from repro_torch.train import trainer
from repro_torch.tree import flatten, leaves, map_tree, unflatten

ARCH = "deepseek-v3-671b"
TOL = 1e-5
TP_LOSS_RTOL = 2e-3            # chip_smoke.py's [train_tp] tolerances
TP_NORM_RTOL = 5e-3
SERVE_LEN, SERVE_PT = 96, 32
# The one-shot through the tensor-core kernel's arithmetic (q, K, V and P
# rounded to bf16, about 2**-9 of each) against the reference's f32:
# the kernel's own tolerance (2**-6 of the largest value), carried
# through w_o.
BF16_PRODUCTS_TOL = 2.0 ** -6


def _rel(got, want) -> float:
    want = np.asarray(want, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - want).max()
                 / max(np.abs(want).max(), 1e-30))


@pytest.fixture(scope="module")
def mla_pair():
    """(reference MLACfg, its params, port MLACfg, the same params)."""
    jcfg = jget_config(ARCH, reduced=True).mla
    jp, _ = JMLA.init_mla(jax.random.PRNGKey(3), jcfg)
    tcfg = get_config(ARCH, reduced=True).mla
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    tp = map_tree(lambda a: torch.from_numpy(np.array(a)),
                  jax.device_get(jp))
    return jcfg, jp, tcfg, tp


def _x(seed, b, s, d=64):
    return np.random.RandomState(seed).randn(b, s, d).astype(np.float32)


def _caches(jcfg, tcfg, b, smax):
    return (JMLA.init_mla_cache(b, smax, jcfg, jnp.float32),
            MLA.init_mla_cache(b, smax, tcfg, torch.float32, "cpu"))


def _assert_caches(jc, tc):
    assert sorted(jc) == sorted(tc) == ["ckv", "krope", "len"]
    for k in jc:
        assert tuple(tc[k].shape) == tuple(jc[k].shape), k
        assert _rel(tc[k].numpy(), jc[k]) <= TOL, k


@pytest.mark.parametrize("train", [False, True])
def test_materialized_forward_matches_reference(mla_pair, train):
    """One-shot prefill into a cache (through the flash op's plain path)
    and the training form (``train_attention``, 2 key blocks of 8)."""
    jcfg, jp, tcfg, tp = mla_pair
    x = _x(0, 2, 13)
    jc, tc = _caches(jcfg, tcfg, 2, 16)
    jout, jc = JMLA.mla_forward(jp, jcfg, jnp.asarray(x), kv_cache=jc,
                                block_k=8)
    tout, tc = MLA.mla_forward(tp, tcfg, torch.from_numpy(x), kv_cache=tc,
                               train=train, block_k=8)
    assert _rel(tout.detach().numpy(), jout) <= TOL
    _assert_caches(jc, tc)


@pytest.fixture(scope="module")
def mla_published_pair():
    """MLA at deepseek-v3's published head dims (scores 128 + 64 = 192,
    values 128) at a narrow width: 4 heads, d_model 64, lora ranks 32."""
    kw = dict(d_model=64, num_heads=4, q_lora=32, kv_lora=32, dh_nope=128,
              dh_rope=64, dh_v=128)
    jcfg, tcfg = JMLA.MLACfg(**kw), MLA.MLACfg(**kw)
    jp, _ = JMLA.init_mla(jax.random.PRNGKey(5), jcfg)
    tp = map_tree(lambda a: torch.from_numpy(np.array(a)),
                  jax.device_get(jp))
    return jcfg, jp, tcfg, tp


def test_materialized_one_shot_at_published_head_dims(mla_published_pair,
                                                      monkeypatch):
    """``Model.prefill``'s MLA form at (192, 128): a 77-token one-shot
    (not a multiple of the kernel's 64-key tile) of 2 rows into a cache,
    the flash op replaced by the tensor-core kernel's arithmetic, which
    it runs on the card for a bf16 query."""
    jcfg, jp, tcfg, tp = mla_published_pair
    calls = []

    def bf16_products(q, k, v, **kw):
        calls.append((tuple(q.shape), tuple(v.shape)))
        return flash_ref.attention_bf16_products(q, k, v, **kw)

    monkeypatch.setattr(MLA.L, "flash_attention", bf16_products)
    x = _x(7, 2, 77)
    jc, tc = _caches(jcfg, tcfg, 2, 80)
    jout, jc = JMLA.mla_forward(jp, jcfg, jnp.asarray(x), kv_cache=jc)
    tout, tc = MLA.mla_forward(tp, tcfg, torch.from_numpy(x), kv_cache=tc)
    assert calls == [((2, 77, 4, 192), (2, 77, 4, 128))]
    assert _rel(tout.numpy(), jout) <= BF16_PRODUCTS_TOL
    _assert_caches(jc, tc)


def test_training_form_gradients_match_reference(mla_pair):
    """``train_attention`` with 24-dim scores against 16-dim values:
    gradients of every MLA weight and of x within 1e-4."""
    jcfg, jp, tcfg, tp = mla_pair
    x = _x(1, 2, 20)
    w = np.random.RandomState(2).randn(2, 20, 64).astype(np.float32)

    def jloss(p, xx):
        return jnp.sum(JMLA.mla_forward(p, jcfg, xx, block_k=8)[0] * w)

    jg, jgx = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    ps, paths = flatten(tp)
    xs = [p.clone().requires_grad_(True) for p in ps]
    xt = torch.from_numpy(x).requires_grad_(True)
    out, _ = MLA.mla_forward(unflatten(paths, xs), tcfg, xt, train=True,
                             block_k=8)
    grads = torch.autograd.grad((out * torch.from_numpy(w)).sum(),
                                xs + [xt])
    want, wpaths = flatten(jax.device_get(jg))
    assert wpaths == paths
    for path, a, g in zip(paths, want, grads[:-1]):
        assert _rel(g.numpy(), a) <= 1e-4, "/".join(path)
    assert _rel(grads[-1].numpy(), jgx) <= 1e-4


def test_chunked_prefill_matches_reference(mla_pair):
    """Two 8-token chunks of a 13-token prompt into a 16-token cache: the
    second right-padded, ``valid_len`` clamping the counter."""
    jcfg, jp, tcfg, tp = mla_pair
    x = _x(3, 1, 16)
    x[:, 13:] = 0.0
    jc, tc = _caches(jcfg, tcfg, 1, 16)
    for c, valid in enumerate((8, 13)):
        part = x[:, 8 * c:8 * (c + 1)]
        jout, jc = JMLA.mla_forward(
            jp, jcfg, jnp.asarray(part), q_offset=jnp.int32(8 * c),
            kv_cache=jc, chunked=True, valid_len=jnp.int32(valid))
        tout, tc = MLA.mla_forward(tp, tcfg, torch.from_numpy(part),
                                   q_offset=8 * c, kv_cache=tc, chunked=True,
                                   valid_len=valid)
        assert _rel(tout.numpy(), jout) <= TOL
        _assert_caches(jc, tc)
    assert tc["len"].tolist() == [13]


def test_decode_matches_reference_on_a_ragged_batch(mla_pair):
    jcfg, jp, tcfg, tp = mla_pair
    jc, tc = _caches(jcfg, tcfg, 2, 16)
    x = _x(4, 2, 9)
    _, jc = JMLA.mla_forward(jp, jcfg, jnp.asarray(x), kv_cache=jc)
    _, tc = MLA.mla_forward(tp, tcfg, torch.from_numpy(x), kv_cache=tc)
    lens = np.array([9, 6], np.int32)             # row 1 forgets 3
    jc = dict(jc, len=jnp.asarray(lens))
    tc = dict(tc, len=torch.from_numpy(lens))
    for step in range(3):
        xt = _x(10 + step, 2, 1)
        jout, jc = JMLA.mla_decode(jp, jcfg, jnp.asarray(xt), jc)
        tout, tc = MLA.mla_decode(tp, tcfg, torch.from_numpy(xt), tc)
        assert _rel(tout.numpy(), jout) <= TOL
        _assert_caches(jc, tc)
    assert tc["len"].tolist() == [12, 9]


# ---------------------------------------------------------------------------
# Paging and serving
# ---------------------------------------------------------------------------


def test_paging_probe_classifies_latent_cache_leaves():
    jcfg = JaxServeCfg(max_len=32, batch=3, cache_dtype=jnp.float32,
                       page_tokens=4)
    tcfg = ServeCfg(max_len=32, batch=3, cache_dtype=torch.float32,
                    page_tokens=4)
    jpool = JaxPagePool(jbuild_model(jget_config(ARCH, reduced=True)), jcfg)
    tpool = PagePool(build_model(get_config(ARCH, reduced=True)), tcfg,
                     device="cpu")
    kinds = {path[-1]: leaf.token_axis is not None
             for path, leaf in zip(tpool.layout.paths, tpool.layout.leaves)}
    assert kinds == {"ckv": True, "krope": True, "len": False}
    assert [(l.shape, l.batch_axis, l.token_axis)
            for l in jpool.layout.leaves] == [
        (l.shape, l.batch_axis, l.token_axis) for l in tpool.layout.leaves]
    assert [tuple(x.shape) for x in jpool.pool] == [
        tuple(x.shape) for x in tpool.pool]
    assert jpool.layout.page_bytes() == tpool.layout.page_bytes()


@pytest.fixture(scope="module")
def weights():
    """(reference model, its params, port model, the same params)."""
    jm = jbuild_model(jget_config(ARCH, reduced=True))
    jp = jax.jit(jm.init)(jax.random.PRNGKey(1))
    tm = build_model(get_config(ARCH, reduced=True))
    return jm, jp, tm, params_from_numpy(jax.device_get(jp), tm.cfg,
                                         device="cpu")


def _prompts(n, seed):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 256, size=rng.randint(5, 60)).tolist()
            for _ in range(n)]


def _serve(tm, tp, prompts, batch, **kw):
    cfg = ServeCfg(max_len=SERVE_LEN, batch=batch, cache_dtype=torch.float32,
                   page_tokens=SERVE_PT, **kw)
    sched = BatchScheduler(tm, tp, cfg, device="cpu")
    for rid, p in enumerate(prompts):
        sched.submit(Request(rid=rid, prompt=list(p), max_new=5))
    return sched, {r.rid: r.generated for r in sched.run()}


@pytest.mark.parametrize("batch", [3, 8])
def test_greedy_streams_match_reference(weights, batch):
    jm, jp, tm, tp = weights
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


def test_chunked_and_back_to_back_prefill_give_the_same_streams(weights):
    _, _, tm, tp = weights
    prompts = _prompts(5, seed=11)
    _, interleaved = _serve(tm, tp, prompts, 3, chunked_prefill=True)
    _, one_shot = _serve(tm, tp, prompts, 3, chunked_prefill=False)
    assert interleaved == one_shot


# ---------------------------------------------------------------------------
# The model split
# ---------------------------------------------------------------------------


def _train(arch, mesh, params):
    cfg = get_config(arch, reduced=True)
    model = build_model(cfg, model_parallel=dict(mesh.shape).get("model", 1))
    opt = make_optimizer("adamw", lr=1e-3)
    ds = SyntheticLMDataset(vocab_size=cfg.vocab_size, seq_len=32,
                            global_batch=4)
    tcfg = trainer.TrainCfg(sync_mode="composed")
    sess = build_session(mesh, model, opt, ds, tcfg)
    states = trainer.init_states(model, opt, map_tree(torch.clone, params),
                                 tcfg, mesh)
    step = trainer.make_train_step(model, opt, tcfg, comm=sess.world)
    losses, norms = [], []
    for i in range(3):
        states, metrics = step(states, ds.host_batch(i))
        losses.append(metrics["loss"].item())
        norms.append(metrics["grad_norm"].item())
    return model, states, losses, norms


@pytest.mark.parametrize("arch", ["nemotron-4-340b", "mistral-large-123b"])
def test_data_x_model_training_follows_the_unsplit_model(arch):
    params = build_model(get_config(arch, reduced=True)).init(
        torch.Generator().manual_seed(5))
    _, _, want_l, want_n = _train(
        arch, substrate.make_host_mesh(2, device="cpu"), params)
    model, states, got_l, got_n = _train(
        arch, substrate.make_host_mesh(2, model_parallel=2, device="cpu"),
        params)
    assert _rel(got_l, want_l) <= TP_LOSS_RTOL, (got_l, want_l)
    assert _rel(got_n, want_n) <= TP_NORM_RTOL, (got_n, want_n)
    assert want_l[-1] < want_l[0]
    paths = flatten(states[0]["params"])[1]
    lay = model.layout
    for path in paths:
        split = sharding.leaf_split(path, lay)
        if path[-2:] in (("mlp", "w_up"), ("mlp", "w_gate")):
            assert split == -1, path
        elif path[-2:] == ("mlp", "w_down"):
            assert split == -2, path
        elif path[-1] == "bias":
            assert split is None, path
    # every model rank holds the same whole norms (LayerNorm bias too)
    for path, a, b in zip(paths, leaves(states[0]["params"]),
                          leaves(states[1]["params"])):
        if sharding.leaf_split(path, lay) is None:
            assert torch.equal(a, b), path
    if arch == "nemotron-4-340b":
        assert any(p[-1] == "bias" for p in paths)


def test_mla_on_a_model_axis_splits_by_heads():
    model = build_model(get_config(ARCH, reduced=True), model_parallel=2)
    assert model.layout.mla_heads == 2
    assert model.local_cfg.mla.num_heads == 2
    p = model.abstract_params()["stage0"]["layer0"]["mla"]
    cfg = model.cfg.mla
    assert p["w_uq"].shape[-1] == 2 * cfg.dh_qk
    assert p["w_ukv"].shape[-1] == 2 * (cfg.dh_nope + cfg.dh_v)
    assert p["w_o"].shape[-2] == 2 * cfg.dh_v
    assert p["w_dkv"].shape[-1] == cfg.kv_lora        # the latent: whole


def test_params_from_numpy_checks_the_mtp_leaves(weights):
    jm, jp, tm, _ = weights
    tree = jax.device_get(jp)
    assert {"mtp_norm1", "mtp_norm2", "mtp_proj", "mtp_block"} <= set(tree)
    tree["mtp_proj"] = np.zeros((3, 3), np.float32)
    with pytest.raises(ValueError, match="mtp_proj"):
        params_from_numpy(tree, tm.cfg, device="cpu")
