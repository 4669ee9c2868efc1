"""The port's mixture-of-experts family (qwen3-moe-30b-a3b) against the
reference, on the CPU.

- Routing against ``repro.models.moe.route`` on seeded inputs, with
  drops (``capacity_factor`` 0.5) and without: ``top_idx``, ``pos`` and
  ``keep`` bit-equal, ``top_vals`` and ``aux`` within 1e-6 relative.
  Pad tokens after the real ones (a serving chunk's tail) cannot take a
  real token's slot.
- ``moe_forward`` in f32 within 1e-5 of the reference's (qwen3's
  softmax routing, and deepseek-v3's sigmoid routing with a shared
  expert); an attention layer with qwen3's per-head q/k norm within
  1e-5, its cache holding the normed k.
- The reduced model from the reference's weights (``params_from_numpy``,
  the router kept f32): logits and ``nll`` / ``aux`` / ``loss`` within
  1e-4, every gradient within 1e-4 of the largest value.
- Serving: prefill + decode against the teacher-forced forward
  (``capacity_factor`` 8, the reference's twin test); greedy streams
  equal the reference's scheduler at batch 3 and 8 over 32-token pages
  (a chunk's capacity 16 can drop); decode rows bit-equal at batch 8
  and 4 (a decode block of 8 rows has capacity 8: nothing drops).
- Training: 5 composed steps on 2 ranks within 1e-4 of the reference's
  (one JAX child with host devices), compressed within 1e-3 of its;
  bucketed, overlapped and ZeRO-1 (``clip_norm`` 0) give the composed
  run's bits, ``auto`` within 1e-4 of composed.
- Expert parallelism over "model": on (data 2, model 2) each rank's loss
  within 1e-5 of the unsplit model's on its rows and every gradient (the
  router's too) within 1e-5; the router's gradient is bit-equal across
  model ranks; 5 training steps with ``check_model_replicas`` within
  1e-5 of the data-parallel run.  ``leaf_split`` splits the experts
  (dim -3), not ``d_ff``; shard / unshard round-trip.
- ``moe_forward_ep`` on p = 2 and 4 thread ranks under a composed
  session (its planned all-to-all) within 1e-6 of the reference's under
  ``shard_map`` with ``lax.all_to_all``.
- ``param_count`` of the full config within 2% of 30.5e9; the launchers
  run the reduced config on the CPU; other mixers and FFNs are refused.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import run_subprocess_script
from repro.configs import get_config as jget_config
from repro.models import build_model as jbuild_model
from repro.models import layers as JL
from repro.models import moe as JM
from repro.serve.engine import BatchScheduler as JaxScheduler
from repro.serve.engine import Request as JaxRequest
from repro.serve.engine import ServeCfg as JaxServeCfg
from repro_torch.comm import Session, collectives
from repro_torch.configs import get_config
from repro_torch.core import plan as plan_mod
from repro_torch.core import registry
from repro_torch.data import SyntheticLMDataset
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train as launch_train
from repro_torch.launch.train import build_session
from repro_torch.models import build_model
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import transformer as T
from repro_torch.models.convert import params_from_numpy
from repro_torch.optim import cosine_schedule, make_optimizer
from repro_torch.parallel import sharding
from repro_torch.runtime import substrate
from repro_torch.serve import BatchScheduler, Request, ServeCfg
from repro_torch.serve.engine import DECODE_ROWS
from repro_torch.train import trainer
from repro_torch.tree import flatten, leaves, unflatten

ARCH = "qwen3-moe-30b-a3b"
SEQ, BATCH, STEPS, RANKS = 32, 4, 5, 2


def _rel_err(got, want) -> float:
    want = np.asarray(want, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - want).max()
                 / max(np.abs(want).max(), 1e-30))


def _batch(seed=0, rows=BATCH, vocab=256):
    return SyntheticLMDataset(vocab_size=vocab, seq_len=SEQ,
                              global_batch=rows).host_batch(seed)


def _torch_batch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


@pytest.fixture(scope="module")
def weights():
    """(reference model, its params, port model, the same params)."""
    jm = jbuild_model(jget_config(ARCH, reduced=True))
    jp = jax.jit(jm.init)(jax.random.PRNGKey(1))
    tm = build_model(get_config(ARCH, reduced=True))
    return jm, jp, tm, params_from_numpy(jax.device_get(jp), tm.cfg,
                                         device="cpu")


# ---------------------------------------------------------------------------
# Routing and the MoE layer
# ---------------------------------------------------------------------------

def _moe_inputs(seed, T_=48, D=16, E=8, Fd=8, shared=False):
    rng = np.random.RandomState(seed)
    p = {"router": rng.randn(D, E).astype(np.float32) * 0.3,
         "w_gate": rng.randn(E, D, Fd).astype(np.float32) * 0.25,
         "w_up": rng.randn(E, D, Fd).astype(np.float32) * 0.25,
         "w_down": rng.randn(E, Fd, D).astype(np.float32) * 0.35}
    if shared:
        p["shared"] = {k: rng.randn(*s).astype(np.float32) * 0.25
                       for k, s in (("w_gate", (D, Fd)), ("w_up", (D, Fd)),
                                    ("w_down", (Fd, D)))}
    return p, rng.randn(T_, D).astype(np.float32)


def _cfgs(cf, **kw):
    c = dict(d_model=16, d_ff=8, num_experts=8, top_k=2,
             capacity_factor=cf, **kw)
    return JM.MoECfg(**c), M.MoECfg(**c)


def _port_tree(tree):
    fl, paths = flatten(tree)
    return unflatten(paths, [torch.from_numpy(np.asarray(a)) for a in fl])


@pytest.mark.parametrize("cf,drops", [(0.5, True), (8.0, False)],
                         ids=["drops", "no-drops"])
def test_route_matches_reference(cf, drops):
    jcfg, tcfg = _cfgs(cf)
    p, x = _moe_inputs(1)
    C = JM.capacity_of(x.shape[0], jcfg)
    assert M.capacity_of(x.shape[0], tcfg) == C
    want = JM.route(jnp.asarray(x), jnp.asarray(p["router"]), jcfg, C)
    got = M.route(torch.from_numpy(x), torch.from_numpy(p["router"]), tcfg,
                  C)
    names = ("top_idx", "top_vals", "pos", "keep", "aux")
    for name, w, g in zip(names, want, got):
        w, g = np.asarray(w), g.numpy()
        if name in ("top_vals", "aux"):
            assert _rel_err(g, w) <= 1e-6, name
        else:
            np.testing.assert_array_equal(g.astype(w.dtype), w, name)
    assert bool((~got[3]).any()) == drops


def test_pad_tokens_after_the_real_ones_keep_every_real_slot():
    """A serving chunk's pad tail comes after its real tokens in the
    token-major order, so the real tokens' positions and drops are those
    of the real tokens routed alone at the chunk's capacity."""
    _, tcfg = _cfgs(0.5)
    p, x = _moe_inputs(2, T_=40)
    router = torch.from_numpy(p["router"])
    real = torch.from_numpy(x[:25])
    pad = torch.from_numpy(np.repeat(x[39:40], 15, axis=0))   # token 0's
    C = M.capacity_of(40, tcfg)
    whole = M.route(torch.cat([real, pad]), router, tcfg, C)
    alone = M.route(real, router, tcfg, C)
    for a, b in zip(whole[:4], alone[:4]):
        assert torch.equal(a[:25], b)


def test_decode_blocks_never_drop():
    """A decode block of DECODE_ROWS rows: capacity >= its tokens, for
    the full and the reduced config (each token picks an expert once)."""
    for reduced in (False, True):
        moe = get_config(ARCH, reduced=reduced).moe
        assert M.capacity_of(DECODE_ROWS, moe) >= DECODE_ROWS
    assert M.capacity_of(256, get_config(ARCH).moe) == 24   # can drop


@pytest.mark.parametrize("cf,kw", [
    (1.25, {}), (0.5, {}),
    (1.25, {"num_shared": 1, "shared_d_ff": 8, "scoring": "sigmoid"})],
    ids=["qwen3", "qwen3-drops", "deepseek-style"])
def test_moe_forward_matches_reference(cf, kw):
    jcfg, tcfg = _cfgs(cf, **kw)
    p, x = _moe_inputs(3, shared=bool(kw))
    x3 = x.reshape(4, 12, 16)
    wy, waux = JM.moe_forward(jax.tree_util.tree_map(jnp.asarray, p), jcfg,
                              jnp.asarray(x3))
    ty, taux = M.moe_forward(_port_tree(p), tcfg, torch.from_numpy(x3))
    assert _rel_err(ty.numpy(), wy) <= 1e-5
    assert _rel_err(taux.item(), float(waux)) <= 1e-6


def test_moe_refuses_other_activations():
    cfg = M.MoECfg(d_model=8, d_ff=4, num_experts=4, top_k=1,
                   activation="gelu")
    with pytest.raises(NotImplementedError, match="gelu"):
        M.init_moe(None, cfg, torch.float32, "meta")


def test_qk_norm_attention_layer_matches_reference():
    jcfg = JL.AttentionCfg(d_model=32, num_heads=4, num_kv_heads=2,
                           head_dim=8, qk_norm=True, rope_theta=1e6)
    tcfg = L.AttentionCfg(d_model=32, num_heads=4, num_kv_heads=2,
                          head_dim=8, qk_norm=True, rope_theta=1e6)
    rng = np.random.RandomState(4)
    p = {"wq": rng.randn(32, 32), "wk": rng.randn(32, 16),
         "wv": rng.randn(32, 16), "wo": rng.randn(32, 32),
         "q_norm": {"scale": 1 + rng.rand(8)},
         "k_norm": {"scale": 1 + rng.rand(8)}}
    p = unflatten(flatten(p)[1], [(a * 0.2).astype(np.float32)
                                  for a in flatten(p)[0]])
    assert sorted(flatten(JL.init_attention(jax.random.PRNGKey(0),
                                            jcfg)[0])[1]) == \
        sorted(flatten(p)[1])
    x = rng.randn(2, 10, 32).astype(np.float32)
    jc = JL.init_kv_cache(2, 16, jcfg, jnp.float32)
    wout, wcache = jax.jit(lambda p_, x_, c_: JL.attention_forward(
        p_, jcfg, x_, kv_cache=c_))(jax.tree_util.tree_map(jnp.asarray, p),
                                    jnp.asarray(x), jc)
    tc = L.init_kv_cache(2, 16, tcfg, torch.float32, "cpu")
    tout, tcache = L.attention_forward(_port_tree(p), tcfg,
                                       torch.from_numpy(x), kv_cache=tc)
    assert _rel_err(tout.numpy(), wout) <= 1e-5
    for k in ("k", "v"):
        assert _rel_err(tcache[k].numpy(), wcache[k]) <= 1e-5, k


# ---------------------------------------------------------------------------
# The reduced model
# ---------------------------------------------------------------------------

def test_router_stays_f32_through_params_from_numpy():
    cfg = get_config(ARCH, reduced=True, param_dtype=torch.bfloat16)
    abstract = build_model(cfg).abstract_params()
    tree = unflatten(flatten(abstract)[1], [
        np.zeros(t.shape, np.float32) for t in leaves(abstract)])
    got = params_from_numpy(tree, cfg, device="cpu")
    for path, t in zip(flatten(got)[1], leaves(got)):
        want = torch.float32 if path[-1] == "router" else torch.bfloat16
        assert t.dtype == want, path
    init = build_model(cfg).init(torch.Generator().manual_seed(0))
    assert init["stage0"]["layer0"]["moe"]["router"].dtype == torch.float32


def test_full_param_count_matches_published():
    n = build_model(get_config(ARCH)).param_count()
    assert abs(n - 30.5e9) / 30.5e9 < 0.02, n


def test_reduced_logits_loss_and_grads_match_reference(weights):
    jm, jp, tm, tp = weights
    assert SEQ // tm.cfg.block_k >= 2
    b = _batch(seed=2, rows=2)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    jlogits = jax.jit(jm.logits)(jp, jb)
    h, _, _ = T.forward(tp, tm.cfg, _torch_batch(b))
    assert _rel_err(T._unembed(tp, tm.cfg, h).numpy(), jlogits) <= 1e-4
    (jloss, jmet), jgrads = jax.jit(jax.value_and_grad(
        jm.loss, has_aux=True))(jp, jb)
    ps, paths = flatten(tp)
    xs = [t.detach().requires_grad_(True) for t in ps]
    tloss, tmet = tm.loss(unflatten(paths, xs), _torch_batch(b))
    tgrads = torch.autograd.grad(tloss, xs)
    for k in ("nll", "aux", "loss"):
        assert _rel_err(tmet[k].item(), float(jmet[k] if k != "loss"
                                               else jloss)) <= 1e-4, k
    assert tmet["aux"].item() > 0
    jg, jpaths = flatten(jax.device_get(jgrads))
    assert jpaths == paths
    for path, a, g in zip(paths, jg, tgrads):
        assert _rel_err(g.numpy(), a) <= 1e-4, "/".join(path)


def test_prefill_and_decode_match_the_teacher_forced_forward():
    """The twin of ``test_archs.py::test_smoke_decode_matches_forward``
    (``capacity_factor`` 8 so drops do not depend on the token count)."""
    cfg = get_config(ARCH, reduced=True)
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=8.0))
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    toks = torch.from_numpy(np.random.RandomState(5).randint(
        0, 256, size=(2, 16)))
    h, _, _ = T.forward(params, cfg, {"tokens": toks})
    full = T._unembed(params, cfg, h)
    caches = model.init_caches(2, 24, dtype=torch.float32, device="cpu")
    lg, caches = model.prefill(params, {"tokens": toks[:, :8]}, caches)
    torch.testing.assert_close(lg, full[:, 7], rtol=1e-4, atol=1e-4)
    for t in range(8, 11):
        lg, caches = model.decode_step(params, {"tokens": toks[:, t:t + 1]},
                                       caches)
        torch.testing.assert_close(lg, full[:, t], rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------

SERVE_LEN, SERVE_PT = 96, 32


def _prompts(n, seed):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 256, size=rng.randint(5, 60)).tolist()
            for _ in range(n)]


def _serve(tm, tp, prompts, batch, max_new=5, **kw):
    cfg = ServeCfg(max_len=SERVE_LEN, batch=batch, cache_dtype=torch.float32,
                   page_tokens=SERVE_PT, **kw)
    sched = BatchScheduler(tm, tp, cfg, device="cpu")
    for rid, p in enumerate(prompts):
        sched.submit(Request(rid=rid, prompt=list(p), max_new=max_new))
    return sched, {r.rid: r.generated for r in sched.run()}


@pytest.mark.parametrize("batch", [3, 8])
def test_greedy_streams_match_reference(weights, batch):
    """At batch <= 8 the reference decodes every row at once (T = batch,
    capacity 8: nothing drops) and the port one block of 8 rows: the
    same streams.  Above 8 the reference's one decode forward can drop
    where the port's blocks do not (a departure by design)."""
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


def test_chunked_and_back_to_back_prefill_are_bit_identical(weights):
    _, _, tm, tp = weights
    prompts = _prompts(6, seed=11)
    _, interleaved = _serve(tm, tp, prompts, 3, chunked_prefill=True)
    _, one_shot = _serve(tm, tp, prompts, 3, chunked_prefill=False)
    assert interleaved == one_shot


def test_decode_rows_equal_at_batch_8_and_4(weights, monkeypatch):
    """Every decode row's logits bit for bit at batch 8 and as two
    batches of 4 (decoding slots only), and the same streams."""
    from repro_torch.serve import engine
    _, _, tm, tp = weights
    prompts = _prompts(8, seed=12)
    pick = engine._pick_tokens

    def run(rids, batch):
        rows, decoding = {}, []

        def recording(lg, cfg, rids_, pos):
            if decoding:
                take = decoding[0][:lg.shape[0]]
                del decoding[0][:lg.shape[0]]
                for j, key in enumerate(take):
                    if key is not None:
                        rows[key] = lg[j].clone()
            return pick(lg, cfg, rids_, pos)

        monkeypatch.setattr(engine, "_pick_tokens", recording)
        cfg = ServeCfg(max_len=SERVE_LEN, batch=batch,
                       cache_dtype=torch.float32, page_tokens=SERVE_PT)
        sched = BatchScheduler(tm, tp, cfg, device="cpu")
        run_decode = sched._decode

        def decode(params, tok, rids_, pos, slot_rids, active):
            decoding.append([(r, q) if a else None for r, a, q in zip(
                slot_rids, active, pos.tolist())])
            try:
                return run_decode(params, tok, rids_, pos, slot_rids,
                                  active)
            finally:
                decoding.pop()

        sched._decode = decode
        for r in rids:
            sched.submit(Request(rid=r, prompt=prompts[r], max_new=6))
        return {r.rid: r.generated for r in sched.run()}, rows

    s8, rows8 = run(range(8), 8)
    lo, rows_lo = run(range(4), 4)
    hi, rows_hi = run(range(4, 8), 4)
    assert s8 == {**lo, **hi}
    rows4 = {**rows_lo, **rows_hi}
    assert rows8.keys() == rows4.keys() and len(rows8) == 8 * 5
    for k in rows8:
        assert torch.equal(rows8[k], rows4[k]), k


# ---------------------------------------------------------------------------
# Training: data-parallel against the reference, expert parallelism
# ---------------------------------------------------------------------------

REFERENCE_CHILD = """
import functools, json, types
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as P
from repro.configs import get_config
from repro.data import SyntheticLMDataset
from repro.launch import train as lt
from repro.models import build_model
from repro.models import moe as M
from repro.optim import cosine_schedule, make_optimizer
from repro.parallel.sharding import named_shardings
from repro.runtime import substrate
from repro.train import trainer
STEPS, SEQ, BATCH, RANKS, PATH = {steps}, {seq}, {batch}, {ranks}, {path!r}
cfg = get_config({arch!r}, reduced=True)
model = build_model(cfg)
mesh = substrate.make_mesh((RANKS, 1), ("data", "model"),
                           devices=jax.devices()[:RANKS])
opt = make_optimizer("adamw", lr=cosine_schedule(
    1e-3, warmup=max(STEPS // 20, 1), total=STEPS))
ds = SyntheticLMDataset(vocab_size=cfg.vocab_size, seq_len=SEQ,
                        global_batch=BATCH)
params = model.init(jax.random.PRNGKey(0))
np.savez(PATH + "_weights.npz", **{{
    "/".join(str(k.key) for k in p): np.asarray(v)
    for p, v in jax.tree_util.tree_flatten_with_path(params)[0]}})
losses = {{}}
for sync in ("composed", "compressed"):
    args = types.SimpleNamespace(
        microbatches=1, sync=sync, bucket_grads=False,
        bucket_bytes=32 << 20, overlap=False, overlap_depth=2, zero=False)
    sess = lt.build_session(mesh, model, opt, ds, args)
    tcfg = trainer.TrainCfg(sync_mode=sync)
    step_fn = jax.jit(trainer.make_train_step(model, opt, tcfg, mesh=mesh,
                                              comm=sess.world))
    sspecs = trainer.state_specs(model, opt, tcfg, mesh=mesh)
    losses[sync] = []
    with substrate.set_mesh(mesh):
        state = trainer.make_train_state(model, opt, jax.random.PRNGKey(0),
                                         cfg=tcfg, mesh=mesh)
        state = jax.device_put(state, named_shardings(mesh, sspecs))
        for step in range(STEPS):
            state, m = step_fn(state, ds.sharded_batch(step, mesh))
            losses[sync].append(float(m["loss"]))

for p in (2, 4):
    mcfg = M.MoECfg(d_model=16, d_ff=8, num_experts=8, top_k=2,
                    capacity_factor=0.5)
    rng = np.random.RandomState(p)
    w = {{"router": rng.randn(16, 8).astype(np.float32) * 0.25,
          "w_gate": rng.randn(8, 16, 8).astype(np.float32) * 0.25,
          "w_up": rng.randn(8, 16, 8).astype(np.float32) * 0.25,
          "w_down": rng.randn(8, 8, 16).astype(np.float32) * 0.35}}
    x = rng.randn(4 * p, 8, 16).astype(np.float32)
    emesh = substrate.make_mesh((p,), ("x",), devices=jax.devices()[:p])

    def a2a(v, ax, s, c):
        return jax.lax.all_to_all(v, ax, s, c, tiled=True)

    @functools.partial(substrate.shard_map, mesh=emesh, in_specs=(
        {{"router": P(), "w_gate": P("x"), "w_up": P("x"),
          "w_down": P("x")}}, P("x")), out_specs=(P("x"), P("x")),
        axis_names={{"x"}}, check_vma=False)
    def block(pl, xl, p=p, mcfg=mcfg):
        y, aux = M.moe_forward_ep(pl, mcfg, xl, all_to_all=a2a, axis="x",
                                  ep_size=p)
        return y, aux[None]

    y, aux = jax.jit(block)({{k: jnp.asarray(v) for k, v in w.items()}},
                            jnp.asarray(x))
    np.savez(PATH + "_ep" + str(p) + ".npz", x=x, y=np.asarray(y),
             aux=np.asarray(aux), **w)
print("LOSSES", json.dumps(losses))
"""


@pytest.fixture(scope="module")
def reference_run(tmp_path_factory):
    """(the reference's losses by sync mode, its initial weights as a tree,
    the path prefix of its ``moe_forward_ep`` inputs and outputs)."""
    path = str(tmp_path_factory.mktemp("ref") / "ref")
    out = run_subprocess_script(REFERENCE_CHILD.format(
        steps=STEPS, seq=SEQ, batch=BATCH, ranks=RANKS, path=path,
        arch=ARCH), devices=4)
    line = next(l for l in out.splitlines() if l.startswith("LOSSES "))
    w = np.load(path + "_weights.npz")
    tree = unflatten([tuple(k.split("/")) for k in w.files],
                     [w[k] for k in w.files])
    return json.loads(line[len("LOSSES "):]), tree, path


def _setup(mesh, tree, sync="composed", steps=STEPS, **cfg_kw):
    cfg = get_config(ARCH, reduced=True)
    model = build_model(cfg, model_parallel=dict(mesh.shape).get("model", 1))
    opt_kw = cfg_kw.pop("opt_kw", {})
    opt = make_optimizer("adamw", lr=cosine_schedule(
        1e-3, warmup=max(steps // 20, 1), total=steps), **opt_kw)
    ds = SyntheticLMDataset(vocab_size=cfg.vocab_size, seq_len=SEQ,
                            global_batch=BATCH)
    tcfg = trainer.TrainCfg(sync_mode=sync, **cfg_kw)
    sess = (Session(mesh=mesh, mode="monolithic") if sync == "auto"
            else build_session(mesh, model, opt, ds, tcfg))
    states = trainer.init_states(model, opt,
                                 params_from_numpy(tree, cfg, device="cpu"),
                                 tcfg, mesh)
    return model, ds, states, trainer.make_train_step(model, opt, tcfg,
                                                      comm=sess.world)


def _train(mesh, tree, sync="composed", steps=STEPS, **cfg_kw):
    """``steps`` steps; returns (losses, states)."""
    model, ds, states, step_fn = _setup(mesh, tree, sync, steps, **cfg_kw)
    losses = []
    for step in range(steps):
        states, metrics = step_fn(states, ds.host_batch(step))
        losses.append(metrics["loss"].item())
        assert np.isfinite(losses[-1])
    return losses, states


def _dp_mesh():
    return substrate.make_host_mesh(RANKS, device="cpu")


def _ep_mesh():
    return substrate.make_host_mesh(RANKS, model_parallel=2, device="cpu")


@pytest.fixture(scope="module")
def composed_run(reference_run):
    return _train(_dp_mesh(), reference_run[1])


def test_composed_training_matches_reference(reference_run, composed_run):
    """The aux loss is each rank's own (capacity from its local tokens),
    as in the reference's composed shard_map."""
    want = reference_run[0]["composed"]
    losses, states = composed_run
    assert _rel_err(losses, want) <= 1e-4, (losses, want)
    for st in states[1:]:
        for a, b in zip(leaves([states[0]["params"], states[0]["opt"]]),
                        leaves([st["params"], st["opt"]])):
            assert torch.equal(a, b)
    assert losses[-1] < losses[0]


@pytest.mark.parametrize("kw", [
    {"bucket_grads": True}, {"overlap": True, "overlap_depth": 3},
    {"zero": True, "overlap": True}], ids=["bucketed", "overlap", "zero"])
def test_sync_flavours_give_the_composed_bits(reference_run, kw):
    tree = reference_run[1]
    opt_kw = {"clip_norm": 0.0} if kw.get("zero") else {}
    base, bs = _train(_dp_mesh(), tree, steps=3, opt_kw=opt_kw)
    got, gs = _train(_dp_mesh(), tree, steps=3, opt_kw=opt_kw, **kw)
    assert got == base
    for a, b in zip(leaves(bs[0]["params"]), leaves(gs[0]["params"])):
        assert torch.equal(a, b)


def test_compressed_training_matches_reference(reference_run):
    """1e-3: the int8 ring can round a code the other way after a 1e-7
    difference in a gradient (``tests/test_torch_train.py``)."""
    want = reference_run[0]["compressed"]
    losses, _ = _train(_dp_mesh(), reference_run[1], sync="compressed")
    assert _rel_err(losses, want) <= 1e-3, (losses, want)


def test_auto_follows_composed(reference_run, composed_run):
    """The port's ``auto`` computes the aux loss and the capacity per
    rank; the reference's ``auto`` routes the global batch at once (a
    departure by design), so it is held to the port's composed run."""
    losses, _ = _train(_dp_mesh(), reference_run[1], sync="auto")
    assert _rel_err(losses, composed_run[0]) <= 1e-4, (losses,
                                                       composed_run[0])


def _moe_leaf(params, name, r=0):
    return params["stage0"]["layer0"]["moe"][name][r]


def test_leaf_split_splits_experts_not_d_ff():
    cfg = get_config(ARCH, reduced=True)
    assert cfg.mlp is None
    tp = build_model(cfg, model_parallel=2)
    assert tp.layout.experts == 4 and tp.layout.d_ff == 0
    lay = tp.layout
    for name in ("w_gate", "w_up", "w_down"):
        assert sharding.leaf_split(("stage0", "layer0", "moe", name),
                                   lay) == -3
        assert sharding.leaf_split(("stage0", "layer0", "moe", "shared",
                                    name), lay) is None
        assert sharding.leaf_split(("stage0", "layer0", "mlp", name),
                                   lay) in (-1, -2)
    assert sharding.leaf_split(("stage0", "layer0", "moe", "router"),
                               lay) is None
    full = build_model(cfg).init(torch.Generator().manual_seed(0))
    shards = [tp.shard(full, i) for i in range(2)]
    want = flatten(tp.abstract_params())
    for sh in shards:
        assert [tuple(t.shape) for t in leaves(sh)] == [
            tuple(t.shape) for t in want[0]]
        assert _moe_leaf(sh, "w_gate").shape == (4, 64, 32)
    for i, sh in enumerate(shards):
        assert torch.equal(_moe_leaf(sh, "w_down"),
                           _moe_leaf(full, "w_down")[4 * i:4 * i + 4])
        assert torch.equal(_moe_leaf(sh, "router"),
                           _moe_leaf(full, "router"))
    back = sharding.unshard_params(shards, lay)
    for a, b in zip(leaves(full), leaves(back)):
        assert torch.equal(a, b)


def test_layout_refuses_experts_that_do_not_split():
    cfg = get_config(ARCH, reduced=True)
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                           num_experts=6))
    with pytest.raises(ValueError, match="num_experts=6"):
        sharding.layout(cfg, 4)


def test_expert_parallel_loss_and_grads_match_the_unsplit_model(weights):
    """(data 2, model 2): each rank's loss and gradients against the
    unsplit model's on its data shard.  The router's gradient has a
    routed term (partial on each model rank: its experts only) and an
    aux term (whole on each rank); it must equal the unsplit one on every
    model rank, bit-equal across them, as the per-head norms must once
    summed."""
    _, _, whole, full = weights
    cfg = whole.cfg
    tp = build_model(cfg, model_parallel=2)
    b = _torch_batch(_batch(seed=3))
    mesh = _ep_mesh()
    want = [whole.loss_and_grads(full, {k: v[2 * d:2 * d + 2]
                                        for k, v in b.items()})
            for d in range(2)]

    def rank(params, d):
        return tp.loss_and_grads(params, {k: v[2 * d:2 * d + 2]
                                          for k, v in b.items()})

    args = [(tp.shard(full, mesh.coords(r)["model"]),
             mesh.coords(r)["data"]) for r in range(mesh.size)]
    out = substrate.run_spmd(rank, args, mesh, timeout=120)
    paths = flatten(full)[1]
    partial = sharding.partial_sum_leaves(paths, tp.layout)
    assert sum(partial) == 2                  # q_norm, k_norm
    router = paths.index(("stage0", "layer0", "moe", "router"))
    for d in range(2):
        rs = [r for r in range(mesh.size) if mesh.coords(r)["data"] == d]
        wl, wg = want[d]
        shards = []
        for i, r in enumerate(rs):
            assert _rel_err(out[r][0].item(), wl.item()) <= 1e-5
            gl = leaves(out[r][1])
            other = leaves(out[rs[1 - i]][1])
            shards.append(unflatten(paths, [
                g + other[j] if partial[j] else g
                for j, g in enumerate(gl)]))
        assert torch.equal(leaves(out[rs[0]][1])[router],
                           leaves(out[rs[1]][1])[router])
        got = sharding.unshard_params(shards, tp.layout)
        for path, a, w in zip(paths, leaves(got), leaves(wg)):
            assert _rel_err(a.numpy(), w.numpy()) <= 1e-5, "/".join(path)


def test_expert_parallel_training_follows_data_parallel(reference_run,
                                                        composed_run):
    """STEPS steps on (data 2, model 2) with ``check_model_replicas`` (the
    router among the leaves whose gradients must agree across "model")
    against the data-parallel composed run."""
    ep, states = _train(_ep_mesh(), reference_run[1], steps=STEPS,
                        check_model_replicas=True)
    assert _rel_err(ep, composed_run[0]) <= 1e-5, (ep, composed_run[0])
    mesh = _ep_mesh()
    for r, st in enumerate(states):
        if mesh.coords(r)["model"] == 1:
            assert torch.equal(_moe_leaf(st["params"], "router"),
                               _moe_leaf(states[0]["params"], "router"))


@pytest.mark.parametrize("p", [2, 4])
def test_moe_forward_ep_matches_reference(reference_run, p):
    """Each rank holds E/p experts and its token shard; the buffers go
    out and back through ``collectives.all_to_all`` under an installed
    composed session, which plans the protocol."""
    ref = np.load(f"{reference_run[2]}_ep{p}.npz")
    cfg = M.MoECfg(d_model=16, d_ff=8, num_experts=8, top_k=2,
                   capacity_factor=0.5)
    e_loc = 8 // p
    x = torch.from_numpy(ref["x"]).chunk(p)
    mesh = substrate.make_mesh((p,), ("x",), device="cpu")
    sess = Session(mesh=mesh)
    assert sess.engine.composed

    def rank(r):
        local = {"router": torch.from_numpy(ref["router"])}
        for k in ("w_gate", "w_up", "w_down"):
            local[k] = torch.from_numpy(ref[k][r * e_loc:(r + 1) * e_loc])
        y, aux = M.moe_forward_ep(local, cfg, x[r], axis="x", ep_size=p)
        return y, aux

    collectives.install(sess)
    try:
        out = substrate.run_spmd(rank, [(r,) for r in range(p)], mesh,
                                 timeout=60)
    finally:
        collectives.install(None)
    # dispatch and combine move the same (E, C, D) bytes a rank, each on
    # the protocol the cost model plans for them (pairwise at p = 2,
    # Bruck at p = 4)
    nb = 8 * M.capacity_of(x[0].shape[0] * x[0].shape[1], cfg) * 16 * 4
    proto = sess.engine.protocol_for(registry.ALL_TO_ALL, nb, "x")
    assert proto == {2: "pairwise", 4: "bruck"}[p]
    sb, _ = plan_mod.phase_wire_bytes(proto, p, nb, registry.ALL_TO_ALL)
    assert registry.ALL_TO_ALL in sess.engine.invoked_functions
    for r in range(p):
        assert sess.engine.stats.rank_phase_bytes[r][
            "all_to_all.start"] == 2 * sb
    y = torch.cat([o[0] for o in out]).numpy()
    assert _rel_err(y, ref["y"]) <= 1e-6
    assert _rel_err([o[1].item() for o in out], ref["aux"]) <= 1e-6


# ---------------------------------------------------------------------------
# Entry points and refusals
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("flags", [[], ["--data", "2", "--model-parallel",
                                        "2"]], ids=["data", "expert"])
def test_train_cli_runs_moe_on_the_cpu(flags):
    launch_train.main(["--device", "cpu", "--arch", ARCH, "--reduced",
                       "--sync", "composed", "--steps", "2", "--seq-len",
                       "16", "--global-batch", "4", "--log-every", "1"]
                      + flags)


def test_serve_cli_runs_moe_on_the_cpu(caplog):
    caplog.set_level("INFO")
    launch_serve.main(["--device", "cpu", "--arch", ARCH, "--reduced",
                       "--requests", "3", "--max-new", "3"])
    assert "served 3 requests (0 shed)" in caplog.text


@pytest.mark.parametrize("spec", [T.LayerSpec("cross_attn", "moe"),
                                  T.LayerSpec("cross_attn", "none"),
                                  T.LayerSpec("attn", "mamba")])
def test_other_mixers_and_ffns_are_refused(spec):
    """Mixers and FFNs the port has no layer for (the attention, MLA and
    Mamba mixers and the dense and MoE FFNs are ported)."""
    cfg = get_config(ARCH, reduced=True)
    cfg = dataclasses.replace(cfg, stages=(T.StageSpec((spec,), 1),))
    with pytest.raises(NotImplementedError, match="slice"):
        build_model(cfg).abstract_params()
