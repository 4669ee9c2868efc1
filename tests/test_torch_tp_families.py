"""The families the reference splits over "model" beside the dense ones:
MLA and the MTP head, Mamba, the embeddings-input model and the
encoder-decoder, on a ``("data", "model")`` mesh of CPU thread ranks.

- The twins: reduced deepseek-v3-671b (MLA, sigmoid MoE with a shared
  expert, the MTP block over MLA + MoE), jamba-1.5-large-398b
  (attention, Mamba, MoE), qwen2-vl-7b (2 microbatches, per-row M-RoPE
  positions) and seamless-m4t-large-v2 trained 3 steps on (data 2,
  model 2) with ``check_model_replicas`` against data 2 from the same
  params and batches (Adafactor for the first two, their reference
  optimizer, AdamW for the others): losses and gradient norms within
  ``TWIN_RTOL`` relative.  The runs are f32, so the split and unsplit
  runs differ by the order of their sums only: the largest readings
  were 0 / 2.0e-7 (deepseek, loss / norm), 7.9e-8 / 4.7e-7 (jamba), 0 /
  1.1e-7 (qwen2-vl) and 7.6e-8 / 1.3e-7 (seamless).  An MTP block's
  expert stack clipped as one group over "model", not an expert at a
  time as the reference maps it, moved deepseek's by 2.0e-5 / 2.1e-5.
- The layouts: where each family's leaves split, which are partial sums;
  ``shard_params`` then ``unshard_params`` gives back the whole tree bit
  for bit at model 2 and 4 (jamba's sectioned ``in_proj`` and conv too,
  whose rank block is its block of each section).
- Mamba's split forward and gradients at model 2 within 1e-5 of the
  unsplit ``mamba_forward``: its gated norm's mean square spans all of
  d_inner, so it is summed over "model" in both directions.
- Checkpoints: a (2, 2) state of reduced jamba and deepseek gathers to
  the unsplit state's global tree, and a trained one saved per shard
  restores bit-equal onto (2, 1) and (1, 2).
- Each rank of the (2, 2) twins sums over "model" as often a step as
  ``chip_smoke.py``'s ``tp_psums`` (and ``adafactor_psums``) plan.
- The MTP head's loss with a ``tp_index``; the train launcher over
  ``--model-parallel 2`` for jamba and deepseek on a 2-row batch; K/V
  heads that do not split over "model" serving each rank's own query
  heads (8 over 2 and 4 over 2 on 4 ranks).

No JAX here: the port's own unsplit model is the reference of the
twins.
"""

import collections
import dataclasses
import functools
import importlib.util
import os
import threading

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
from repro_torch.configs import get_config
from repro_torch.data import SyntheticLMDataset
from repro_torch.launch.train import build_session
from repro_torch.models import build_model
from repro_torch.models import mamba as M
from repro_torch.models import transformer as T
from repro_torch.models.frontends import vision_positions
from repro_torch.optim import make_optimizer
from repro_torch.parallel import sharding
from repro_torch.runtime import substrate
from repro_torch.train import trainer
from repro_torch.tree import flatten, leaves, map_tree, unflatten

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: f32 twins: 10x the largest reading (see the module's docstring)
TWIN_RTOL = 5e-6
STEPS, SEQ, BATCH = 3, 16, 4
#: (optimizer, microbatches) of each family's twins
RUNS = {"deepseek-v3-671b": ("adafactor", 1),
        "jamba-1.5-large-398b": ("adafactor", 1),
        "qwen2-vl-7b": ("adamw", 2),
        "seamless-m4t-large-v2": ("adamw", 1)}
ARCHS = tuple(RUNS)


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def _bits_equal(a, b) -> bool:
    return (a.dtype == b.dtype and a.shape == b.shape
            and torch.equal(a, b))


class _Batches:
    """Seeded numpy batches of a reduced arch: tokens for the decoders,
    ``inputs_embeds`` and per-row, per-section M-RoPE ``positions`` for
    qwen2-vl-7b, ``frame_embeds`` beside tokens for seamless."""

    def __init__(self, arch, cfg):
        self.arch, self.cfg = arch, cfg
        self.ds = SyntheticLMDataset(vocab_size=cfg.vocab_size, seq_len=SEQ,
                                     global_batch=BATCH, seed=3)

    def host_batch(self, step):
        batch = self.ds.host_batch(step)
        rng = np.random.default_rng([11, step])
        b, s, d = BATCH, SEQ, self.cfg.d_model
        if self.arch == "qwen2-vl-7b":
            pos = vision_positions(b, s).numpy().copy()
            pos[:, :, s // 4:] += (5 * np.arange(b, dtype=np.int32)
                                   + step)[None, :, None]
            return {"inputs_embeds": rng.standard_normal(
                        (b, s, d), dtype=np.float32) * np.float32(0.02),
                    "positions": pos, "labels": batch["labels"]}
        if self.arch == "seamless-m4t-large-v2":
            batch["frame_embeds"] = rng.standard_normal(
                (b, s, d), dtype=np.float32) * np.float32(0.05)
        return batch


def _optimizer(name):
    if name == "adafactor":       # factor the reduced widths' matrices
        return make_optimizer("adafactor", lr=1e-3, min_dim_factored=32)
    return make_optimizer("adamw", lr=1e-3)


@functools.lru_cache(maxsize=None)
def _params(arch):
    return build_model(get_config(arch, reduced=True)).init(
        torch.Generator().manual_seed(5))


def _run(arch, shape, states=None, steps=STEPS, calls=None, **kw):
    """``steps`` steps of reduced ``arch`` on a (data, model) ``shape``
    from ``_params(arch)`` (or ``states``): (session, mesh, states,
    losses, grad norms).  Given a Counter ``calls``, the steps' sums
    over "model" (``sharding.psum``) are counted into it by thread."""
    opt_name, micro = RUNS[arch]
    cfg = get_config(arch, reduced=True)
    data, m = shape
    sess = trainer.TrainSession(
        build_model(cfg, model_parallel=m), _optimizer(opt_name),
        trainer.TrainCfg(microbatches=micro, **kw))
    mesh = substrate.make_host_mesh(data, model_parallel=m, device="cpu")
    ds = _Batches(arch, cfg)
    if states is None:
        states = trainer.init_states(sess.model, sess.optimizer,
                                     map_tree(torch.clone, _params(arch)),
                                     sess.cfg, mesh)
    step = sess.step_fn(build_session(mesh, sess.model, sess.optimizer, ds,
                                      sess.cfg).world)
    psum = sharding.psum

    def counted(x):
        calls[threading.get_ident()] += 1
        return psum(x)

    if calls is not None:
        sharding.psum = counted
    try:
        losses, norms = [], []
        for i in range(steps):
            states, metrics = step(states, ds.host_batch(i))
            losses.append(metrics["loss"].item())
            norms.append(metrics["grad_norm"].item())
    finally:
        sharding.psum = psum
    return sess, mesh, states, losses, norms


@functools.lru_cache(maxsize=None)
def _twins(arch):
    """(the data-2 run, the (2, 2) run) of ``_run``, and the (2, 2) run's
    sums over "model" by rank thread."""
    calls = collections.Counter()
    return (_run(arch, (2, 1)),
            _run(arch, (2, 2), calls=calls, check_model_replicas=True),
            calls)


@pytest.mark.parametrize("arch", ARCHS)
def test_data_x_model_training_follows_the_unsplit_model(arch):
    (_, _, _, want_l, want_n), (sess, mesh, states, got_l, got_n), _ = \
        _twins(arch)
    assert _rel(got_l, want_l) <= TWIN_RTOL, (got_l, want_l)
    assert _rel(got_n, want_n) <= TWIN_RTOL, (got_n, want_n)
    assert all(np.isfinite(got_l))
    # the data replicas of each model coordinate hold the same shard,
    # and every rank the same whole leaves
    paths = flatten(states[0]["params"])[1]
    for r, st in enumerate(states):
        twin = states[mesh.coords(r)["model"]]
        assert all(_bits_equal(a, b) for a, b in zip(
            leaves(twin["params"]), leaves(st["params"])))
        assert all(_bits_equal(a, b) for p, a, b in zip(
            paths, leaves(states[0]["params"]), leaves(st["params"]))
            if sharding.leaf_split(p, sess.model.layout) is None)


def _smoke():
    """``chip_smoke.py`` as a module (its imports of the port are inside
    its functions)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("arch", ARCHS)
def test_the_smoke_plans_every_model_axis_all_reduce(arch):
    """The 4 ranks of the (2, 2) twin sum over "model" as often a step as
    ``chip_smoke.py`` plans from the config (``tp_psums``, with
    Adafactor's ``adafactor_psums``), the plan its ``sum_chunks``
    launches are held to on the card."""
    _, (sess, _, _, _, _), calls = _twins(arch)
    smoke = _smoke()
    want = smoke.tp_psums(sess.model, sess.cfg.microbatches)
    if sess.optimizer.name == "adafactor":
        want += smoke.adafactor_psums(sess.model, sess.optimizer)
    assert sum(calls.values()) == 4 * STEPS * want, (dict(calls), want)


def _where(arch, m=2):
    """{path: (split dim, partial sum)} of reduced ``arch`` at model
    ``m``."""
    model = build_model(get_config(arch, reduced=True), model_parallel=m)
    paths = flatten(model.abstract_params())[1]
    lay = model.layout
    return {p: (sharding.leaf_split(p, lay), s) for p, s in
            zip(paths, sharding.partial_sum_leaves(paths, lay))}


def test_mla_and_the_mtp_head_split_by_heads():
    where = _where("deepseek-v3-671b")
    mla = {p[-1] if p[-2] == "mla" else p[-2]: w for p, w in where.items()
           if p[:3] == ("stage0", "layer0", "mla")}
    assert mla == {"w_uq": (-1, False), "w_ukv": (-1, False),
                   "w_o": (-2, False), "w_dq": (None, True),
                   "w_dkv": (None, True), "w_kr": (None, True),
                   "q_norm": (None, True), "kv_norm": (None, True)}
    for name in ("mtp_norm1", "mtp_norm2"):
        assert where[(name, "scale")] == (None, False)
    assert where[("mtp_proj",)] == (None, False)
    assert where[("mtp_block", "mla", "w_uq")] == (-1, False)
    assert where[("mtp_block", "moe", "w_up")] == (-3, False)
    assert where[("embed",)] == (-2, False)
    assert where[("lm_head",)] == (-1, False)


def test_mamba_splits_by_heads_and_sections():
    where = _where("jamba-1.5-large-398b")
    mamba = {p[-1] if p[-2] == "mamba" else p[-2]: w
             for p, w in where.items()
             if p[:3] == ("stage0", "layer1", "mamba")}
    assert mamba == {"in_proj": (-1, False), "conv_w": (-1, False),
                     "conv_b": (-1, False), "A_log": (-1, False),
                     "D": (-1, False), "dt_bias": (-1, False),
                     "out_proj": (-2, False), "norm": (-1, False)}
    lay = build_model(get_config("jamba-1.5-large-398b", reduced=True),
                      model_parallel=2).layout
    path = ("stage0", "layer1", "mamba", "in_proj")
    assert sharding.leaf_sections(path, lay) == (128, 128, 16, 16, 8)
    assert sharding.leaf_sections(("opt", "f") + path + ("vc",), lay) == (
        128, 128, 16, 16, 8)
    assert sharding.leaf_sections(("opt", "f") + path + ("vr",), lay) is None
    assert sharding.leaf_sections(path[:-1] + ("out_proj",), lay) is None
    full = get_config("jamba-1.5-large-398b")
    sec = dict(sharding.layout(full, 2).sections)
    assert sec["in_proj"] == (16384, 16384, 128, 128, 256)
    assert sum(sec["in_proj"]) == 33280
    with pytest.raises(ValueError, match="mamba nheads=8"):
        sharding.layout(get_config("mamba2-1.3b", reduced=True), 16)


def test_the_embeddings_model_and_the_encdec_split():
    where = _where("qwen2-vl-7b")
    assert ("embed",) not in where
    assert where[("lm_head",)] == (-1, False)
    where = _where("seamless-m4t-large-v2")
    for stack, attn in (("encoder", "attn"), ("decoder", "self_attn"),
                        ("decoder", "cross")):
        for name, d in (("wq", -1), ("wk", -1), ("wv", -1), ("wo", -2)):
            assert where[(stack, attn, name)] == (d, False)
        assert where[(stack, "mlp", "w_up")] == (-1, False)
        assert where[(stack, "mlp", "w_down")] == (-2, False)
    assert where[("embed",)] == (-2, False)
    assert where[("lm_head",)] == (-1, False)
    assert where[("enc_norm", "bias")] == (None, False)
    assert not any(s for _, s in where.values())
    cfg = get_config("seamless-m4t-large-v2")
    assert sharding.layout(cfg, 2).vocab == 128103
    # a vocabulary that does not split is held whole (TPLayout.whole)
    lay = sharding.layout(cfg, 4)
    assert (lay.whole, lay.vocab) == (("vocab",), 256206)


@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("arch", ARCHS)
def test_shard_then_unshard_gives_back_every_bit(arch, m):
    model = build_model(get_config(arch, reduced=True), model_parallel=m)
    full, lay = _params(arch), model.layout
    shards = [model.shard(full, i) for i in range(m)]
    for sh in shards:
        assert [tuple(a.shape) for a in leaves(sh)] == [
            tuple(a.shape) for a in leaves(model.abstract_params())]
    back = sharding.unshard_params(shards, lay)
    assert flatten(back)[1] == flatten(full)[1]
    assert all(_bits_equal(a, b) for a, b in zip(leaves(back),
                                                 leaves(full)))
    if arch != "jamba-1.5-large-398b":
        return
    for name in ("in_proj", "conv_w", "conv_b"):
        path = ("stage0", "layer1", "mamba", name)
        whole = full["stage0"]["layer1"]["mamba"][name]
        secs = whole.split(list(sharding.leaf_sections(path, lay)), dim=-1)
        for i, sh in enumerate(shards):
            assert torch.equal(sh["stage0"]["layer1"]["mamba"][name],
                               torch.cat([s.chunk(m, dim=-1)[i]
                                          for s in secs], dim=-1))


@pytest.mark.parametrize("ngroups", [1, 2])
def test_split_mamba_follows_the_unsplit_mixer(ngroups):
    """One Mamba mixer of reduced jamba at model 2 on 2 thread ranks: the
    output summed over "model" and every gradient (the input's summed by
    *f*, the params' joined) within 1e-5 of the unsplit
    ``mamba_forward``.  A gated norm whose mean square were summed by *g*
    alone would give each rank only its own heads' share of its
    gradient.  With one group every rank's heads read the other rank's
    half of B and C; with 2 each head picks its group of the gathered
    whole (``mamba._groups_of_heads``)."""
    cfg = get_config("jamba-1.5-large-398b", reduced=True)
    cfg = dataclasses.replace(cfg, mamba=dataclasses.replace(
        cfg.mamba, ngroups=ngroups))
    full = M.init_mamba(torch.Generator().manual_seed(6), cfg.mamba,
                        torch.float32, "cpu")
    lay = sharding.layout(cfg, 2)
    local = dataclasses.replace(cfg.mamba, head_shards=2)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((2, SEQ, cfg.d_model),
                                             dtype=np.float32))
    w = torch.from_numpy(rng.standard_normal((2, SEQ, cfg.d_model),
                                             dtype=np.float32))

    def loss_and_grads(fn, params, *extra):
        ps, paths = flatten(params)
        ps = [p.detach().requires_grad_(True) for p in ps]
        xi = x.clone().requires_grad_(True)
        y = fn(unflatten(paths, ps), xi, *extra)
        gs = torch.autograd.grad((y * w).sum(), [xi] + ps)
        return y.detach(), gs[0], unflatten(paths, list(gs[1:]))

    want_y, want_dx, want_dp = loss_and_grads(
        lambda p, xi: M.mamba_forward(p, cfg.mamba, xi)[0], full)

    def split(p, xi):
        out, _ = M.mamba_forward(p, local, sharding.copy_to_model(xi))
        return sharding.reduce_from_model(out)

    def rank(i):
        return loss_and_grads(split, sharding.shard_params(
            {"mamba": full}, lay, i)["mamba"])

    mesh = substrate.make_mesh((2,), ("model",), device="cpu")
    out = substrate.run_spmd(rank, [(0,), (1,)], mesh, timeout=60)
    for y, dx, _ in out:
        assert _rel(y, want_y) <= 1e-5
        assert _rel(dx, want_dx) <= 1e-5
    got = sharding.unshard_params([{"mamba": o[2]} for o in out], lay)
    gl, paths = flatten(got["mamba"])
    for path, a, b in zip(paths, gl, leaves(want_dp)):
        assert _rel(a, b) <= 1e-5, path


CKPT_ARCHS = ("jamba-1.5-large-398b", "deepseek-v3-671b")


@pytest.mark.parametrize("arch", CKPT_ARCHS)
def test_split_state_gathers_to_the_unsplit_tree(arch):
    """A fresh (2, 2) state gathered is the unsplit state, leaf for
    leaf and bit for bit, sectioned leaves included."""
    (sess1, mesh1, _, _, _), (sess, _, _, _, _), _ = _twins(arch)
    mesh = substrate.make_host_mesh(2, model_parallel=2, device="cpu")
    states = trainer.init_states(sess.model, sess.optimizer,
                                 _params(arch), sess.cfg, mesh)
    want = trainer.make_train_state(sess1.model, sess1.optimizer,
                                    _params(arch), sess1.cfg)
    got = trainer.logical_state(sess.gather(states, mesh))
    assert flatten(got)[1] == flatten(want)[1]
    assert all(_bits_equal(a, b) for a, b in zip(leaves(got),
                                                 leaves(want)))


@pytest.mark.parametrize("shape", [(2, 1), (1, 2)])
@pytest.mark.parametrize("arch", CKPT_ARCHS)
def test_split_checkpoint_restores_onto_another_mesh(arch, shape,
                                                     tmp_path):
    """The trained (2, 2) twin saved per shard, restored onto ``shape``:
    the gathered logical state bit-equal to the saved one, and it
    trains."""
    _, (sess, mesh, states, _, _), _ = _twins(arch)
    saved = sess.gather(states, mesh)
    want = map_tree(lambda t: t.clone(), trainer.logical_state(saved))
    d = str(tmp_path / "ck")
    save_checkpoint(d, STEPS, saved, sharded=True)
    new = substrate.make_host_mesh(shape[0], model_parallel=shape[1],
                                   device="cpu")
    tree = restore_checkpoint(d, sess.abstract_state(mesh=new))
    moved = sess.scatter(tree, new)
    got = trainer.logical_state(sess.gather(moved, new))
    assert all(_bits_equal(a, b) for a, b in zip(leaves(got),
                                                 leaves(want)))
    losses = _run(arch, shape, states=moved, steps=1)[3]
    assert np.isfinite(losses[0])


def test_mtp_head_runs_on_a_model_axis():
    """``transformer.loss_fn`` with a ``tp_index`` reports the MTP term,
    equal on both model ranks and within 1e-5 of the unsplit one."""
    cfg = get_config("deepseek-v3-671b", reduced=True)
    model = build_model(cfg, model_parallel=2)
    full = _params("deepseek-v3-671b")
    batch = {k: torch.from_numpy(v) for k, v in
             _Batches("deepseek-v3-671b", cfg).host_batch(0).items()}
    _, want = T.loss_fn(full, cfg, batch)

    def rank(i):
        with torch.no_grad():
            return T.loss_fn(model.shard(full, i), model.local_cfg, batch,
                             tp_index=i)[1]

    mesh = substrate.make_mesh((2,), ("model",), device="cpu")
    out = substrate.run_spmd(rank, [(0,), (1,)], mesh, timeout=60)
    for key in ("nll", "mtp", "loss"):
        assert out[0][key].item() == out[1][key].item()
        assert _rel(out[0][key].item(), want[key].item()) <= 1e-5, key


@pytest.mark.parametrize("arch", CKPT_ARCHS)
def test_train_launcher_splits_the_family(arch, caplog):
    """The train launcher runs reduced jamba and deepseek over
    ``--model-parallel 2``, on a batch of fewer rows than the session's
    probe has ranks (2 rows on (data 1, model 2))."""
    from repro_torch.launch import train as launch
    caplog.set_level("INFO", logger="repro_torch.train")
    launch.main(["--device", "cpu", "--arch", arch, "--reduced",
                 "--optimizer", "adafactor", "--data", "1",
                 "--model-parallel", "2", "--steps", "2", "--seq-len",
                 str(SEQ), "--global-batch", "2", "--log-every", "1"])
    steps = [r.getMessage() for r in caplog.records
             if r.getMessage().startswith("step")]
    assert len(steps) == 2 and "nan" not in " ".join(steps)


@pytest.mark.parametrize("heads,kv,m", [(8, 2, 4), (4, 2, 4)])
def test_replicated_kv_heads_serve_the_ranks_own_query_heads(heads, kv, m):
    """K/V heads that do not split over "model" (``num_kv_heads % m``)
    are held whole, and each rank's query heads read their own KV head
    (``layers.AttentionCfg.kv_group``): 8 heads over 2 KV heads on 4
    ranks give each rank 2 query heads that both read KV head r // 2,
    not one each; 4 over 2 give each rank 1.  The loss at model ``m``
    within 1e-5 of the unsplit one."""
    cfg = get_config("mistral-large-123b", reduced=True)
    cfg = dataclasses.replace(cfg, attn=dataclasses.replace(
        cfg.attn, num_heads=heads, num_kv_heads=kv))
    full = build_model(cfg).init(torch.Generator().manual_seed(2))
    model = build_model(cfg, model_parallel=m)
    assert model.layout.kv_replicated
    assert model.local_cfg.attn.kv_group == heads // kv
    batch = {k: torch.from_numpy(v) for k, v in _Batches(
        "mistral-large-123b", cfg).host_batch(0).items()}
    with torch.no_grad():
        want = T.loss_fn(full, cfg, batch)[0].item()

    def rank(i):
        with torch.no_grad():
            return T.loss_fn(model.shard(full, i), model.local_cfg, batch,
                             tp_index=i)[0].item()

    mesh = substrate.make_mesh((m,), ("model",), device="cpu")
    out = substrate.run_spmd(rank, [(i,) for i in range(m)], mesh,
                             timeout=60)
    assert len(set(out)) == 1
    assert _rel(out[0], want) <= 1e-5, (out, want)
