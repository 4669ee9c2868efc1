"""Rematerialization over a "model" axis (``models.remat.staged``,
``parallel.sharding.StagedBackward.block``), on CPU thread ranks.

- Reduced qwen2-72b, qwen3-moe-30b-a3b, deepseek-v3-671b (MLA, MoE, the
  MTP block), jamba-1.5-large-398b (attention, Mamba, MoE),
  seamless-m4t-large-v2 and qwen2-vl-7b (M-RoPE positions, embeddings
  input) on (data 1, model 2): with remat on, under policy "nothing"
  and "dots" (seamless's config has no policy: "nothing"), each rank's
  loss and every gradient are bit-equal (``torch.equal``) to remat off.
  Every block is rerun once, on the rank's own thread and outside any
  autograd graph task (not on autograd's device thread, as
  ``torch.utils.checkpoint``'s recompute would be).
- One step on (data 2, model 2) with remat on: each rank sums over
  "model" (``sharding.psum``) as often as ``chip_smoke.py``'s
  ``tp_psums`` plans, the reruns' *g*s included; with remat off, as it
  plans for a config with ``remat=False``.
- "dots" hands every 2-D product of the forward back to the rerun (the
  products computed in a step equal remat off's), "nothing" recomputes
  them; "nothing" saves nothing for the backward inside a block (the
  forward's saved tensors do not grow with depth).
- A block whose rerun gives other bits than its forward raises.

No JAX: remat off is the reference of remat on.
"""

import collections
import dataclasses
import importlib.util
import os
import threading
import types

import numpy as np
import pytest
import torch
from torch.utils import checkpoint as tuc
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import get_config
from repro_torch.launch.train import build_session
from repro_torch.models import build_model
from repro_torch.models import remat as R
from repro_torch.models import transformer as T
from repro_torch.optim import make_optimizer
from repro_torch.parallel import sharding
from repro_torch.runtime import substrate
from repro_torch.train import trainer
from repro_torch.tree import leaves, map_tree

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, S = 4, 16
FAMILIES = ("qwen2-72b", "qwen3-moe-30b-a3b", "deepseek-v3-671b",
            "jamba-1.5-large-398b", "seamless-m4t-large-v2", "qwen2-vl-7b")
CASES = [(a, p) for a in FAMILIES
         for p in (("nothing",) if a == "seamless-m4t-large-v2"
                   else R.POLICIES)]


def _cfg(arch, remat, policy="nothing", **kw):
    cfg = get_config(arch, reduced=True)
    if isinstance(cfg, T.TransformerCfg):
        kw["remat_policy"] = policy
    return dataclasses.replace(cfg, remat=remat, **kw)


def _batch(cfg, kind, seed=0):
    """A loss batch of ``B`` rows from numpy seeded by ``seed``."""
    rng = np.random.default_rng(seed)
    t = torch.from_numpy
    batch = {"tokens": t(rng.integers(0, cfg.vocab_size, (B, S))),
             "labels": t(rng.integers(0, cfg.vocab_size, (B, S)))}
    embeds = t(rng.standard_normal((B, S, cfg.d_model), dtype=np.float32))
    if kind == "encdec":
        batch["frame_embeds"] = embeds
    elif not cfg.embed_inputs:
        del batch["tokens"]
        batch["inputs_embeds"] = embeds
        batch["positions"] = t(rng.integers(0, S, (3, B, S)).astype(np.int32))
    return batch


def _blocks(cfg) -> int:
    """Checkpointed blocks of one training forward."""
    if not hasattr(cfg, "stages"):
        return cfg.enc_layers + cfg.dec_layers
    return sum(st.repeat for st in cfg.stages)


def _ranks(cfg, body, shape=(1, 2)):
    """``body(model, params, rank)`` on every rank of a (data, model)
    ``shape`` of CPU thread ranks, each given its shard of seeded params;
    returns the results in rank order."""
    model = build_model(cfg, model_parallel=shape[1])
    full = build_model(cfg).init(torch.Generator().manual_seed(0))
    mesh = substrate.make_host_mesh(shape[0], model_parallel=shape[1],
                                    device="cpu")
    return substrate.run_spmd(
        lambda r: body(model, model.shard(full, mesh.coords(r)["model"]), r),
        [(r,) for r in range(mesh.size)], mesh)


class _Reruns:
    """Records each staged block's rerun: its thread and autograd graph
    task (-1 outside a backward)."""

    def __init__(self, monkeypatch):
        self.seen = []
        run = sharding._Block.run

        def spy(block):
            self.seen.append((threading.get_ident(),
                              torch._C._current_graph_task_id()))
            return run(block)

        monkeypatch.setattr(sharding._Block, "run", spy)


@pytest.mark.parametrize("arch,policy", CASES)
def test_remat_over_model_gives_the_bits_of_no_remat(arch, policy,
                                                     monkeypatch):
    off = _cfg(arch, False)

    def grads(model, params, r):
        return (threading.get_ident(),
                model.loss_and_grads(params, _batch(off, model.kind)))

    want = _ranks(off, grads)
    calls = collections.Counter()
    real = tuc.checkpoint
    monkeypatch.setattr(tuc, "checkpoint", lambda *a, **k: (
        calls.update(["checkpoint"]), real(*a, **k))[1])
    reruns = _Reruns(monkeypatch)
    got = _ranks(_cfg(arch, True, policy), grads)
    assert not calls
    assert len(reruns.seen) == 2 * _blocks(off)
    ranks = {tid for tid, _ in got}
    assert {tid for tid, _ in reruns.seen} == ranks
    assert {task for _, task in reruns.seen} == {-1}
    for (_, (loss_on, g_on)), (_, (loss_off, g_off)) in zip(got, want):
        assert torch.equal(loss_on, loss_off)
        for a, b in zip(leaves(g_on), leaves(g_off)):
            assert a.dtype == b.dtype and torch.equal(a, b)


def _smoke():
    """``chip_smoke.py`` as a module (its imports of the port are inside
    its functions)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _step_sums(cfg) -> int:
    """Sums over "model" of one AdamW step on (data 2, model 2), all
    ranks together."""
    model = build_model(cfg, model_parallel=2)
    opt = make_optimizer("adamw", lr=1e-3)
    mesh = substrate.make_host_mesh(2, model_parallel=2, device="cpu")
    tcfg = trainer.TrainCfg()
    batch = {k: v.numpy() for k, v in _batch(cfg, model.kind, 2).items()}
    ds = types.SimpleNamespace(host_batch=lambda step: batch)
    step = trainer.make_train_step(model, opt, tcfg, comm=build_session(
        mesh, model, opt, ds, tcfg).world)
    states = trainer.init_states(
        model, opt, build_model(cfg).init(torch.Generator().manual_seed(0)),
        tcfg, mesh)
    calls = [0]
    psum = sharding.psum

    def counted(x):
        calls[0] += 1
        return psum(x)

    sharding.psum = counted
    try:
        _, metrics = step(states, batch)
    finally:
        sharding.psum = psum
    assert np.isfinite(metrics["loss"].item())
    return calls[0]


@pytest.mark.parametrize("remat", [True, False], ids=["remat", "no_remat"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_model_axis_sums_a_step_equal_the_plan(arch, remat):
    cfg = _cfg(arch, remat)
    want = _smoke().tp_psums(build_model(cfg, model_parallel=2))
    assert _step_sums(cfg) == 4 * want


class _Products(TorchDispatchMode):
    """Counts the 2-D products computed under it."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += func in R.DOTS
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("arch", ["qwen2-72b", "jamba-1.5-large-398b"])
def test_dots_hands_back_every_2d_product(arch):
    def products(model, params, r):
        with _Products() as mode:
            model.loss_and_grads(params, _batch(model.cfg, model.kind))
        return mode.n

    off = _ranks(_cfg(arch, False), products)
    dots = _ranks(_cfg(arch, True, "dots"), products)
    nothing = _ranks(_cfg(arch, True, "nothing"), products)
    assert dots == off
    assert all(n > o for n, o in zip(nothing, off))


def _saved(cfg) -> int:
    """Tensors rank 0's training forward saves for its backward."""
    def body(model, params, r):
        n = [0]

        def pack(t):
            n[0] += 1
            return t

        xs = map_tree(lambda p: p.detach().requires_grad_(True), params)
        with sharding.StagedBackward(), \
                torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            model.loss(xs, _batch(model.cfg, model.kind))
        return n[0]

    return _ranks(cfg, body)[0]


def test_nothing_saves_nothing_inside_the_blocks():
    counts = {}
    for repeat in (2, 4):
        for remat in (True, False):
            cfg = _cfg("qwen2-72b", remat)
            cfg = dataclasses.replace(cfg, stages=(dataclasses.replace(
                cfg.stages[0], repeat=repeat),))
            counts[repeat, remat] = _saved(cfg)
    assert counts[4, True] == counts[2, True]
    assert counts[4, False] - counts[2, False] > 10


def test_a_rerun_with_other_bits_raises():
    w = torch.ones(4, requires_grad=True)
    shifts = [0.0, 1e-3]

    def fn(x):
        return x * w + shifts.pop(0), ()

    tape = sharding.StagedBackward()
    with tape:
        y, _ = sharding.checkpoint_block(fn, torch.ones(4))
    with pytest.raises(RuntimeError, match="other bits than its forward"):
        tape.backward(y.sum())
