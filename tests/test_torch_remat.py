"""Rematerialization in the port (``models.remat``), on the CPU.

- The loss and every gradient of a reduced arch's training forward with
  ``remat`` on, under each policy its config has, are bit-equal
  (``torch.equal``) to ``remat`` off: the recompute is the same op
  sequence on the same inputs.
- Policy "dots" keeps the outputs of the 2-D products (``aten.mm`` /
  ``addmm``) and of nothing else, and every product with a 2-D weight
  lowers to one of them (an ``einsum`` over a weight that lowered to
  ``bmm`` would fall outside the policy unseen); batched products (the
  attention's, SSD's and the experts') are recomputed.
- Policy "nothing" keeps only the blocks' inputs: the tensors saved for
  the backward outside the checkpoints do not grow with depth.
- Prefill, decode and a forward under ``no_grad`` never enter a
  checkpoint; a layer over a "model" axis never enters
  ``torch.utils.checkpoint``: its blocks are checkpointed on the staged
  backward's tape (``tests/test_torch_remat_tp.py``).
- The remat fields have the reference's names and defaults.
"""

import collections
import dataclasses

import numpy as np
import pytest
import torch
from torch.utils import checkpoint as tuc
from torch.utils._python_dispatch import TorchDispatchMode

from repro.models import encdec as ref_encdec
from repro.models import transformer as ref_transformer
from repro_torch.configs import get_config
from repro_torch.data import SyntheticLMDataset
from repro_torch.launch.train import build_session
from repro_torch.models import build_model
from repro_torch.models import encdec as ED
from repro_torch.models import remat as R
from repro_torch.models import transformer as T
from repro_torch.optim import make_optimizer
from repro_torch.runtime import substrate
from repro_torch.train import trainer
from repro_torch.tree import flatten, leaves, unflatten

B, S = 2, 32
ARCHS = ("granite-34b", "qwen3-moe-30b-a3b", "deepseek-v3-671b",
         "mamba2-1.3b", "jamba-1.5-large-398b", "qwen2-vl-7b",
         "seamless-m4t-large-v2")
CASES = [(a, p) for a in ARCHS
         for p in (("nothing",) if a == "seamless-m4t-large-v2"
                   else R.POLICIES)]


def make_batch(model, seed=0, b=B, s=S):
    """A loss batch for ``model`` from numpy seeded by ``seed``."""
    cfg = model.cfg
    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(a)
    batch = {"tokens": t(rng.integers(0, cfg.vocab_size, (b, s))),
             "labels": t(rng.integers(0, cfg.vocab_size, (b, s)))}
    embeds = t(rng.standard_normal((b, s, cfg.d_model)).astype(np.float32))
    if model.kind == "encdec":
        batch["frame_embeds"] = embeds
    elif not cfg.embed_inputs:
        batch["inputs_embeds"] = embeds
        batch["positions"] = t(rng.integers(0, s, (3, b, s)).astype(np.int32))
    return batch


def with_remat(arch, remat, policy="nothing"):
    cfg = get_config(arch, reduced=True)
    kw = {"remat_policy": policy} if isinstance(cfg, T.TransformerCfg) \
        else {}
    return build_model(dataclasses.replace(cfg, remat=remat, **kw))


class _Counting:
    """Counts the calls of ``torch.utils.checkpoint.checkpoint`` while
    installed (the remat module looks it up at each call)."""

    def __init__(self, monkeypatch):
        self.calls = 0
        real = tuc.checkpoint

        def spy(*a, **k):
            self.calls += 1
            return real(*a, **k)

        monkeypatch.setattr(tuc, "checkpoint", spy)


def _blocks(model) -> int:
    """Checkpointed blocks of one training forward."""
    cfg = model.cfg
    if model.kind == "encdec":
        return cfg.enc_layers + cfg.dec_layers
    return sum(st.repeat for st in cfg.stages)


@pytest.mark.parametrize("arch,policy", CASES)
def test_remat_gives_the_bits_of_no_remat(arch, policy, monkeypatch):
    off = with_remat(arch, False)
    params = off.init(torch.Generator().manual_seed(0))
    batch = make_batch(off)
    loss_off, grads_off = off.loss_and_grads(params, batch)
    calls = _Counting(monkeypatch)
    loss_on, grads_on = with_remat(arch, True, policy).loss_and_grads(
        params, batch)
    assert calls.calls == _blocks(off)
    assert torch.equal(loss_on, loss_off)
    for a, b in zip(leaves(grads_on), leaves(grads_off)):
        assert torch.equal(a, b)


class _Products(TorchDispatchMode):
    """Records each product op and whether an operand is a 2-D weight
    (shares its storage with a param leaf and has 2 dims)."""

    def __init__(self, params):
        super().__init__()
        self.storages = {p.untyped_storage().data_ptr()
                         for p in leaves(params)}
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in R.DOTS or func == torch.ops.aten.bmm.default:
            weight2d = any(
                isinstance(a, torch.Tensor) and a.ndim == 2
                and a.untyped_storage().data_ptr() in self.storages
                for a in args)
            self.seen.append((func, weight2d))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("arch", [a for a in ARCHS
                                  if a != "seamless-m4t-large-v2"])
def test_dots_keeps_the_2d_products_only(arch, monkeypatch):
    model = with_remat(arch, True, "dots")
    params = model.init(torch.Generator().manual_seed(0))
    batch = make_batch(model)
    # the products of one forward without remat, by kind
    with torch.no_grad(), _Products(params) as mode:
        model.loss(params, batch)
    weight_bmm = [f for f, w in mode.seen if w and f not in R.DOTS]
    assert not weight_bmm, "a 2-D weight's product lowered to bmm"
    decided = collections.Counter()
    real = tuc.create_selective_checkpoint_contexts

    def contexts(policy_fn, *a, **k):
        def spy(ctx, op, *args, **kwargs):
            pol = policy_fn(ctx, op, *args, **kwargs)
            if not ctx.is_recompute:
                decided[op, pol] += 1
            return pol
        return real(spy, *a, **k)

    monkeypatch.setattr(tuc, "create_selective_checkpoint_contexts",
                        contexts)
    model.loss_and_grads(params, batch)
    saved = {op: n for (op, pol), n in decided.items()
             if pol == tuc.CheckpointPolicy.MUST_SAVE}
    assert set(saved) <= set(R.DOTS)
    # the checkpointed products are those of the stages (the head's and
    # the MTP block's run outside them)
    with torch.no_grad(), _Products(params) as stages:
        x = (batch["inputs_embeds"] if "inputs_embeds" in batch
             else params["embed"][batch["tokens"].long()])
        for i, st in enumerate(model.cfg.stages):
            x = T.apply_stage(params[f"stage{i}"], model.cfg, st, x,
                              positions=batch.get("positions"),
                              train=True)[0]
    assert sum(saved.values()) == sum(f in R.DOTS for f, _ in stages.seen)
    bmm = decided.get((torch.ops.aten.bmm.default,
                       tuc.CheckpointPolicy.PREFER_RECOMPUTE), 0)
    assert bmm > 0 and not decided.get((torch.ops.aten.bmm.default,
                                        tuc.CheckpointPolicy.MUST_SAVE))


def _saved_outside(model, params, batch) -> int:
    """Tensors the training forward saves for its backward outside the
    checkpoints (a checkpoint's own hooks take its blocks' saves)."""
    n = 0
    paths = flatten(params)[1]

    def pack(t):
        nonlocal n
        n += 1
        return t

    params = [p.detach().requires_grad_(True) for p in leaves(params)]
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        model.loss(unflatten(paths, params), batch)
    return n


@pytest.mark.parametrize("arch", ["granite-34b", "seamless-m4t-large-v2"])
def test_nothing_keeps_only_block_inputs(arch):
    """The tensors saved outside the checkpoints grow with depth by the
    new blocks' inputs alone."""
    counts = {}
    for layers in (2, 4):
        cfg = get_config(arch, reduced=True)
        if isinstance(cfg, ED.EncDecCfg):
            cfg = dataclasses.replace(cfg, enc_layers=layers,
                                      dec_layers=layers)
        else:
            cfg = dataclasses.replace(cfg, stages=(dataclasses.replace(
                cfg.stages[0], repeat=layers),))
        for remat in (True, False):
            model = build_model(dataclasses.replace(cfg, remat=remat))
            params = model.init(torch.Generator().manual_seed(0))
            counts[layers, remat] = _saved_outside(model, params,
                                                   make_batch(model))
    # two more blocks save only their tensor inputs: x, and a decoder
    # layer's memory too; without remat each adds all it keeps
    added = 2 if arch == "granite-34b" else 2 * 1 + 2 * 2
    assert counts[4, True] - counts[2, True] == added
    assert counts[4, False] - counts[2, False] > 10 * added


@pytest.mark.parametrize("arch", ARCHS)
def test_serving_never_checkpoints(arch, monkeypatch):
    model = with_remat(arch, True)
    params = model.init(torch.Generator().manual_seed(0))
    batch = make_batch(model)
    calls = _Counting(monkeypatch)
    prompt = {k: v for k, v in batch.items() if k != "labels"}
    kw = {"enc_len": S} if model.kind == "encdec" else {}
    caches = model.init_caches(B, 2 * S, dtype=torch.float32, device="cpu",
                               **kw)
    _, caches = model.prefill(params, prompt, caches)
    step = ({"inputs_embeds": batch["inputs_embeds"][:, :1],
             "positions": batch["positions"][:, :, :1] + S}
            if "inputs_embeds" in batch
            else {"tokens": batch["tokens"][:, :1]})
    model.decode_step(params, step, caches)
    with torch.no_grad():
        model.loss(params, batch)
    if model.supports_chunked_prefill and model.kind == "decoder":
        caches = model.init_caches(B, 2 * S, dtype=torch.float32,
                                   device="cpu")
        model.prefill_chunk(params, {k: v[..., :S // 2] if k == "positions"
                                     else v[:, :S // 2]
                                     for k, v in prompt.items()}, caches,
                            q_offset=0, valid_len=S // 2,
                            last_index=S // 2 - 1)
    assert calls.calls == 0


def test_tp_layers_are_not_checkpointed(monkeypatch):
    """A training step on (data 1, model 2), remat on as by default: no
    layer over "model" enters ``torch.utils.checkpoint`` (whose recompute
    would run on autograd's device thread), and every block is
    checkpointed on the staged backward's tape instead: each rank reruns
    each of them once."""
    from repro_torch.parallel import sharding
    cfg = get_config("granite-34b", reduced=True)
    assert cfg.remat
    model = build_model(cfg, model_parallel=2)
    opt = make_optimizer("adamw", lr=1e-3)
    ds = SyntheticLMDataset(vocab_size=cfg.vocab_size, seq_len=16,
                            global_batch=4)
    mesh = substrate.make_host_mesh(1, model_parallel=2, device="cpu")
    tcfg = trainer.TrainCfg()
    step_fn = trainer.make_train_step(model, opt, tcfg, comm=build_session(
        mesh, model, opt, ds, tcfg).world)
    states = trainer.init_states(
        model, opt, model.init(torch.Generator().manual_seed(0)), tcfg,
        mesh)
    calls = _Counting(monkeypatch)
    reruns = []
    run = sharding._Block.run
    monkeypatch.setattr(sharding._Block, "run",
                        lambda block: (reruns.append(1), run(block))[1])
    _, metrics = step_fn(states, ds.host_batch(0))
    assert calls.calls == 0 and np.isfinite(metrics["loss"].item())
    assert len(reruns) == mesh.size * _blocks(model)


def test_remat_fields_are_the_references():
    for port, ref in ((T.TransformerCfg, ref_transformer.TransformerCfg),
                      (ED.EncDecCfg, ref_encdec.EncDecCfg)):
        want = {f.name: f.default for f in dataclasses.fields(ref)
                if f.name.startswith("remat")}
        got = {f.name: f.default for f in dataclasses.fields(port)
               if f.name.startswith("remat")}
        assert got == want and want
    assert T.TransformerCfg.__dataclass_fields__["remat_policy"].default \
        in R.POLICIES
    with pytest.raises(ValueError, match="unknown remat_policy"):
        R.checkpointed(lambda x: x, torch.ones(1, requires_grad=True),
                       policy="everything")
