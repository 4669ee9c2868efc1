"""The embeddings archs trained by the port, against the reference, on
the CPU.

- The trainer splits a batch as the reference does: M-RoPE
  ``positions`` (3, B, S) at dim 1, every other key at dim 0, over the
  ranks (the reference's ``batch_specs``) and over the microbatches
  (its ``_split_micro``).  The positions differ per section and per row
  (Qwen2-VL's vision positions with a per-row text offset): the
  dataset's own are one ``arange`` in every row and section, and cannot
  show rows mixed up.  Each rank's microbatches are recorded where the
  trainer hands them to the model, for the composed, ``auto`` and ZeRO-1
  steps.
- Reduced qwen2-vl-7b (2 microbatches) and seamless-m4t-large-v2 (1)
  trained composed on 4 data ranks, batch 8, seq 32, for 3 steps with
  AdamW from the reference's initial weights on the same numpy batches
  (the reference's settings from its dry-run: AdamW, 2 and 1
  microbatches): each step's loss within 1e-4 and gradient norm within
  1e-5 relative of the reference trainer's, replicas bit-identical.

The reference's runs come from one child interpreter with 4 host
devices.
"""

import json

import numpy as np
import pytest
import torch

from conftest import run_subprocess_script
from repro.train import trainer as ref_trainer
from repro_torch.comm import Session
from repro_torch.configs import get_config
from repro_torch.launch.train import build_session
from repro_torch.models import build_model
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.frontends import vision_positions
from repro_torch.optim import cosine_schedule, make_optimizer
from repro_torch.runtime import substrate
from repro_torch.train import trainer
from repro_torch.tree import leaves, map_tree, unflatten

STEPS, SEQ, BATCH, RANKS = 3, 32, 8, 4
LOSS_RTOL, NORM_RTOL = 1e-4, 1e-5
RUNS = (("qwen2-vl-7b", 2), ("seamless-m4t-large-v2", 1))


def host_batch(arch, cfg, step, b=BATCH, s=SEQ):
    """The numpy batch both packages train ``arch`` on at ``step``."""
    rng = np.random.default_rng([7, step])
    labels = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    embeds = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
    if arch == "seamless-m4t-large-v2":
        return {"frame_embeds": embeds * np.float32(0.05),
                "tokens": rng.integers(0, cfg.vocab_size,
                                       (b, s)).astype(np.int32),
                "labels": labels}
    # the vision positions, the text part of row r moved on by 5r + step
    pos = vision_positions(b, s).numpy().copy()
    pos[:, :, s // 4:] += (5 * np.arange(b, dtype=np.int32)
                           + step)[None, :, None]
    return {"positions": pos, "inputs_embeds": embeds * np.float32(0.02),
            "labels": labels}


class _Batches:
    """A dataset of ``host_batch``'s batches (what ``build_session``
    probes with)."""

    def __init__(self, arch, cfg):
        self.arch, self.cfg = arch, cfg

    def host_batch(self, step):
        return host_batch(self.arch, self.cfg, step)


def _adamw():
    return make_optimizer("adamw", lr=cosine_schedule(
        1e-3, warmup=max(STEPS // 20, 1), total=STEPS))


def _ref_rows(batch, rank: int, n: int, micro: int):
    """Microbatch ``micro`` of data rank ``rank`` of ``n`` as the
    reference cuts it: the rank's rows at the dim ``batch_specs`` shards
    over the data axes, then its ``_split_micro``."""
    specs = ref_trainer.batch_specs(batch)
    rows = {}
    for k, v in batch.items():
        dim = next(i for i, a in enumerate(specs[k]) if a is not None)
        per = v.shape[dim] // n
        rows[k] = np.take(v, range(rank * per, (rank + 1) * per), axis=dim)
    return {k: np.asarray(v[micro]) for k, v in
            ref_trainer._split_micro(rows, 2).items()}


@pytest.mark.parametrize("kw", [{}, {"sync_mode": "auto"}, {"zero": True}],
                         ids=["composed", "auto", "zero"])
def test_split_takes_the_references_rows(kw, monkeypatch):
    cfg = get_config("qwen2-vl-7b", reduced=True)
    model = build_model(cfg)
    batch = host_batch("qwen2-vl-7b", cfg, 0)
    pos = batch["positions"]
    assert len({pos[0, r, -1] for r in range(BATCH)}) == BATCH
    assert not np.array_equal(pos[1], pos[2])      # h and w differ
    mesh = substrate.make_host_mesh(RANKS, device="cpu")
    opt = _adamw()
    tcfg = trainer.TrainCfg(microbatches=2, **kw)
    session = (Session(mesh=mesh, mode="monolithic")
               if tcfg.sync_mode == "auto" else
               build_session(mesh, model, opt, _Batches("qwen2-vl-7b", cfg),
                             tcfg))
    step_fn = trainer.make_train_step(model, opt, tcfg, comm=session.world)
    states = trainer.init_states(
        model, opt, model.init(torch.Generator().manual_seed(0)), tcfg, mesh)
    seen = {}

    def record(params, mb):
        seen.setdefault(substrate.current_rank(), []).append(
            {k: v.numpy().copy() for k, v in mb.items()})
        return (torch.zeros(()), map_tree(torch.zeros_like, params))

    monkeypatch.setattr(model, "loss_and_grads", record)
    # the rows are counted off the first key, whichever it is
    for first in ("inputs_embeds", "positions"):
        seen.clear()
        step_fn(states, {first: batch[first], **batch})
        assert sorted(seen) == list(range(RANKS))
        for r in range(RANKS):
            assert len(seen[r]) == 2
            for i, got in enumerate(seen[r]):
                want = _ref_rows(batch, r, RANKS, i)
                assert sorted(got) == sorted(want)
                for k in want:
                    assert got[k].shape == want[k].shape, (first, r, i, k)
                    assert np.array_equal(got[k], want[k]), (first, r, i, k)


REFERENCE_CHILD = """
import json, types
import jax, numpy as np
from jax.sharding import NamedSharding
from repro.configs import get_config
from repro.launch import train as lt
from repro.launch.mesh import make_host_mesh
from repro.models import build_model
from repro.optim import cosine_schedule, make_optimizer
from repro.parallel.sharding import filter_spec, named_shardings
from repro.runtime import substrate
from repro.train import trainer
STEPS = {steps}
out = {{}}
for arch, micro in {runs}:
    cfg = get_config(arch, reduced=True)
    model = build_model(cfg)
    mesh = make_host_mesh(model_parallel=1)
    opt = make_optimizer("adamw", lr=cosine_schedule(
        1e-3, warmup=max(STEPS // 20, 1), total=STEPS))
    batches = [dict(np.load({path!r} + f"_{{arch}}_batch{{s}}.npz"))
               for s in range(STEPS)]
    ds = types.SimpleNamespace(host_batch=lambda step: batches[step])
    params = model.init(jax.random.PRNGKey(0))
    np.savez({path!r} + "_" + arch + ".npz", **{{
        "/".join(str(k.key) for k in p): np.asarray(v)
        for p, v in jax.tree_util.tree_flatten_with_path(params)[0]}})
    args = types.SimpleNamespace(
        microbatches=micro, sync="composed", bucket_grads=False,
        bucket_bytes=32 << 20, overlap=False, overlap_depth=2, zero=False)
    sess = lt.build_session(mesh, model, opt, ds, args)
    tcfg = trainer.TrainCfg(microbatches=micro, sync_mode="composed")
    step_fn = jax.jit(trainer.make_train_step(model, opt, tcfg, mesh=mesh,
                                              comm=sess.world))
    sspecs = trainer.state_specs(model, opt, tcfg, mesh=mesh)
    with substrate.set_mesh(mesh):
        state = trainer.make_train_state(model, opt, jax.random.PRNGKey(0),
                                         cfg=tcfg, mesh=mesh)
        state = jax.device_put(state, named_shardings(mesh, sspecs))
        losses, norms = [], []
        for step in range(STEPS):
            b = batches[step]
            specs = trainer.batch_specs(b)
            gb = {{k: jax.make_array_from_callback(
                v.shape, NamedSharding(mesh, filter_spec(
                    specs[k], mesh.axis_names)), lambda idx, v=v: v[idx])
                for k, v in b.items()}}
            state, m = step_fn(state, gb)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
    out[arch] = {{"loss": losses, "grad_norm": norms}}
print("RUNS", json.dumps(out))
"""


@pytest.fixture(scope="module")
def reference_run(tmp_path_factory):
    """({arch: {"loss", "grad_norm"}}, {arch: initial weights as a numpy
    tree}) of the reference's composed runs on 4 data ranks."""
    path = str(tmp_path_factory.mktemp("ref") / "run")
    for arch, _ in RUNS:
        cfg = get_config(arch, reduced=True)
        for step in range(STEPS):
            np.savez(f"{path}_{arch}_batch{step}.npz",
                     **host_batch(arch, cfg, step))
    out = run_subprocess_script(REFERENCE_CHILD.format(
        steps=STEPS, runs=list(RUNS), path=path), devices=RANKS,
        timeout=600)
    line = next(l for l in out.splitlines() if l.startswith("RUNS "))
    trees = {}
    for arch, _ in RUNS:
        w = np.load(f"{path}_{arch}.npz")
        trees[arch] = unflatten([tuple(k.split("/")) for k in w.files],
                                [w[k] for k in w.files])
    return json.loads(line[len("RUNS "):]), trees


def _rel_err(got, want) -> float:
    want = np.asarray(want, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - want).max()
                 / max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("arch,micro", RUNS)
def test_embeddings_training_matches_reference(reference_run, arch, micro):
    ref, trees = reference_run
    cfg = get_config(arch, reduced=True)
    model = build_model(cfg)
    opt = _adamw()
    mesh = substrate.make_host_mesh(RANKS, device="cpu")
    tcfg = trainer.TrainCfg(microbatches=micro)
    ds = _Batches(arch, cfg)
    step_fn = trainer.make_train_step(model, opt, tcfg, comm=build_session(
        mesh, model, opt, ds, tcfg).world)
    states = trainer.init_states(
        model, opt, params_from_numpy(trees[arch], cfg, device="cpu"), tcfg,
        mesh)
    losses, norms = [], []
    for step in range(STEPS):
        states, metrics = step_fn(states, ds.host_batch(step))
        losses.append(metrics["loss"].item())
        norms.append(metrics["grad_norm"].item())
        for st in states[1:]:
            for a, b in zip(leaves(states[0]["params"]),
                            leaves(st["params"])):
                assert torch.equal(a, b), f"replicas differ at {step}"
    want = ref[arch]
    assert _rel_err(losses, want["loss"]) <= LOSS_RTOL, (losses, want)
    assert _rel_err(norms, want["grad_norm"]) <= NORM_RTOL, (norms, want)
