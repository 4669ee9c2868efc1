"""Parts held whole over "model" where their split does not divide
(``parallel.sharding.TPLayout.whole``), as the reference's ``fit_spec``
drops a spec entry whose dim does not divide: what lets the dry-run
trace qwen2-vl-7b (28 query heads), mamba2-1.3b (vocabulary 50280) and
seamless-m4t-large-v2 (256206) at the production meshes' 16 model ranks.

- The layouts at 16: which part is whole, its leaves unsplit and no
  partial sums; nothing whole where the split divides.
- The twins: reduced qwen2-vl-7b with 6 query heads on (data 1, model
  4) (its attention whole) and reduced mamba2-1.3b and seamless with a
  vocabulary of 251 on (1, 2) (embedding and head whole), 3 steps with
  ``check_model_replicas`` (the whole parts' gradients bit-equal on
  every model rank) against (1, 1) from the same params and batches:
  losses and gradient norms within ``TWIN_RTOL`` relative (f32; the
  largest readings were 0 for the losses and 1.3e-7 for the norms).
- ``shard_params`` then ``unshard_params`` gives the whole tree back.

No JAX here: the port's own unsplit model is the reference.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.comm import Session
from repro_torch.configs import get_config
from repro_torch.data import SyntheticLMDataset
from repro_torch.models import build_model
from repro_torch.optim import make_optimizer
from repro_torch.parallel import sharding
from repro_torch.runtime import substrate
from repro_torch.train import trainer
from repro_torch.tree import flatten, map_tree

TWIN_RTOL = 5e-6
STEPS, SEQ, BATCH = 3, 16, 4


def _cfg(arch):
    """(reduced config whose split does not divide, model ranks)."""
    cfg = get_config(arch, reduced=True)
    if arch == "qwen2-vl-7b":
        return dataclasses.replace(cfg, attn=dataclasses.replace(
            cfg.attn, num_heads=6)), 4
    return dataclasses.replace(cfg, vocab_size=251), 2


def _batch(arch, cfg, step):
    batch = SyntheticLMDataset(vocab_size=cfg.vocab_size, seq_len=SEQ,
                               global_batch=BATCH, seed=3).host_batch(step)
    rng = np.random.default_rng([11, step])
    if arch == "qwen2-vl-7b":
        pos = np.broadcast_to(np.arange(SEQ, dtype=np.int32),
                              (3, BATCH, SEQ)).copy()
        pos[1] += np.arange(BATCH, dtype=np.int32)[:, None]
        return {"inputs_embeds": rng.standard_normal(
                    (BATCH, SEQ, cfg.d_model), dtype=np.float32) * 0.02,
                "positions": pos, "labels": batch["labels"]}
    if arch == "seamless-m4t-large-v2":
        batch["frame_embeds"] = rng.standard_normal(
            (BATCH, SEQ, cfg.d_model), dtype=np.float32) * 0.05
    return batch


@pytest.mark.parametrize("arch,whole", [
    ("qwen2-vl-7b", ("attn",)), ("mamba2-1.3b", ("vocab",)),
    ("seamless-m4t-large-v2", ("vocab",))])
def test_layouts_at_sixteen(arch, whole):
    cfg = get_config(arch)
    model = build_model(cfg, model_parallel=16)
    lay = model.layout
    assert lay.whole == whole
    assert sharding.layout(cfg, 2).whole == ()
    paths = flatten(model.abstract_params())[1]
    for path, partial in zip(paths, sharding.partial_sum_leaves(paths, lay)):
        if ("attn" in whole and "attn" in path) or (
                "vocab" in whole and path[-1] in ("embed", "lm_head")):
            assert sharding.leaf_split(path, lay) is None, path
            assert not partial, path
    if whole == ("attn",):
        assert (lay.heads, lay.kv_heads) == (cfg.attn.num_heads,
                                             cfg.attn.num_kv_heads)
        assert not lay.kv_replicated
        assert lay.d_ff == cfg.mlp.d_ff // 16
    else:
        assert lay.vocab == cfg.vocab_size


def _run(arch, cfg, m, params):
    model = build_model(cfg, model_parallel=m)
    opt = make_optimizer("adamw", lr=1e-3)
    tcfg = trainer.TrainCfg(sync_mode="auto", check_model_replicas=m > 1)
    mesh = substrate.make_host_mesh(1, model_parallel=m, device="cpu")
    step = trainer.make_train_step(
        model, opt, tcfg, comm=Session(mesh=mesh, mode="monolithic").world)
    states = trainer.init_states(model, opt, map_tree(torch.clone, params),
                                 tcfg, mesh)
    losses, norms = [], []
    for s in range(STEPS):
        states, metrics = step(states, _batch(arch, cfg, s))
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
    return losses, norms


@pytest.mark.parametrize("arch", ["qwen2-vl-7b", "mamba2-1.3b",
                                  "seamless-m4t-large-v2"])
def test_whole_parts_train_as_the_unsplit_model(arch):
    cfg, m = _cfg(arch)
    assert build_model(cfg, model_parallel=m).layout.whole
    params = build_model(cfg).init(torch.Generator().manual_seed(5))
    l1, n1 = _run(arch, cfg, 1, params)
    lm, nm = _run(arch, cfg, m, params)
    assert np.all(np.isfinite(lm))
    np.testing.assert_allclose(lm, l1, rtol=TWIN_RTOL)
    np.testing.assert_allclose(nm, n1, rtol=TWIN_RTOL)


@pytest.mark.parametrize("arch", ["qwen2-vl-7b", "mamba2-1.3b"])
def test_shard_unshard_round_trip(arch):
    cfg, m = _cfg(arch)
    model = build_model(cfg, model_parallel=m)
    params = build_model(cfg).init(torch.Generator().manual_seed(1))
    shards = [model.shard(params, j) for j in range(m)]
    back = sharding.unshard_params(shards, model.layout)
    for (a, b) in zip(flatten(params)[0], flatten(back)[0]):
        assert torch.equal(a, b)
