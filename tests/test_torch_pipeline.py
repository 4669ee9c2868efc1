"""The data pipeline's sharded batches and prefetcher
(``repro_torch.data.pipeline``) against the reference's
(``repro.data.pipeline``):

- ``sharded_batch``'s rank slices equal, bit for bit, the reference's
  addressable shards of the same step on a (4,) and a (data 2, model 2)
  host mesh (one JAX child with 4 host devices), ``inputs_embeds`` and
  M-RoPE ``positions`` (split at dim 1) included; the ranks of one data
  coordinate share one copy;
- the train step splits its global batch through ``shard_batch``: fed
  host batches or a ``Prefetcher``'s tensors, the same bits;
- ``Prefetcher`` keeps order and depth, raises the fetch's error in the
  consumer in its place, and closes.
"""

import functools
import json
import time

import numpy as np
import pytest
import torch

from conftest import run_subprocess_script
from repro_torch.configs import get_config
from repro_torch.data import SyntheticLMDataset
from repro_torch.data.pipeline import Prefetcher
from repro_torch.launch.train import build_session
from repro_torch.models import build_model
from repro_torch.optim import make_optimizer
from repro_torch.runtime import substrate
from repro_torch.train import trainer
from repro_torch.tree import leaves, map_tree

DS = dict(vocab_size=97, seq_len=8, global_batch=4, seed=7, embed_dim=6,
          with_embeds=True, mrope=True)
MESHES = {"4": ((4,), ("data",)), "2x2": ((2, 2), ("data", "model"))}

_CHILD = r"""
import json
import numpy as np
from repro.data.pipeline import SyntheticLMDataset
from repro.runtime import substrate

ds = SyntheticLMDataset(**json.loads('DS'))
out = {}
for name, (shape, axes) in json.loads('MESHES').items():
    mesh = substrate.make_mesh(tuple(shape), tuple(axes))
    order = {d.id: r for r, d in enumerate(mesh.devices.flat)}
    batch = ds.sharded_batch(3, mesh)
    ranks = [{} for _ in order]
    for k, arr in batch.items():
        for shard in arr.addressable_shards:
            ranks[order[shard.device.id]][k] = np.asarray(shard.data).tolist()
    out[name] = ranks
print(json.dumps(out))
"""


@functools.lru_cache(maxsize=None)
def _reference():
    code = _CHILD.replace("'DS'", repr(json.dumps(DS))).replace(
        "'MESHES'", repr(json.dumps(MESHES)))
    return json.loads(run_subprocess_script(code, devices=4,
                                            timeout=300).splitlines()[-1])


@pytest.mark.parametrize("name", list(MESHES))
def test_sharded_batch_equals_reference_shards(name):
    shape, axes = MESHES[name]
    mesh = substrate.make_mesh(shape, axes, device="cpu")
    got = SyntheticLMDataset(**DS).sharded_batch(3, mesh)
    want = _reference()[name]
    assert len(got) == len(want) == mesh.size
    for r, (g, w) in enumerate(zip(got, want)):
        assert set(g) == set(w) == {"tokens", "labels", "inputs_embeds",
                                    "positions"}
        for k in g:
            assert g[k].device.type == "cpu"
            ref = np.asarray(w[k], dtype=g[k].numpy().dtype)
            assert g[k].shape == ref.shape, (r, k)
            assert np.array_equal(g[k].numpy(), ref), (r, k)
    if "model" in axes:          # one copy a data coordinate
        assert got[0]["tokens"] is got[1]["tokens"]
        assert got[0]["tokens"] is not got[2]["tokens"]


def test_step_over_sharded_batch_gives_the_same_bits():
    """The step splits its global batch through ``shard_batch``: fed the
    host batches, or the same batches as tensors through a
    ``Prefetcher``, it gives the same bits."""
    cfg = get_config("granite-34b", reduced=True)
    model = build_model(cfg)
    ds = SyntheticLMDataset(vocab_size=cfg.vocab_size, seq_len=16,
                            global_batch=4, seed=1)
    mesh = substrate.make_host_mesh(2, device="cpu")
    opt = make_optimizer("adamw", lr=1e-3)
    tcfg = trainer.TrainCfg(sync_mode="composed", microbatches=2)
    session = build_session(mesh, model, opt, ds, tcfg)
    params = model.init(torch.Generator().manual_seed(0))
    feeds = {
        "host": lambda: map(ds.host_batch, range(2)),
        "prefetched": lambda: Prefetcher(
            lambda s: {k: torch.from_numpy(v)
                       for k, v in ds.host_batch(s).items()}, depth=2),
    }
    out = []
    for name, feed in feeds.items():
        states = trainer.init_states(model, opt,
                                     map_tree(torch.clone, params), tcfg,
                                     mesh)
        step = trainer.make_train_step(model, opt, tcfg, comm=session.world)
        batches = feed()
        for _ in range(2):
            states, metrics = step(states, next(batches))
        if name == "prefetched":
            batches.close()
        out.append((float(metrics["loss"]), leaves(states[1]["params"])))
    (l0, p0), (l1, p1) = out
    assert l0 == l1
    assert all(torch.equal(a, b) for a, b in zip(p0, p1))
    with pytest.raises(ValueError, match="do not split"):
        step(states, SyntheticLMDataset(vocab_size=cfg.vocab_size,
                                        seq_len=16, global_batch=3,
                                        seed=1).host_batch(0))


def test_sharded_batch_refuses_rows_that_do_not_split():
    mesh = substrate.make_host_mesh(3, device="cpu")
    with pytest.raises(ValueError, match="do not split"):
        SyntheticLMDataset(**DS).sharded_batch(0, mesh)


def test_prefetcher_keeps_order_and_depth():
    calls = []

    def fetch(step):
        calls.append(step)
        return step * step

    pf = Prefetcher(fetch, depth=3, start_step=2)
    deadline = time.monotonic() + 10
    while len(calls) < 4 and time.monotonic() < deadline:
        time.sleep(0.01)
    time.sleep(0.05)
    # three queued, one fetched and waiting for room: no further
    assert calls == [2, 3, 4, 5]
    assert [next(pf) for _ in range(5)] == [4, 9, 16, 25, 36]
    pf.close()
    assert not pf._thread.is_alive()


def test_prefetcher_raises_the_fetch_error_in_place():
    def fetch(step):
        if step == 2:
            raise KeyError("no batch 2")
        return step

    pf = Prefetcher(fetch, depth=2)
    assert next(pf) == 0 and next(pf) == 1
    with pytest.raises(KeyError, match="no batch 2"):
        next(pf)
    pf.close()


def test_prefetcher_close_drains_and_stops():
    pf = Prefetcher(lambda s: np.zeros(4) + s, depth=2)
    assert float(next(pf)[0]) == 0.0
    pf.close()
    assert not pf._thread.is_alive()
    assert pf._q.empty()
    with pytest.raises(ValueError):
        Prefetcher(lambda s: s, depth=0)
