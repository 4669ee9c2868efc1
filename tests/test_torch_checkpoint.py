"""Checkpoints: the port's store, and checkpoints crossing between the
two packages.

- Round trips keep every bit (f32, bf16, int32 scalars, the bucketed EF
  tuple); a save leaves no ``.tmp`` behind; ``allow_resize_1d``
  truncates or zero-pads 1-D leaves only; a compressed+bucketed restore
  with another ``bucket_bytes`` names both bucket layouts; the manager's
  gc keeps ``keep`` steps, skips stray names and reclaims an orphaned
  ``.tmp``, and it records each save's wait, call and durable times.
- ZeRO: a run on 4 thread ranks saved per shard (async, while the
  caller goes on) restores onto 2 ranks and a run on 2 onto 4: the
  gathered logical state equals the saved one bit for bit, and the next
  step trains.
- Across packages: a reference train state in the ZeRO layout, saved by
  ``repro.checkpoint.save_checkpoint`` unsharded and ``sharded=True``
  from 4 host devices, restores through the port equal to the same
  state converted to torch; a port-written sharded ZeRO checkpoint
  restores through ``repro.checkpoint.restore_checkpoint`` bit-equal;
  bf16 leaves cross both ways.  One child interpreter with 4 host
  devices does the reference's side.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import run_subprocess_script
from repro.checkpoint import manager as jmanager
from repro_torch.checkpoint import (CheckpointManager, ShardedTensor,
                                    latest_step, load_manifest,
                                    restore_checkpoint, save_checkpoint)
from repro_torch.configs import get_config
from repro_torch.data import SyntheticLMDataset
from repro_torch.launch.train import build_session
from repro_torch.models import build_model
from repro_torch.optim import make_optimizer
from repro_torch.runtime import substrate as S
from repro_torch.train import trainer
from repro_torch.tree import flatten, leaves, map_tree


def _meta(tree):
    return map_tree(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                          device="meta"), tree)


def _bits_equal(a, b) -> bool:
    view = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    return (a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.reshape(-1).view(view[a.element_size()]),
        b.reshape(-1).view(view[b.element_size()])))


def _assert_trees_equal(a, b):
    la, pa = flatten(a)
    lb, pb = flatten(b)
    assert pa == pb
    for path, x, y in zip(pa, la, lb):
        assert _bits_equal(x, y), path


def test_roundtrip_keeps_every_bit_and_leaves_no_tmp(tmp_path):
    rng = np.random.RandomState(0)
    tree = {"ef": (torch.from_numpy(rng.randn(600).astype(np.float32)),
                   torch.from_numpy(rng.randn(20).astype(np.float32))),
            "opt": {"m": torch.from_numpy(rng.randn(4, 3).astype(
                np.float32)).to(torch.bfloat16),
                    "step": torch.tensor(7, dtype=torch.int32)},
            "params": {"w": torch.from_numpy(rng.randn(5, 2).astype(
                np.float32))}}
    d = str(tmp_path / "ck")
    save_checkpoint(d, 3, tree, meta={"note": "x"})
    assert latest_step(d) == 3 and os.listdir(d) == ["step_00000003"]
    assert load_manifest(d)["meta"] == {"note": "x"}
    out = restore_checkpoint(d, _meta(tree))
    assert isinstance(out["ef"], tuple)
    _assert_trees_equal(out, tree)


def test_restore_resize_1d(tmp_path):
    d = str(tmp_path / "ck")
    padded = torch.cat([torch.arange(13, dtype=torch.float32),
                        torch.zeros(3)])
    save_checkpoint(d, 0, {"v": padded, "w": torch.ones(2, 2)})
    meta = lambda n, w=(2, 2): {"v": torch.empty(n, device="meta"),
                                "w": torch.empty(w, device="meta")}
    with pytest.raises(ValueError, match="shape"):
        restore_checkpoint(d, meta(15))
    out = restore_checkpoint(d, meta(15), allow_resize_1d=True)
    assert torch.equal(out["v"], padded[:15])
    out = restore_checkpoint(d, meta(18), allow_resize_1d=True)
    assert torch.equal(out["v"][:13], torch.arange(13.0))
    assert not out["v"][13:].any()
    with pytest.raises(ValueError, match="shape"):
        restore_checkpoint(d, meta(16, (3, 2)), allow_resize_1d=True)


def _bucketed_state(bucket_bytes):
    model = build_model(get_config("granite-34b", reduced=True))
    tcfg = trainer.TrainCfg(sync_mode="compressed", bucket_grads=True,
                            bucket_bytes=bucket_bytes)
    return trainer.abstract_state(model, make_optimizer("adamw"), tcfg)


def test_bucket_layout_mismatch_names_both_layouts(tmp_path):
    d = str(tmp_path / "ck")
    saved = map_tree(lambda t: torch.zeros(t.shape, dtype=t.dtype),
                     _bucketed_state(64 * 1024))
    save_checkpoint(d, 3, saved)
    smaller = _bucketed_state(16 * 1024)
    assert len(smaller["ef"]) != len(saved["ef"])
    with pytest.raises(ValueError) as err:
        restore_checkpoint(d, smaller, step=3)
    msg = str(err.value)
    assert "bucket_bytes" in msg
    assert str([int(e.shape[0]) for e in saved["ef"]]) in msg
    assert str([int(e.shape[0]) for e in smaller["ef"]]) in msg
    _assert_trees_equal(restore_checkpoint(d, _bucketed_state(64 * 1024)),
                        saved)
    bad = {"params": saved["params"], "step": saved["step"]}
    with pytest.raises(ValueError, match="structure changed"):
        restore_checkpoint(d, bad, step=3)


def test_gc_skips_stray_names_and_reclaims_orphan_tmp(tmp_path):
    d = str(tmp_path / "ck")
    mgr = CheckpointManager(d, every=1, keep=2, async_=False)
    os.makedirs(os.path.join(d, "step_foo"))
    os.makedirs(os.path.join(d, "step_00000009.tmp"))
    assert latest_step(d) is None
    for s in (1, 2, 3):
        mgr.maybe_save(s, {"x": torch.zeros(2)})
    names = set(os.listdir(d))
    assert "step_foo" in names
    assert not any(n.endswith(".tmp") for n in names)
    assert names >= {"step_00000002", "step_00000003"}
    assert "step_00000001" not in names
    assert mgr.maybe_save(4, {"x": torch.zeros(2)})
    tree, step = mgr.restore_latest({"x": torch.empty(2, device="meta")})
    assert step == 4 and torch.equal(tree["x"], torch.zeros(2))


@pytest.mark.parametrize("async_", [False, True], ids=["sync", "async"])
def test_manager_records_each_save(tmp_path, async_):
    mgr = CheckpointManager(str(tmp_path / "ck"), every=2, keep=1,
                            async_=async_)
    for s in range(5):
        mgr.maybe_save(s, {"x": torch.full((64,), float(s))})
    mgr.maybe_save(5, {"x": torch.zeros(64)}, force=True)
    mgr.wait()
    assert [sv["step"] for sv in mgr.saves] == [0, 2, 4, 5]
    for sv in mgr.saves:
        assert min(sv["wait_s"], sv["call_s"], sv["durable_s"]) >= 0
        assert sv["t0"] <= sv["t_called"]
        assert sv["t_durable"] >= sv["t0"] + sv["wait_s"]
    assert mgr.latest() == 5 and os.listdir(str(tmp_path / "ck")) == [
        "step_00000005"]


# ---------------------------------------------------------------------------
# ZeRO: save on one width, restore on another
# ---------------------------------------------------------------------------

def _zero_run(p, steps, states=None):
    cfg = get_config("granite-34b", reduced=True)
    model = build_model(cfg)
    opt = make_optimizer("adamw", lr=1e-3)
    ds = SyntheticLMDataset(vocab_size=cfg.vocab_size, seq_len=16,
                            global_batch=8)
    tcfg = trainer.TrainCfg(zero=True, overlap=True)
    mesh = S.make_host_mesh(p, device="cpu")
    sess = build_session(mesh, model, opt, ds, tcfg)
    if states is None:
        states = trainer.replicate(trainer.make_train_state(
            model, opt, model.init(torch.Generator().manual_seed(0)), tcfg,
            mesh=mesh), p)
    step_fn = trainer.make_train_step(model, opt, tcfg, comm=sess.world)
    losses = []
    start = int(states[0]["step"])
    for step in range(start, start + steps):
        states, metrics = step_fn(states, ds.host_batch(step))
        losses.append(metrics["loss"].item())
    return states, losses, (model, opt, tcfg, mesh)


@pytest.mark.parametrize("p_from,p_to", [(4, 2), (2, 4)])
def test_zero_checkpoint_reshards_onto_another_width(tmp_path, p_from,
                                                     p_to):
    states, _, _ = _zero_run(p_from, 2)
    saved = trainer.gather_state(states, trainer.TrainCfg(zero=True))
    want = map_tree(lambda t: t.clone(), trainer.logical_state(saved))
    d = str(tmp_path / "ck")
    mgr = CheckpointManager(d, every=1, async_=True, sharded=True)
    mgr.maybe_save(2, saved)
    for st in states:              # the caller goes on; the cut holds
        for t in leaves(st["opt"]):
            t.add_(1)
    mgr.wait()
    assert os.listdir(d) == ["step_00000002"]
    man = load_manifest(d)
    assert sum("shards" in e for e in man["leaves"]) == 2 * 11
    assert all(len(e["shards"]) == p_from for e in man["leaves"]
               if "shards" in e)
    model = build_model(get_config("granite-34b", reduced=True))
    tcfg = trainer.TrainCfg(zero=True, overlap=True)
    mesh = S.make_host_mesh(p_to, device="cpu")
    tree, step = mgr.restore_latest(trainer.global_abstract_state(
        model, make_optimizer("adamw"), tcfg, mesh), allow_resize_1d=True)
    assert step == 2
    restored = trainer.scatter_state(tree, tcfg, mesh)
    _assert_trees_equal(
        trainer.logical_state(trainer.gather_state(restored, tcfg)), want)
    _, losses, _ = _zero_run(p_to, 1, states=restored)
    assert np.isfinite(losses).all()


# ---------------------------------------------------------------------------
# Across packages
# ---------------------------------------------------------------------------

def test_bf16_leaves_cross_both_ways(tmp_path):
    rng = np.random.RandomState(3)
    x = rng.randn(4, 3).astype(np.float32)
    port_tree = {"m": torch.from_numpy(x).to(torch.bfloat16),
                 "step": torch.tensor(5, dtype=torch.int32)}
    d = str(tmp_path / "port")
    save_checkpoint(d, 0, port_tree)
    got = jmanager.restore_checkpoint(d, {
        "m": jax.ShapeDtypeStruct((4, 3), jnp.bfloat16),
        "step": jax.ShapeDtypeStruct((), jnp.int32)})
    assert got["m"].dtype == jnp.bfloat16
    np.testing.assert_array_equal(
        np.asarray(got["m"]).view(np.int16),
        port_tree["m"].view(torch.int16).numpy())
    assert int(got["step"]) == 5
    d2 = str(tmp_path / "ref")
    jmanager.save_checkpoint(d2, 0, got)
    _assert_trees_equal(restore_checkpoint(d2, _meta(port_tree)), port_tree)


CHILD = """
import json
import jax, jax.numpy as jnp, numpy as np
from repro.checkpoint import manager
from repro.configs import get_config
from repro.models import build_model
from repro.optim import make_optimizer
from repro.parallel.sharding import named_shardings
from repro.runtime import substrate
from repro.train import trainer

cfg = get_config("granite-34b", reduced=True)
model = build_model(cfg)
opt = make_optimizer("adamw", lr=1e-3)
mesh = substrate.make_mesh((4,), ("data",))
tcfg = trainer.TrainCfg(sync_mode="composed", data_axes=("data",),
                        zero=True)
rng = np.random.RandomState(0)
state = trainer.make_train_state(model, opt, jax.random.PRNGKey(0),
                                 cfg=tcfg, mesh=mesh)
state = jax.tree_util.tree_map(
    lambda x: (rng.randn(*x.shape) if x.ndim else np.asarray(3)
               ).astype(x.dtype), state)
with substrate.set_mesh(mesh):
    state = jax.device_put(state, named_shardings(
        mesh, trainer.state_specs(model, opt, tcfg, mesh=mesh)))
flat = jax.tree_util.tree_flatten_with_path(state)[0]
assert any(not l.is_fully_replicated for _, l in flat)
np.savez({ref_npz!r}, **{{str(i): np.asarray(l)
                          for i, (_, l) in enumerate(flat)}})
manager.save_checkpoint({ref_dense!r}, 1, state)
manager.save_checkpoint({ref_sharded!r}, 1, state, sharded=True)
port = manager.restore_checkpoint(
    {port_dir!r}, trainer.make_train_state(model, opt, abstract=True,
                                            cfg=tcfg, mesh=mesh),
    allow_resize_1d=False)
np.savez({port_npz!r}, **{{str(i): np.asarray(l) for i, l in
                           enumerate(jax.tree_util.tree_leaves(port))}})
print("CHILD OK")
"""


@pytest.fixture(scope="module")
def crossed(tmp_path_factory):
    """A port ZeRO checkpoint (4 ranks, 1 step, sharded) and the child's
    outputs: the reference's dense and sharded checkpoints of its own
    state (with that state as npz), and the port's checkpoint as the
    reference restored it (npz)."""
    root = tmp_path_factory.mktemp("cross")
    paths = {k: str(root / k) for k in ("port_dir", "ref_dense",
                                        "ref_sharded")}
    paths.update({k: str(root / (k + ".npz"))
                  for k in ("ref_npz", "port_npz")})
    states, _, (model, opt, tcfg, mesh) = _zero_run(4, 1)
    saved = trainer.gather_state(states, tcfg)
    save_checkpoint(paths["port_dir"], 1, saved, sharded=True)
    out = run_subprocess_script(CHILD.format(**paths), devices=4)
    assert "CHILD OK" in out
    return paths, trainer.logical_state(saved), saved, (model, opt, tcfg, mesh)


def _npz_leaves(path):
    z = np.load(path)
    return [z[str(i)] for i in range(len(z.files))]


@pytest.mark.parametrize("layout", ["ref_dense", "ref_sharded"])
def test_reference_checkpoint_restores_through_the_port(crossed, layout):
    paths, _, _, (model, opt, tcfg, mesh) = crossed
    if layout == "ref_sharded":
        man = load_manifest(paths[layout])
        assert any("shards" in e for e in man["leaves"])
    abstract = trainer.global_abstract_state(model, opt, tcfg, mesh)
    got = restore_checkpoint(paths[layout], abstract)
    want = _npz_leaves(paths["ref_npz"])
    ls = leaves(got)
    assert len(ls) == len(want)
    for t, w in zip(ls, want):
        assert _bits_equal(t, torch.from_numpy(np.array(w)))
    states = trainer.scatter_state(got, tcfg, mesh)   # and it trains
    _, losses, _ = _zero_run(4, 1, states=states)
    assert np.isfinite(losses).all()


def test_port_checkpoint_restores_through_the_reference(crossed):
    paths, _, saved, _ = crossed
    got = _npz_leaves(paths["port_npz"])
    want = [l.dense() if isinstance(l, ShardedTensor) else l
            for l in leaves(saved)]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert _bits_equal(torch.from_numpy(np.array(g)), w)


def test_train_cli_restores_onto_another_width(tmp_path):
    """The launcher's ZeRO run saves sharded checkpoints; a second launch
    on 4 ranks restores the latest and trains on to the last step."""
    from repro_torch.launch import train as launch_train
    d = str(tmp_path / "ck")
    common = ["--device", "cpu", "--arch", "granite-34b", "--reduced",
              "--sync", "composed", "--zero", "--overlap", "--seq-len",
              "16", "--global-batch", "4", "--ckpt-dir", d,
              "--ckpt-sharded", "--ckpt-every", "2", "--log-every", "1"]
    launch_train.main(common + ["--steps", "2", "--data", "2"])
    man = load_manifest(d)
    assert man["step"] == 2 and any("shards" in e for e in man["leaves"])
    launch_train.main(common + ["--steps", "3", "--data", "4"])
    assert latest_step(d) == 3
    assert sorted(os.listdir(d)) == ["step_00000002", "step_00000003"]

