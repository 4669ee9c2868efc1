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
- Adafactor (reduced mistral-large-123b, ``min_dim_factored`` 32): a
  (2, 2) run's state gathers to the paths and shapes of the reference's
  ``make_train_state``, each leaf split over "model" where the
  reference's ``state_specs`` puts "model" (``vr`` / ``vc`` included);
  it scatters back onto (2, 2) and onto (1, 2) bit-equal and trains on;
  ZeRO-1 saved per shard at data 4 restores at data 3; a
  reference-written state restores through the port and a port-written
  (2, 2) checkpoint through the reference, bit-equal (in this process).
  ZeRO-1 with Adafactor on (2, 2) crosses with the reference's (2, 2)
  ZeRO-1 checkpoint both ways, bit-equal (the child's side, as for
  AdamW), restores onto (3, 2), (2, 1) and (1, 2), and a random state
  in its layout round-trips over the expert and sectioned leaves.
"""

import dataclasses
import math
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
from repro_torch.parallel import sharding
from repro_torch.runtime import substrate as S
from repro_torch.runtime.elastic import remesh
from repro_torch.train import trainer
from repro_torch.tree import flatten, leaves, map_tree, unflatten


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
    states, _, (_, _, tcfg_from, mesh_from) = _zero_run(p_from, 2)
    model = build_model(get_config("granite-34b", reduced=True))
    saved = trainer.gather_state(states, tcfg_from, mesh_from, model)
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
    tcfg = trainer.TrainCfg(zero=True, overlap=True)
    mesh = S.make_host_mesh(p_to, device="cpu")
    tree, step = mgr.restore_latest(trainer.global_abstract_state(
        model, make_optimizer("adamw"), tcfg, mesh), allow_resize_1d=True)
    assert step == 2
    restored = trainer.scatter_state(tree, tcfg, mesh, model)
    _assert_trees_equal(trainer.logical_state(
        trainer.gather_state(restored, tcfg, mesh, model)), want)
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
tp = {tp!r}
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

# a (data 2, model 2) run's state: ZeRO-1 and compressed with bucketed EF,
# and ZeRO-1 with Adafactor of the reduced mistral-large-123b
mesh = substrate.make_mesh((2, 2), ("data", "model"))
zero = trainer.TrainCfg(sync_mode="composed", data_axes=("data",), zero=True)
af = (build_model(get_config("mistral-large-123b", reduced=True)),
      make_optimizer("adafactor", lr=1e-3, min_dim_factored=32))
for kind, tcfg, (model, opt) in (
        ("zero", zero, (model, opt)),
        ("ef", trainer.TrainCfg(
            sync_mode="compressed", data_axes=("data",), bucket_grads=True,
            bucket_bytes={bucket_bytes}), (model, opt)),
        ("af_zero", zero, af)):
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
    np.savez(tp[kind]["ref_npz"], **{{str(i): np.asarray(l)
                                     for i, (_, l) in enumerate(flat)}})
    manager.save_checkpoint(tp[kind]["ref_dir"], 1, state, sharded=True)
    port = manager.restore_checkpoint(
        tp[kind]["port_dir"], trainer.make_train_state(
            model, opt, abstract=True, cfg=tcfg, mesh=mesh))
    np.savez(tp[kind]["port_npz"], **{{str(i): np.asarray(l) for i, l in
                                       enumerate(jax.tree_util.tree_leaves(
                                           port))}})
print("CHILD OK")
"""


TP_TCFGS = {"zero": {"zero": True},
            "ef": {"sync_mode": "compressed", "bucket_grads": True,
                   "bucket_bytes": 1 << 14},
            "af_zero": {"zero": True}}


def _tp_run(kind, shape=(2, 2), steps=1):
    """A (data, model) run of the reduced granite-34b with AdamW (of the
    reduced mistral-large-123b with Adafactor for "af_zero"), ``kind``
    one of ``TP_TCFGS``: (session, mesh, states after ``steps``
    steps)."""
    if kind == "af_zero":
        cfg = get_config(AF_ARCH, reduced=True)
        opt = make_optimizer("adafactor", lr=1e-3, min_dim_factored=32)
    else:
        cfg = get_config("granite-34b", reduced=True)
        opt = make_optimizer("adamw", lr=1e-3, clip_norm=0.0)
    sess = trainer.TrainSession(
        build_model(cfg, model_parallel=2), opt,
        trainer.TrainCfg(data_axes=("data",), **TP_TCFGS[kind]))
    ds = SyntheticLMDataset(vocab_size=cfg.vocab_size, seq_len=16,
                            global_batch=12)
    mesh = S.make_mesh(shape, ("data", "model"), device="cpu")
    states = sess.init_state(torch.Generator().manual_seed(0), mesh=mesh)
    step_fn = sess.step_fn(build_session(mesh, sess.model, sess.optimizer,
                                         ds, sess.cfg).world)
    for s in range(steps):
        states, metrics = step_fn(states, ds.host_batch(s))
        assert np.isfinite(metrics["loss"].item())
    return sess, mesh, states


def _dense(tree):
    return [l.dense() if isinstance(l, ShardedTensor) else l
            for l in leaves(tree)]


@pytest.fixture(scope="module")
def crossed(tmp_path_factory):
    """A port ZeRO checkpoint (4 ranks, 1 step, sharded), port
    checkpoints of (data 2, model 2) runs (``TP_TCFGS``, 1 step,
    sharded), and the child's outputs: the reference's dense and sharded
    checkpoints of its own state and sharded ones of its (2, 2) states
    (with those states as npz), and the port's checkpoints as the
    reference restored them (npz)."""
    root = tmp_path_factory.mktemp("cross")
    paths = {k: str(root / k) for k in ("port_dir", "ref_dense",
                                        "ref_sharded")}
    paths.update({k: str(root / (k + ".npz"))
                  for k in ("ref_npz", "port_npz")})
    tp = {kind: {k: str(root / (f"{k}_tp_{kind}"
                                + (".npz" if k.endswith("npz") else "")))
                 for k in ("ref_dir", "port_dir", "ref_npz", "port_npz")}
          for kind in TP_TCFGS}
    states, _, (model, opt, tcfg, mesh) = _zero_run(4, 1)
    saved = trainer.gather_state(states, tcfg, mesh, model)
    save_checkpoint(paths["port_dir"], 1, saved, sharded=True)
    tp_runs = {}
    for kind in TP_TCFGS:
        sess, mesh22, st22 = _tp_run(kind)
        tp_runs[kind] = (sess, mesh22, sess.gather(st22, mesh22))
        save_checkpoint(tp[kind]["port_dir"], 1, tp_runs[kind][2],
                        sharded=True)
    out = run_subprocess_script(CHILD.format(
        tp=tp, bucket_bytes=TP_TCFGS["ef"]["bucket_bytes"], **paths),
        devices=4)
    assert "CHILD OK" in out
    return (paths, trainer.logical_state(saved), saved,
            (model, opt, tcfg, mesh), tp, tp_runs)


def _npz_leaves(path):
    z = np.load(path)
    return [z[str(i)] for i in range(len(z.files))]


@pytest.mark.parametrize("layout", ["ref_dense", "ref_sharded"])
def test_reference_checkpoint_restores_through_the_port(crossed, layout):
    paths, _, _, (model, opt, tcfg, mesh), _, _ = crossed
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
    states = trainer.scatter_state(got, tcfg, mesh, model)   # and it trains
    _, losses, _ = _zero_run(4, 1, states=states)
    assert np.isfinite(losses).all()


def test_port_checkpoint_restores_through_the_reference(crossed):
    paths, _, saved, _, _, _ = crossed
    got = _npz_leaves(paths["port_npz"])
    want = [l.dense() if isinstance(l, ShardedTensor) else l
            for l in leaves(saved)]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert _bits_equal(torch.from_numpy(np.array(g)), w)


@pytest.mark.parametrize("kind", list(TP_TCFGS))
def test_reference_tp_checkpoint_restores_through_the_port(crossed, kind):
    """The reference's (2, 2) state, saved per shard (its boxes split
    over "data" too), restores bit-equal; scattered onto the port's
    (2, 2) ranks and gathered back it is the same global tree, and it
    trains."""
    _, _, _, _, tp, tp_runs = crossed
    sess, mesh, _ = tp_runs[kind]
    assert any("shards" in e for e in load_manifest(
        tp[kind]["ref_dir"])["leaves"])
    got = restore_checkpoint(tp[kind]["ref_dir"],
                             sess.abstract_state(mesh=mesh))
    want = [torch.from_numpy(np.array(w))
            for w in _npz_leaves(tp[kind]["ref_npz"])]
    assert len(leaves(got)) == len(want)
    for t, w in zip(leaves(got), want):
        assert _bits_equal(t, w)
    states = sess.scatter(got, mesh)
    _assert_trees_equal(
        trainer.logical_state(sess.gather(states, mesh)),
        trainer.logical_state(got))
    cfg = sess.model.cfg
    ds = SyntheticLMDataset(vocab_size=cfg.vocab_size, seq_len=16,
                            global_batch=12)
    _, metrics = sess.step_fn(build_session(
        mesh, sess.model, sess.optimizer, ds, sess.cfg).world)(
            states, ds.host_batch(1))
    assert np.isfinite(metrics["loss"].item())


@pytest.mark.parametrize("kind", list(TP_TCFGS))
def test_port_tp_checkpoint_restores_through_the_reference(crossed, kind):
    _, _, _, _, tp, tp_runs = crossed
    man = load_manifest(tp[kind]["port_dir"])
    assert sum("shards" in e for e in man["leaves"]) > 0
    got = _npz_leaves(tp[kind]["port_npz"])
    want = _dense(tp_runs[kind][2])
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert _bits_equal(torch.from_numpy(np.array(g)), w)


@pytest.fixture(scope="module")
def zero_tp_saved(tmp_path_factory):
    """A ZeRO-1 run on (data 4, model 2) saved per shard after 1 step:
    (session, directory, its logical state)."""
    d = str(tmp_path_factory.mktemp("zero_tp"))
    sess, mesh, states = _tp_run("zero", shape=(4, 2))
    saved = sess.gather(states, mesh)
    save_checkpoint(d, 1, saved, sharded=True)
    return sess, d, trainer.logical_state(saved)


@pytest.mark.parametrize("shape", [(3, 2), (2, 1), (1, 2)])
def test_zero_tp_checkpoint_restores_onto_another_mesh(zero_tp_saved,
                                                       shape):
    sess, d, want = zero_tp_saved
    mesh = S.make_mesh(shape, ("data", "model"), device="cpu")
    tree = restore_checkpoint(d, sess.abstract_state(mesh=mesh),
                              allow_resize_1d=True)
    states = sess.scatter(tree, mesh)
    assert len(states) == mesh.size
    assert states[0]["params"]["lm_head"].shape[-1] * shape[1] == \
        want["params"]["lm_head"].shape[-1]
    _assert_trees_equal(trainer.logical_state(sess.gather(states, mesh)),
                        want)


@pytest.mark.parametrize("shape", [(3, 2), (2, 1), (1, 2)])
def test_adafactor_zero_tp_checkpoint_restores_onto_another_width(
        crossed, shape):
    """The port's ZeRO-1 + Adafactor (2, 2) checkpoint (each rank's piece
    of its data rank's chunk of every whole param, saved per shard)
    restores onto another data and model width: the logical state
    bit-equal, and it trains."""
    _, _, _, _, tp, tp_runs = crossed
    sess, _, saved = tp_runs["af_zero"]
    want = trainer.logical_state(saved)
    mesh = S.make_mesh(shape, ("data", "model"), device="cpu")
    tree = restore_checkpoint(tp["af_zero"]["port_dir"],
                              sess.abstract_state(mesh=mesh),
                              allow_resize_1d=True)
    states = sess.scatter(tree, mesh)
    _assert_trees_equal(trainer.logical_state(sess.gather(states, mesh)),
                        want)
    _adafactor_run(sess, mesh, states=states)


def _random_global(sess, mesh, seed):
    """A random tree in the checkpoint layout for ``mesh`` (ZeRO's
    padding zero, as the layout has it)."""
    ab = sess.abstract_state(mesh=mesh)
    rng = np.random.RandomState(seed)
    ls, ps = flatten(ab)
    sizes = {p[1:]: math.prod(l.shape) for p, l in zip(ps, ls)
             if p[0] == "params"}
    out = []
    for p, l in zip(ps, ls):
        x = torch.from_numpy(np.asarray(rng.randn(*l.shape) * 8,
                                        np.float32)).to(l.dtype)
        n = (sizes.get(sharding.opt_leaf(p, None)[0])
             if p[0] == "opt" and sess.cfg.zero else None)
        if n is not None:
            x[n:] = 0
        out.append(x)
    return unflatten(ps, out)


@pytest.mark.parametrize("src,dst", [((3, 2), (5, 1)), ((5, 2), (3, 2)),
                                     ((1, 2), (7, 2))])
@pytest.mark.parametrize("zero", [False, True], ids=["leaf", "zero1"])
@pytest.mark.parametrize("arch", ["granite-34b", "qwen3-moe-30b-a3b",
                                  "jamba-1.5-large-398b"])
def test_state_round_trip_over_every_split_kind(arch, zero, src, dst):
    """A random global state scattered onto ``src`` and gathered gives
    itself; re-meshed onto ``dst`` (another data width that divides no
    leaf, another model width) and gathered, the same logical state.
    granite-34b holds column (-1), row (-2) and replicated leaves (MQA's
    K/V among them), qwen3-moe-30b-a3b expert (-3) ones too, and
    jamba-1.5-large-398b sectioned ones (Mamba's ``in_proj`` and conv,
    whose ZeRO chunks a gather writes back section by section)."""
    cfg = get_config(arch, reduced=True)
    sess = trainer.TrainSession(build_model(cfg, model_parallel=2),
                                make_optimizer("adamw"),
                                trainer.TrainCfg(zero=zero))
    lay = sess.model.layout
    kinds = {sharding.leaf_split(p, lay)
             for p in flatten(sess.abstract_state(
                 mesh=S.make_mesh(src, ("data", "model"), device="cpu"))
                 )[1]}
    assert kinds >= {-1, -2, None} and (-3 in kinds) == (arch != "granite-34b")
    for seed in range(2):
        mesh = S.make_mesh(src, ("data", "model"), device="cpu")
        tree = _random_global(sess, mesh, seed)
        states = sess.scatter(tree, mesh)
        back = sess.gather(states, mesh)
        _assert_trees_equal(unflatten(flatten(back)[1], _dense(back)), tree)
        new = S.make_mesh(dst, ("data", "model"), device="cpu")
        moved = remesh(states, sess.cfg, sess.abstract_state(mesh=new), new,
                       mesh=mesh, model=sess.model)
        _assert_trees_equal(trainer.logical_state(sess.gather(moved, new)),
                            trainer.logical_state(tree))


@pytest.mark.parametrize("src,dst", [((3, 2), (5, 1)), ((1, 2), (7, 2))])
@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b",
                                  "jamba-1.5-large-398b"])
def test_adafactor_zero_state_round_trip_over_every_split_kind(arch, src,
                                                              dst):
    """ZeRO-1 with Adafactor over "model": a random global state
    scattered onto ``src`` (each rank's pieces of the whole params'
    chunks) and gathered gives itself; re-meshed onto ``dst`` and
    gathered, the same logical state (expert and sectioned leaves
    included)."""
    cfg = get_config(arch, reduced=True)
    sess = trainer.TrainSession(build_model(cfg, model_parallel=2),
                                make_optimizer("adafactor"),
                                trainer.TrainCfg(zero=True))
    mesh = S.make_mesh(src, ("data", "model"), device="cpu")
    tree = _random_global(sess, mesh, 0)
    states = sess.scatter(tree, mesh)
    back = sess.gather(states, mesh)
    _assert_trees_equal(unflatten(flatten(back)[1], _dense(back)), tree)
    new = S.make_mesh(dst, ("data", "model"), device="cpu")
    moved = remesh(states, sess.cfg, sess.abstract_state(mesh=new), new,
                   mesh=mesh, model=sess.model)
    _assert_trees_equal(trainer.logical_state(sess.gather(moved, new)),
                        trainer.logical_state(tree))


def test_bucket_layout_hint_names_global_buckets_on_a_model_axis(tmp_path):
    """A compressed+bucketed (2, 2) checkpoint holds the reference's
    global EF buckets; restoring it with another ``bucket_bytes`` names
    both global layouts."""
    sess, mesh, states = _tp_run("ef", steps=0)
    d = str(tmp_path / "ck")
    save_checkpoint(d, 0, sess.gather(states, mesh))
    saved = [int(t.shape[0]) for t in sess.abstract_state(mesh)["ef"]]
    other = trainer.TrainSession(sess.model, sess.optimizer,
                                 dataclasses.replace(sess.cfg,
                                                     bucket_bytes=1 << 20))
    want = [int(t.shape[0]) for t in other.abstract_state(mesh)["ef"]]
    assert len(saved) != len(want)
    with pytest.raises(ValueError) as err:
        restore_checkpoint(d, other.abstract_state(mesh))
    assert str(saved) in str(err.value) and str(want) in str(err.value)


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



# ---------------------------------------------------------------------------
# Adafactor's state in the checkpoint layout
# ---------------------------------------------------------------------------

AF_ARCH = "mistral-large-123b"


def _adafactor_session(model_parallel, **cfg_kw):
    """Reduced mistral-large-123b with Adafactor (``min_dim_factored``
    32: the reduced widths factor) on ``model_parallel`` model ranks."""
    return trainer.TrainSession(
        build_model(get_config(AF_ARCH, reduced=True),
                    model_parallel=model_parallel),
        make_optimizer("adafactor", lr=1e-3, min_dim_factored=32),
        trainer.TrainCfg(data_axes=("data",), **cfg_kw))


def _adafactor_run(sess, mesh, steps=1, states=None):
    cfg = sess.model.cfg
    ds = SyntheticLMDataset(vocab_size=cfg.vocab_size, seq_len=16,
                            global_batch=12)
    if states is None:
        states = sess.init_state(torch.Generator().manual_seed(0), mesh=mesh)
    step_fn = sess.step_fn(build_session(
        mesh, sess.model_for(mesh), sess.optimizer, ds, sess.cfg).world)
    for s in range(steps):
        states, metrics = step_fn(states, ds.host_batch(s))
        assert np.isfinite(metrics["loss"].item())
    return states


def _reference_adafactor():
    """(the reference's model, optimizer and TrainCfg) of the reduced
    arch, as ``_adafactor_session`` builds it."""
    from repro.configs import get_config as jget_config
    from repro.models import build_model as jbuild_model
    from repro.optim import make_optimizer as jmake_optimizer
    from repro.train import trainer as jtrainer
    return (jbuild_model(jget_config(AF_ARCH, reduced=True)),
            jmake_optimizer("adafactor", lr=1e-3, min_dim_factored=32),
            jtrainer.TrainCfg())


def test_adafactor_state_gathers_to_the_reference_tree():
    """A (2, 2) run's state gathered: the paths and shapes of the
    reference's ``make_train_state`` for Adafactor, and each leaf split
    over "model" at the dim where the reference's ``state_specs`` puts
    "model" (Adafactor's ``vr`` / ``vc`` included)."""
    from jax.sharding import PartitionSpec as P
    from repro.train import trainer as jtrainer
    sess = _adafactor_session(2)
    mesh = S.make_mesh((2, 2), ("data", "model"), device="cpu")
    got = sess.gather(_adafactor_run(sess, mesh), mesh)
    jmodel, jopt, jcfg = _reference_adafactor()
    want = jtrainer.make_train_state(jmodel, jopt, abstract=True, cfg=jcfg)
    specs = jtrainer.state_specs(jmodel, jopt, jcfg)
    wpaths, wl = zip(*jax.tree_util.tree_flatten_with_path(want)[0])
    sl = jax.tree_util.tree_leaves(specs,
                                   is_leaf=lambda x: isinstance(x, P))
    gl, gpaths = flatten(got)
    assert gpaths == [tuple(k.key for k in p) for p in wpaths]
    assert any(p[-1] == "vr" for p in gpaths)
    lay = sess.model_for(mesh).layout
    for path, g, w, spec in zip(gpaths, gl, wl, sl):
        assert tuple(g.shape) == tuple(w.shape), path
        assert str(g.dtype).split(".")[-1] == str(w.dtype), path
        entries = tuple(spec) + (None,) * (len(w.shape) - len(spec))
        model_dims = [i - len(entries) for i, e in enumerate(entries)
                      if e == "model"]
        assert sharding.leaf_split(path, lay) == (
            model_dims[0] if model_dims else None), path
        assert isinstance(g, ShardedTensor) == bool(model_dims), path


@pytest.mark.parametrize("shape", [(2, 2), (1, 2)])
def test_adafactor_state_scatters_back_bit_equal(shape):
    """Gathered on (2, 2), scattered onto ``shape`` and gathered again:
    the same global tree, bit for bit, which trains on."""
    sess = _adafactor_session(2)
    mesh = S.make_mesh((2, 2), ("data", "model"), device="cpu")
    tree = sess.gather(_adafactor_run(sess, mesh), mesh)
    tree = unflatten(flatten(tree)[1], [t.clone() for t in _dense(tree)])
    want = trainer.logical_state(tree)
    new = S.make_mesh(shape, ("data", "model"), device="cpu")
    states = sess.scatter(tree, new)
    assert len(states) == new.size
    _assert_trees_equal(trainer.logical_state(sess.gather(states, new)),
                        want)
    _adafactor_run(sess, new, states=states)


def test_adafactor_zero_checkpoint_restores_onto_another_width(tmp_path):
    """ZeRO-1 with Adafactor saved per shard at data 4, restored at data
    3: the logical state (each flat statistic cut to its param's size)
    bit-equal, and it trains."""
    sess = _adafactor_session(1, zero=True, overlap=True)
    mesh = S.make_mesh((4,), ("data",), device="cpu")
    saved = sess.gather(_adafactor_run(sess, mesh), mesh)
    assert all(p[-1] == "v" for p in flatten(saved["opt"]["f"])[1])
    want = map_tree(lambda t: t.clone(), trainer.logical_state(saved))
    d = str(tmp_path / "ck")
    save_checkpoint(d, 1, saved, sharded=True)
    new = S.make_mesh((3,), ("data",), device="cpu")
    tree = restore_checkpoint(d, sess.abstract_state(mesh=new),
                              allow_resize_1d=True)
    states = sess.scatter(tree, new)
    _assert_trees_equal(trainer.logical_state(sess.gather(states, new)),
                        want)
    _adafactor_run(sess, new, states=states)


def test_adafactor_checkpoints_cross_both_ways(tmp_path):
    """A reference-written Adafactor train state (random values) restores
    through the port bit-equal and trains on (2, 2); the port's (2, 2)
    run saved per shard restores through the reference bit-equal."""
    from repro.train import trainer as jtrainer
    jmodel, jopt, jcfg = _reference_adafactor()
    rng = np.random.RandomState(5)
    state = jax.tree_util.tree_map(
        lambda x: (np.abs(rng.randn(*x.shape)) if x.ndim
                   else np.asarray(3)).astype(x.dtype),
        jtrainer.make_train_state(jmodel, jopt, abstract=True, cfg=jcfg))
    d_ref = str(tmp_path / "ref")
    jmanager.save_checkpoint(d_ref, 1, state)
    sess = _adafactor_session(2)
    mesh = S.make_mesh((2, 2), ("data", "model"), device="cpu")
    got = restore_checkpoint(d_ref, sess.abstract_state(mesh=mesh))
    want = jax.tree_util.tree_leaves(state)
    assert len(leaves(got)) == len(want)
    for t, w in zip(leaves(got), want):
        assert _bits_equal(t, torch.from_numpy(np.array(w)))
    states = _adafactor_run(sess, mesh, states=sess.scatter(got, mesh))
    d_port = str(tmp_path / "port")
    tree = sess.gather(states, mesh)
    save_checkpoint(d_port, 2, tree, sharded=True)
    assert any("shards" in e for e in load_manifest(d_port)["leaves"])
    back = jmanager.restore_checkpoint(d_port, jtrainer.make_train_state(
        jmodel, jopt, abstract=True, cfg=jcfg))
    for w, t in zip(jax.tree_util.tree_leaves(back), _dense(tree)):
        assert _bits_equal(torch.from_numpy(np.array(w)), t)
