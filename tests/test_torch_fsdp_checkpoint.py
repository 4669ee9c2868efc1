"""Checkpoints and re-meshing of the ``auto`` step's state split over
"data" (``test_torch_fsdp.py``: the layout and the step), on the CPU.

- A (data 2, model 2) ``auto`` run's state, gathered (``TrainSession.
  gather``: the reference's global tree, each block a box of it) and
  saved per shard, restores onto (data 1, model 2), (data 4, model 2)
  and ``composed``'s layout (params whole over "data"), and gathered
  from each of those back to the same tree, bit for bit; onto (data 4,
  model 2) each rank holds a quarter of every split leaf, and the
  restored run trains.  For reduced granite-34b with AdamW and reduced
  mistral-large-123b with factored Adafactor statistics.
- It crosses with the reference's (2, 2) ``auto`` checkpoint both ways:
  the reference's state, placed by its ``state_specs`` and saved per
  shard, restores through the port bit for bit, scatters onto the
  port's (2, 2) ranks and gathers back to the same tree; the port's
  checkpoint restores through the reference's ``restore_checkpoint``
  bit for bit.  One child interpreter with 4 host devices (about 12 s
  on the CPU).
- Under ``ElasticController`` an ``auto`` run on (4, 1) that loses a
  rank at step 3 goes on on (3, 1), where no width of the reduced config
  divides by 3 and every leaf is whole, bit for bit the run started on
  the survivors from the step-2 checkpoint.
"""

import tempfile

import numpy as np
import pytest
import torch

from conftest import run_subprocess_script
from repro_torch.checkpoint import (ShardedTensor, load_manifest,
                                    restore_checkpoint, save_checkpoint)
from repro_torch.comm import Session
from repro_torch.configs import get_config
from repro_torch.data import SyntheticLMDataset
from repro_torch.models import build_model
from repro_torch.optim import make_optimizer
from repro_torch.parallel import sharding
from repro_torch.runtime import substrate
from repro_torch.runtime.controller import (ElasticController, FaultEvent,
                                            FaultPlan)
from repro_torch.train import trainer
from repro_torch.tree import flatten, leaves

AXES = ("data", "model")
ARCHS = {"granite-34b": ("adamw", {}),
         "mistral-large-123b": ("adafactor", {"min_dim_factored": 32})}


def _bits_equal(a, b) -> bool:
    return sharding.bits_equal(a, b)


def _assert_trees_equal(a, b):
    la, pa = flatten(a)
    lb, pb = flatten(b)
    assert pa == pb
    for path, x, y in zip(pa, la, lb):
        assert _bits_equal(x, y), path


def _session(arch, sync="auto", model_parallel=2):
    name, kw = ARCHS[arch]
    cfg = get_config(arch, reduced=True)
    return trainer.TrainSession(
        build_model(cfg, model_parallel=model_parallel),
        make_optimizer(name, lr=1e-3, **kw),
        trainer.TrainCfg(sync_mode=sync, data_axes=("data",))), cfg


def _step(sess, cfg, mesh, states, step):
    ds = SyntheticLMDataset(vocab_size=cfg.vocab_size, seq_len=16,
                            global_batch=8)
    step_fn = sess.step_fn(Session(mesh=mesh, mode="monolithic").world
                           if sess.cfg.sync_mode == "auto" else
                           _composed(mesh, sess, ds))
    states, metrics = step_fn(states, ds.host_batch(step))
    assert np.isfinite(metrics["loss"].item())
    return states


def _composed(mesh, sess, ds):
    from repro_torch.launch.train import build_session
    return build_session(mesh, sess.model, sess.optimizer, ds,
                         sess.cfg).world


def _mesh(data, model=2):
    return substrate.make_mesh((data, model), AXES, device="cpu")


@pytest.fixture(scope="module", params=list(ARCHS))
def saved(request, tmp_path_factory):
    """(arch, the (2, 2) auto session, its gathered tree after a step,
    the directory it is saved in per shard)."""
    arch = request.param
    sess, cfg = _session(arch)
    mesh = _mesh(2)
    states = sess.init_state(torch.Generator().manual_seed(0), mesh=mesh)
    states = _step(sess, cfg, mesh, states, 0)
    tree = sess.gather(states, mesh)
    assert sum(isinstance(l, ShardedTensor) for l in leaves(tree)) > 0
    d = str(tmp_path_factory.mktemp("fsdp_" + arch))
    save_checkpoint(d, 1, tree, sharded=True)
    return arch, sess, cfg, trainer.logical_state(tree), d


@pytest.mark.parametrize("target", ["1x2", "4x2", "composed"])
def test_split_state_restores_across_widths_and_back(saved, target):
    arch, sess, cfg, want, d = saved
    manifest = load_manifest(d)
    boxes = [len(e["shards"]) for e in manifest["leaves"] if "shards" in e]
    assert max(boxes) == 4          # a box each (data, model) block
    other = sess
    if target == "composed":
        other = _session(arch, sync="composed")[0]
    mesh = _mesh(4 if target == "4x2" else 2 if target == "composed" else 1)
    tree = restore_checkpoint(d, other.abstract_state(mesh=mesh))
    states = other.scatter(tree, mesh)
    if target == "4x2":           # a quarter of each split leaf a rank
        whole = leaves(sess.scatter(tree, _mesh(1))[0])
        assert {b.numel() // a.numel() for a, b in
                zip(leaves(states[0]), whole)} == {1, 4}
    _assert_trees_equal(trainer.logical_state(other.gather(states, mesh)),
                        want)
    # and back onto (2, 2) in the split layout
    back = sess.scatter(trainer.logical_state(other.gather(states, mesh)),
                        _mesh(2))
    _assert_trees_equal(trainer.logical_state(sess.gather(back, _mesh(2))),
                        want)
    _step(other, cfg, mesh, states, 1)


CHILD = """
import jax, numpy as np
from repro.checkpoint import manager
from repro.configs import get_config
from repro.models import build_model
from repro.optim import make_optimizer
from repro.parallel.sharding import fitted_shardings
from repro.runtime import substrate
from repro.train import trainer

cfg = get_config("granite-34b", reduced=True)
model = build_model(cfg)
opt = make_optimizer("adamw", lr=1e-3)
mesh = substrate.make_mesh((2, 2), ("data", "model"))
tcfg = trainer.TrainCfg(sync_mode="auto", data_axes=("data",))
rng = np.random.RandomState(0)
state = trainer.make_train_state(model, opt, jax.random.PRNGKey(0),
                                 cfg=tcfg, mesh=mesh)
state = jax.tree_util.tree_map(
    lambda x: (rng.randn(*x.shape) if x.ndim else np.asarray(3)
               ).astype(x.dtype), state)
with substrate.set_mesh(mesh):
    state = jax.device_put(state, fitted_shardings(
        mesh, trainer.state_specs(model, opt, tcfg, mesh=mesh), state))
flat = jax.tree_util.tree_flatten_with_path(state)[0]
assert any(len(l.sharding.device_set) > 1 and not l.is_fully_replicated
           for _, l in flat)
np.savez({ref_npz!r}, **{{str(i): np.asarray(l)
                          for i, (_, l) in enumerate(flat)}})
manager.save_checkpoint({ref_dir!r}, 1, state, sharded=True)
port = manager.restore_checkpoint(
    {port_dir!r}, trainer.make_train_state(model, opt, abstract=True,
                                            cfg=tcfg, mesh=mesh))
np.savez({port_npz!r}, **{{str(i): np.asarray(l) for i, l in
                           enumerate(jax.tree_util.tree_leaves(port))}})
print("CHILD OK")
"""


@pytest.fixture(scope="module")
def crossed(tmp_path_factory):
    """The port's (2, 2) auto state saved per shard, the reference's
    saved so, and each restored by the other package."""
    root = tmp_path_factory.mktemp("cross")
    paths = {k: str(root / k) for k in ("ref_dir", "port_dir")}
    paths.update({k: str(root / (k + ".npz"))
                  for k in ("ref_npz", "port_npz")})
    sess, cfg = _session("granite-34b")
    mesh = _mesh(2)
    states = sess.init_state(torch.Generator().manual_seed(0), mesh=mesh)
    states = _step(sess, cfg, mesh, states, 0)
    tree = sess.gather(states, mesh)
    save_checkpoint(paths["port_dir"], 1, tree, sharded=True)
    out = run_subprocess_script(CHILD.format(**paths), devices=4)
    assert "CHILD OK" in out
    return sess, cfg, mesh, tree, paths


def _npz_leaves(path):
    z = np.load(path)
    return [torch.from_numpy(np.array(z[str(i)]))
            for i in range(len(z.files))]


def test_reference_auto_checkpoint_restores_through_the_port(crossed):
    sess, cfg, mesh, _, paths = crossed
    assert any("shards" in e for e in load_manifest(
        paths["ref_dir"])["leaves"])
    got = restore_checkpoint(paths["ref_dir"], sess.abstract_state(
        mesh=mesh))
    want = _npz_leaves(paths["ref_npz"])
    assert len(leaves(got)) == len(want)
    for t, w in zip(leaves(got), want):
        assert _bits_equal(t, w)
    states = sess.scatter(got, mesh)
    _assert_trees_equal(trainer.logical_state(sess.gather(states, mesh)),
                        trainer.logical_state(got))
    _step(sess, cfg, mesh, states, 1)


def test_port_auto_checkpoint_restores_through_the_reference(crossed):
    _, _, _, tree, paths = crossed
    got = _npz_leaves(paths["port_npz"])
    want = [l.dense() if isinstance(l, ShardedTensor) else l
            for l in leaves(tree)]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert _bits_equal(g, w)


def test_elastic_shrink_is_bit_identical_to_the_survivor_run():
    sess, cfg = _session("granite-34b", model_parallel=1)
    ds = SyntheticLMDataset(vocab_size=cfg.vocab_size, seq_len=16,
                            global_batch=12)
    mesh = substrate.make_mesh((4, 1), AXES, device="cpu")
    assert trainer.data_width(sess.cfg, mesh) == 4
    ckpt = tempfile.mkdtemp()
    ctl = ElasticController(
        sess, ds, mesh, comm=Session(mesh=mesh, mode="monolithic"),
        ckpt_dir=ckpt, ckpt_every=2, ckpt_keep=0, ckpt_sharded=True,
        total_steps=5,
        watchdog_timeout=600.0,
        fault_plan=FaultPlan([FaultEvent(3, "lose", 1)], seed=1))
    report = ctl.run()
    (rec,) = report.recoveries
    assert (rec.before_shape, rec.after_shape, rec.restored_step) == (
        (4, 1), (3, 1), 2)
    assert any("shards" in e for e in load_manifest(
        ctl.ckpt.directory, 2)["leaves"])
    assert report.mesh_history == [(4, 1), (3, 1)]
    small = substrate.make_mesh((3, 1), AXES, device="cpu",
                                members=rec.healthy_after)
    tree = restore_checkpoint(ctl.ckpt.directory,
                              sess.abstract_state(mesh=small),
                              step=rec.restored_step)
    states = sess.scatter(tree, small)
    step_fn = sess.step_fn(Session(mesh=small, mode="monolithic").world)
    want = {}
    for s in range(rec.restored_step, 5):
        states, m = step_fn(states, ds.host_batch(s))
        want[s] = m["loss"].item()
    assert {s: report.losses[s] for s in want} == want
