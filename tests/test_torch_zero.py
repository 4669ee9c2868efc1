"""ZeRO-1 on the reduce-scatter / all-gather seam: the port against its
own unsharded path and against the reference.

- ``TrainCfg`` validation and the padded-flat chunk layout are the
  reference's.
- The ZeRO RS and AG programs' predicted phase bytes equal the
  reference's, and each rank measures them to the byte in a ZeRO step.
- Training reduced granite-34b with ``clip_norm=0``: ZeRO losses and
  parameters are bit-identical to the unsharded per-leaf composed run at
  p in {2, 4} (overlapped, depth 2 and 3), and each rank's optimizer
  state is the padded 1/p of the unsharded state.  At p = 3 (odd
  chunks) they agree to summation order.
- 8 steps of ZeRO training from the reference's initial weights: losses
  within ``test_torch_train.LOSS_RTOL`` (1e-4 relative) of the
  reference's composed run at ``clip_norm=0`` (one child interpreter
  with 4 host devices).
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import run_subprocess_script
from repro import comm as jcomm
from repro.core.topology import topology_from_mesh_shape as jtopology
from repro.train import trainer as jtrainer
from repro_torch import comm
from repro_torch.configs import get_config
from repro_torch.core import plan as plan_mod
from repro_torch.core import schedule as schedule_mod
from repro_torch.core.engine import SYNC_STATS_KEY
from repro_torch.core.topology import topology_from_mesh_shape
from repro_torch.data import SyntheticLMDataset
from repro_torch.launch.train import build_session
from repro_torch.models import build_model
from repro_torch.models.convert import params_from_numpy
from repro_torch.optim import cosine_schedule, make_optimizer
from repro_torch.runtime import substrate as S
from repro_torch.train import trainer
from repro_torch.tree import flatten, leaves, unflatten
from test_torch_train import LOSS_RTOL, _rel_err


def test_zero_cfg_validation():
    with pytest.raises(ValueError, match="composed"):
        trainer.TrainCfg(sync_mode="compressed", zero=True)
    with pytest.raises(ValueError, match="bucket_grads"):
        trainer.TrainCfg(sync_mode="composed", zero=True, bucket_grads=True)
    trainer.TrainCfg(sync_mode="composed", zero=True)
    cfg = trainer.TrainCfg(zero=True)
    with pytest.raises(ValueError, match="mesh"):
        trainer.zero_layout(cfg, None)
    two_axes = S.abstract_mesh((2, 2), ("data", "pod"))
    with pytest.raises(ValueError, match="ONE data"):
        trainer.zero_layout(trainer.TrainCfg(zero=True,
                                             data_axes=("pod", "data")),
                            two_axes)
    assert trainer.zero_layout(cfg, S.abstract_mesh((4,), ("data",))) == (
        "data", 4)


@pytest.mark.parametrize("n,p", [(10, 4), (12, 4), (37, 8), (5, 8)])
def test_pad_len_and_chunks_are_the_reference_layout(n, p):
    assert trainer._zero_pad_len(n, p) == jtrainer._zero_pad_len(n, p)
    x = np.arange(n, dtype=np.float32).reshape(1, n) + 1
    chunks = [trainer._zero_chunk(torch.from_numpy(x), p, r)
              for r in range(p)]
    for r in range(p):
        want = np.asarray(jtrainer._zero_chunk(jnp.asarray(x), p, r))
        np.testing.assert_array_equal(chunks[r].numpy(), want)
    flat = torch.cat(chunks)
    assert torch.equal(flat[:n], torch.from_numpy(x.reshape(-1)))
    assert not flat[n:].any()


@pytest.mark.parametrize("p", [2, 4, 8])
def test_zero_programs_predict_the_reference_bytes(p):
    specs = [("leaf0", 1000, torch.float32), ("leaf1", 37, torch.float32),
             ("leaf2", 300_000, torch.bfloat16)]
    jspecs = [(n, k, jnp.float32 if d == torch.float32 else jnp.bfloat16)
              for n, k, d in specs]
    jt = jtopology(("data",), (p,))
    from repro_torch.core import topology
    pt = topology.Topology(
        axis_sizes=dict(jt.axis_sizes),
        axis_links={a: topology.Link(bandwidth=l.bandwidth, alpha=l.alpha,
                                     wraparound=l.wraparound,
                                     duplex=l.duplex)
                    for a, l in jt.axis_links.items()})
    port, ref = comm.Session(topology=pt), jcomm.Session(topology=jt)
    for kind in ("rs", "ag"):
        a = port.world.zero_sync_schedule(specs, kind=kind)
        b = ref.world.zero_sync_schedule(jspecs, kind=kind)
        assert a.predicted_phase_bytes() == b.predicted_phase_bytes()
        assert ([u.protocol for u in a.units]
                == [u.protocol for u in b.units])


def test_ag_schedule_hides_under_next_forward():
    sess = comm.Session(topology=topology_from_mesh_shape(("data",), (8,)))
    base = sess.world.zero_sync_schedule(
        [(f"param{i}", 1 << 20, torch.float32) for i in range(4)],
        kind="ag", compute=(("next_forward", True),))
    rewritten, _ = plan_mod.run_passes(
        base, plan_mod.canonical_overlap_passes(2))
    w = float(sum(base.predicted_phase_bytes().values()))
    assert schedule_mod.modeled_exposed_comm_frac(base, w) == 1.0
    assert schedule_mod.modeled_exposed_comm_frac(rewritten, w) < 1.0


# ---------------------------------------------------------------------------
# ZeRO against the unsharded path, bit for bit
# ---------------------------------------------------------------------------

def _run(tcfg, p, steps=3, init=None, lr=1e-3, seq=16, batch=8,
         clip_norm=0.0, norms=None):
    """``norms``, if given, collects each step's ``grad_norm`` metric."""
    cfg = get_config("granite-34b", reduced=True)
    model = build_model(cfg)
    opt = make_optimizer("adamw", lr=lr, clip_norm=clip_norm)
    ds = SyntheticLMDataset(vocab_size=cfg.vocab_size, seq_len=seq,
                            global_batch=batch)
    mesh = S.make_host_mesh(p, device="cpu")
    sess = build_session(mesh, model, opt, ds, tcfg)
    if init is None:
        init = model.init(torch.Generator().manual_seed(0))
    states = trainer.replicate(trainer.make_train_state(
        model, opt, init, tcfg, mesh=mesh), p)
    step_fn = trainer.make_train_step(model, opt, tcfg, comm=sess.world)
    losses = []
    for step in range(steps):
        states, metrics = step_fn(states, ds.host_batch(step))
        losses.append(metrics["loss"].item())
        if norms is not None:
            norms.append(metrics["grad_norm"].item())
    return losses, states, sess, step_fn


def _opt_bytes(state) -> int:
    return sum(t.numel() * t.element_size() for t in leaves(state["opt"]))


@pytest.mark.parametrize("p,depth", [(2, 2), (4, 3)])
def test_zero_bit_identical_to_unsharded_with_sharded_state(p, depth):
    base = dict(sync_mode="composed", microbatches=2)
    lu, su, _, _ = _run(trainer.TrainCfg(**base), p)
    lz, sz, sess, step_fn = _run(trainer.TrainCfg(
        **base, zero=True, overlap=True, overlap_depth=depth), p)
    assert np.array(lu, np.float32).view(np.int32).tolist() == \
        np.array(lz, np.float32).view(np.int32).tolist(), (lu, lz)
    for r in range(p):
        for a, b in zip(leaves(su[r]["params"]), leaves(sz[r]["params"])):
            assert torch.equal(a, b)
    # each rank's chunk is its rows of the unsharded moments
    for name in ("m", "v"):
        fl, paths = flatten(su[0]["opt"][name])
        for i, f in enumerate(fl):
            whole = torch.cat([leaves(sz[r]["opt"][name])[i]
                               for r in range(p)])
            assert torch.equal(whole[:f.numel()], f.reshape(-1)), paths[i]
            assert not whole[f.numel():].any()
    # optimizer state per rank: the padded 1/p of the unsharded state
    n_pad = sum(trainer._zero_pad_len(t.numel(), p)
                for t in leaves(su[0]["params"]))
    assert _opt_bytes(sz[0]) == 2 * 4 * n_pad // p + 4
    assert _opt_bytes(su[0]) == 2 * 4 * sum(
        t.numel() for t in leaves(su[0]["params"])) + 4
    # what each rank measured is the two programs' prediction, per step
    want = {}
    for sched in (step_fn.schedule, step_fn.ag_schedule):
        for k, v in sched.predicted_phase_bytes().items():
            want[k] = want.get(k, 0) + 3 * v
    for r in range(p):
        got = {k: v for k, v in
               sess.engine.stats.rank_phase_bytes[r].items() if v}
        assert got == {k: v for k, v in want.items() if v}
    assert sess.engine.stats.bytes[SYNC_STATS_KEY] == 3 * p * sum(
        step_fn.schedule.predicted_phase_bytes().values())


@pytest.mark.parametrize("p", [2, 4])
def test_zero_clipped_update_agrees_with_unsharded(p):
    """clip_norm 1.0, AdamW's default and the launcher's: the norm ZeRO
    builds from chunk-local sums and one scalar all-reduce engages the
    clip, and it and the losses agree with the unsharded run's to
    rounding (summation order only)."""
    base = dict(sync_mode="composed", microbatches=2)
    nu, nz = [], []
    lu, _, _, _ = _run(trainer.TrainCfg(**base), p, clip_norm=1.0,
                       norms=nu)
    lz, _, _, _ = _run(trainer.TrainCfg(**base, zero=True, overlap=True),
                       p, clip_norm=1.0, norms=nz)
    assert min(nu) > 1.0, nu                 # the clip is engaged
    assert _rel_err(nz, nu) <= 1e-6, (nu, nz)
    assert _rel_err(lz, lu) <= 1e-6, (lu, lz)


def test_zero_agrees_with_unsharded_on_an_odd_width():
    """p = 3: the odd chunks run the plain ring's reduce-scatter where the
    all-reduce may take another protocol, so the sums agree to
    summation order, not bit for bit."""
    lu, _, _, _ = _run(trainer.TrainCfg(), 3, batch=12)
    lz, _, _, _ = _run(trainer.TrainCfg(zero=True), 3, batch=12)
    assert _rel_err(lz, lu) <= 1e-5, (lu, lz)


# ---------------------------------------------------------------------------
# 8 steps against the reference's composed run at clip_norm=0
# ---------------------------------------------------------------------------

STEPS, SEQ, BATCH, RANKS = 8, 32, 8, 4

REFERENCE_CHILD = """
import json, types
import jax, numpy as np
from repro.configs import get_config
from repro.data import SyntheticLMDataset
from repro.launch import train as lt
from repro.launch.mesh import make_host_mesh
from repro.models import build_model
from repro.optim import cosine_schedule, make_optimizer
from repro.parallel.sharding import named_shardings
from repro.runtime import substrate
from repro.train import trainer
STEPS, SEQ, BATCH = {steps}, {seq}, {batch}
cfg = get_config("granite-34b", reduced=True)
model = build_model(cfg)
mesh = make_host_mesh(model_parallel=1)
assert mesh.shape["data"] == {ranks} and mesh.size == {ranks}, mesh.shape
opt = make_optimizer("adamw", lr=cosine_schedule(
    1e-3, warmup=max(STEPS // 20, 1), total=STEPS), clip_norm=0.0)
ds = SyntheticLMDataset(vocab_size=cfg.vocab_size, seq_len=SEQ,
                        global_batch=BATCH)
params = model.init(jax.random.PRNGKey(0))
np.savez({path!r}, **{{"/".join(str(k.key) for k in p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(params)[0]}})
args = types.SimpleNamespace(
    microbatches=1, sync="composed", bucket_grads=False,
    bucket_bytes=32 << 20, overlap=False, overlap_depth=2, zero=False)
sess = lt.build_session(mesh, model, opt, ds, args)
tcfg = trainer.TrainCfg(sync_mode="composed")
step_fn = jax.jit(trainer.make_train_step(model, opt, tcfg, mesh=mesh,
                                          comm=sess.world))
sspecs = trainer.state_specs(model, opt, tcfg, mesh=mesh)
with substrate.set_mesh(mesh):
    state = trainer.make_train_state(model, opt, jax.random.PRNGKey(0),
                                     cfg=tcfg, mesh=mesh)
    state = jax.device_put(state, named_shardings(mesh, sspecs))
    losses = []
    for step in range(STEPS):
        state, m = step_fn(state, ds.sharded_batch(step, mesh))
        losses.append(float(m["loss"]))
print("LOSSES", json.dumps(losses))
"""


@pytest.fixture(scope="module")
def reference_run(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("ref") / "weights.npz")
    out = run_subprocess_script(REFERENCE_CHILD.format(
        steps=STEPS, seq=SEQ, batch=BATCH, ranks=RANKS, path=path),
        devices=RANKS)
    line = next(l for l in out.splitlines() if l.startswith("LOSSES "))
    w = np.load(path)
    tree = unflatten([tuple(k.split("/")) for k in w.files],
                     [w[k] for k in w.files])
    return json.loads(line[len("LOSSES "):]), tree


def test_zero_training_matches_reference(reference_run):
    ref_losses, tree = reference_run
    cfg = get_config("granite-34b", reduced=True)
    lr = cosine_schedule(1e-3, warmup=max(STEPS // 20, 1), total=STEPS)
    losses, _, _, step_fn = _run(
        trainer.TrainCfg(zero=True, overlap=True), RANKS, steps=STEPS,
        init=params_from_numpy(tree, cfg, device="cpu"), lr=lr, seq=SEQ,
        batch=BATCH)
    assert step_fn.ag_schedule is not None
    assert _rel_err(losses, ref_losses) <= LOSS_RTOL["composed"], (
        losses, ref_losses)
    assert losses[-1] < losses[0]
