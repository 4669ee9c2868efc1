"""Bucketed and overlapped gradient sync: the port against the reference
and against its own blocking path.

- ``sync_gradients_bucketed`` (fused dtype-grouped buckets, f32 and bf16
  leaves, several buckets) gives the reference's bits at p in {2, 3, 4}
  for each planned protocol, and so does its compressed twin with the
  per-bucket EF residuals over 3 steps (the reference compiled, as it
  trains).
- The two-phase arms (``sync_gradient_start/progress/wait``, persistent
  handles) give the blocking bits, and EF residuals change in wait only.
- (The overlapped train step against the blocking one is in
  ``tests/test_torch_schedule.py``.)
- 8 steps of overlapped bucketed training from the reference's initial
  weights: losses within ``test_torch_train.LOSS_RTOL`` of the
  reference's overlapped bucketed run (one child interpreter with 4
  host devices runs both sync modes).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import run_subprocess_script
from repro.comm import Session as JaxSession
from repro.core.engine import EngineConfig as JaxEngineConfig
from repro.core.topology import topology_from_mesh_shape as jax_topology
from repro_torch.comm import Session
from repro_torch.configs import get_config
from repro_torch.core import compression
from repro_torch.core import plan as plan_mod
from repro_torch.core.engine import SYNC_STATS_KEY, EngineConfig
from repro_torch.data import SyntheticLMDataset
from repro_torch.launch.train import build_session
from repro_torch.models import build_model
from repro_torch.models.convert import params_from_numpy
from repro_torch.optim import cosine_schedule, make_optimizer
from repro_torch.runtime import substrate as S
from repro_torch.train import trainer
from repro_torch.tree import leaves, unflatten
from test_torch_train import LOSS_RTOL, _rel_err

AX = "x"
BUCKET_BYTES = 4096
SHAPES = [((40, 7), np.float32), ((513,), np.float32),
          ((33, 9), jnp.bfloat16), ((2000,), np.float32),
          ((17,), jnp.bfloat16), ((6, 50), np.float32)]
TDT = {np.float32: torch.float32, jnp.bfloat16: torch.bfloat16}


def _tree(p, seed):
    rng = np.random.RandomState(seed)
    return {f"g{i}": (rng.randn(p, *s) * rng.uniform(0.1, 2.0)).astype(
        np.float32) for i, (s, _) in enumerate(SHAPES)}


def _engines(p, proto=None):
    force = {"all_reduce": proto} if proto else {}
    jeng = JaxSession(topology=jax_topology((AX,), (p,)),
                      config=JaxEngineConfig(force_protocol=force)).engine
    sess = Session(mesh=S.make_mesh((p,), (AX,), device="cpu"),
                   config=EngineConfig(force_protocol=force))
    return jeng, sess


def _ref_leaves(tree):
    return {k: jnp.asarray(v).astype(SHAPES[int(k[1:])][1])
            for k, v in tree.items()}


def _port_rank(tree, r):
    return {k: torch.from_numpy(np.ascontiguousarray(v[r])).to(
        TDT[SHAPES[int(k[1:])][1]]) for k, v in tree.items()}


def _bits(t) -> np.ndarray:
    t = torch.as_tensor(t) if not isinstance(t, torch.Tensor) else t
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy()
    return t.view(torch.int32).numpy()


def _jbits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.int16 if a.dtype.itemsize == 2 else np.int32)


@pytest.mark.parametrize("p,proto", [(2, "ring"), (3, "ring"),
                                     (4, "bidir_ring"),
                                     (4, "recursive_halving"),
                                     (4, "recursive_doubling")])
def test_bucketed_sync_bits_match_reference(p, proto):
    jeng, sess = _engines(p, proto)
    tree = _tree(p, p)
    want = jax.jit(jax.vmap(lambda g: jeng.sync_gradients_bucketed(
        g, AX, bucket_bytes=BUCKET_BYTES)[0], axis_name=AX))(
            _ref_leaves(tree))
    d = sess.split(AX)
    got = S.run_spmd(lambda g: d.sync_gradients_bucketed(
        g, bucket_bytes=BUCKET_BYTES)[0],
        [(_port_rank(tree, r),) for r in range(p)], sess.mesh, timeout=60)
    n_buckets = len(plan_mod.plan_buckets(
        leaves(_port_rank(tree, 0)), BUCKET_BYTES))
    assert n_buckets >= 4
    for k in tree:
        for r in range(p):
            assert got[r][k].dtype == TDT[SHAPES[int(k[1:])][1]]
            np.testing.assert_array_equal(_bits(got[r][k]),
                                          _jbits(want[k][r]), err_msg=k)


@pytest.mark.parametrize("p", [2, 4])
def test_compressed_bucketed_sync_and_residuals_match_reference(p):
    """Three steps with the per-bucket residuals carried: the reduced
    values and every residual, bit for bit (the reference compiled)."""
    jeng, sess = _engines(p)
    d = sess.split(AX)

    def ref_step(g, ef):
        return jeng.sync_gradients_bucketed(
            g, AX, bucket_bytes=BUCKET_BYTES, compress=True, ef_state=ef)

    jstep = jax.jit(jax.vmap(ref_step, axis_name=AX))
    buckets = plan_mod.plan_buckets(leaves(_port_rank(_tree(p, 0), 0)),
                                    BUCKET_BYTES)
    jef = tuple(jnp.zeros((p, b.size), jnp.float32) for b in buckets)
    pef = [compression.bucket_ef_zeros(buckets) for _ in range(p)]
    for step in range(3):
        tree = _tree(p, 100 + step)
        want, jef = jstep(_ref_leaves(tree), jef)
        out = S.run_spmd(
            lambda g, ef: d.sync_gradients_bucketed(
                g, bucket_bytes=BUCKET_BYTES, compress=True, ef_state=ef),
            [(_port_rank(tree, r), pef[r]) for r in range(p)], sess.mesh,
            timeout=60)
        for r in range(p):
            got, pef[r] = out[r]
            for k in tree:
                np.testing.assert_array_equal(_bits(got[k]),
                                              _jbits(want[k][r]))
            for bi in range(len(buckets)):
                np.testing.assert_array_equal(_bits(pef[r][bi]),
                                              _jbits(jef[bi][r]))


def _bucket_program(d, buckets, compress, overlap, depth=3):
    return trainer._sync_program(d.sync_schedule(
        [(f"bucket{i}", b.size, b.wire_dtype)
         for i, b in enumerate(buckets)], compress=compress), overlap, depth)


@pytest.mark.parametrize("compress", [False, True])
def test_two_phase_arms_give_the_blocking_bits(compress):
    """Overlapped bucket sync (persistent handles or the compressed
    two-phase arms, depth 3 with progress hops) against the blocking
    bucketed sync: values, EF residuals, and the sync byte ledger."""
    p = 4
    tree = _tree(p, 7)
    buckets = plan_mod.plan_buckets(leaves(_port_rank(tree, 0)),
                                    BUCKET_BYTES)
    results = {}
    for overlap in (False, True):
        # ring: a steppable wait phase, so depth 3 emits progress hops
        _, sess = _engines(p, "ring")
        d = sess.split(AX)
        handles = () if compress else tuple(
            d.persistent("all_reduce", (b.size,), b.wire_dtype, mean=True,
                         sync_stats=True) for b in buckets)
        sched = _bucket_program(d, buckets, compress, True)
        efs = [compression.bucket_ef_zeros(buckets) for _ in range(p)]

        def rank(g, ef):
            if overlap:
                return trainer._bucket_sync(
                    d, (d,), handles, buckets, g, compress,
                    ef if compress else None, sched)
            return d.sync_gradients_bucketed(
                g, bucket_bytes=BUCKET_BYTES, compress=compress,
                ef_state=ef if compress else None)

        for _ in range(2):
            out = S.run_spmd(rank, [(_port_rank(tree, r), efs[r])
                                    for r in range(p)], sess.mesh,
                             timeout=60)
        results[overlap] = (out, sess.engine.stats.bytes[SYNC_STATS_KEY])
        if overlap:
            assert any(op.kind == "progress" for op in sched.comm_ops)
    (blk, blk_bytes), (ovl, ovl_bytes) = results[False], results[True]
    assert blk_bytes == ovl_bytes > 0
    for (gb, eb), (go, eo) in zip(blk, ovl):
        for k in gb:
            assert torch.equal(gb[k], go[k]), k
        if compress:
            for a, b in zip(eb, eo):
                assert torch.equal(a, b)


@pytest.mark.parametrize("bucket", [False, True])
@pytest.mark.parametrize("compress", [False, True])
def test_trainer_sync_gives_the_engine_blocking_bits(bucket, compress):
    """The train step's sync (``trainer._leaf_sync`` / ``_bucket_sync``
    running the communicator's unrewritten program) against the engine's
    blocking ``sync_gradients[_bucketed]``: values, EF residuals and the
    sync byte ledger, over 2 steps with the residuals carried."""
    p = 4
    results = {}
    for via_program in (False, True):
        _, sess = _engines(p)
        d = sess.split(AX)
        g0 = leaves(_port_rank(_tree(p, 0), 0))
        buckets = plan_mod.plan_buckets(g0, BUCKET_BYTES)
        if bucket:
            handles = () if compress else tuple(
                d.persistent("all_reduce", (b.size,), b.wire_dtype,
                             mean=True, sync_stats=True) for b in buckets)
            sched = _bucket_program(d, buckets, compress, False)
            efs = [compression.bucket_ef_zeros(buckets) for _ in range(p)]
        else:
            sched = trainer._sync_program(d.sync_schedule(
                [(f"leaf{i}", g.numel(), g.dtype) for i, g in enumerate(g0)],
                compress=compress), False, 2)
            efs = [{k: torch.zeros(v.shape[1:]) for k, v in
                    _tree(p, 0).items()} for _ in range(p)]
        assert sched.depth == 1

        def rank(g, ef):
            ef = ef if compress else None
            if via_program and bucket:
                return trainer._bucket_sync(d, (d,), handles, buckets, g,
                                            compress, ef, sched)
            if via_program:
                return trainer._leaf_sync(d, (d,), g, compress, ef, sched)
            if bucket:
                return d.sync_gradients_bucketed(
                    g, bucket_bytes=BUCKET_BYTES, compress=compress,
                    ef_state=ef)
            out, st = d.sync_gradients(g, compress=compress, ef_state=None
                                       if ef is None else {
                                           k: compression.EFState(residual=v)
                                           for k, v in ef.items()})
            return out, ef

        for step in range(2):
            tree = _tree(p, 30 + step)
            out = S.run_spmd(rank, [(_port_rank(tree, r), efs[r])
                                    for r in range(p)], sess.mesh,
                             timeout=60)
        results[via_program] = (out, efs,
                                sess.engine.stats.bytes[SYNC_STATS_KEY])
    (blk, eb, bb), (prg, ep, pb) = results[False], results[True]
    assert bb == pb > 0
    for (gb, _), (gp, _) in zip(blk, prg):
        for k in gb:
            assert torch.equal(gb[k], gp[k]), k
    if compress:
        for a, b in zip(leaves(eb), leaves(ep)):
            assert torch.equal(a, b)
            assert a.any()


def test_overlapped_bucket_sync_checks_the_ef_layout():
    sess = Session(mesh=S.make_mesh((2,), (AX,), device="cpu"))
    d = sess.split(AX)
    buckets = plan_mod.plan_buckets([torch.zeros(600)])
    with pytest.raises(ValueError, match="bucket_bytes"):
        trainer._bucket_sync(
            d, (d,), (), buckets, {"w": torch.zeros(600)}, True,
            (torch.zeros(13),), None)


def test_compressed_residual_changes_in_wait_only():
    p = 2
    sess = Session(mesh=S.make_mesh((p,), (AX,), device="cpu"))
    d = sess.split(AX)

    def rank(g):
        res = torch.zeros_like(g)
        tok = d.sync_gradient_start(g, compress=True, ef_residual=res)
        while d.sync_gradient_progress(tok, 1):
            pass
        assert torch.count_nonzero(res) == 0     # untouched until wait
        y, new_res = d.sync_gradient_wait(tok)
        with pytest.raises(RuntimeError, match="already waited"):
            d.sync_gradient_wait(tok)
        return y, new_res

    gs = [torch.from_numpy(np.random.RandomState(r).randn(700).astype(
        np.float32)) for r in range(p)]
    out = S.run_spmd(rank, [(g,) for g in gs], sess.mesh, timeout=60)
    blocking = S.run_spmd(
        lambda g: d.sync_gradients({"g": g}, compress=True,
                                   ef_state=None)[0]["g"],
        [(g,) for g in gs], sess.mesh, timeout=60)
    for (y, res), yb in zip(out, blocking):
        assert torch.equal(y, yb)
        assert torch.count_nonzero(res) > 0


# ---------------------------------------------------------------------------
# 8 steps against the reference's overlapped bucketed run
# ---------------------------------------------------------------------------

STEPS, SEQ, BATCH, RANKS = 8, 32, 8, 4
REF_BUCKET_BYTES = 64 * 1024

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
    1e-3, warmup=max(STEPS // 20, 1), total=STEPS))
ds = SyntheticLMDataset(vocab_size=cfg.vocab_size, seq_len=SEQ,
                        global_batch=BATCH)
params = model.init(jax.random.PRNGKey(0))
np.savez({path!r}, **{{"/".join(str(k.key) for k in p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(params)[0]}})
out = {{}}
for sync in ("composed", "compressed"):
    args = types.SimpleNamespace(
        microbatches=1, sync=sync, bucket_grads=True,
        bucket_bytes={bucket_bytes}, overlap=True, overlap_depth=2,
        zero=False)
    sess = lt.build_session(mesh, model, opt, ds, args)
    tcfg = trainer.TrainCfg(sync_mode=sync, bucket_grads=True,
                            bucket_bytes={bucket_bytes}, overlap=True)
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
    out[sync] = losses
print("LOSSES", json.dumps(out))
"""


@pytest.fixture(scope="module")
def reference_run(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("ref") / "weights.npz")
    out = run_subprocess_script(REFERENCE_CHILD.format(
        steps=STEPS, seq=SEQ, batch=BATCH, ranks=RANKS, path=path,
        bucket_bytes=REF_BUCKET_BYTES), devices=RANKS)
    line = next(l for l in out.splitlines() if l.startswith("LOSSES "))
    w = np.load(path)
    tree = unflatten([tuple(k.split("/")) for k in w.files],
                     [w[k] for k in w.files])
    return json.loads(line[len("LOSSES "):]), tree


@pytest.mark.parametrize("sync", ["composed", "compressed"])
def test_overlapped_bucketed_training_matches_reference(reference_run, sync):
    ref_losses, tree = reference_run
    cfg = get_config("granite-34b", reduced=True)
    model = build_model(cfg)
    opt = make_optimizer("adamw", lr=cosine_schedule(
        1e-3, warmup=max(STEPS // 20, 1), total=STEPS))
    ds = SyntheticLMDataset(vocab_size=cfg.vocab_size, seq_len=SEQ,
                            global_batch=BATCH)
    mesh = S.make_host_mesh(RANKS, device="cpu")
    tcfg = trainer.TrainCfg(sync_mode=sync, bucket_grads=True,
                            bucket_bytes=REF_BUCKET_BYTES, overlap=True)
    sess = build_session(mesh, model, opt, ds, tcfg)
    states = trainer.replicate(trainer.make_train_state(
        model, opt, params_from_numpy(tree, cfg, device="cpu"), tcfg,
        mesh=mesh), RANKS)
    step_fn = trainer.make_train_step(model, opt, tcfg, comm=sess.world)
    assert len(step_fn.schedule.units) > 1
    losses = []
    for step in range(STEPS):
        states, metrics = step_fn(states, ds.host_batch(step))
        losses.append(metrics["loss"].item())
    assert _rel_err(losses, ref_losses[sync]) <= LOSS_RTOL[sync], (
        losses, ref_losses[sync])
    assert losses[-1] < losses[0]
