"""The port's schedule IR against the reference's, op for op.

- IR validation raises what the reference raises.
- The communicator's blocking sync programs (leaf, bucket, compressed,
  ZeRO RS and AG) and their pass pipelines at depths 2 and 3 equal the
  reference's for the same specs and topology: every unit, every op,
  ``predicted_phase_bytes`` and the modeled exposure.
- The executor drives the engine's two-phase arms on thread ranks: the
  bytes each rank measures equal the prediction to the byte, for the
  leaf, bucket, ZeRO RS and ZeRO AG arms, and stepped progress gives
  the blocking bits.
- ``Session.schedule_for`` lifts a scanned step into an annotated
  program.
- Persistent handles: ``call``, ``start``/``progress``/``wait`` and the
  planned all-reduce give the same bits; after ``remesh`` a stale token
  raises ``HandleRevokedError``, and a re-mesh with a token in flight
  raises ``InFlightHandleError``.
- The train step's executed program: training reduced granite-34b on 4
  thread ranks for 2 steps with 2 microbatches, overlapped (depth 2 and
  3) and blocking runs give bit-identical losses and
  state, per leaf and bucketed, composed in f32 and bf16 and compressed;
  at depth 4 the bytes each rank measures equal the program's
  prediction.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import comm as jcomm
from repro.core import plan as jplan
from repro.core import schedule as jsched
from repro.core.topology import topology_from_mesh_shape as jtopology
from repro.train import trainer as jtrainer
from repro_torch import comm
from repro_torch.comm.session import HandleInFlight
from repro_torch.configs import get_config
from repro_torch.core import costmodel, topology
from repro_torch.core import plan as plan_mod
from repro_torch.core import schedule as schedule_mod
from repro_torch.core.engine import EngineConfig
from repro_torch.data import SyntheticLMDataset
from repro_torch.launch.train import build_session
from repro_torch.models import build_model
from repro_torch.optim import make_optimizer
from repro_torch.runtime import substrate as S
from repro_torch.train import trainer
from repro_torch.tree import leaves

AX = "data"
JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}

# one unit per planned protocol family at p = 4: recursive doubling
# (small), Rabenseifner and the (bidirectional) ring (large), bf16 and
# f32, a ragged size
SPECS = [("u0", 37, torch.float32), ("u1", 6144, torch.float32),
         ("u2", 40 * 1024, torch.float32), ("u3", 300_001, torch.bfloat16),
         ("u4", 1 << 20, torch.float32), ("u5", 4096, torch.bfloat16)]


def _jspecs(specs):
    return [(n, k, JDT[d]) for n, k, d in specs]


def _program(sched):
    """Units, ops (type and every field) and meta without timings."""
    units = [dataclasses.astuple(u) for u in sched.units]
    ops = [(type(op).__name__,) + dataclasses.astuple(op)
           for op in sched.ops]
    meta = {k: v for k, v in sched.meta.items() if k != "pass_us"}
    return units, ops, meta


def _sessions(p):
    """(port, reference) sessions over one network: the reference's link
    values on both sides, so their plans agree."""
    jt = jtopology((AX,), (p,))
    links = {a: topology.Link(bandwidth=l.bandwidth, alpha=l.alpha,
                              wraparound=l.wraparound, duplex=l.duplex)
             for a, l in jt.axis_links.items()}
    pt = topology.Topology(axis_sizes=dict(jt.axis_sizes), axis_links=links)
    return comm.Session(topology=pt), jcomm.Session(topology=jt)


def _assert_same(port, ref):
    assert _program(port) == _program(ref)
    assert port.predicted_phase_bytes() == ref.predicted_phase_bytes()
    assert port.depth == ref.depth
    assert port.describe() == ref.describe()
    for w in (0.0, 1e5):
        assert (schedule_mod.modeled_exposed_comm_frac(port, w)
                == jsched.modeled_exposed_comm_frac(ref, w))


def _build(sess, kind, specs, compute):
    d = sess.split(AX)
    if kind in ("rs", "ag"):
        return d.zero_sync_schedule(specs, kind=kind, compute=compute)
    return d.sync_schedule(specs, compress=kind == "compressed",
                           compute=compute)


@pytest.mark.parametrize("p", [2, 4, 8])
@pytest.mark.parametrize("kind", ["leaf", "compressed", "rs", "ag"])
@pytest.mark.parametrize("depth", [None, 2, 3])
def test_programs_and_passes_equal_the_reference(p, kind, depth):
    port_sess, ref_sess = _sessions(p)
    compute = (("peeled_microbatch", True), ("epilogue", False)) \
        if kind != "ag" else (("next_forward", True),)
    port = _build(port_sess, kind, SPECS, compute)
    ref = _build(ref_sess, kind, _jspecs(SPECS), compute)
    if depth is not None:
        port, us = plan_mod.run_passes(
            port, plan_mod.canonical_overlap_passes(depth))
        ref, _ = jplan.run_passes(ref, jplan.canonical_overlap_passes(depth))
        assert set(us) == {"reverse_layout", f"interleave_depth{depth}",
                           "hoist_starts"}
    _assert_same(port, ref)


def test_granite_bucket_programs_equal_the_reference():
    """The reduced granite-34b's buckets (its real gradient layout) at
    a cap that splits them, at depths 2 and 3."""
    model = build_model(get_config("granite-34b", reduced=True))
    tcfg = trainer.TrainCfg(bucket_grads=True, bucket_bytes=64 * 1024)
    buckets = trainer.grad_bucket_plan(model.abstract_params(), tcfg)
    assert len(buckets) > 3
    specs = [(f"bucket{i}", b.size, b.wire_dtype)
             for i, b in enumerate(buckets)]
    port_sess, ref_sess = _sessions(4)
    for depth in (2, 3):
        port = trainer._sync_program(
            port_sess.split(AX).sync_schedule(specs), True, depth)
        ref = jtrainer._overlap_sync_schedule(
            ref_sess.split(AX), _jspecs(specs), False, depth)
        _assert_same(port, ref)


def test_interleave_and_hoist_on_handmade_units():
    """The reference's own pass cases: depth 1 stays blocking, depth 2 is
    the software pipeline, hoisting stops at non-overlappable compute
    and at an operand's definition."""
    def units(mod, k, uses=()):
        return [mod.sync_unit(
            name=f"b{i}", index=i, fn="all_reduce", axes=(AX,),
            protocol="ring", start_stages=7, wait_stages=7,
            start_bytes=7 * 1024, wait_bytes=7 * 1024, uses=uses)
            for i in range(k)]

    for mod, pl in ((schedule_mod, plan_mod), (jsched, jplan)):
        base = mod.build_sync_schedule(units(mod, 4))
        assert pl.interleave_pass(1)(base).ops == base.ops
        seq = [(op.kind, op.unit) for op in pl.interleave_pass(2)(base).ops]
        assert seq == [("start", "b0"), ("start", "b1"), ("wait", "b0"),
                       ("start", "b2"), ("wait", "b1"), ("start", "b3"),
                       ("wait", "b2"), ("wait", "b3")]
        with pytest.raises(ValueError, match="blocking"):
            pl.reverse_layout_pass(pl.interleave_pass(2)(base))
        comp = (mod.ComputeOp(tag="epi", overlappable=False),
                mod.ComputeOp(tag="mb", overlappable=True))
        out = pl.hoist_starts_pass(mod.build_sync_schedule(
            units(mod, 1), compute=comp))
        assert [op.tag if isinstance(op, mod.ComputeOp)
                else (op.kind, op.overlaps) for op in out.ops] == [
                    "epi", ("start", "mb"), "mb", ("wait", None)]
        dep = (mod.ComputeOp(tag="mb", overlappable=True, defs=("g",)),)
        out = pl.hoist_starts_pass(mod.build_sync_schedule(
            units(mod, 1, uses=("g",)), compute=dep))
        assert isinstance(out.ops[0], mod.ComputeOp)
        with pytest.raises(ValueError, match=">= 1"):
            pl.interleave_pass(0)


def test_validate_rejects_what_the_reference_rejects():
    def cases(mod):
        u = mod.sync_unit(name="b0", index=0, fn="all_reduce", axes=(AX,),
                          protocol="ring", start_stages=3, wait_stages=3,
                          start_bytes=6, wait_bytes=6)
        s = lambda: mod.CommOp(kind="start", unit="b0")
        w = lambda: mod.CommOp(kind="wait", unit="b0", defs=u.defs)
        pr = lambda k=1: mod.CommOp(kind="progress", unit="b0", stages=k)
        mk = lambda *ops: mod.Schedule(units=(u,), ops=tuple(ops))
        return [lambda: mk(s(), s(), w()).validate(),
                lambda: mk(w()).validate(),
                lambda: mk(pr(), s(), w()).validate(),
                lambda: mk(s(), pr(4), w()).validate(),
                lambda: mk(s()).validate(),
                lambda: mk(s(), w(), mod.CommOp(kind="start",
                                                unit="ghost")).validate(),
                lambda: mod.Schedule(units=(u, u), ops=(s(), w())).validate(),
                lambda: mod.CommOp(kind="compute", unit="b0")]

    for port_case, ref_case in zip(cases(schedule_mod), cases(jsched)):
        with pytest.raises(ValueError) as want:
            ref_case()
        with pytest.raises(ValueError, match=str(want.value)[:20]):
            port_case()


def test_executor_runs_callbacks_in_op_order():
    port_sess, _ = _sessions(4)
    sched, _ = plan_mod.run_passes(
        port_sess.split(AX).sync_schedule(SPECS),
        plan_mod.canonical_overlap_passes(3))
    log = []
    res = schedule_mod.execute(
        sched, start=lambda u: log.append(("start", u.name)) or u.name,
        progress=lambda u, t, k: log.append(("progress", u.name)),
        wait=lambda u, t: (log.append(("wait", u.name)), t)[1])
    assert log == [(op.kind, op.unit) for op in sched.comm_ops]
    assert res == {u.name: u.name for u in sched.units}


# ---------------------------------------------------------------------------
# Predicted == measured, per rank, on thread ranks
# ---------------------------------------------------------------------------

def _run(p, fn, inputs):
    mesh = S.make_mesh((p,), (AX,), device="cpu")
    return S.run_spmd(fn, [(x,) for x in inputs], mesh, timeout=60)


def _rank_inputs(p, specs, seed=0):
    rng = np.random.RandomState(seed)
    return [{n: torch.from_numpy(rng.randn(k).astype(np.float32)).to(d)
             for n, k, d in specs} for _ in range(p)]


def _assert_exact(sess, sched, p):
    for r in range(p):
        diff = sess.timeline_diff(sched, rank=r)
        assert diff and all(row["delta"] == 0 for row in diff.values()), (
            r, diff)


@pytest.mark.parametrize("depth", [None, 2, 3])
@pytest.mark.parametrize("compress", [False, True])
def test_leaf_and_bucket_arms_measure_the_prediction(depth, compress):
    p = 4
    sess = comm.Session(mesh=S.make_mesh((p,), (AX,), device="cpu"))
    d = sess.split(AX)
    sched = d.sync_schedule(SPECS, compress=compress)
    if depth is not None:
        sched, _ = plan_mod.run_passes(
            sched, plan_mod.canonical_overlap_passes(depth))

    def rank(vals):
        return schedule_mod.execute(
            sched,
            start=lambda u: d.sync_gradient_start(vals[u.name],
                                                  compress=compress),
            progress=lambda u, t, k: (d.sync_gradient_progress(t, k), t)[1],
            wait=lambda u, t: d.sync_gradient_wait(t)[0])

    inputs = _rank_inputs(p, SPECS)
    out = _run(p, rank, inputs)
    _assert_exact(sess, sched, p)
    if not compress:    # the blocking per-leaf sync gives the same bits
        blocking = _run(p, lambda vals: d.sync_gradients(vals)[0], inputs)
        for a, b in zip(out, blocking):
            for n in a:
                assert torch.equal(a[n], b[n]), n


@pytest.mark.parametrize("kind", ["rs", "ag"])
@pytest.mark.parametrize("p", [2, 3, 4])
def test_zero_arms_measure_the_prediction(kind, p):
    sess = comm.Session(mesh=S.make_mesh((p,), (AX,), device="cpu"))
    d = sess.split(AX)
    chunks = [(n, -(-k // p), dt) for n, k, dt in SPECS]
    if kind == "rs":
        specs, inputs = SPECS, _rank_inputs(p, SPECS, seed=p)
        start, wait = d.zero_reduce_scatter_start, d.zero_reduce_scatter_wait
    else:    # the AG's specs carry the gathered (padded) counts
        specs = [(n, c * p, dt) for n, c, dt in chunks]
        inputs = _rank_inputs(p, chunks, seed=p)
        start, wait = d.zero_all_gather_start, d.zero_all_gather_wait
    sched, _ = plan_mod.run_passes(
        d.zero_sync_schedule(specs, kind=kind),
        plan_mod.canonical_overlap_passes(3))

    def rank(vals):
        return schedule_mod.execute(
            sched, start=lambda u: start(vals[u.name]),
            wait=lambda u, t: wait(t))

    out = _run(p, rank, inputs)
    _assert_exact(sess, sched, p)
    for n, c, _ in chunks:
        if kind == "ag":     # every rank holds every rank's chunk
            want = torch.cat([inputs[r][n] for r in range(p)])
            assert all(torch.equal(o[n], want) for o in out), n
            continue
        # rank r's chunk is rows r of the planned all-reduce's mean
        full = _run(p, lambda vals: d.sync_gradients(vals)[0], inputs)[0]
        want = torch.cat([full[n], full[n].new_zeros(c * p - full[n].numel())])
        for r in range(p):
            assert torch.equal(out[r][n], want[r * c:(r + 1) * c]), n


def test_progress_hops_give_the_blocking_bits():
    p = 4
    for proto in (costmodel.RING, costmodel.BIDIR_RING,
                  costmodel.RECURSIVE_HALVING):
        from repro_torch.core.engine import EngineConfig
        sess = comm.Session(mesh=S.make_mesh((p,), (AX,), device="cpu"),
                            config=EngineConfig(
                                force_protocol={"all_reduce": proto}))
        d = sess.split(AX)

        def stepped(x):
            tok = d.all_reduce_start(x)
            hops = 0
            while d.all_reduce_progress(tok, 1):
                hops += 1
            assert hops > 0, proto
            return d.all_reduce_wait(tok)

        xs = [torch.from_numpy(np.random.RandomState(r).randn(96).astype(
            np.float32)) for r in range(p)]
        for a, b in zip(_run(p, stepped, xs), _run(p, d.all_reduce, xs)):
            assert torch.equal(a, b), proto


def test_schedule_for_lifts_a_scanned_step():
    """A step of two all-reduces scanned on ``meta`` tensors: its hops
    become units annotated from the plan; passes apply."""
    probe = comm.Session.probe((4,), (AX,))
    d = probe.split(AX)

    def step(x):
        return S.run_spmd(lambda v: d.all_reduce(d.all_reduce(v)),
                          [(x,)] * 4, probe.mesh)

    sched = probe.schedule_for(step, torch.empty(1 << 16, device="meta"),
                               passes=plan_mod.canonical_overlap_passes(2))
    assert sched.units and all(u.fn == "permute" for u in sched.units)
    assert set(sched.meta["pass_us"]) == {"reverse_layout",
                                          "interleave_depth2",
                                          "hoist_starts"}
    report_sched = sched.validate()
    assert sum(u.total_bytes for u in report_sched.units) > 0


# ---------------------------------------------------------------------------
# Persistent handles
# ---------------------------------------------------------------------------

def test_handle_matches_the_planned_call_and_its_arms():
    p = 4
    sess = comm.Session(mesh=S.make_mesh((p,), (AX,), device="cpu"))
    d = sess.split(AX)
    h = d.persistent("all_reduce", (3000,), torch.float32, mean=True,
                     sync_stats=True)
    xs = [torch.from_numpy(np.random.RandomState(r).randn(3000).astype(
        np.float32)) for r in range(p)]

    def arms(x):
        tok = h.start(x)
        while h.progress(tok, 1):
            pass
        return h.wait(tok)

    planned = _run(p, lambda x: d.all_reduce(x, mean=True), xs)
    for got in (_run(p, h, xs), _run(p, arms, xs)):
        for a, b in zip(got, planned):
            assert torch.equal(a, b)
    assert h.inflight == 0
    assert sess.average_layer_number() <= sess.average_layer_number(
        include_handles=False)


def test_remesh_revokes_rebinds_and_refuses_in_flight():
    sess = comm.Session(mesh=S.make_mesh((2,), (AX,), device="cpu"))
    d = sess.split(AX)
    h = d.persistent("all_reduce", (33,), torch.float32, mean=True)
    x = [torch.ones(33), torch.ones(33)]
    toks = _run(2, h.start, x)
    assert h.inflight == 2
    with pytest.raises(comm.InFlightHandleError) as exc:
        sess.remesh(S.make_mesh((4,), (AX,), device="cpu"))
    assert "all_reduce[33]" in str(exc.value)
    assert "2 start(s) never waited" in str(exc.value)
    assert h.abandon_inflight() == 2
    assert sess.remesh(S.make_mesh((4,), (AX,), device="cpu"))
    assert h.epoch == 2 and h.revocations == 1 and not h.revoked
    assert h.binding.mean_scale == pytest.approx(0.25)
    with pytest.raises(comm.HandleRevokedError, match="epoch 1"):
        h.wait(toks[0])
    with pytest.raises(comm.HandleRevokedError, match="progress"):
        h.progress(HandleInFlight(handle=h, epoch=1, inner=None))
    other = d.persistent("all_reduce", (33,), torch.float32)
    with pytest.raises(ValueError, match="different handle"):
        other.wait(HandleInFlight(handle=h, epoch=h.epoch, inner=None))
    y = _run(4, h, [torch.full((33,), float(r)) for r in range(4)])
    assert torch.equal(y[0], torch.full((33,), 1.5))
    # an axis the new mesh lacks leaves the handle revoked
    sess.remesh(S.make_mesh((2,), ("model",), device="cpu"))
    assert h.revoked
    with pytest.raises(comm.HandleRevokedError, match="revoked"):
        h(torch.ones(33))
    sess.finalize()
    with pytest.raises(comm.HandleRevokedError, match="finalized"):
        h(torch.ones(33))


# ---------------------------------------------------------------------------
# Training: overlapped == blocking, bit for bit
# ---------------------------------------------------------------------------

def _train(tcfg, dtype=torch.float32, steps=2, p=4, seq=16, batch=8):
    """Reduced granite-34b on ``p`` CPU ranks, every all-reduce on the
    ring (a steppable wait phase: depth >= 3 emits progress hops)."""
    cfg = get_config("granite-34b", reduced=True, param_dtype=dtype)
    model = build_model(cfg)
    opt = make_optimizer("adamw", lr=1e-3)
    ds = SyntheticLMDataset(vocab_size=cfg.vocab_size, seq_len=seq,
                            global_batch=batch)
    mesh = S.make_host_mesh(p, device="cpu")
    sess = build_session(mesh, model, opt, ds, tcfg, config=EngineConfig(
        force_protocol={"all_reduce": "ring"}))
    init = model.init(torch.Generator().manual_seed(0))
    states = trainer.replicate(trainer.make_train_state(
        model, opt, init, tcfg, mesh=mesh), p)
    step_fn = trainer.make_train_step(model, opt, tcfg, comm=sess.world)
    losses = []
    for step in range(steps):
        states, metrics = step_fn(states, ds.host_batch(step))
        losses.append(metrics["loss"].item())
    return losses, states, sess, step_fn


@pytest.mark.parametrize("bucket", [False, True])
@pytest.mark.parametrize("sync,dtype", [("composed", torch.float32),
                                        ("composed", torch.bfloat16),
                                        ("compressed", torch.float32)])
def test_overlapped_train_step_bit_identical(bucket, sync, dtype):
    base = dict(sync_mode=sync, microbatches=2, bucket_grads=bucket,
                bucket_bytes=16 * 1024)
    lb, sb, _, blocking = _train(trainer.TrainCfg(**base), dtype)
    # the blocking step runs the communicator's unrewritten program
    units = [u.name for u in blocking.schedule.units]
    assert [(op.kind, op.unit) for op in blocking.schedule.ops] == [
        (k, u) for u in units for k in ("start", "wait")]
    for depth in (2, 3):
        lo, so, _, step_fn = _train(trainer.TrainCfg(
            **base, overlap=True, overlap_depth=depth), dtype)
        sched = step_fn.schedule
        assert sched.depth == depth
        assert (depth == 3) == any(op.kind == "progress"
                                   for op in sched.comm_ops)
        assert lb == lo, (depth, lb, lo)
        for a, b in zip(leaves(sb), leaves(so)):   # params, opt, EF
            assert torch.equal(a, b)
    assert all(np.isfinite(lb))


def test_depth4_bucketed_step_measures_its_program():
    tcfg = trainer.TrainCfg(sync_mode="composed", microbatches=2,
                            bucket_grads=True, bucket_bytes=16 * 1024,
                            overlap=True, overlap_depth=4)
    _, _, sess, step_fn = _train(tcfg, steps=1)
    sched = step_fn.schedule
    assert sched.depth == 4 and any(op.kind == "progress"
                                    for op in sched.comm_ops)
    for r in range(4):
        diff = sess.timeline_diff(sched, rank=r)
        assert all(row["delta"] == 0 for row in diff.values()), diff
