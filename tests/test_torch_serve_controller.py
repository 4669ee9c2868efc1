"""The port's elastic serving tier on the CPU: ``ServeController`` over a
session of data-parallel thread ranks, the reduced qwen2-72b in f32 with
8-token pages.

- Data 4 -> 2 (``lose@3:2``, while some requests decode and some are
  mid-prefill): the batch shrinks 8 -> 4 (``plan_serve_batch``), the
  drained slots re-splice, and every request's tokens equal those of an
  uninterrupted run on the survivors (data 2, batch 4) and the greedy
  streams of the reference's own ``ServeController`` under the same
  plan (one child interpreter with 4 host devices), whose recovery
  record (resumed, parked, shed, batches, survivors) is the same too.
  The pool passes its integrity check after the recovery, and the
  snapshot moved fewer bytes than full rows would.
- Degradation: a deep loss sheds the queued backlog (never in-flight
  work) and parks the overflow; a preemption notice drives a second
  recovery through the same lifecycle.
- ``rehearse_recovery`` drains and re-admits over the same members with
  no plan rebuild and unchanged tokens.
- ``save_snapshot`` / ``load_snapshot``: a mid-run snapshot round-trips
  through disk and resumes to the uninterrupted tokens; the reference's
  ``load_snapshot`` reads the port's snapshot with the same pages, and
  the controller persists each drained snapshot to ``snapshot_dir``.
- ``plan_serve_batch`` equals the reference's over a grid.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import REPO, run_subprocess_script
from repro.configs import get_config as jax_config
from repro.models import build_model as jax_build
from repro.serve import controller as jcontroller
from repro.serve import state as jstate
from repro_torch.comm import Session
from repro_torch.configs import get_config
from repro_torch.models import build_model
from repro_torch.models.convert import params_from_numpy
from repro_torch.runtime import substrate
from repro_torch.runtime.controller import FaultEvent, FaultPlan
from repro_torch.runtime.health import PreemptionNotice
from repro_torch.serve import (BatchScheduler, Request, ServeCfg,
                               ServeController, load_snapshot,
                               plan_serve_batch, save_snapshot)

MAX_LEN, PT = 64, 8
N_REQ, MAX_NEW = 12, 6
PROMPT_HI = 50          # prompts of 1 to 7 chunks: some still prefill


@pytest.fixture(scope="module")
def weights():
    jm = jax_build(jax_config("qwen2-72b", reduced=True))
    jp = jm.init(jax.random.PRNGKey(0))
    tm = build_model(get_config("qwen2-72b", reduced=True))
    return jm, jp, tm, params_from_numpy(jax.device_get(jp), tm.cfg,
                                         device="cpu")


def _requests(n=N_REQ, max_new=MAX_NEW, seed=0):
    rng = np.random.RandomState(seed)
    return [Request(rid=i, prompt=rng.randint(0, 256, size=rng.randint(
        3, PROMPT_HI)).tolist(), max_new=max_new) for i in range(n)]


def _cfg(batch=8, **kw):
    return ServeCfg(max_len=MAX_LEN, batch=batch, cache_dtype=torch.float32,
                    page_tokens=PT, **kw)


def _world(n, members=None):
    return Session(mesh=substrate.make_mesh(
        (n,), ("data",), device="cpu", members=members)).world


def test_plan_serve_batch_matches_reference():
    for b0 in range(1, 17):
        for d0 in range(1, 9):
            for dn in range(1, 9):
                assert plan_serve_batch(b0, d0, dn) == \
                    jcontroller.plan_serve_batch(b0, d0, dn)
    with pytest.raises(ValueError):
        plan_serve_batch(8, 0, 2)


def test_scheduler_splits_the_batch_over_the_data_ranks(weights):
    _, _, tm, tp = weights
    sched = BatchScheduler(tm, tp, _cfg(batch=8), comm=_world(4))
    assert (sched.data_ranks, sched.rows_per_rank) == (4, 2)
    assert sched.device == torch.device("cpu")
    with pytest.raises(ValueError, match="does not split"):
        BatchScheduler(tm, tp, _cfg(batch=6), comm=_world(4))


REFERENCE_CHILD = """
import json
import os
import subprocess
import sys
import jax, numpy as np
from repro import comm as comm_mod
from repro.configs import get_config
from repro.launch.mesh import make_host_mesh
from repro.models import build_model
from repro.runtime.controller import FaultPlan
from repro.serve import Request, ServeCfg, ServeController
model = build_model(get_config("qwen2-72b", reduced=True))
params = model.init(jax.random.PRNGKey(0))
mesh = make_host_mesh(model_parallel=1)
assert mesh.shape["data"] == 4, mesh.shape
scfg = ServeCfg(max_len={max_len}, batch=8, cache_dtype=jax.numpy.float32,
                page_tokens={pt})
ctl = ServeController(model, params, scfg,
                      comm=comm_mod.Session(mesh=mesh).world,
                      fault_plan=FaultPlan.parse("lose@3:2", seed=0),
                      watchdog_timeout=600.0)
rng = np.random.RandomState(0)
for i in range({n}):
    ctl.submit(Request(rid=i, prompt=rng.randint(0, 256, size=rng.randint(
        3, {hi})).tolist(), max_new={max_new}))
report = ctl.run()
rec = report.recoveries[0]
print("REPORT", json.dumps({{
    "tokens": report.tokens(), "meshes": report.mesh_history,
    "batches": report.batch_history,
    "record": [rec.resumed, rec.parked, rec.shed, rec.batch_before,
               rec.batch_after, list(rec.healthy_after)],
    "decode_steps": report.decode_steps}}))
"""


def test_data_four_to_two_matches_survivors_and_reference(weights,
                                                         monkeypatch):
    _, _, tm, tp = weights
    chunks = []
    prefill_chunk = tm.prefill_chunk
    monkeypatch.setattr(tm, "prefill_chunk", lambda *a, **kw: (
        chunks.append(1), prefill_chunk(*a, **kw))[1])
    ctl = ServeController(tm, tp, _cfg(), comm=_world(4),
                          fault_plan=FaultPlan.parse("lose@3:2", seed=0),
                          watchdog_timeout=600.0)
    reqs = _requests()
    for r in reqs:
        ctl.submit(r)
    report = ctl.run()

    assert len(report.recoveries) == 1, report.describe()
    rec = report.recoveries[0]
    assert (rec.step, rec.kind) == (3, "lose")
    assert (rec.before_shape, rec.after_shape) == ((4,), (2,))
    assert (rec.batch_before, rec.batch_after) == (8, 4)
    assert rec.healthy_after == (0, 2) and rec.plan_rebuilt
    assert rec.requeued > 0 and rec.resumed > 0     # both kinds drained
    # every prompt chunk ran once, and the requeued requests' again
    assert rec.requeued_chunks >= rec.requeued
    assert len(chunks) == sum(-(-len(r.prompt) // PT) for r in reqs) \
        + rec.requeued_chunks
    assert 0 < rec.snapshot_bytes < rec.snapshot_bytes_contiguous
    assert report.mesh_history == [(4,), (2,)]
    assert report.batch_history == [8, 4]
    assert ctl.comm.mesh.members == (0, 2)
    ctl.sched.pool.check_integrity()
    assert len(report.completed) == N_REQ and not report.shed
    assert all(len(r.generated) == MAX_NEW for r in report.completed)

    # uninterrupted on the survivors: data 2, batch 4 from the start
    base = BatchScheduler(tm, tp, _cfg(batch=plan_serve_batch(8, 4, 2)),
                          comm=_world(2, members=(0, 2)))
    for r in _requests():
        base.submit(r)
    baseline = {r.rid: r.generated for r in base.run()}
    assert report.tokens() == baseline

    out = run_subprocess_script(REFERENCE_CHILD.format(
        max_len=MAX_LEN, pt=PT, n=N_REQ, max_new=MAX_NEW, hi=PROMPT_HI),
        devices=4)
    line = next(l for l in out.splitlines() if l.startswith("REPORT "))
    ref = json.loads(line[len("REPORT "):])
    assert {int(k): v for k, v in ref["tokens"].items()} == report.tokens()
    assert ref["meshes"] == [[4, 1], [2, 1]] and ref["batches"] == [8, 4]
    assert ref["record"] == [rec.resumed, rec.parked, rec.shed,
                             rec.batch_before, rec.batch_after,
                             list(rec.healthy_after)]
    assert ref["decode_steps"] == report.decode_steps


def test_degradation_sheds_queue_and_a_preemption_recovers(weights):
    _, _, tm, tp = weights
    notice = PreemptionNotice()
    ctl = ServeController(tm, tp, _cfg(max_queue=2), comm=_world(8),
                          fault_plan=FaultPlan([FaultEvent(2, "lose", 4)],
                                               seed=1),
                          preemption=notice, watchdog_timeout=600.0)
    reqs = _requests(n=14, seed=3)
    admitted = [ctl.submit(r) for r in reqs]
    # 8 slots + 2 queued: 10 admitted, 4 shed at submit
    assert admitted.count(True) == 10 and len(ctl.sched.shed) == 4
    report = ctl.run()
    rec = report.recoveries[0]
    assert rec.after_shape == (4,) and (rec.batch_before,
                                        rec.batch_after) == (8, 4)
    # 5 decoding (4 resume, 1 parks) and 3 mid-prefill (back to the
    # queue, as in the reference); the backlog bound of 2 less the 1
    # parked overflow keeps 1 of the 5 queued and sheds 4
    assert (rec.resumed, rec.parked, rec.requeued, rec.shed) == (4, 1, 3, 4)
    # decoding work is never shed; every completed request is whole
    assert all(len(r.generated) == r.max_new for r in report.completed)
    assert (len(report.completed), len(report.shed)) == (6, 8)

    rng = np.random.RandomState(9)
    for i in range(14, 17):
        ctl.submit(Request(rid=i, prompt=rng.randint(0, 256, size=5)
                           .tolist(), max_new=4))
    ctl.sched.step()
    notice.post(sorted(ctl._healthy)[:2])
    report2 = ctl.run()
    rec2 = report2.recoveries[1]
    assert rec2.after_shape == (2,) and rec2.batch_after == 2
    assert len(rec2.healthy_after) == 2
    assert report2.mesh_history == [(8,), (4,), (2,)]
    assert report2.batch_history == [8, 4, 2]
    assert all(len(r.generated) == r.max_new for r in report2.completed)
    assert {r.rid for r in report2.completed} >= {14, 15, 16}


def test_rehearsal_keeps_tokens_and_the_plan(weights):
    _, _, tm, tp = weights
    plain = BatchScheduler(tm, tp, _cfg(), comm=_world(4))
    for r in _requests():
        plain.submit(r)
    want = {r.rid: r.generated for r in plain.run()}

    ctl = ServeController(tm, tp, _cfg(), comm=_world(4),
                          watchdog_timeout=600.0)
    for r in _requests():
        ctl.submit(r)
    for _ in range(4):
        ctl.sched.step()
    rec = ctl.rehearse_recovery()
    assert rec.kind == "rehearsal" and rec.before_shape == rec.after_shape
    assert not rec.plan_rebuilt and rec.batch_after == 8
    assert rec.resumed > 0 and rec.total_s > 0
    assert ctl.run().tokens() == want


def test_snapshot_round_trip_through_disk(weights, tmp_path):
    jm, _, tm, tp = weights
    plain = BatchScheduler(tm, tp, _cfg(), device="cpu")
    for r in _requests():
        plain.submit(r)
    want = {r.rid: r.generated for r in plain.run()}

    sched = BatchScheduler(tm, tp, _cfg(), device="cpu")
    for r in _requests():
        sched.submit(r)
    for _ in range(5):
        sched.step()
    snap = sched.snapshot()
    assert snap.inflight
    save_snapshot(str(tmp_path), snap, 5)
    back = load_snapshot(str(tmp_path), tm)
    assert back.decode_steps == snap.decode_steps and not back.parked
    assert [s.req.rid for s in back.inflight] == \
        [s.req.rid for s in snap.resumable]
    for a, b in zip(back.inflight, snap.resumable):
        assert a.cache.tokens == b.cache.tokens
        assert a.req.generated == b.req.generated
        for x, y in zip(a.cache.pages + a.cache.state,
                        b.cache.pages + b.cache.state):
            assert x.dtype == y.dtype and torch.equal(x, y)
    resumed = BatchScheduler.from_snapshot(tm, tp, _cfg(batch=4), back,
                                           device="cpu")
    got = {r.rid: r.generated for r in resumed.run()}
    assert got == want

    # the reference reads the port's snapshot: the same books and pages
    jback = jstate.load_snapshot(str(tmp_path), jm)
    assert [s.req.rid for s in jback.inflight] == \
        [s.req.rid for s in back.inflight]
    assert jnp.dtype(jback.cfg.cache_dtype) == jnp.float32
    for a, b in zip(jback.inflight, back.inflight):
        assert a.cache.tokens == b.cache.tokens
        for x, y in zip(list(a.cache.pages) + list(a.cache.state),
                        b.cache.pages + b.cache.state):
            assert np.array_equal(np.asarray(x), y.numpy())


def test_controller_persists_the_drained_snapshot(weights, tmp_path):
    _, _, tm, tp = weights
    ctl = ServeController(tm, tp, _cfg(), comm=_world(4),
                          fault_plan=FaultPlan.parse("lose@3:2", seed=0),
                          snapshot_dir=str(tmp_path),
                          watchdog_timeout=600.0)
    for r in _requests():
        ctl.submit(r)
    report = ctl.run()
    snap = load_snapshot(str(tmp_path), tm)
    rec = report.recoveries[0]
    assert len(snap.inflight) == rec.resumed + rec.parked
    assert snap.decode_steps > 0


def test_elastic_serve_launcher_recovers_on_the_cpu(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--data", "4", "--elastic", "--fault-plan", "lose@3:2",
         "--snapshot-dir", str(tmp_path)], env=env, capture_output=True,
        text=True, timeout=300, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "recovered: step 3: lose (4,)->(2,) batch 4->2" in proc.stderr
    assert "served 8 requests (0 shed)" in proc.stderr
    assert os.listdir(tmp_path)              # the drained snapshot
