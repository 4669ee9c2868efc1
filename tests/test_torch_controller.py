"""The port's elastic training controller on CPU thread ranks (reduced
granite-34b, f32), against the reference's scenarios.

- 4 -> 2 ranks with ``lose@3:2``, composed per leaf and as ZeRO-1: the
  step-2 checkpoint restores onto the 2 survivors, every loss from step
  2 on equals (bit for bit) a run started on 2 ranks from the same
  checkpoint, the CommPlan is rebuilt exactly once, and a persistent
  handle bound before the loss is revoked once and rebound (its mean
  scale follows the width).
- Shrink, shrink, grow (a live re-mesh with no restore) and a straggler
  that is a no-op; a duplicate lose fires twice; a gain with nothing
  lost is ignored; a stall after a health probe flagged a member
  recovers; a stall alone leaves the losses of an uninterrupted run;
  ``TooManyRecoveries``; quorum loss checkpoints and halts.
- A real error inside a rank: a CUDA device loss in rank 2 recovers over
  the other ranks; a bug propagates, and so does a rank that never
  reaches its hop (a deadlock of thread ranks).
- Against the reference: one child interpreter with 4 host devices runs
  the reference controller (composed, a (4, 1) data x model mesh) with
  the same plan; the port's controller starts from the reference's
  step-0 checkpoint and its losses stay within ``LOSS_RTOL`` (1e-4).
"""

import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading

import pytest
import torch

from conftest import REPO, run_subprocess_script
from repro_torch.checkpoint import restore_checkpoint
from repro_torch.configs import get_config
from repro_torch.data import SyntheticLMDataset
from repro_torch.launch.train import build_session
from repro_torch.models import build_model
from repro_torch.optim import cosine_schedule, make_optimizer
from repro_torch.runtime import ctrlplane, substrate
from repro_torch.runtime.controller import (ElasticController, FaultEvent,
                                            FaultPlan, TooManyRecoveries)
from repro_torch.train import trainer

LOSS_RTOL = 1e-4           # composed, as tests/test_torch_train.py
SEQ = 16


def _setup(zero=False, batch=8, steps=8):
    cfg = get_config("granite-34b", reduced=True)
    model = build_model(cfg)
    opt = make_optimizer("adamw", lr=cosine_schedule(
        1e-3, warmup=max(steps // 20, 1), total=steps),
        **({"clip_norm": 0.0} if zero else {}))
    tcfg = trainer.TrainCfg(zero=zero)
    ds = SyntheticLMDataset(vocab_size=cfg.vocab_size, seq_len=SEQ,
                            global_batch=batch)
    return trainer.TrainSession(model, opt, tcfg), ds


def _controller(session, ds, ranks=4, **kw):
    mesh = substrate.make_host_mesh(ranks, device="cpu")
    comm = build_session(mesh, session.model, session.optimizer, ds,
                         session.cfg)
    kw.setdefault("ckpt_dir", tempfile.mkdtemp())
    kw.setdefault("ckpt_every", 1)
    kw.setdefault("watchdog_timeout", 600.0)
    return ElasticController(session, ds, mesh, comm=comm, **kw)


def _baseline(session, ds, ckpt_dir, step, members, total):
    """A run started on ``members`` from checkpoint ``step``."""
    mesh = substrate.make_mesh((len(members),), ("data",), device="cpu",
                               members=members)
    tree = restore_checkpoint(ckpt_dir, session.abstract_state(mesh=mesh),
                              step=step, allow_resize_1d=True)
    states = session.scatter(tree, mesh)
    step_fn = session.step_fn(build_session(
        mesh, session.model, session.optimizer, ds, session.cfg).world)
    losses = {}
    for s in range(step, total):
        states, m = step_fn(states, ds.host_batch(s))
        losses[s] = m["loss"].item()
    return losses


@pytest.mark.parametrize("zero", [False, True], ids=["composed", "zero1"])
def test_lose_two_of_four_is_bit_identical_to_the_survivor_run(zero):
    session, ds = _setup(zero=zero)
    ctl = _controller(session, ds, total_steps=6, ckpt_every=2,
                      ckpt_keep=0, ckpt_sharded=zero,
                      fault_plan=FaultPlan.parse("lose@3:2", seed=0))
    handle = ctl.comm.split("data").persistent("all_reduce", (16,),
                                               torch.float32, mean=True)
    assert handle.epoch == 1 and handle.binding.mean_scale == 0.25
    report = ctl.run()

    assert len(report.recoveries) == 1, report.describe()
    rec = report.recoveries[0]
    assert (rec.step, rec.kind, rec.restored_step) == (3, "lose", 2)
    assert (rec.before_shape, rec.after_shape) == ((4,), (2,))
    assert rec.healthy_after == (0, 2)       # the reference's victims 1, 3
    assert ctl.mesh.members == (0, 2) and rec.total_s > 0
    assert report.mesh_history == [(4,), (2,)]
    assert rec.plan_rebuilt and report.plan_rebuilds == 1
    assert ctl.engine.plan.stats.rebuilds == 1
    assert handle.revocations == 1 and not handle.revoked
    assert handle.binding.mean_scale == 0.5
    assert sorted(report.losses) == list(range(6))
    want = _baseline(session, ds, ctl.ckpt.directory, 2, (0, 2), 6)
    assert {s: report.losses[s] for s in want} == want


def test_shrink_shrink_grow_and_a_straggler_noop():
    session, ds = _setup(batch=12)
    ctl = _controller(session, ds, total_steps=9, ckpt_keep=0,
                      fault_plan=FaultPlan([FaultEvent(2, "lose", 1),
                                            FaultEvent(4, "lose", 1),
                                            FaultEvent(6, "gain", 2),
                                            FaultEvent(7, "stall")], seed=2))
    report = ctl.run()
    assert report.mesh_history == [(4,), (3,), (2,), (4,)]
    assert [r.kind for r in report.recoveries] == ["lose", "lose", "grow"]
    assert [r.restored_step for r in report.recoveries] == [2, 4, None]
    assert report.recoveries[2].healthy_after == (0, 1, 2, 3)
    assert report.stalls == [7]
    assert sorted(report.losses) == list(range(9))
    assert report.plan_rebuilds == 3


def test_duplicate_lose_gain_with_nothing_lost_and_degraded_stall():
    session, ds = _setup(batch=12)
    ctl = _controller(session, ds, total_steps=4,
                      fault_plan=FaultPlan([FaultEvent(1, "lose", 1),
                                            FaultEvent(1, "lose", 1),
                                            FaultEvent(3, "gain", 9)],
                                           seed=4))
    report = ctl.run()
    assert [r.kind for r in report.recoveries] == ["lose", "lose", "grow"]
    assert [len(r.healthy_after) for r in report.recoveries] == [3, 2, 4]
    assert report.mesh_history == [(4,), (3,), (2,), (4,)]
    assert sorted(report.losses) == list(range(4))

    ctl2 = _controller(session, ds, total_steps=2,
                       fault_plan=FaultPlan([FaultEvent(1, "gain", 2)]))
    assert not ctl2.run().recoveries

    ctl3 = _controller(session, ds, total_steps=4,
                       fault_plan=FaultPlan([FaultEvent(2, "stall")]))
    ctl3.mark_unhealthy([3])
    report3 = ctl3.run()
    assert report3.stalls == [2]
    assert [r.kind for r in report3.recoveries] == ["lose"]
    assert report3.recoveries[0].after_shape == (3,)
    assert report3.recoveries[0].healthy_after == (0, 1, 2)
    assert sorted(report3.losses) == list(range(4))


def test_a_straggler_alone_leaves_the_losses_unchanged():
    session, ds = _setup()
    plain = _controller(session, ds, total_steps=4, ckpt_every=2).run()
    stalled = _controller(session, ds, total_steps=4, ckpt_every=2,
                          fault_plan=FaultPlan([FaultEvent(2, "stall")])
                          ).run()
    assert stalled.stalls == [2] and not stalled.recoveries
    assert stalled.losses == plain.losses
    assert stalled.mesh_history == [(4,)]


def test_too_many_recoveries_and_an_adopted_engine():
    session, ds = _setup()
    ctl = _controller(session, ds, total_steps=3, max_recoveries=0,
                      fault_plan=FaultPlan([FaultEvent(1, "lose", 2)]))
    with pytest.raises(TooManyRecoveries):
        ctl.run()
    # a bare engine is adopted into a session, which the controller owns
    engine = ctl.engine
    adopted = ElasticController(
        session, ds, ctl.mesh, engine=engine, total_steps=2,
        ckpt_dir=tempfile.mkdtemp(), ckpt_every=1, watchdog_timeout=600.0,
        fault_plan=FaultPlan([FaultEvent(1, "lose", 2)], seed=0))
    assert adopted.comm.engine is engine
    report = adopted.run()
    assert report.mesh_history == [(4,), (2,)] and report.plan_rebuilds == 1
    with pytest.raises(ValueError, match="not both"):
        ElasticController(session, ds, ctl.mesh, engine=engine,
                          comm=adopted.comm, total_steps=1,
                          ckpt_dir=tempfile.mkdtemp())


def test_quorum_loss_checkpoints_and_halts():
    class NoQuorum:                      # a vote that can never commit
        def bind_view(self, fn):
            pass

        def start(self):
            return self

        def poll_commit(self):
            return None

        def agree(self, view):
            raise ctrlplane.QuorumLostError("1 of 3 members alive")

    session, ds = _setup()
    ctl = _controller(session, ds, total_steps=5, ckpt_every=2,
                      ckpt_keep=0, membership=NoQuorum(),
                      fault_plan=FaultPlan([FaultEvent(3, "lose", 2)]))
    with pytest.raises(ctrlplane.QuorumLostError):
        ctl.run()
    assert not ctl.report.recoveries and ctl.mesh.axis_sizes == (4,)
    assert ctl.ckpt.latest() == 3           # the state it held, saved


class _FailingSession:
    """A ``TrainSession`` whose step fails once, at step ``at``, inside
    ``run_spmd``: rank ``rank`` raises ``exc``, or, when ``exc`` is a
    ``threading.Event``, waits for it instead of reaching its hop."""

    def __init__(self, session, at, rank, exc, timeout=30.0):
        self._s, self._at, self._rank, self._exc = session, at, rank, exc
        self._timeout = timeout
        self.cfg = session.cfg

    def __getattr__(self, name):
        return getattr(self._s, name)

    def step_fn(self, comm):
        inner = self._s.step_fn(comm)

        def step(states, batch):
            if int(states[0]["step"]) == self._at and self._exc:
                exc, self._exc = self._exc, None

                def body(r):
                    if r == self._rank:
                        if isinstance(exc, threading.Event):
                            exc.wait(30)
                            return
                        raise exc
                    substrate.ppermute(torch.zeros(1), "data", [(0, 1)])
                substrate.run_spmd(body, [(r,) for r in range(len(states))],
                                   comm.mesh, timeout=self._timeout)
            return inner(states, batch)
        return step


def test_a_lost_device_inside_a_rank_recovers_and_a_bug_propagates():
    session, ds = _setup(batch=12)
    lost = _FailingSession(session, 2, 2, RuntimeError(
        "CUDA error: GPU has fallen off the bus"))
    ctl = _controller(lost, ds, total_steps=4)
    report = ctl.run()
    assert [r.kind for r in report.recoveries] == ["lose"]
    assert report.recoveries[0].healthy_after == (0, 1, 3)
    assert report.mesh_history == [(4,), (3,)]
    assert sorted(report.losses) == list(range(4))

    bug = _FailingSession(session, 1, 1, ValueError("shape bug"))
    with pytest.raises(substrate.RankFailure, match="shape bug"):
        _controller(bug, ds, total_steps=3).run()


def test_a_rank_that_never_reaches_its_hop_propagates():
    # rank 0 never sends what rank 1 waits for: on thread ranks that is a
    # deadlock (or a step slower than the hop timeout), never recovered
    session, ds = _setup()
    release = threading.Event()
    hung = _FailingSession(session, 1, 0, release, timeout=0.5)
    ctl = _controller(hung, ds, total_steps=3)
    try:
        with pytest.raises(substrate.RankFailure) as ei:
            ctl.run()
    finally:
        release.set()
    assert ei.value.hung and ei.value.rank == 0
    assert not ctl.report.recoveries and ctl.mesh.axis_sizes == (4,)


REFERENCE_CHILD = """
import json
from repro.configs import get_config
from repro.data import SyntheticLMDataset
from repro.launch import train as lt
from repro.models import build_model
from repro.optim import cosine_schedule, make_optimizer
from repro.runtime import ElasticController, FaultPlan, substrate
from repro.train import TrainCfg, TrainSession
import types
cfg = get_config("granite-34b", reduced=True)
model = build_model(cfg)
opt = make_optimizer("adamw", lr=cosine_schedule(1e-3, warmup=1,
                                                 total={steps}))
tcfg = TrainCfg(sync_mode="composed", data_axes=("data",))
ds = SyntheticLMDataset(vocab_size=cfg.vocab_size, seq_len={seq},
                        global_batch={batch})
mesh = substrate.make_mesh((4, 1), ("data", "model"))
args = types.SimpleNamespace(
    microbatches=1, sync="composed", bucket_grads=False,
    bucket_bytes=32 << 20, overlap=False, overlap_depth=2, zero=False)
comm = lt.build_session(mesh, model, opt, ds, args)
ctl = ElasticController(TrainSession(model, opt, tcfg), ds, mesh,
                        total_steps={steps}, ckpt_dir={ckpt!r}, comm=comm,
                        ckpt_every=2, ckpt_keep=0,
                        fault_plan=FaultPlan.parse("lose@3:2", seed=0),
                        watchdog_timeout=600.0)
report = ctl.run()
rec = report.recoveries[0]
print("REPORT", json.dumps({{"losses": report.losses,
                            "healthy": list(rec.healthy_after),
                            "shapes": [list(rec.before_shape),
                                       list(rec.after_shape)]}}))
"""


def test_controller_losses_match_the_reference_controller(tmp_path):
    steps = 6
    ref_dir = str(tmp_path / "ref")
    out = run_subprocess_script(REFERENCE_CHILD.format(
        steps=steps, seq=SEQ, batch=8, ckpt=ref_dir), devices=4)
    line = next(l for l in out.splitlines() if l.startswith("REPORT "))
    ref = json.loads(line[len("REPORT "):])
    assert ref["shapes"] == [[4, 1], [2, 1]] and ref["healthy"] == [0, 2]

    session, ds = _setup(steps=steps)
    port_dir = str(tmp_path / "port")
    os.makedirs(port_dir)
    # start from the reference's own initial state (its step-0 save)
    shutil.copytree(os.path.join(ref_dir, f"step_{0:08d}"),
                    os.path.join(port_dir, f"step_{0:08d}"))
    ctl = _controller(session, ds, total_steps=steps, ckpt_dir=port_dir,
                      ckpt_every=2, ckpt_keep=0,
                      fault_plan=FaultPlan.parse("lose@3:2", seed=0))
    report = ctl.run()
    assert report.recoveries[0].healthy_after == (0, 2)
    want = [ref["losses"][str(s)] for s in range(steps)]
    got = [report.losses[s] for s in range(steps)]
    err = max(abs(a - b) / abs(b) for a, b in zip(got, want))
    assert err <= LOSS_RTOL, (got, want)


def test_elastic_train_launcher_recovers_on_the_cpu(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
         "--arch", "granite-34b", "--reduced", "--data", "4", "--zero",
         "--elastic", "--fault-plan", "lose@3:2", "--ckpt-dir",
         str(tmp_path), "--ckpt-sharded", "--ckpt-every", "2", "--steps",
         "5", "--seq-len", "16"], env=env, capture_output=True, text=True,
        timeout=300, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "recovered: step 3: lose (4,)->(2,) restored=2" in proc.stderr
    assert "meshes=[(4,), (2,)]" in proc.stderr
