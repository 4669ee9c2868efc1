"""Model-sharded training state under the port's elastic controller, on
CPU thread ranks (reduced granite-34b, f32), against the reference's
scenarios on ``("data", "model")`` meshes.

- Lose 2 of (4, 2) at step 5: the step-4 checkpoint (in the reference's
  global layout) restores onto (3, 2), the survivors the reference picks
  for the same plan and seed, and every loss from step 4 on equals, bit
  for bit, a run started on (3, 2) from the same checkpoint.  Composed
  (twin: ``tests/test_controller.py::
  test_shrink_recovery_bit_identical_and_replans_once``), ZeRO-1 with
  per-shard files (twin: ``tests/test_zero.py::
  test_zero_elastic_recovery_from_sharded_checkpoint``) and compressed
  with the EF residual per leaf and in buckets.  The CommPlan rebuilds
  once; persistent handles on "data" and "model" are revoked and
  rebound, the data handle's mean scale following the width to 1/3.
- Shrink, shrink, grow (the grow a live re-mesh of ZeRO-1 states):
  [(4, 2), (3, 2), (2, 2), (4, 2)], one plan rebuild a change.  Two
  value-equal lose events fire twice; 7 healthy members plan (3, 2) and
  leave one idle.  A plan that must shrink "model" (one survivor of a
  (1, 2) mesh) runs the same run on a model rebuilt at width 1, bit for
  bit the run restored onto (1, 1), and grows back to (1, 2).
- A compressed, bucketed (2, 2) run keeps the params every model rank
  holds whole bit-equal across "model": no bucket mixes split and whole
  leaves, so their int8 blocks never share scales.
- Against the reference: one child interpreter with 8 host devices runs
  the reference's controller on (4, 2) under the same plan; the port's,
  started from the reference's step-0 save, stays within ``LOSS_RTOL``.
- The launcher: ``--model-parallel 2 --ckpt-dir --ckpt-sharded
  --elastic --fault-plan lose@5:2`` recovers on the CPU and exits 0.
"""

import glob
import json
import os
import shutil
import subprocess
import sys
import tempfile

import pytest
import torch

from conftest import REPO, run_subprocess_script
from repro_torch.checkpoint import load_manifest, restore_checkpoint
from repro_torch.configs import get_config
from repro_torch.data import SyntheticLMDataset
from repro_torch.launch.train import build_session
from repro_torch.models import build_model
from repro_torch.optim import cosine_schedule, make_optimizer
from repro_torch.parallel import sharding
from repro_torch.runtime import substrate
from repro_torch.runtime.controller import (ElasticController, FaultEvent,
                                            FaultPlan)
from repro_torch.train import trainer
from repro_torch.tree import flatten

LOSS_RTOL = 1e-4           # composed, as tests/test_torch_train.py
SEQ = 16
BATCH = 12                 # splits over 4, 3, 2 and 1 data ranks
AXES = ("data", "model")

SYNCS = {"composed": {}, "zero1": {"zero": True},
         "compressed": {"sync_mode": "compressed"},
         "compressed_bucketed": {"sync_mode": "compressed",
                                 "bucket_grads": True,
                                 "bucket_bytes": 1 << 14}}


def _setup(steps=8, model_parallel=2, **tcfg):
    cfg = get_config("granite-34b", reduced=True)
    model = build_model(cfg, model_parallel=model_parallel)
    opt = make_optimizer("adamw", lr=cosine_schedule(
        1e-3, warmup=max(steps // 20, 1), total=steps),
        **({"clip_norm": 0.0} if tcfg.get("zero") else {}))
    ds = SyntheticLMDataset(vocab_size=cfg.vocab_size, seq_len=SEQ,
                            global_batch=BATCH)
    return trainer.TrainSession(model, opt, trainer.TrainCfg(**tcfg)), ds


def _controller(session, ds, shape=(4, 2), **kw):
    mesh = substrate.make_mesh(shape, AXES, device="cpu")
    comm = build_session(mesh, session.model, session.optimizer, ds,
                         session.cfg)
    kw.setdefault("ckpt_dir", tempfile.mkdtemp())
    kw.setdefault("ckpt_every", 1)
    kw.setdefault("watchdog_timeout", 600.0)
    return ElasticController(session, ds, mesh, comm=comm, **kw)


def _baseline(session, ds, ckpt_dir, step, members, shape, total):
    """A run started on ``members`` (a ``shape`` mesh) from checkpoint
    ``step``."""
    mesh = substrate.make_mesh(shape, AXES, device="cpu", members=members)
    tree = restore_checkpoint(ckpt_dir, session.abstract_state(mesh=mesh),
                              step=step, allow_resize_1d=session.cfg.zero)
    states = session.scatter(tree, mesh)
    step_fn = session.step_fn(build_session(
        mesh, session.model, session.optimizer, ds, session.cfg).world)
    losses = {}
    for s in range(step, total):
        states, m = step_fn(states, ds.host_batch(s))
        losses[s] = m["loss"].item()
    return losses


@pytest.mark.parametrize("sync", list(SYNCS))
def test_lose_two_of_eight_is_bit_identical_to_the_survivor_run(sync):
    session, ds = _setup(**SYNCS[sync])
    ctl = _controller(session, ds, total_steps=8, ckpt_every=2,
                      ckpt_keep=0, ckpt_sharded=True,
                      fault_plan=FaultPlan([FaultEvent(5, "lose", 2)],
                                           seed=1))
    data = ctl.comm.split("data").persistent("all_reduce", (16,),
                                             torch.float32, mean=True)
    model = ctl.comm.split("model").persistent("all_reduce", (16,),
                                               torch.float32, mean=True)
    assert data.binding.mean_scale == 0.25
    assert model.binding.mean_scale == 0.5
    report = ctl.run()

    assert len(report.recoveries) == 1, report.describe()
    rec = report.recoveries[0]
    assert (rec.step, rec.kind, rec.restored_step) == (5, "lose", 4)
    assert (rec.before_shape, rec.after_shape) == ((4, 2), (3, 2))
    assert rec.healthy_after == (0, 1, 3, 4, 6, 7)   # the reference's
    assert report.mesh_history == [(4, 2), (3, 2)]
    assert rec.plan_rebuilt and report.plan_rebuilds == 1
    assert ctl.engine.plan.stats.rebuilds == 1
    for h in (data, model):
        assert h.revocations == 1 and not h.revoked
    assert data.binding.mean_scale == 1.0 / 3.0
    assert model.binding.mean_scale == 0.5
    assert sorted(report.losses) == list(range(8))
    step4 = os.path.join(ctl.ckpt.directory, "step_00000004")
    assert any("shards" in e for e in load_manifest(
        ctl.ckpt.directory, 4)["leaves"])
    assert glob.glob(os.path.join(step4, "*.shard_*.bin"))
    want = _baseline(session, ds, ctl.ckpt.directory, 4,
                     rec.healthy_after, (3, 2), 8)
    assert {s: report.losses[s] for s in want} == want


def test_shrink_shrink_grow_over_data_and_model():
    session, ds = _setup(steps=9, zero=True)
    ctl = _controller(session, ds, total_steps=9, ckpt_keep=0,
                      fault_plan=FaultPlan([FaultEvent(2, "lose", 2),
                                            FaultEvent(4, "lose", 2),
                                            FaultEvent(6, "gain", 4),
                                            FaultEvent(7, "stall")], seed=2))
    report = ctl.run()
    assert report.mesh_history == [(4, 2), (3, 2), (2, 2), (4, 2)]
    assert [r.kind for r in report.recoveries] == ["lose", "lose", "grow"]
    assert [r.restored_step for r in report.recoveries] == [2, 4, None]
    assert len(report.recoveries[2].healthy_after) == 8
    assert report.stalls == [7]
    assert sorted(report.losses) == list(range(9))
    assert report.plan_rebuilds == 3 and ctl.engine.plan.stats.rebuilds == 3


def test_duplicate_lose_plans_three_by_two_and_leaves_one_idle():
    session, ds = _setup(steps=4)
    ctl = _controller(session, ds, total_steps=4,
                      fault_plan=FaultPlan([FaultEvent(1, "lose", 1),
                                            FaultEvent(1, "lose", 1),
                                            FaultEvent(3, "gain", 9)],
                                           seed=4))
    report = ctl.run()
    assert [r.kind for r in report.recoveries] == ["lose", "lose", "grow"]
    assert [len(r.healthy_after) for r in report.recoveries] == [7, 6, 8]
    assert report.recoveries[0].after_shape == (3, 2)
    assert report.mesh_history == [(4, 2), (3, 2), (4, 2)]
    assert sorted(report.losses) == list(range(4))


def test_degraded_model_shrink_runs_on_a_rebuilt_model():
    """One survivor of (1, 2): ``plan_mesh_shape`` halves "model", the
    checkpoint restores onto a model built for width 1, and a gain grows
    the state back onto (1, 2)."""
    session, ds = _setup(steps=7)
    ctl = _controller(session, ds, shape=(1, 2), total_steps=7,
                      ckpt_every=2, ckpt_keep=0,
                      fault_plan=FaultPlan([FaultEvent(3, "lose", 1),
                                            FaultEvent(5, "gain", 1)]))
    seen = []
    ctl.on_step = lambda s, l: seen.append((s, ctl.mesh.axis_sizes))
    report = ctl.run()
    assert report.mesh_history == [(1, 2), (1, 1), (1, 2)]
    rec = report.recoveries[0]
    assert (rec.kind, rec.restored_step) == ("lose", 2)
    assert [k for k in seen if k[0] in (2, 4, 5)] == [
        (2, (1, 2)), (2, (1, 1)), (4, (1, 1)), (5, (1, 2))]
    assert report.plan_rebuilds == 2
    want = _baseline(session, ds, ctl.ckpt.directory, 2, rec.healthy_after,
                     (1, 1), 5)
    assert {s: report.losses[s] for s in want} == want


def test_compressed_buckets_keep_replicated_params_equal_over_model():
    """A compressed, bucketed (2, 2) run: a leaf every model rank holds
    whole gets the same synced update on each, so after the steps its
    param and EF residual are bit-equal across "model" (no bucket mixes
    split and whole leaves, whose int8 blocks would share scales)."""
    session, ds = _setup(steps=3, check_model_replicas=True,
                         sync_mode="compressed", bucket_grads=True)
    mesh = substrate.make_mesh((2, 2), AXES, device="cpu")
    model = session.model_for(mesh)
    paths = flatten(model.abstract_params())[1]
    split = sharding.sharded_leaves(paths, model.layout)
    buckets = trainer.grad_bucket_plan(model.abstract_params(), session.cfg,
                                       model.layout)
    assert len({split[sl.index] for b in buckets for sl in b.slots}) == 2
    assert all(len({split[sl.index] for sl in b.slots}) == 1
               for b in buckets)
    states = session.init_state(torch.Generator().manual_seed(0), mesh=mesh)
    step_fn = session.step_fn(build_session(
        mesh, session.model, session.optimizer, ds, session.cfg).world)
    for s in range(3):
        states, _ = step_fn(states, ds.host_batch(s))
    for d in range(2):
        a, b = (states[mesh.rank_of({"data": d, "model": m})]
                for m in range(2))
        pa, pb = flatten(a["params"])[0], flatten(b["params"])[0]
        whole = [j for j, sp in enumerate(split) if not sp]
        assert whole and all(torch.equal(pa[j], pb[j]) for j in whole)
        for bk, ea, eb in zip(buckets, a["ef"], b["ef"]):
            if not split[bk.slots[0].index]:
                assert torch.equal(ea, eb)


REFERENCE_CHILD = """
import json
import types
from repro.configs import get_config
from repro.data import SyntheticLMDataset
from repro.launch import train as lt
from repro.models import build_model
from repro.optim import cosine_schedule, make_optimizer
from repro.runtime import ElasticController, FaultPlan, substrate
from repro.train import TrainCfg, TrainSession
cfg = get_config("granite-34b", reduced=True)
model = build_model(cfg)
opt = make_optimizer("adamw", lr=cosine_schedule(1e-3, warmup=1,
                                                 total={steps}))
tcfg = TrainCfg(sync_mode="composed", data_axes=("data",))
ds = SyntheticLMDataset(vocab_size=cfg.vocab_size, seq_len={seq},
                        global_batch={batch})
mesh = substrate.make_mesh((4, 2), ("data", "model"))
args = types.SimpleNamespace(
    microbatches=1, sync="composed", bucket_grads=False,
    bucket_bytes=32 << 20, overlap=False, overlap_depth=2, zero=False)
comm = lt.build_session(mesh, model, opt, ds, args)
ctl = ElasticController(TrainSession(model, opt, tcfg), ds, mesh,
                        total_steps={steps}, ckpt_dir={ckpt!r}, comm=comm,
                        ckpt_every=2, ckpt_keep=0,
                        fault_plan=FaultPlan.parse("lose@5:2", seed=1),
                        watchdog_timeout=600.0)
report = ctl.run()
rec = report.recoveries[0]
print("REPORT", json.dumps({{"losses": report.losses,
                            "healthy": list(rec.healthy_after),
                            "restored": rec.restored_step,
                            "shapes": [list(rec.before_shape),
                                       list(rec.after_shape)]}}))
"""


@pytest.fixture(scope="module")
def reference_run(tmp_path_factory):
    """The reference's controller on (4, 2), 8 steps, ``lose@5:2`` with
    seed 1: (its report, its checkpoint directory)."""
    ckpt = str(tmp_path_factory.mktemp("ref_tp"))
    out = run_subprocess_script(REFERENCE_CHILD.format(
        steps=8, seq=SEQ, batch=BATCH, ckpt=ckpt), devices=8)
    line = next(l for l in out.splitlines() if l.startswith("REPORT "))
    return json.loads(line[len("REPORT "):]), ckpt


def test_controller_losses_match_the_reference_controller(reference_run,
                                                          tmp_path):
    ref, ref_dir = reference_run
    assert ref["shapes"] == [[4, 2], [3, 2]] and ref["restored"] == 4
    session, ds = _setup()
    port_dir = str(tmp_path / "port")
    os.makedirs(port_dir)
    # start from the reference's own initial state (its step-0 save)
    shutil.copytree(os.path.join(ref_dir, f"step_{0:08d}"),
                    os.path.join(port_dir, f"step_{0:08d}"))
    ctl = _controller(session, ds, total_steps=8, ckpt_dir=port_dir,
                      ckpt_every=2, ckpt_keep=0,
                      fault_plan=FaultPlan.parse("lose@5:2", seed=1))
    report = ctl.run()
    rec = report.recoveries[0]
    assert list(rec.healthy_after) == ref["healthy"]
    assert [list(rec.before_shape), list(rec.after_shape)] == ref["shapes"]
    want = [ref["losses"][str(s)] for s in range(8)]
    got = [report.losses[s] for s in range(8)]
    err = max(abs(a - b) / abs(b) for a, b in zip(got, want))
    assert err <= LOSS_RTOL, (got, want)


def test_elastic_tp_launcher_recovers_on_the_cpu(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
         "--arch", "granite-34b", "--reduced", "--data", "4",
         "--model-parallel", "2", "--ckpt-dir", str(tmp_path),
         "--ckpt-sharded", "--ckpt-every", "2", "--elastic",
         "--fault-plan", "lose@5:2", "--steps", "8", "--seq-len", "16",
         "--global-batch", "12"], env=env, capture_output=True, text=True,
        timeout=300, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "recovered: step 5: lose (4, 2)->(3, 2) restored=4" in proc.stderr
    assert "meshes=[(4, 2), (3, 2)]" in proc.stderr
