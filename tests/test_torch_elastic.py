"""The port's elastic building blocks against the reference, on the CPU.

- ``plan_mesh_shape`` / ``plan_from_mesh`` give the reference's shapes
  (or raise where it raises) over a grid of (n, model parallel, pods,
  ndim), and plan the port's one-axis data meshes (``ndim=1``).
- ``FaultPlan`` parses the reference's grammar into the same events and
  picks the same seeded victims.
- Mesh member ids: the default, a survivor mesh keeping the survivors'
  ids through ``make_mesh_from_shape`` and ``Session.remesh_over``.
- ``run_spmd`` raises a ``RankFailure`` naming the rank that failed
  (and its member id), never a peer's abort.
- ``classify_failure``: CUDA and NCCL messages of a lost device and a
  ``RankFailure`` carrying one (or a rank that never reached its hop)
  classify; out of memory, illegal addresses, device-side asserts, NCCL
  misuse and ordinary errors propagate.
- ``elastic.remesh`` moves ZeRO-1 states of 2 ranks onto 4 (a live
  grow) with the logical state unchanged, and the next step's loss
  equals that of states restored onto 4 ranks from a checkpoint.
- The watchdog fires once per stall episode and records the straggler
  beat, on a clock the test advances (no sleeps between beats); the
  preemption mailbox and its SIGTERM binding.
"""

import os
import signal
import threading
import time

import pytest
import torch

from repro.runtime import controller as jcontroller
from repro.runtime import elastic as jelastic
from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
from repro_torch.runtime import elastic, health
from repro_torch.runtime import watchdog as watchdog_mod
from repro_torch.runtime import substrate as S
from repro_torch.runtime.controller import FaultEvent, FaultPlan
from repro_torch.runtime.watchdog import StepWatchdog
from repro_torch.train import trainer
from repro_torch.tree import flatten


def _plan(mod, *args, **kw):
    try:
        return mod.plan_mesh_shape(*args, **kw)
    except ValueError as e:
        return ("raises", str(e))


@pytest.mark.parametrize("ndim", [None, 2, 3])
@pytest.mark.parametrize("pods", [1, 2, 3])
@pytest.mark.parametrize("mp", [1, 2, 4, 8])
def test_plan_mesh_shape_matches_reference(mp, pods, ndim):
    for n in range(0, 33):
        assert _plan(elastic, n, mp, pods, ndim=ndim) == \
            _plan(jelastic, n, mp, pods, ndim=ndim), (n, mp, pods, ndim)


@pytest.mark.parametrize("shape,names", [
    ((4, 2), ("data", "model")), ((2, 2, 2), ("pod", "data", "model")),
    ((8, 1), ("data", "model"))])
def test_plan_from_mesh_matches_reference(shape, names):
    class JMesh:                         # what plan_from_mesh reads
        def __init__(self):
            self.shape = dict(zip(names, shape))
    mesh = S.make_mesh(shape, names, device="cpu")
    for n in range(1, mesh.size + 1):
        assert elastic.plan_from_mesh(mesh, n) == \
            jelastic.plan_from_mesh(JMesh(), n)


def test_one_axis_data_mesh_plans_data_only():
    mesh = S.make_host_mesh(4, device="cpu")
    assert [elastic.plan_from_mesh(mesh, n) for n in (4, 3, 2, 1)] == \
        [(4,), (3,), (2,), (1,)]
    with pytest.raises(ValueError, match="model axis"):
        elastic.plan_mesh_shape(4, 2, ndim=1)
    with pytest.raises(ValueError, match="pod axis"):
        elastic.plan_mesh_shape(8, 1, pods=2, ndim=1)
    with pytest.raises(ValueError, match="no healthy"):
        elastic.plan_mesh_shape(0, 1, ndim=1)


@pytest.mark.parametrize("spec", ["lose@5:2,gain@9:2,stall@7",
                                  "stall@3, lose@1", "gain@2:4,lose@2:1"])
def test_fault_plan_parses_as_the_reference(spec):
    got = FaultPlan.parse(spec, seed=3)
    want = jcontroller.FaultPlan.parse(spec, seed=3)
    assert [(e.step, e.kind, e.count) for e in got.events] == \
        [(e.step, e.kind, e.count) for e in want.events]
    with pytest.raises(ValueError):
        FaultEvent(1, "explode")
    with pytest.raises(ValueError):
        FaultEvent(1, "lose", 0)


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_fault_plan_victims_match_the_reference(seed):
    mine = FaultPlan(seed=seed)
    ref = jcontroller.FaultPlan(seed=seed)
    for step in range(12):
        for pool in ([0, 1, 2, 3], list(range(8)), [1, 3, 4, 6, 7]):
            for count in (1, 2):
                assert mine.pick_victims(pool, count, step) == \
                    ref.pick_victims(pool, count, step)


def test_mesh_members_default_and_survive_a_remesh():
    from repro_torch.comm import Session
    mesh = S.make_host_mesh(4, device="cpu")
    assert mesh.members == (0, 1, 2, 3)
    small = elastic.make_mesh_from_shape((2,), members=(1, 3),
                                         device="cpu")
    assert small.axis_names == ("data",) and small.members == (1, 3)
    assert small.coords(1) == {"data": 1} and small.rank_of({"data": 1}) == 1
    with pytest.raises(ValueError, match="distinct member ids"):
        S.make_mesh((2,), ("data",), device="cpu", members=(1, 1))
    sess = Session(mesh=mesh)
    new, rebuilt = sess.remesh_over([0, 2, 3])
    assert new.axis_sizes == (3,) and new.members == (0, 2, 3) and rebuilt
    assert sess.mesh is new and sess.generation == 1
    with sess.activate() as active:
        assert active is new


def test_run_spmd_names_the_failing_rank():
    mesh = S.make_mesh((4,), ("data",), device="cpu", members=(10, 11, 12,
                                                               13))

    def body(r):
        if r == 2:
            raise RuntimeError("CUDA error: GPU has fallen off the bus")
        for _ in range(3):
            S.ppermute(torch.zeros(2), "data",
                       [(j, (j + 1) % 4) for j in range(4)])
        return r

    with pytest.raises(S.RankFailure) as ei:
        S.run_spmd(body, [(r,) for r in range(4)], mesh, timeout=30)
    err = ei.value
    assert (err.rank, err.member, err.hung) == (2, 12, False)
    assert isinstance(err.exc, RuntimeError) and err.__cause__ is err.exc
    assert not isinstance(err.exc, S.SpmdAbort)
    assert health.classify_failure(err) == (12,)


def test_a_rank_that_never_arrives_is_named():
    release = threading.Event()

    def body(r):
        if r == 1:
            release.wait(10)
            return r
        return S.ppermute(torch.zeros(1), "data", [(0, 1), (1, 0)])

    with pytest.raises(S.RankFailure) as ei:
        S.run_spmd(body, [(r,) for r in range(2)],
                   S.make_host_mesh(2, device="cpu"), timeout=0.5)
    release.set()
    assert ei.value.rank == 1 and ei.value.hung
    assert isinstance(ei.value.exc, S.SpmdAbort)
    # a thread rank that never arrives is a deadlock, not a lost device
    assert health.classify_failure(ei.value) is None


@pytest.mark.parametrize("msg,victims", [
    ("CUDA error: GPU has fallen off the bus", ()),
    ("CUDA error: uncorrectable ECC error encountered", ()),
    ("CUDA error: CUDA-capable device(s) is/are busy or unavailable "
     "(cudaErrorDevicesUnavailable)", ()),
    ("NCCL error in: ProcessGroupNCCL.cpp:1970, remote process exited or "
     "there was a network error, NCCL version 2.21.5 ncclRemoteError",
     ()),
    ("UNAVAILABLE: device 3 halted; device 5 halted", (3, 5)),
    ("device lost: device:1 stopped answering", (1,)),
])
def test_classify_names_lost_devices(msg, victims):
    assert health.classify_failure(RuntimeError(msg)) == victims
    wrapped = S.RankFailure(3, 7, 4, RuntimeError(msg))
    assert health.classify_failure(wrapped) == (7,)


@pytest.mark.parametrize("exc", [
    torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate "
                                "2.00 GiB"),
    RuntimeError("CUDA error: an illegal memory access was encountered"),
    RuntimeError("CUDA error: device-side assert triggered"),
    RuntimeError("CUDA error: misaligned address"),
    RuntimeError("NCCL error: unhandled cuda error, ncclUnhandledCudaError:"
                 " Cuda failure 'out of memory'"),
    RuntimeError("NCCL error: invalid usage, ncclInvalidUsage"),
    RuntimeError("shape '[4, 8]' is invalid for input of size 30"),
    RuntimeError("compilation terminated: device_count=8"),
    ValueError("device 3 exploded"),
    KeyError("unavailable"),
])
def test_classify_propagates_bugs(exc):
    assert health.classify_failure(exc) is None
    assert health.classify_failure(S.RankFailure(0, 0, 2, exc)) is None


def test_weak_markers_need_the_word_device():
    assert health.classify_failure(
        RuntimeError("execution halted on device 4")) == (4,)
    assert health.classify_failure(
        RuntimeError("execution halted with errors")) is None


def _zero_workload(p):
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLMDataset
    from repro_torch.launch.train import build_session
    from repro_torch.models import build_model
    from repro_torch.optim import make_optimizer
    cfg = get_config("granite-34b", reduced=True)
    model = build_model(cfg)
    opt = make_optimizer("adamw", lr=1e-3, clip_norm=0.0)
    tcfg = trainer.TrainCfg(zero=True)
    ds = SyntheticLMDataset(vocab_size=cfg.vocab_size, seq_len=16,
                            global_batch=4)
    sess = trainer.TrainSession(model, opt, tcfg)

    def step_on(mesh):
        return sess.step_fn(build_session(mesh, model, opt, ds,
                                          tcfg).world)
    return sess, ds, step_on


def test_remesh_grows_zero_states_and_keeps_the_logical_state(tmp_path):
    sess, ds, step_on = _zero_workload(2)
    mesh2 = S.make_host_mesh(2, device="cpu")
    mesh4 = S.make_host_mesh(4, device="cpu")
    states = sess.init_state(torch.Generator().manual_seed(0), mesh=mesh2)
    states, _ = step_on(mesh2)(states, ds.host_batch(0))
    want = trainer.logical_state(sess.gather(states, mesh2))
    grown = elastic.remesh(states, sess.cfg, sess.abstract_state(mesh=mesh4),
                           mesh4, mesh=mesh2, model=sess.model)
    assert len(grown) == 4
    got = trainer.logical_state(sess.gather(grown, mesh4))
    (gl, gp), (wl, wp) = flatten(got), flatten(want)
    assert gp == wp and all(torch.equal(a, b) for a, b in zip(gl, wl))
    # the same as the checkpoint path: a restore resized onto 4 ranks
    d = str(tmp_path)
    save_checkpoint(d, 1, sess.gather(states, mesh2), sharded=True)
    restored = sess.scatter(restore_checkpoint(
        d, sess.abstract_state(mesh=mesh4), allow_resize_1d=True), mesh4)
    step4 = step_on(mesh4)
    _, m_grown = step4(grown, ds.host_batch(1))
    _, m_restored = step4(restored, ds.host_batch(1))
    assert m_grown["loss"].item() == m_restored["loss"].item()


class _FakeClock:
    """``time.monotonic`` for the watchdog, advanced only by the test: the
    watchdog's arithmetic then sees exact step times whatever the load on
    the host."""

    def __init__(self):
        self.now = 1000.0

    def __call__(self) -> float:
        return self.now

    def advance(self, dt: float) -> None:
        self.now += dt


@pytest.fixture
def fake_clock(monkeypatch):
    clock = _FakeClock()
    monkeypatch.setattr(watchdog_mod.time, "monotonic", clock)
    return clock


def _wait_for(pred, seconds=5.0):
    """Poll the monitor thread's effect on the real clock."""
    deadline = time.perf_counter() + seconds
    while not pred() and time.perf_counter() < deadline:
        time.sleep(0.01)
    return pred()


def test_watchdog_fires_once_per_stall_episode(fake_clock):
    fired = []
    wd = StepWatchdog(timeout=0.2, on_stall=fired.append).start()
    try:
        fake_clock.advance(0.7)
        assert _wait_for(lambda: len(fired) >= 1)
        time.sleep(0.2)                      # several more monitor polls
        assert len(fired) == 1               # one episode, one callback
        assert fired[0] == pytest.approx(0.7)
        wd.beat()
        fake_clock.advance(0.5)
        assert _wait_for(lambda: len(fired) >= 2)
        time.sleep(0.2)
        assert len(fired) == 2               # re-armed by the beat
    finally:
        wd.stop()


def test_straggler_beats_are_recorded(fake_clock):
    seen = []
    wd = StepWatchdog(timeout=60.0, straggler_factor=3.0,
                      on_straggler=lambda beat, dt: seen.append(beat))
    for dt in (0.0, 0.01, 0.01, 0.01, 0.01, 0.01, 0.08):
        fake_clock.advance(dt)
        wd.beat()
    assert wd.stragglers == [6] and seen == [6]


def test_preemption_notice_and_sigterm_handler():
    notice = health.PreemptionNotice()
    threads = [threading.Thread(target=notice.post, args=([i],))
               for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert notice.pending and notice.drain() == tuple(range(8))
    assert not notice.pending and notice.drain() == ()
    previous = health.install_preemption_handler(notice, (2, 3))
    try:
        os.kill(os.getpid(), signal.SIGTERM)
        deadline = time.monotonic() + 5
        while not notice.pending and time.monotonic() < deadline:
            time.sleep(0.01)
        assert notice.drain() == (2, 3)
    finally:
        signal.signal(signal.SIGTERM, previous)
    assert health.agree_survivors({0, 1, 2, 3}, [{1, 2, 3}, {0, 2, 3}]) \
        == {2, 3}
