"""The port's control plane (``repro_torch.runtime.ctrlplane``) against
the reference's scenarios, on the CPU.

The module is a copy of ``repro.runtime.ctrlplane`` (it imports only the
standard library), so the in-process twins of ``tests/test_ctrlplane.py``
run unchanged against it: transports, the seeded message-fault
injector, the heartbeat failure detector, the two-phase epoch-stamped
vote, the fence and quorum loss.  Then, with the port's controllers:
a superseded epoch is retried, quorum loss checkpoints and halts, and
two REAL processes over TCP under a one-sided partition commit the same
(survivors, epoch) and each stays bit-identical to its own survivor
baseline.  Last, a port member and a reference member vote together
over TCP and commit the same (survivors, epoch): the wire format is
shared.
"""

import os
import subprocess
import sys
import threading
import time

import pytest

from conftest import REPO
from repro_torch.runtime import ctrlplane as cp

FAST = cp.CtrlConfig(heartbeat_interval=0.02, heartbeat_timeout=0.1,
                     suspicions=3, vote_interval=0.02, agree_timeout=5.0)


def _members(fabric, names, views, config=FAST, plans=None):
    ms = {}
    for n in names:
        t = fabric.transport(n)
        if plans and n in plans:
            t = plans[n].wrap(t)
        ms[n] = cp.Membership(t, peers=names, config=config)
        ms[n].bind_view(lambda n=n: views[n])
        ms[n].start()
    return ms


def _vote_all(ms, views, timeout=10.0):
    out = {}
    def vote(n):
        out[n] = ms[n].agree(views[n])
    threads = [threading.Thread(target=vote, args=(n,)) for n in ms]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout)
    assert len(out) == len(ms), "a vote never returned"
    return out


# ---------------------------------------------------------------------------
# Transports
# ---------------------------------------------------------------------------

def test_local_transport_takes_the_json_roundtrip():
    fab = cp.LocalFabric()
    a, b = fab.transport("a"), fab.transport("b")
    a.send("b", {"kind": "x", "view": (3, 1, 2)})
    msg = b.recv(timeout=1.0)
    assert msg == {"kind": "x", "view": [3, 1, 2]}   # tuples -> lists
    assert b.recv(timeout=0.01) is None
    a.send("nobody", {"kind": "x"})                  # unknown dest: dropped


def test_tcp_transport_length_prefixed_frames():
    a = cp.TcpTransport(port=0)
    b = cp.TcpTransport(port=0, peers={a.member: ("127.0.0.1", a.port)})
    try:
        assert a.member == f"127.0.0.1:{a.port}"
        for i in range(5):
            b.send(a.member, {"kind": "hb", "n": i, "src": b.member})
        got = [a.recv(timeout=2.0) for _ in range(5)]
        assert [m["n"] for m in got] == list(range(5))
        assert all(m["src"] == b.member for m in got)
    finally:
        a.close()
        b.close()


def test_tcp_send_to_dead_peer_is_best_effort():
    t = cp.TcpTransport(port=0, peers={"x": ("127.0.0.1", 1)})
    try:
        t.send("x", {"kind": "hb"})                  # refused: no raise
        t.send("x", {"kind": "hb"})                  # backing off: no raise
        assert t._backoff["x"] > 0                   # backoff armed
    finally:
        t.close()


def test_parse_peers():
    assert cp.parse_peers("127.0.0.1:9001, 10.0.0.2:9002") == {
        "127.0.0.1:9001": ("127.0.0.1", 9001),
        "10.0.0.2:9002": ("10.0.0.2", 9002)}
    assert cp.parse_peers("") == {}
    # name=host:port decouples the member id from the dialed endpoint
    assert cp.parse_peers("a=10.0.0.1:9001, 10.0.0.2:9002") == {
        "a": ("10.0.0.1", 9001),
        "10.0.0.2:9002": ("10.0.0.2", 9002)}


def test_tcp_member_id_decoupled_from_bind_address():
    """The multi-host regression: the advertised member id must be
    honored verbatim (never derived from the bind address) — a peer's
    ``_on_message`` drops messages from unknown ids, so a loopback-
    derived id on a real deployment would declare every peer dead.  Two
    members advertised as "alpha"/"beta" but bound to loopback must
    still find each other and commit one (survivor set, epoch)."""
    ta = cp.TcpTransport("alpha", port=0, bind_host="127.0.0.1")
    tb = cp.TcpTransport("beta", port=0, bind_host="127.0.0.1",
                         peers={"alpha": ("127.0.0.1", ta.port)})
    ta._peers["beta"] = ("127.0.0.1", tb.port)   # late wiring: test only
    assert ta.member == "alpha" and tb.member == "beta"
    views = {"alpha": [0, 1, 2], "beta": [1, 2, 3]}
    ms = {}
    for name, t in (("alpha", ta), ("beta", tb)):
        ms[name] = cp.Membership(t, peers=("alpha", "beta"), config=FAST)
        ms[name].bind_view(lambda name=name: views[name])
        ms[name].start()
    try:
        out = _vote_all(ms, views)
        assert out["alpha"] == out["beta"]
        assert out["alpha"].survivors == (1, 2)
        assert out["alpha"].members == ("alpha", "beta")
    finally:
        for m in ms.values():
            m.close()


def test_tcp_slow_peer_does_not_stall_sends_to_others(monkeypatch):
    """Connection state is per-peer: a peer blocking in its connect
    timeout must not delay heartbeats/votes to healthy peers (that
    jitter would land exactly during partial failures)."""
    a = cp.TcpTransport(port=0)
    b = cp.TcpTransport(port=0, peers={a.member: ("127.0.0.1", a.port),
                                       "dead": ("127.0.0.1", 1)})
    real = cp.socket.create_connection
    def connect(addr, timeout=None):
        if addr == ("127.0.0.1", 1):
            time.sleep(0.6)
            raise OSError("unreachable")
        return real(addr, timeout=timeout)
    monkeypatch.setattr(cp.socket, "create_connection", connect)
    try:
        t = threading.Thread(target=b.send, args=("dead", {"kind": "hb"}))
        t.start()
        time.sleep(0.1)                  # the dead dial is now blocking
        t0 = time.monotonic()
        b.send(a.member, {"kind": "hb", "src": b.member})
        assert time.monotonic() - t0 < 0.3   # did not wait for the dial
        got = a.recv(timeout=2.0)
        assert got == {"kind": "hb", "src": b.member}
        t.join()
    finally:
        a.close()
        b.close()


# ---------------------------------------------------------------------------
# Fault injection
# ---------------------------------------------------------------------------

def test_ctrl_fault_plan_parse_and_validation():
    plan = cp.CtrlFaultPlan.parse("drop@3:2,delay@5:4,dup@2,partition@0:40")
    assert [(e.kind, e.step, e.count) for e in plan.events] == \
        [("partition", 0, 40), ("dup", 2, 1), ("drop", 3, 2),
         ("delay", 5, 4)]
    with pytest.raises(ValueError):
        cp.CtrlFaultEvent(0, "mangle")
    with pytest.raises(ValueError):
        cp.CtrlFaultEvent(0, "drop", count=0)
    # delay jitter is pure in (seed, step)
    ev = cp.CtrlFaultEvent(5, "delay", 4)
    assert plan.delay_for(ev, 6) == plan.delay_for(ev, 6)
    assert cp.CtrlFaultPlan([ev], seed=1).delay_for(ev, 6) \
        != cp.CtrlFaultPlan([ev], seed=2).delay_for(ev, 6)


def test_fault_plan_drop_dup_partition_semantics():
    fab = cp.LocalFabric()
    rx = fab.transport("rx")
    plan = cp.CtrlFaultPlan([cp.CtrlFaultEvent(0, "drop", 2),
                             cp.CtrlFaultEvent(2, "dup", 1),
                             cp.CtrlFaultEvent(4, "partition", 3)])
    tx = plan.wrap(fab.transport("tx"))
    for n in range(8):                # sends 0..7
        tx.send("rx", {"n": n})
    got = []
    while True:
        m = rx.recv(timeout=0.2)
        if m is None:
            break
        got.append(m["n"])
    # 0,1 dropped; 2 duplicated; 3 passes; 4,5,6 partitioned; 7 passes
    assert got == [2, 2, 3, 7], got
    assert tx.sent == 8 and tx.dropped == 5


def test_fault_plan_delay_defers_delivery():
    fab = cp.LocalFabric()
    rx = fab.transport("rx")
    plan = cp.CtrlFaultPlan([cp.CtrlFaultEvent(0, "delay", 1,
                                               delay_s=0.2)])
    tx = plan.wrap(fab.transport("tx"))
    t0 = time.monotonic()
    tx.send("rx", {"n": 0})
    assert rx.recv(timeout=0.05) is None             # not yet
    assert rx.recv(timeout=2.0) == {"n": 0}
    assert time.monotonic() - t0 >= 0.2


# ---------------------------------------------------------------------------
# Failure detector
# ---------------------------------------------------------------------------

def test_heartbeat_detector_suspicions_death_resurrection():
    fab = cp.LocalFabric()
    views = {"a": [0], "b": [0]}
    m = cp.Membership(fab.transport("a"), peers=["a", "b"], config=FAST)
    m.bind_view(lambda: views["a"])
    m.start()
    try:
        ghost = fab.transport("b")                   # b: no beats yet
        deadline = time.monotonic() + 3.0
        while "b" in m.alive_peers() and time.monotonic() < deadline:
            time.sleep(0.02)
        assert m.alive_peers() == ()                 # declared dead
        assert m.suspicion_count("b") >= FAST.suspicions
        # ANY message resurrects — a healed partition re-admits
        ghost.send("a", {"kind": "hb", "src": "b"})
        deadline = time.monotonic() + 2.0
        while "b" not in m.alive_peers() and time.monotonic() < deadline:
            time.sleep(0.02)
        assert m.alive_peers() == ("b",)
        assert m.suspicion_count("b") == 0
    finally:
        m.close()


# ---------------------------------------------------------------------------
# The vote
# ---------------------------------------------------------------------------

def test_single_member_fast_path_matches_agree_survivors():
    from repro_torch.runtime import health
    fab = cp.LocalFabric()
    m = cp.Membership(fab.transport("solo"))
    v1 = m.agree({0, 1, 2, 3})
    assert v1.epoch == 1
    assert set(v1.survivors) == health.agree_survivors({0, 1, 2, 3})
    v2 = m.agree({0, 1})                             # epochs are monotone
    assert v2.epoch == 2 and v2.survivors == (0, 1)
    assert m.poll_commit() == v2


def test_symmetric_vote_commits_identical_set_and_epoch():
    fab = cp.LocalFabric()
    names = ["a", "b", "c"]
    views = {"a": [0, 1, 2, 3, 4, 5], "b": [0, 1, 2, 3, 4, 5, 6, 7],
             "c": [0, 1, 2, 3, 4, 5, 7]}
    ms = _members(fab, names, views)
    try:
        out = _vote_all(ms, views)
        assert len(set(out.values())) == 1, out      # one (set, epoch)
        v = out["a"]
        assert v.survivors == (0, 1, 2, 3, 4, 5)     # intersection
        assert v.members == ("a", "b", "c")
    finally:
        for m in ms.values():
            m.close()


def test_passive_member_adopts_the_commit():
    fab = cp.LocalFabric()
    views = {"a": [0, 1, 2], "b": [0, 1, 2, 3]}
    ms = _members(fab, ["a", "b"], views)
    try:
        va = ms["a"].agree(views["a"])               # only a votes
        assert va.survivors == (0, 1, 2)
        deadline = time.monotonic() + 3.0
        while ms["b"].poll_commit() != va and time.monotonic() < deadline:
            time.sleep(0.02)
        assert ms["b"].poll_commit() == va           # b served passively
        assert ms["b"].epoch == va.epoch
    finally:
        for m in ms.values():
            m.close()


def test_vote_survives_dropped_and_duplicated_messages():
    fab = cp.LocalFabric()
    views = {"a": [0, 1, 2, 3], "b": [1, 2, 3, 4]}
    plans = {"a": cp.CtrlFaultPlan([cp.CtrlFaultEvent(0, "drop", 4),
                                    cp.CtrlFaultEvent(6, "dup", 3)])}
    ms = _members(fab, ["a", "b"], views, plans=plans)
    try:
        out = _vote_all(ms, views)
        assert out["a"] == out["b"]
        assert out["a"].survivors == (1, 2, 3)
    finally:
        for m in ms.values():
            m.close()


def test_vote_survives_one_sided_partition():
    # a's first 25 sends vanish (one-sided: b -> a still flows); the
    # re-broadcast cadence heals the round once the window passes and
    # both commit the same epoch
    fab = cp.LocalFabric()
    views = {"a": [0, 1, 2, 3, 4, 5], "b": [0, 1, 2, 3, 4, 5, 6, 7]}
    plans = {"a": cp.CtrlFaultPlan([cp.CtrlFaultEvent(0, "partition",
                                                      25)])}
    ms = _members(fab, ["a", "b"], views, plans=plans)
    try:
        out = _vote_all(ms, views, timeout=15.0)
        assert out["a"] == out["b"], out
        assert out["a"].survivors == (0, 1, 2, 3, 4, 5)
        assert ms["a"].transport.dropped == 25
    finally:
        for m in ms.values():
            m.close()


def test_fence_raises_on_stale_and_uncommitted_epochs():
    fab = cp.LocalFabric()
    m = cp.Membership(fab.transport("solo"))
    with pytest.raises(cp.StaleEpochError):
        m.fence(0)                                   # nothing committed
    v1 = m.agree({0, 1, 2})
    v2 = m.agree({0, 1})
    assert m.fence(v2.epoch) == v2                   # committed: passes
    with pytest.raises(cp.StaleEpochError):
        m.fence(v1.epoch)                            # superseded
    with pytest.raises(cp.StaleEpochError):
        m.fence(v2.epoch + 1)                        # from the future


def _racy_membership():
    """agree() hands back epoch 1, but a concurrent vote commits epoch 2
    before the fence — the multi-failure race _sync_membership must
    absorb by adopting the newer committed view and retrying."""
    class Racy:
        def __init__(self):
            self.v1 = cp.MembershipView(1, (0, 1, 2), ("a", "b"))
            self.v2 = cp.MembershipView(2, (0, 1), ("a", "b"))
            self.committed = None
            self.agreed = []
        def poll_commit(self):
            return self.committed
        def agree(self, view):
            self.agreed.append(tuple(view))
            if self.committed is None:
                self.committed = self.v2     # the racing vote lands now
                return self.v1               # ...but WE got epoch 1 back
            return self.committed
        def fence(self, epoch):
            if self.committed is None or epoch != self.committed.epoch:
                raise cp.StaleEpochError(f"epoch {epoch} superseded")
            return self.committed
    return Racy()


@pytest.mark.parametrize("controller", ["elastic", "serve"])
def test_sync_membership_retries_a_superseded_epoch(controller):
    """A commit racing in between agree() and fence() must re-drive the
    agreement at the newer epoch, not crash the run with
    StaleEpochError (both controllers share the contract)."""
    from types import SimpleNamespace
    if controller == "elastic":
        from repro_torch.runtime.controller import ElasticController as cls
    else:
        from repro_torch.serve.controller import ServeController as cls
    ctl = SimpleNamespace(membership=_racy_membership(),
                          _healthy={0, 1, 2, 3}, _ctrl_epoch=0)
    epoch = cls._sync_membership(ctl)
    assert epoch == 2                        # settled on the NEWER epoch
    assert ctl._ctrl_epoch == 2 and ctl._healthy == {0, 1}
    assert ctl.membership.agreed == [(0, 1, 2, 3)]   # no re-vote needed


def test_quorum_loss_raises_instead_of_minority_commit():
    fab = cp.LocalFabric()
    cfg = cp.CtrlConfig(heartbeat_interval=0.02, heartbeat_timeout=0.05,
                        suspicions=2, vote_interval=0.02,
                        agree_timeout=0.6)
    m = cp.Membership(fab.transport("a"), peers=["a", "b", "c"],
                      config=cfg)
    m.start()
    try:
        assert m.quorum == 2
        with pytest.raises(cp.QuorumLostError):
            m.agree([0, 1, 2, 3])                    # b, c never answer
        assert m.poll_commit() is None               # nothing committed
    finally:
        m.close()


def test_membership_view_is_comparable_and_ordered():
    v = cp.MembershipView(3, [5, 1, 3], ["b", "a"])
    assert v.epoch == 3
    assert v.survivors == (1, 3, 5)                  # sorted, deduped
    assert v.members == ("a", "b")
    assert v == cp.MembershipView(3, (1, 3, 5), ("a", "b"))
    assert v != cp.MembershipView(4, (1, 3, 5), ("a", "b"))


# ---------------------------------------------------------------------------
# Controllers under the control plane (reduced granite-34b on CPU ranks)
# ---------------------------------------------------------------------------

_SETUP = """
import sys, tempfile
from repro_torch.configs import get_config
from repro_torch.data import SyntheticLMDataset
from repro_torch.launch.train import build_session
from repro_torch.models import build_model
from repro_torch.optim import make_optimizer
from repro_torch.runtime import ctrlplane, substrate
from repro_torch.runtime.controller import (ElasticController, FaultEvent,
                                            FaultPlan)
from repro_torch.train import trainer

cfg = get_config("granite-34b", reduced=True)
model = build_model(cfg)
opt = make_optimizer("adamw", lr=1e-3)
tcfg = trainer.TrainCfg(sync_mode="composed")
session = trainer.TrainSession(model, opt, tcfg)
ds = SyntheticLMDataset(vocab_size=cfg.vocab_size, seq_len=16,
                        global_batch=8)
mesh0 = substrate.make_host_mesh(4, device="cpu")
comm = build_session(mesh0, model, opt, ds, tcfg)
tmp = tempfile.mkdtemp()
"""


def test_quorum_loss_checkpoints_then_halts():
    """A member whose peers are unreachable loses quorum on the first
    loss: the controller saves a final checkpoint and raises
    QuorumLostError instead of re-meshing a minority island."""
    ns = {}
    exec(_SETUP, ns)
    membership = cp.connect(
        port=0, peers="127.0.0.1:1,127.0.0.1:2",
        config=cp.CtrlConfig(heartbeat_interval=0.1, heartbeat_timeout=0.3,
                             suspicions=2, vote_interval=0.05,
                             agree_timeout=3.0))
    ctl = ns["ElasticController"](
        ns["session"], ns["ds"], ns["mesh0"], total_steps=6,
        ckpt_dir=ns["tmp"], comm=ns["comm"], ckpt_every=2, ckpt_keep=0,
        fault_plan=ns["FaultPlan"]([ns["FaultEvent"](3, "lose", 2)],
                                   seed=1),
        watchdog_timeout=600.0, membership=membership)
    try:
        with pytest.raises(cp.QuorumLostError):
            ctl.run()
    finally:
        membership.close()
    assert not ctl.report.recoveries            # no re-mesh happened
    # graceful degradation: the state was checkpointed before the halt
    assert ctl.ckpt.latest() == 3
    tree, step = ctl.ckpt.restore_latest(
        ns["session"].abstract_state(mesh=ns["mesh0"]))
    assert tree is not None and step == 3


_CHILD = _SETUP + """
import time
membership = ctrlplane.connect(
    port=@PORT@, peers="127.0.0.1:@PEER@",
    config=ctrlplane.CtrlConfig(heartbeat_interval=1000.0,
                                heartbeat_timeout=0.5, suspicions=3,
                                vote_interval=0.05, agree_timeout=120.0),
    fault_plan=@CPLAN@)
ctl = ElasticController(
    session, ds, mesh0, total_steps=@STEPS@, ckpt_dir=tmp, comm=comm,
    ckpt_every=2, ckpt_keep=0, fault_plan=@FPLAN@,
    watchdog_timeout=600.0, membership=membership, @THROTTLE@)
report = ctl.run()

assert len(report.recoveries) == 1, report.describe()
rec = report.recoveries[0]
assert rec.kind == "lose" and rec.epoch == 1, rec   # ONE committed epoch
assert rec.after_shape == (2,) and len(rec.healthy_after) == 2, rec

# Every loss from the restored step on equals a run on this member's
# survivor mesh from the same checkpoint, bit for bit.
from repro_torch.checkpoint import restore_checkpoint
mesh2 = substrate.make_mesh((2,), ("data",), device="cpu",
                            members=rec.healthy_after)
tree = restore_checkpoint(tmp, session.abstract_state(mesh=mesh2),
                          step=rec.restored_step)
states = session.scatter(tree, mesh2)
step = session.step_fn(build_session(mesh2, model, opt, ds, tcfg).world)
for s in range(rec.restored_step, @STEPS@):
    states, metrics = step(states, ds.host_batch(s))
    assert metrics["loss"].item() == report.losses[s], s
membership.close()
print("COMMIT epoch=" + str(rec.epoch) + " survivors="
      + ",".join(str(d) for d in rec.healthy_after))
"""


def _free_ports(n):
    import socket
    socks = [socket.socket() for _ in range(n)]
    for s in socks:
        s.bind(("127.0.0.1", 0))
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


def test_two_processes_agree_under_one_sided_partition():
    """Member A injects lose@3:2 AND loses its first 40 control-plane
    sends (a one-sided partition); member B has no faults of its own and
    learns of the loss only from the vote it serves passively.  Both
    commit the identical (survivors, epoch=1), and each stays
    bit-identical to its own survivor baseline."""
    pa, pb = _free_ports(2)

    def child(code):
        env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
        return subprocess.Popen([sys.executable, "-c", code], env=env,
                                stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)

    code_a = (_CHILD.replace("@PORT@", str(pa)).replace("@PEER@", str(pb))
              .replace("@STEPS@", "6").replace("@THROTTLE@", "")
              .replace("@FPLAN@", "FaultPlan([FaultEvent(3, 'lose', 2)], "
                                  "seed=1)")
              .replace("@CPLAN@",
                       "ctrlplane.CtrlFaultPlan.parse('partition@0:40')"))
    # B's loop is throttled so its drain window stays open however the
    # two children interleave
    code_b = (_CHILD.replace("@PORT@", str(pb)).replace("@PEER@", str(pa))
              .replace("@STEPS@", "24")
              .replace("@THROTTLE@", "on_step=lambda s, l: time.sleep(0.4)")
              .replace("@FPLAN@", "None").replace("@CPLAN@", "None"))
    procs = [child(code_a), child(code_b)]
    results = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=300)
            results.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for rc, out, err in results:
        assert rc == 0, err[-3000:]
    commits = [line for _, out, _ in results for line in out.splitlines()
               if line.startswith("COMMIT ")]
    assert len(commits) == 2, results
    assert commits[0] == commits[1], commits
    assert "epoch=1" in commits[0], commits


def test_port_and_reference_members_commit_the_same_view():
    """One member of each package, over real TCP: the wire format is
    shared, so their vote commits one (survivors, epoch)."""
    from repro.runtime import ctrlplane as jcp
    ta = cp.TcpTransport("port", port=0, bind_host="127.0.0.1")
    tb = jcp.TcpTransport("reference", port=0, bind_host="127.0.0.1",
                          peers={"port": ("127.0.0.1", ta.port)})
    ta._peers["reference"] = ("127.0.0.1", tb.port)   # late wiring
    views = {"port": [0, 1, 2, 3, 5], "reference": [1, 2, 3, 4, 5]}
    names = ("port", "reference")
    ms = {"port": cp.Membership(ta, peers=names, config=FAST),
          "reference": jcp.Membership(tb, peers=names, config=jcp.CtrlConfig(
              heartbeat_interval=0.02, heartbeat_timeout=0.1, suspicions=3,
              vote_interval=0.02, agree_timeout=5.0))}
    for n, m in ms.items():
        m.bind_view(lambda n=n: views[n])
        m.start()
    try:
        out = _vote_all(ms, views)
        got = {n: (v.epoch, v.survivors, v.members) for n, v in out.items()}
        assert got["port"] == got["reference"], got
        assert got["port"] == (1, (1, 2, 3, 5), names)
    finally:
        for m in ms.values():
            m.close()
