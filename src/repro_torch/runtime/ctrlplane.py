"""Control-plane membership: heartbeats, epoch-fenced survivor agreement,
and split-brain-free re-mesh.

Counterpart of ``repro.runtime.ctrlplane``, copied: the module imports
only the standard library, and its wire format is the reference's, so a
member of this package and a member of the reference vote together over
TCP and commit the same (survivors, epoch).

On a deployment of several hosts every host sees its own failure
evidence — a local CUDA or NCCL error, a watchdog stall, a preemption
notice — and two hosts that re-mesh over different survivor sets have
split the brain: half the job all-reduces over a mesh the other half
already abandoned.  The fix is the MPIX_Comm_agree shape from the
fault-tolerant MPI lineage, made concrete:

* **Transport** — one tiny message interface with two implementations:
  ``LocalTransport`` (in-process queues over a shared ``LocalFabric``;
  tests, benches, single-host) and ``TcpTransport`` (length-prefixed
  JSON frames over sockets, per-peer reconnect with exponential backoff
  + jitter).  This module is the ONLY place that constructs transports
  or touches sockets: the controllers consume the vote, they never
  speak the wire format.  ``connect()`` is the blessed factory.

* **Heartbeat failure detector** — a sender thread beats every
  ``heartbeat_interval``; a monitor charges one *suspicion* per
  ``heartbeat_timeout`` of continued silence and declares the peer dead
  at ``suspicions`` strikes.  Death is soft: any received message
  resurrects (a healed partition re-admits the peer automatically).

* **Two-phase, epoch-stamped survivor agreement** — ``Membership.
  agree(local_view)`` proposes the caller's healthy-device view under a
  fresh epoch, collects every live member's proposal (re-broadcasting
  against message loss), intersects — a device survives only if EVERY
  view still trusts it — then commits the intersection.  A member
  returns only when all participants' commits match; conflicting
  commits (asymmetric partitions produce them) abandon the round and
  re-vote under a higher epoch.  Epochs are monotone and **fenced**:
  stale-epoch messages are answered with the committed view instead of
  being replayed, and ``Membership.fence(epoch)`` raises
  ``StaleEpochError`` unless ``epoch`` is THE committed epoch — the
  controllers call it immediately before re-meshing, so a superseded
  decision can never re-mesh.

* **Quorum** — below ``quorum`` live members (default: majority) a vote
  cannot commit; ``agree`` keeps retrying until its deadline and then
  raises ``QuorumLostError``.  The controllers turn that into
  checkpoint/snapshot + halt: degrading to a saved image is recoverable,
  re-meshing a minority island into a second brain is not.

* **CtrlFaultPlan** — the control-plane twin of the data plane's
  ``FaultPlan``: seeded, deterministic message faults keyed on the
  transport's send counter ("drop@3:2", "delay@5:4", "dup@2:1",
  "partition@0:40" = this member's next 40 sends vanish — a one-sided
  partition when installed on one side), so agreement-under-partition
  is a unit test, not an outage post-mortem.

Single-member fast path: with no peers, ``agree`` is exactly the old
``health.agree_survivors`` intersection (which now delegates to
``intersect_views`` here) plus an epoch bump — the controllers run the
same code on one host as on fifty.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import queue
import random
import socket
import struct
import threading
import time
from typing import (Callable, Dict, Iterable, List, Mapping, Optional,
                    Sequence, Set, Tuple)

logger = logging.getLogger("repro_torch.runtime")

__all__ = [
    "CtrlConfig", "CtrlFaultEvent", "CtrlFaultPlan", "LocalFabric",
    "LocalTransport", "Membership", "MembershipView", "QuorumLostError",
    "StaleEpochError", "TcpTransport", "connect", "intersect_views",
]


class QuorumLostError(RuntimeError):
    """Fewer than ``quorum`` live members: the vote cannot commit.  The
    controllers checkpoint/snapshot and halt instead of re-meshing a
    minority island into a split brain."""


class StaleEpochError(RuntimeError):
    """A re-mesh was attempted on an epoch that is not the committed one
    — either superseded by a later vote or never committed at all."""


def intersect_views(local_view: Iterable[int],
                    peer_views: Sequence[Iterable[int]] = ()) -> Set[int]:
    """The agreement rule, as a pure function: a device survives only if
    EVERY view still trusts it (conservative intersection — no member
    re-meshes over a device another member watched die).  This is both
    the commit rule of the two-phase vote and, via
    ``health.agree_survivors``, the single-host fast path."""
    survivors = set(int(d) for d in local_view)
    for view in peer_views:
        survivors &= set(int(d) for d in view)
    return survivors


# ---------------------------------------------------------------------------
# Transports
# ---------------------------------------------------------------------------

class LocalFabric:
    """Shared in-process 'network': one mailbox per member.  The
    threaded twin of a TCP deployment — same messages, same dropped-set
    semantics (sends to unknown members vanish, like a dead socket)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._boxes: Dict[str, "queue.Queue[dict]"] = {}

    def transport(self, member: str) -> "LocalTransport":
        with self._lock:
            self._boxes.setdefault(member, queue.Queue())
        return LocalTransport(self, member)

    def _deliver(self, dest: str, msg: dict) -> None:
        with self._lock:
            box = self._boxes.get(dest)
        if box is not None:
            box.put(msg)

    def _box(self, member: str) -> "queue.Queue[dict]":
        with self._lock:
            return self._boxes[member]


class LocalTransport:
    """In-process transport over a ``LocalFabric`` (tests / single-host
    / benches).  Messages take a JSON round-trip so anything that runs
    here is wire-compatible with ``TcpTransport``."""

    def __init__(self, fabric: LocalFabric, member: str):
        self.fabric = fabric
        self.member = member
        self._closed = False

    def send(self, dest: str, msg: dict) -> None:
        if self._closed:
            return
        self.fabric._deliver(dest, json.loads(json.dumps(msg)))

    def recv(self, timeout: float) -> Optional[dict]:
        try:
            return self.fabric._box(self.member).get(timeout=timeout)
        except queue.Empty:
            return None

    def close(self) -> None:
        self._closed = True


_FRAME = struct.Struct(">I")
_MAX_FRAME = 1 << 20


class TcpTransport:
    """Length-prefixed JSON frames over sockets, one listener per member.

    Addressing is split three ways for multi-host deployments: the
    listener binds ``bind_host`` (default ``0.0.0.0`` — peers dial in
    over whatever interface routes here), ``host`` is the *advertised*
    address peers know this member by, and ``member`` is the id stamped
    on every message (default ``host:<bound port>``).  The id must match
    what peers carry in THEIR ``peers`` map, never the bind address —
    on a real deployment the two differ and a loopback-derived id would
    make every peer drop this member's messages as unknown.

    ``peers`` maps member id -> ``(host, port)``.  Sends are best-effort
    (the control plane tolerates loss by re-broadcasting): an
    unreachable peer costs one connect attempt, then goes into
    exponential backoff with jitter — ``reconnect_backoff`` doubling up
    to ``reconnect_backoff_max``, so a dead host is not hammered and a
    healed one is re-dialed promptly.  Connection state (conn, backoff,
    lock) is per-peer: one peer blocking in its connect timeout must not
    stall heartbeats and vote traffic to the healthy ones — that jitter
    would land exactly during the partial failures the vote must
    survive."""

    def __init__(self, member: Optional[str] = None, *, port: int = 0,
                 host: str = "127.0.0.1",
                 bind_host: Optional[str] = None,
                 peers: Optional[Mapping[str, Tuple[str, int]]] = None,
                 reconnect_backoff: float = 0.2,
                 reconnect_backoff_max: float = 2.0,
                 reconnect_jitter: float = 0.25,
                 seed: int = 0):
        self._server = socket.create_server(
            (bind_host if bind_host is not None else "0.0.0.0", port))
        self._server.settimeout(0.2)
        self.port = self._server.getsockname()[1]
        self.member = member or f"{host}:{self.port}"
        self._peers = dict(peers or {})
        self._inbox: "queue.Queue[dict]" = queue.Queue()
        self._conns: Dict[str, socket.socket] = {}
        self._backoff: Dict[str, float] = {}
        self._next_try: Dict[str, float] = {}
        self._b0 = reconnect_backoff
        self._bmax = reconnect_backoff_max
        self._jitter = reconnect_jitter
        self._rnd = random.Random(seed)
        self._state_lock = threading.Lock()    # guards the per-peer maps
        self._peer_locks: Dict[str, threading.Lock] = {}
        self._closed = threading.Event()
        self._accept_thread = threading.Thread(target=self._accept_loop,
                                               daemon=True)
        self._accept_thread.start()

    # -- receive side -----------------------------------------------------

    def _accept_loop(self) -> None:
        while not self._closed.is_set():
            try:
                conn, _ = self._server.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            threading.Thread(target=self._read_loop, args=(conn,),
                             daemon=True).start()

    def _read_loop(self, conn: socket.socket) -> None:
        buf = b""
        try:
            while not self._closed.is_set():
                while len(buf) >= _FRAME.size:
                    (n,) = _FRAME.unpack_from(buf)
                    if n > _MAX_FRAME:
                        return
                    if len(buf) < _FRAME.size + n:
                        break
                    payload = buf[_FRAME.size:_FRAME.size + n]
                    buf = buf[_FRAME.size + n:]
                    try:
                        self._inbox.put(json.loads(payload.decode()))
                    except ValueError:
                        pass                       # corrupt frame: drop
                chunk = conn.recv(65536)
                if not chunk:
                    return
                buf += chunk
        except OSError:
            return
        finally:
            conn.close()

    def recv(self, timeout: float) -> Optional[dict]:
        try:
            return self._inbox.get(timeout=timeout)
        except queue.Empty:
            return None

    # -- send side --------------------------------------------------------

    def _peer_lock(self, dest: str) -> threading.Lock:
        with self._state_lock:
            lock = self._peer_locks.get(dest)
            if lock is None:
                lock = self._peer_locks[dest] = threading.Lock()
            return lock

    def send(self, dest: str, msg: dict) -> None:
        if self._closed.is_set() or dest not in self._peers:
            return
        data = json.dumps(msg).encode()
        frame = _FRAME.pack(len(data)) + data
        with self._peer_lock(dest):
            now = time.monotonic()
            conn = self._conns.get(dest)
            if conn is None:
                if now < self._next_try.get(dest, 0.0):
                    return                         # still backing off
                try:
                    conn = socket.create_connection(self._peers[dest],
                                                    timeout=0.5)
                    self._conns[dest] = conn
                    self._backoff.pop(dest, None)  # reconnected: reset
                except OSError:
                    self._arm_backoff(dest, now)
                    return
            try:
                conn.sendall(frame)
            except OSError:
                conn.close()
                self._conns.pop(dest, None)
                self._arm_backoff(dest, now)

    def _arm_backoff(self, dest: str, now: float) -> None:
        b = min(self._backoff.get(dest, self._b0 / 2) * 2, self._bmax)
        self._backoff[dest] = b
        with self._state_lock:
            jitter = self._jitter * self._rnd.random()
        self._next_try[dest] = now + b * (1 + jitter)

    def close(self) -> None:
        self._closed.set()
        try:
            self._server.close()
        except OSError:
            pass
        for conn in list(self._conns.values()):
            try:
                conn.close()
            except OSError:
                pass
        self._conns.clear()


# ---------------------------------------------------------------------------
# Deterministic control-plane fault injection
# ---------------------------------------------------------------------------

DROP, DELAY, DUP, PARTITION = "drop", "delay", "dup", "partition"


@dataclasses.dataclass(frozen=True)
class CtrlFaultEvent:
    """One message fault, keyed on the wrapped transport's send counter
    (the control-plane analogue of ``FaultEvent.step``): fires for sends
    ``step .. step+count-1``."""
    step: int
    kind: str              # "drop" | "delay" | "dup" | "partition"
    count: int = 1
    delay_s: float = 0.25  # delay events: added latency before delivery
    peers: Tuple[str, ...] = ()   # partition: sever only these (default all)

    def __post_init__(self):
        if self.kind not in (DROP, DELAY, DUP, PARTITION):
            raise ValueError(f"unknown ctrl fault kind {self.kind!r}")
        if self.count < 1:
            raise ValueError(f"{self.kind} event needs count >= 1")

    def covers(self, n: int) -> bool:
        return self.step <= n < self.step + self.count


class CtrlFaultPlan:
    """A seeded schedule of message faults, mirroring ``FaultPlan``.

    ``parse("drop@3:2,delay@5:4,dup@2:1,partition@0:40")`` — at send N
    drop/delay/duplicate that message, or (partition) drop *everything*
    this member sends for the next ``count`` sends: installed on one
    member only, that is exactly a one-sided partition.  Delay jitter is
    pure in ``(seed, step)`` so two runs delay identically."""

    def __init__(self, events: Sequence[CtrlFaultEvent] = (),
                 seed: int = 0):
        self.events = tuple(sorted(events, key=lambda e: e.step))
        self.seed = seed

    @classmethod
    def parse(cls, spec: str, seed: int = 0) -> "CtrlFaultPlan":
        """``"drop@3:2,partition@5:40"`` -> CtrlFaultPlan (CLI surface)."""
        events = []
        for part in filter(None, (p.strip() for p in spec.split(","))):
            kind, _, rest = part.partition("@")
            at, _, count = rest.partition(":")
            events.append(CtrlFaultEvent(step=int(at), kind=kind,
                                         count=int(count) if count else 1))
        return cls(events, seed=seed)

    def delay_for(self, ev: CtrlFaultEvent, n: int) -> float:
        rnd = random.Random((self.seed << 24) ^ (n + 1))
        return ev.delay_s * (1.0 + 0.5 * rnd.random())

    def wrap(self, transport) -> "_FaultyTransport":
        return _FaultyTransport(transport, self)


class _FaultyTransport:
    """Transport decorator applying a ``CtrlFaultPlan`` to sends."""

    def __init__(self, inner, plan: CtrlFaultPlan):
        self.inner = inner
        self.plan = plan
        self.member = inner.member
        self.sent = 0
        self.dropped = 0
        self._lock = threading.Lock()

    @property
    def port(self):                                # TcpTransport passthrough
        return getattr(self.inner, "port", None)

    def send(self, dest: str, msg: dict) -> None:
        with self._lock:
            n = self.sent
            self.sent += 1
        dup = False
        for ev in self.plan.events:
            if not ev.covers(n):
                continue
            if ev.kind == PARTITION and (not ev.peers or dest in ev.peers):
                with self._lock:
                    self.dropped += 1
                return
            if ev.kind == DROP:
                with self._lock:
                    self.dropped += 1
                return
            if ev.kind == DELAY:
                t = threading.Timer(self.plan.delay_for(ev, n),
                                    self.inner.send, (dest, msg))
                t.daemon = True
                t.start()
                return
            if ev.kind == DUP:
                dup = True
        self.inner.send(dest, msg)
        if dup:
            self.inner.send(dest, msg)

    def recv(self, timeout: float) -> Optional[dict]:
        return self.inner.recv(timeout)

    def close(self) -> None:
        self.inner.close()


# ---------------------------------------------------------------------------
# Heartbeats + the two-phase vote
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CtrlConfig:
    heartbeat_interval: float = 0.1   # beat cadence
    heartbeat_timeout: float = 0.5    # silence per suspicion charge
    suspicions: int = 3               # strikes before a peer is dead
    vote_interval: float = 0.05       # re-broadcast cadence mid-vote
    agree_timeout: float = 10.0       # total budget before QuorumLost

    @property
    def detection_s(self) -> float:
        """Nominal silence-to-declared-dead latency."""
        return self.heartbeat_timeout * self.suspicions


class MembershipView(Tuple):
    """A committed agreement: ``(epoch, survivors, members)``."""
    __slots__ = ()

    def __new__(cls, epoch: int, survivors: Iterable[int],
                members: Iterable[str]):
        return super().__new__(cls, (int(epoch),
                                     tuple(sorted(set(int(d)
                                                      for d in survivors))),
                                     tuple(sorted(members))))

    @property
    def epoch(self) -> int:
        return self[0]

    @property
    def survivors(self) -> Tuple[int, ...]:
        return self[1]

    @property
    def members(self) -> Tuple[str, ...]:
        return self[2]

    def __repr__(self) -> str:
        return (f"MembershipView(epoch={self.epoch}, "
                f"survivors={self.survivors}, members={self.members})")


class _PeerState:
    __slots__ = ("last_heard", "suspicions", "dead")

    def __init__(self) -> None:
        self.last_heard = time.monotonic()
        self.suspicions = 0
        self.dead = False


class _Round:
    """Per-epoch vote state (proposals + commits seen so far)."""
    __slots__ = ("proposals", "commits", "my_commit", "done", "last_tx")

    def __init__(self) -> None:
        self.proposals: Dict[str, Tuple[int, ...]] = {}
        self.commits: Dict[str, Tuple] = {}
        self.my_commit: Optional[Tuple] = None
        self.done = False
        self.last_tx = 0.0     # rate-limits this round's retransmission


class Membership:
    """One member of the control plane: heartbeats out, suspicion-counted
    failure detection in, and the epoch-fenced two-phase survivor vote.

    The vote is symmetric (no coordinator): ``agree`` drives a round
    actively, while the receive thread serves rounds *passively* using
    ``bind_view``'s provider — so a member whose step loop is busy
    training still answers a peer's vote.  Controllers poll
    ``poll_commit`` at step boundaries to learn about votes they did not
    start, and call ``fence(epoch)`` immediately before re-meshing."""

    def __init__(self, transport, peers: Sequence[str] = (), *,
                 config: Optional[CtrlConfig] = None,
                 quorum: Optional[int] = None):
        self.transport = transport
        self.member: str = transport.member
        self.peers: Tuple[str, ...] = tuple(p for p in peers
                                            if p != self.member)
        self.members: Tuple[str, ...] = tuple(sorted((self.member,)
                                                     + self.peers))
        self.config = config or CtrlConfig()
        self.quorum = (quorum if quorum is not None
                       else len(self.members) // 2 + 1)
        if not 1 <= self.quorum <= len(self.members):
            raise ValueError(f"quorum {self.quorum} outside "
                             f"1..{len(self.members)}")
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._peer_state = {p: _PeerState() for p in self.peers}
        self._epoch = 0
        self._view: Optional[MembershipView] = None
        self._rounds: Dict[int, _Round] = {}
        self._highest_seen = 0
        self._last_contrib: Optional[Tuple[int, ...]] = None
        self._view_provider: Optional[Callable[[], Iterable[int]]] = None
        self._beats_sent = 0
        self._started = False
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []

    # -- lifecycle --------------------------------------------------------

    def start(self) -> "Membership":
        with self._lock:
            if self._started:
                return self
            self._started = True
        for fn in (self._beat_loop, self._recv_loop, self._monitor_loop):
            t = threading.Thread(target=fn, daemon=True)
            t.start()
            self._threads.append(t)
        return self

    def close(self) -> None:
        self._stop.set()
        with self._cond:
            self._cond.notify_all()
        for t in self._threads:
            t.join(timeout=1.0)
        self.transport.close()

    def __enter__(self) -> "Membership":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()

    def bind_view(self, provider: Callable[[], Iterable[int]]) -> None:
        """Install the local healthy-device view the passive vote path
        answers with (the controllers bind ``lambda: sorted(healthy)``)."""
        self._view_provider = provider

    # -- failure detector -------------------------------------------------

    def _beat_loop(self) -> None:
        while not self._stop.wait(self.config.heartbeat_interval):
            self._beats_sent += 1
            for p in self.peers:
                self.transport.send(p, {"kind": "hb", "src": self.member})

    def _monitor_loop(self) -> None:
        cfg = self.config
        while not self._stop.wait(min(cfg.heartbeat_timeout / 2,
                                      cfg.heartbeat_interval)):
            now = time.monotonic()
            with self._cond:
                for p, st in self._peer_state.items():
                    strikes = int((now - st.last_heard)
                                  / cfg.heartbeat_timeout)
                    if strikes > st.suspicions:
                        st.suspicions = strikes
                        if st.suspicions >= cfg.suspicions and not st.dead:
                            st.dead = True
                            logger.warning(
                                "ctrlplane[%s]: peer %s declared dead "
                                "(%d suspicions, %.2fs silent)",
                                self.member, p, st.suspicions,
                                now - st.last_heard)
                            self._cond.notify_all()

    def suspicion_count(self, peer: str) -> int:
        with self._lock:
            return self._peer_state[peer].suspicions

    def alive_peers(self) -> Tuple[str, ...]:
        with self._lock:
            return tuple(p for p, st in self._peer_state.items()
                         if not st.dead)

    def alive_members(self) -> Tuple[str, ...]:
        return tuple(sorted((self.member,) + self.alive_peers()))

    # -- receive path -----------------------------------------------------

    def _recv_loop(self) -> None:
        while not self._stop.is_set():
            msg = self.transport.recv(timeout=0.1)
            if msg is None:
                continue
            try:
                self._on_message(msg)
            except Exception:                      # pragma: no cover
                logger.exception("ctrlplane[%s]: bad message %r",
                                 self.member, msg)

    def _on_message(self, msg: dict) -> None:
        src = msg.get("src")
        if src not in self._peer_state:
            return                                 # not a known member
        kind = msg.get("kind")
        with self._cond:
            st = self._peer_state[src]
            st.last_heard = time.monotonic()
            st.suspicions = 0
            if st.dead:                            # resurrection
                st.dead = False
                logger.warning("ctrlplane[%s]: peer %s back from the "
                               "dead", self.member, src)
            if kind == "hb":
                self._cond.notify_all()
                return
            epoch = int(msg.get("epoch", 0))
            self._highest_seen = max(self._highest_seen, epoch)
            if kind == "committed":
                # catch-up: the sender already adopted this commit
                # (unanimity + quorum verified there) — adopt if newer.
                if epoch > self._epoch:
                    self._last_contrib = None      # not our proposal
                    self._adopt(MembershipView(epoch, msg["survivors"],
                                               msg["members"]))
                return
            if epoch <= self._epoch:
                # Epoch fence on the wire: answer stale proposals and
                # commits with the committed view, never replay them.
                if kind in ("propose", "commit") and self._view is not None:
                    self.transport.send(src, self._committed_msg())
                return
            rnd = self._rounds.setdefault(epoch, _Round())
            if kind == "propose":
                rnd.proposals[src] = tuple(int(d) for d in msg["view"])
                self._serve_round(epoch)
            elif kind == "commit":
                rnd.commits[src] = (tuple(int(d) for d in msg["survivors"]),
                                    tuple(msg["members"]))
                self._serve_round(epoch)
            self._cond.notify_all()

    # -- the vote ---------------------------------------------------------

    def _committed_msg(self) -> dict:
        return {"kind": "committed", "src": self.member,
                "epoch": self._view.epoch,
                "survivors": list(self._view.survivors),
                "members": list(self._view.members)}

    def _broadcast(self, msg: dict) -> None:
        for p in self.peers:
            self.transport.send(p, msg)

    def _serve_round(self, epoch: int) -> None:
        """Advance a round from received state (caller holds the lock):
        ensure our proposal is in (passive path answers with the bound
        view), broadcast our commit once every live proposal is in, and
        adopt when all participant commits match."""
        rnd = self._rounds[epoch]
        if rnd.done or epoch <= self._epoch:
            return
        if self.member not in rnd.proposals:
            if self._view_provider is None:
                return                # nothing to answer with (yet)
            rnd.proposals[self.member] = tuple(
                sorted(int(d) for d in self._view_provider()))
        # Retransmission is timer-paced, never receipt-paced: serving a
        # round on every received message but also BROADCASTING on every
        # received message turns one receipt into a peers-wide fan-out —
        # an unconverged round then feeds itself a message storm that
        # starves later epochs in the FIFO inboxes.  Round state still
        # advances on every call; only the re-send is throttled.
        now = time.monotonic()
        throttled = now - rnd.last_tx < self.config.vote_interval
        if not throttled:
            rnd.last_tx = now
            self._broadcast({"kind": "propose", "src": self.member,
                             "epoch": epoch,
                             "view": list(rnd.proposals[self.member])})
        expected = set(self.alive_members_locked())
        have = set(rnd.proposals)
        if not (expected <= have and len(have & expected) >= self.quorum):
            return
        participants = tuple(sorted(have & expected))
        survivors = tuple(sorted(intersect_views(
            rnd.proposals[self.member],
            [rnd.proposals[p] for p in participants if p != self.member])))
        changed = rnd.my_commit != (survivors, participants)
        rnd.my_commit = (survivors, participants)
        rnd.commits[self.member] = rnd.my_commit
        if changed or not throttled:
            self._broadcast({"kind": "commit", "src": self.member,
                             "epoch": epoch, "survivors": list(survivors),
                             "members": list(participants)})
        needed = set(participants)
        if needed <= set(rnd.commits):
            votes = {rnd.commits[p] for p in needed}
            if len(votes) == 1:
                rnd.done = True
                self._last_contrib = rnd.proposals[self.member]
                self._adopt(MembershipView(epoch, survivors, participants))
                self._broadcast(self._committed_msg())

    def alive_members_locked(self) -> Tuple[str, ...]:
        return tuple(sorted((self.member,)
                            + tuple(p for p, st in self._peer_state.items()
                                    if not st.dead)))

    def _adopt(self, view: MembershipView) -> None:
        self._epoch = view.epoch
        self._view = view
        for e in list(self._rounds):
            if e <= view.epoch:
                self._rounds.pop(e)
        logger.info("ctrlplane[%s]: committed %r", self.member, view)
        self._cond.notify_all()

    def agree(self, local_view: Iterable[int],
              timeout: Optional[float] = None) -> MembershipView:
        """The two-phase survivor vote.  Blocks until every live member's
        commit for one epoch matches, then returns the committed view;
        raises ``QuorumLostError`` when quorum never assembles before the
        deadline.  With no peers this is the single-member fast path:
        exactly ``health.agree_survivors`` plus an epoch bump."""
        my = tuple(sorted(intersect_views(local_view)))
        if not self.peers:
            with self._cond:
                self._epoch += 1
                self._last_contrib = my
                self._view = MembershipView(self._epoch, my, (self.member,))
                return self._view
        if not self._started:
            self.start()
        deadline = time.monotonic() + (timeout if timeout is not None
                                       else self.config.agree_timeout)
        with self._cond:
            # Idempotence against the passive path: a round this member
            # already served (with this exact view, via bind_view) and
            # committed IS this vote — starting another would fork epochs
            # across members that raced their agree() calls.
            if (self._view is not None
                    and self.member in self._view.members
                    and self._last_contrib == my):
                return self._view
            floor = self._epoch          # any commit above this satisfies us
            min_epoch = self._epoch + 1
            while True:
                if self._epoch > floor:
                    return self._view    # a concurrent vote committed
                # JOIN the highest active round rather than out-bid it:
                # concurrent voters racing to start "the next" epoch must
                # land in one round or their commits diverge.
                epoch = max([min_epoch]
                            + [e for e in self._rounds if e > self._epoch])
                rnd = self._rounds.setdefault(epoch, _Round())
                rnd.proposals[self.member] = my
                self._serve_round(epoch)
                if self._epoch > floor:
                    return self._view
                self._cond.wait(timeout=self.config.vote_interval)
                if self._stop.is_set():
                    raise QuorumLostError(
                        f"{self.member}: membership closed mid-vote")
                if time.monotonic() >= deadline:
                    raise QuorumLostError(
                        f"{self.member}: no quorum of {self.quorum}/"
                        f"{len(self.members)} members committed epoch "
                        f"{epoch} within the deadline (alive: "
                        f"{self.alive_members_locked()})")
                # A conflicting commit set abandons this epoch and
                # re-votes under a fresh one (merged views converge
                # post-heal).  Peers proposing the SAME epoch is the
                # normal symmetric race — agreement, not conflict.
                rnd = self._rounds.get(epoch)
                conflicted = (rnd is not None and rnd.my_commit is not None
                              and any(c != rnd.my_commit
                                      for c in rnd.commits.values()))
                if conflicted:
                    min_epoch = max(epoch, self._highest_seen,
                                    self._epoch) + 1

    # -- committed state --------------------------------------------------

    @property
    def epoch(self) -> int:
        with self._lock:
            return self._epoch

    def poll_commit(self) -> Optional[MembershipView]:
        """Latest committed view (or None) — the step-boundary drain for
        votes this member served passively."""
        with self._lock:
            return self._view

    def fence(self, epoch: int) -> MembershipView:
        """The split-brain fence: raise unless ``epoch`` is THE committed
        epoch.  Controllers call this immediately before re-meshing, so a
        decision superseded by a later vote — or never committed at all —
        can never reconfigure the job."""
        with self._lock:
            if self._view is None or epoch != self._epoch:
                raise StaleEpochError(
                    f"{self.member}: re-mesh fenced — epoch {epoch} is "
                    f"not the committed epoch "
                    f"{self._epoch if self._view else None}")
            return self._view


# ---------------------------------------------------------------------------
# The blessed constructors (the one way onto the wire)
# ---------------------------------------------------------------------------

def parse_peers(spec: str) -> Dict[str, Tuple[str, int]]:
    """``"127.0.0.1:9001,10.0.0.2:9001"`` -> {member id: (host, port)}.
    The member id defaults to the ``host:port`` string itself, so every
    process derives the same name for the same endpoint; an explicit
    ``name=host:port`` entry decouples the two (NAT, DNS aliases, or
    any deployment where members dial an address that is not the id)."""
    peers: Dict[str, Tuple[str, int]] = {}
    for part in filter(None, (p.strip() for p in spec.split(","))):
        name, eq, endpoint = part.partition("=")
        endpoint = endpoint if eq else part
        host, _, port = endpoint.rpartition(":")
        peers[name if eq else f"{host}:{int(port)}"] = (host, int(port))
    return peers


def local_fabric() -> LocalFabric:
    """A fresh in-process fabric (tests / single-host wiring)."""
    return LocalFabric()


def connect(member: Optional[str] = None, *, port: int = 0,
            host: str = "127.0.0.1",
            bind_host: Optional[str] = None,
            peers: "str | Mapping[str, Tuple[str, int]]" = "",
            config: Optional[CtrlConfig] = None,
            quorum: Optional[int] = None,
            fault_plan: Optional[CtrlFaultPlan] = None) -> Membership:
    """Build a TCP control-plane member and start its threads — the ONE
    public way to get on the wire (nothing else constructs transports
    or opens sockets).  ``peers``
    is the *other* members as a ``[name=]host:port`` comma list (or a
    prebuilt mapping).  ``host`` is the address this member is
    *advertised* as — what the peers' lists call it — and the member id
    defaults to ``host:<bound port>``; the listener itself binds
    ``bind_host`` (default all interfaces), which on a multi-host
    deployment is a different thing from the advertised address."""
    pmap = parse_peers(peers) if isinstance(peers, str) else dict(peers)
    transport = TcpTransport(member, port=port, host=host,
                             bind_host=bind_host, peers=pmap)
    if fault_plan is not None:
        transport = fault_plan.wrap(transport)
    return Membership(transport, peers=tuple(pmap),
                      config=config, quorum=quorum).start()
