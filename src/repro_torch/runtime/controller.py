"""Elastic controller: the supervised fail/shrink/grow re-mesh loop.

Counterpart of ``repro.runtime.controller``.  One entity owns the whole
failure lifecycle: ``StepWatchdog`` stall and straggler signals,
injected losses, preemption notices, control-plane commits and real
errors that ``health.classify_failure`` names all feed one supervisor
that

  1. plans the survivors' mesh (``plan_mesh_shape`` over the healthy
     member ids, aiming back at the original layout),
  2. restores the latest atomic checkpoint in that mesh's layout to
     host memory (``allow_resize_1d`` for ZeRO's flat padded leaves),
  3. re-meshes the state: scatters it to the new ranks on the card,
  4. calls ``Session.remesh`` on the communication session — the ONE
     invalidation path: the topology fingerprint decides whether the
     ``CommPlan`` rebuilds, every persistent handle is revoked and
     rebound — and rebuilds the step over it, and
  5. resumes the step loop at the restored step.

A live grow (members came back) re-meshes the current state without a
restore.  Meshes are ``("data",)``, ``("data", "model")`` or with
"pod": the checkpoint holds the reference's global tree, so the state
moves over every axis, and a plan that has to shrink "model" (fewer
survivors than one model group) runs the same run on the model rebuilt
for the new width (``TrainSession.model_for``).  Ranks are threads of
one process on one card (``substrate.run_spmd``); a member id is a rank
of the original mesh (``Mesh.members``), and a lost member is a rank the
survivor mesh no longer runs.

Determinism contract: the data pipeline is a pure function of step and
the checkpoint carries the step counter, so every loss from the
restored step on is bit-identical to a run started on the survivors'
mesh from the same checkpoint.

``FaultPlan`` is the reference's deterministic injection harness, with
its grammar (``"lose@5:2,gain@9:2,stall@7"``) and its seeded choice of
victims, so the two packages lose the same members on the same plan.
"""

from __future__ import annotations

import dataclasses
import logging
import math
import random
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.runtime import elastic, health
from repro_torch.runtime.ctrlplane import (Membership, QuorumLostError,
                                           StaleEpochError)
from repro_torch.runtime.watchdog import StepWatchdog

logger = logging.getLogger("repro_torch.runtime")

LOSE, GAIN, STALL = "lose", "gain", "stall"


class DeviceLoss(RuntimeError):
    """A step failed because members died; carries their ids."""

    def __init__(self, device_ids: Sequence[int]):
        super().__init__(f"lost devices {sorted(device_ids)}")
        self.device_ids = tuple(sorted(device_ids))


class TooManyRecoveries(RuntimeError):
    pass


# ---------------------------------------------------------------------------
# Deterministic fault injection
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class FaultEvent:
    step: int          # fires just before this step executes
    kind: str          # "lose" | "gain" | "stall"
    count: int = 0     # members lost/regained (stall: unused)

    def __post_init__(self):
        if self.kind not in (LOSE, GAIN, STALL):
            raise ValueError(f"unknown fault kind {self.kind!r}")
        if self.kind in (LOSE, GAIN) and self.count < 1:
            raise ValueError(f"{self.kind} event needs count >= 1")


class FaultPlan:
    """A seeded schedule of injected faults — pure in (events, seed).

    Victim selection is a deterministic function of (seed, step), the
    reference's, so two runs with the same plan kill the same members:
    the property that lets a test rebuild the survivors' mesh on its
    own."""

    def __init__(self, events: Sequence[FaultEvent] = (), seed: int = 0):
        self.events = tuple(sorted(events, key=lambda e: e.step))
        self.seed = seed

    @classmethod
    def parse(cls, spec: str, seed: int = 0) -> "FaultPlan":
        """``"lose@5:2,gain@9:2,stall@7"`` -> FaultPlan (CLI surface)."""
        events = []
        for part in filter(None, (p.strip() for p in spec.split(","))):
            kind, _, rest = part.partition("@")
            at, _, count = rest.partition(":")
            events.append(FaultEvent(step=int(at), kind=kind,
                                     count=int(count) if count else
                                     (0 if kind == STALL else 1)))
        return cls(events, seed=seed)

    def pick_victims(self, healthy_ids: Sequence[int], count: int,
                     step: int) -> Tuple[int, ...]:
        rnd = random.Random((self.seed << 24) ^ (step + 1))
        return tuple(sorted(rnd.sample(list(healthy_ids), count)))


# ---------------------------------------------------------------------------
# Run report
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class RecoveryRecord:
    step: int                       # step at which the fault surfaced
    kind: str                       # "lose" | "grow"
    before_shape: Tuple[int, ...]
    after_shape: Tuple[int, ...]
    healthy_after: Tuple[int, ...]  # surviving member ids, sorted
    restored_step: Optional[int]    # None: live re-mesh (grow path)
    plan_rebuilt: bool
    restore_s: float = 0.0
    remesh_s: float = 0.0
    replan_s: float = 0.0
    epoch: Optional[int] = None     # committed membership epoch (None:
                                    # no control plane attached)

    @property
    def total_s(self) -> float:
        return self.restore_s + self.remesh_s + self.replan_s


@dataclasses.dataclass
class ControllerReport:
    losses: Dict[int, float] = dataclasses.field(default_factory=dict)
    recoveries: List[RecoveryRecord] = dataclasses.field(default_factory=list)
    stalls: List[int] = dataclasses.field(default_factory=list)
    stragglers: List[int] = dataclasses.field(default_factory=list)
    mesh_history: List[Tuple[int, ...]] = dataclasses.field(
        default_factory=list)

    @property
    def plan_rebuilds(self) -> int:
        return sum(1 for r in self.recoveries if r.plan_rebuilt)

    def describe(self) -> str:
        rows = [f"ControllerReport(steps={len(self.losses)}, "
                f"recoveries={len(self.recoveries)}, "
                f"stalls={len(self.stalls)}, "
                f"meshes={self.mesh_history})"]
        for r in self.recoveries:
            rows.append(
                f"  step {r.step}: {r.kind} {r.before_shape}->"
                f"{r.after_shape} restored={r.restored_step} "
                f"rebuilt={r.plan_rebuilt} "
                f"({r.restore_s * 1e3:.0f}+{r.remesh_s * 1e3:.0f}"
                f"+{r.replan_s * 1e3:.0f} ms)")
        return "\n".join(rows)


# ---------------------------------------------------------------------------
# The controller
# ---------------------------------------------------------------------------

class SurvivorAgreement:
    """The fault surfaces both controllers share (``ElasticController``
    here, ``serve.controller.ServeController``): health probes and
    preemption notices, and the control plane's vote.  Uses
    ``self._healthy`` (a set of member ids, only ever rebound),
    ``self.membership``, ``self._ctrl_epoch`` and ``self.preemption``."""

    def mark_unhealthy(self, device_ids: Sequence[int]) -> None:
        """The surface for real health probes and preemption notices:
        members reported dead here are excluded from the next re-mesh.
        The survivor set runs through agreement — the control plane's
        epoch-stamped vote when a ``Membership`` is attached, its
        in-process fast path (``health.agree_survivors``, same rule)
        otherwise."""
        local = self._healthy - set(device_ids)
        if self.membership is not None:
            view = self.membership.agree(sorted(local))
            self._healthy = set(view.survivors)
            self._ctrl_epoch = view.epoch
        else:
            self._healthy = health.agree_survivors(local)

    def _drain_membership(self) -> None:
        """Step-boundary drain of votes served passively: a commit that
        shrank the survivor set below our view is a loss decided
        elsewhere — recover over it (same epoch, no re-vote)."""
        if self.membership is None:
            return
        view = self.membership.poll_commit()
        if view is None or view.epoch <= self._ctrl_epoch:
            return
        lost = self._healthy - set(view.survivors)
        self._healthy = set(view.survivors)
        self._ctrl_epoch = view.epoch
        if lost:
            logger.warning("membership epoch %d committed without "
                           "members %s — recovering", view.epoch,
                           sorted(lost))
            raise DeviceLoss(tuple(lost))

    def _sync_membership(self) -> Optional[int]:
        """Pre-re-mesh agreement: every recovery re-meshes only on a
        committed epoch, and the fence makes the decision final — a
        recovery superseded by a later commit adopts the newer view and
        agrees again on top of it."""
        if self.membership is None:
            return None
        while True:
            view = self.membership.poll_commit()
            if not (view is not None and view.epoch == self._ctrl_epoch
                    and set(view.survivors) == self._healthy):
                view = self.membership.agree(sorted(self._healthy))
                self._healthy = set(view.survivors)
                self._ctrl_epoch = view.epoch
            try:
                self.membership.fence(view.epoch)
            except StaleEpochError:
                newer = self.membership.poll_commit()
                logger.warning("membership epoch %d superseded before "
                               "re-mesh (committed: %s) — retrying the "
                               "agreement", view.epoch,
                               newer.epoch if newer else None)
                if newer is not None:
                    self._healthy = set(newer.survivors)
                    self._ctrl_epoch = newer.epoch
                continue
            return view.epoch

    def _drain_preemptions(self) -> None:
        """Step-boundary drain of the preemption mailbox: an announced
        eviction becomes a graceful re-mesh BEFORE the hardware goes."""
        if self.preemption is None or not self.preemption.pending:
            return
        victims = self.preemption.drain()
        if not victims:
            return
        logger.warning("preemption notice for members %s", victims)
        self.mark_unhealthy(victims)
        raise DeviceLoss(victims)


class ElasticController(SurvivorAgreement):
    """Supervised elastic training loop over a ``trainer.TrainSession``.

    ``mesh`` is the initial mesh; its member ids are the pool faults draw
    from.  ``comm`` is the ``repro_torch.comm.Session`` the step syncs
    through (``launch.train.build_session`` composes one from the step);
    the controller owns its lifecycle and calls ``comm.remesh`` on every
    topology change.  ``engine`` (a bare ``CollectiveEngine``) is adopted
    into a session instead; with neither, a session over ``mesh`` with
    the full library is built.  ``fault_plan`` injects deterministic
    failures; with none, this is a plain fault-tolerant loop (watchdog
    + atomic checkpoints) that a real device error steers the same way.
    ``membership`` (a ``ctrlplane.Membership``) attaches the control
    plane: every recovery then re-meshes only on a committed, fenced
    epoch, and quorum loss checkpoints and halts with
    ``QuorumLostError``.  ``states`` holds the per-rank train states.
    """

    def __init__(self, session, dataset, mesh, *,
                 total_steps: int,
                 ckpt_dir: str,
                 engine=None,
                 comm=None,
                 ckpt_every: int = 10,
                 ckpt_keep: int = 3,
                 ckpt_sharded: bool = False,
                 fault_plan: Optional[FaultPlan] = None,
                 max_recoveries: int = 8,
                 watchdog_timeout: float = 300.0,
                 rng_seed: int = 0,
                 preemption: Optional[health.PreemptionNotice] = None,
                 membership: Optional[Membership] = None,
                 on_step: Optional[Callable[[int, float], None]] = None):
        from repro_torch.comm import Session     # comm imports runtime
        self.session = session
        self.dataset = dataset
        if comm is not None and engine is not None:
            raise ValueError("pass comm= (repro_torch.comm.Session) or "
                             "engine=, not both")
        if comm is None:
            comm = (Session.adopt(engine, mesh) if engine is not None
                    else Session(mesh=mesh))
        self.comm = comm
        self.engine = comm.engine
        self.total_steps = total_steps
        self.fault_plan = fault_plan or FaultPlan()
        self.max_recoveries = max_recoveries
        self.rng_seed = rng_seed
        self.preemption = preemption
        self.membership = membership
        self._ctrl_epoch = 0        # last membership epoch acted on
        self.on_step = on_step
        self.ckpt = CheckpointManager(ckpt_dir, every=ckpt_every,
                                      keep=ckpt_keep, sharded=ckpt_sharded)
        self.watchdog = StepWatchdog(
            timeout=watchdog_timeout, on_stall=self._on_stall,
            on_straggler=lambda beat, dt: self.report.stragglers.append(beat))
        self.report = ControllerReport()

        self._pool: List[int] = list(mesh.members)      # canonical order
        self._healthy = set(self._pool)
        self._axis_names = tuple(mesh.axis_names)
        self._device = mesh.device
        if membership is not None:
            # The passive vote path reads the healthy view on the
            # membership's receive thread: _healthy is only ever REBOUND
            # to a new set, never mutated in place.
            membership.bind_view(lambda: sorted(self._healthy))
            membership.start()
        # The ORIGINAL layout: re-planning always aims back at it.
        sizes = mesh.shape
        self._mp0 = sizes.get("model", 1)
        self._pods0 = sizes.get("pod", 1)
        self._ndim = len(sizes)
        self._stall_pending = False
        self._fired: set = set()   # events consumed (recovery rewinds steps)
        self.states = None
        self.mesh = None
        self._step = None
        self._bind(mesh)

    # -- topology ---------------------------------------------------------

    def _healthy_members(self) -> List[int]:
        return [m for m in self._pool if m in self._healthy]

    def _planned_mesh(self):
        members = self._healthy_members()
        shape = elastic.plan_mesh_shape(len(members), self._mp0,
                                        pods=self._pods0, ndim=self._ndim)
        return elastic.make_mesh_from_shape(
            shape, self._axis_names, members=members[:math.prod(shape)],
            device=self._device)

    def _bind(self, mesh) -> None:
        """Bind every mesh-dependent piece: the comm session (plan and
        persistent handles, through ``Session.remesh``, the one
        invalidation path), the step function, the report."""
        self.mesh = mesh
        self.comm.remesh(mesh)
        self._step = self.session.step_fn(comm=self.comm.world)
        shape = mesh.axis_sizes
        if not self.report.mesh_history \
                or self.report.mesh_history[-1] != shape:
            self.report.mesh_history.append(shape)

    def _gathered(self):
        """The per-rank states as one tree in the checkpoint layout."""
        return self.session.gather(self.states, self.mesh)

    def _fresh_states(self, mesh):
        gen = torch.Generator(device=mesh.device).manual_seed(self.rng_seed)
        return self.session.init_state(gen, mesh=mesh)

    def _restore(self, mesh):
        """(host tree in the checkpoint layout of ``mesh``, step) of the
        latest checkpoint, or (None, None) when there is none."""
        return self.ckpt.restore_latest(
            self.session.abstract_state(mesh=mesh),
            allow_resize_1d=self.session.cfg.zero)

    # -- fault surfaces ---------------------------------------------------

    def _on_stall(self, silence: float) -> None:
        # Monitor-thread callback: note it; the step loop handles it at
        # the next boundary.
        self._stall_pending = True

    def _apply_faults(self, step: int) -> None:
        # keyed by event *index*: value-equal duplicate events are
        # distinct injections, and recovery re-runs steps but not faults
        for i, ev in enumerate(self.fault_plan.events):
            if ev.step != step or i in self._fired:
                continue
            self._fired.add(i)
            if ev.kind == LOSE:
                victims = self.fault_plan.pick_victims(
                    sorted(self._healthy), ev.count, step)
                self._healthy = self._healthy - set(victims)
                logger.warning("step %d: injected loss of members %s",
                               step, victims)
                raise DeviceLoss(victims)
            if ev.kind == GAIN:
                lost = [m for m in self._pool if m not in self._healthy]
                back = lost[:ev.count]
                if not back:       # nothing was lost: no re-mesh to do
                    logger.warning("step %d: gain event with no lost "
                                   "members — ignored", step)
                    continue
                self._healthy = self._healthy | set(back)
                logger.warning("step %d: members %s returned", step, back)
                self._grow(step)
            elif ev.kind == STALL:
                self._stall_pending = True

    def _check_stall(self, step: int) -> None:
        if not self._stall_pending:
            return
        self._stall_pending = False
        self.report.stalls.append(step)
        # A stall with every member still healthy: the planned shape is
        # unchanged, so recovery is a no-op — keep stepping.
        if len(self._healthy_members()) >= self.mesh.size:
            logger.warning("step %d: stall signal, all members healthy "
                           "— no re-mesh", step)
            return
        # Stalled AND a health probe flagged members (mark_unhealthy):
        # the stall is attributed to them — full recovery off this mesh.
        raise DeviceLoss(())

    # -- recovery paths ---------------------------------------------------

    def _engine_reinit(self, mesh) -> Tuple[bool, float]:
        """Steps 4 and 5: rebind everything mesh-shaped.  Returns
        (plan_rebuilt, seconds)."""
        t0 = time.perf_counter()
        before = self.engine.plan.stats.rebuilds
        # a step that failed mid-sync left its collectives started: its
        # states are discarded, so are they (remesh refuses them else)
        for h in self.comm.handles:
            h.abandon_inflight()
        self._bind(mesh)
        rebuilt = self.engine.plan.stats.rebuilds > before
        return rebuilt, time.perf_counter() - t0

    def _grow(self, step: int) -> None:
        """Members came back: live re-mesh — nothing was lost, so the
        current state moves to the bigger mesh without a restore."""
        before_shape = self.mesh.axis_sizes
        epoch = self._sync_membership()    # re-admission is a vote too
        self.ckpt.wait()
        new_mesh = self._planned_mesh()
        t0 = time.perf_counter()
        self.states = elastic.remesh(
            self.states, self.session.cfg,
            self.session.abstract_state(mesh=new_mesh), new_mesh,
            mesh=self.mesh, model=self.session.model)
        remesh_s = time.perf_counter() - t0
        rebuilt, replan_s = self._engine_reinit(new_mesh)
        self.report.recoveries.append(RecoveryRecord(
            step=step, kind="grow", before_shape=before_shape,
            after_shape=new_mesh.axis_sizes,
            healthy_after=tuple(sorted(self._healthy)),
            restored_step=None, plan_rebuilt=rebuilt,
            remesh_s=remesh_s, replan_s=replan_s, epoch=epoch))

    def _recover(self, step: int, exc: DeviceLoss) -> int:
        """The full crash-recovery path; returns the step to resume at."""
        if len(self.report.recoveries) >= self.max_recoveries:
            raise TooManyRecoveries(
                f"{len(self.report.recoveries)} recoveries reached the "
                f"--max-recoveries cap") from exc
        before_shape = self.mesh.axis_sizes
        # (0) agree before re-meshing: the survivor set must be a
        # committed epoch, and the fence inside guarantees no later
        # epoch superseded it — the split-brain guard.
        epoch = self._sync_membership()
        self.ckpt.wait()                       # drain any in-flight save

        # (1) plan the survivors' mesh FIRST: a ZeRO restore needs the
        # target data-parallel width to shape (and resize) the state.
        new_mesh = self._planned_mesh()
        self.states = None                     # the lost mesh's memory

        # (2) restore the latest atomic checkpoint (host tensors).
        t0 = time.perf_counter()
        tree, rstep = self._restore(new_mesh)
        restore_s = time.perf_counter() - t0

        # (3) re-mesh the state: scatter it to the new ranks.
        t0 = time.perf_counter()
        if tree is None:                       # failed before any save
            self.states, rstep = self._fresh_states(new_mesh), 0
        else:
            self.states = self.session.scatter(tree, new_mesh)
        del tree
        remesh_s = time.perf_counter() - t0

        # (4)+(5) Session.remesh (fingerprint change => CommPlan rebuild,
        # handles revoked and rebound) and a step built over it.
        rebuilt, replan_s = self._engine_reinit(new_mesh)

        self.report.recoveries.append(RecoveryRecord(
            step=step, kind="lose", before_shape=before_shape,
            after_shape=new_mesh.axis_sizes,
            healthy_after=tuple(sorted(self._healthy)),
            restored_step=rstep, plan_rebuilt=rebuilt,
            restore_s=restore_s, remesh_s=remesh_s, replan_s=replan_s,
            epoch=epoch))
        logger.warning("recovered: %s", self.report.describe()
                       .splitlines()[-1].strip())
        return rstep

    # -- the loop ---------------------------------------------------------

    def run(self) -> ControllerReport:
        if self.states is None:
            tree, step = self._restore(self.mesh)
            if tree is not None:
                self.states = self.session.scatter(tree, self.mesh)
            else:
                self.states, step = self._fresh_states(self.mesh), 0
                self.ckpt.maybe_save(0, self._gathered(), force=True)
        else:
            step = 0

        self.watchdog.start()
        try:
            while step < self.total_steps:
                try:
                    self._drain_preemptions()
                    self._drain_membership()
                    self._apply_faults(step)
                    self.states, metrics = self._step(
                        self.states, self.dataset.host_batch(step))
                    loss = float(metrics["loss"])
                    self.watchdog.beat()
                    self.report.losses[step] = loss
                    if self.on_step is not None:
                        self.on_step(step, loss)
                    step += 1
                    if self.ckpt.due(step):   # gathers only to save
                        self.ckpt.maybe_save(step, self._gathered())
                    self._check_stall(step - 1)
                except DeviceLoss as e:
                    step = self._recover(step, e)
                except Exception as e:
                    # A real runtime error: recover ONLY if it classifies
                    # as a device failure; anything else is a bug and
                    # propagates untouched.
                    victims = health.classify_failure(e)
                    if victims is None:
                        raise
                    logger.warning("step %d: runtime error classified as "
                                   "device failure (victims=%s): %s",
                                   step, victims, e)
                    self.mark_unhealthy(victims)
                    step = self._recover(step, DeviceLoss(victims))
            self.ckpt.maybe_save(self.total_steps, self._gathered(),
                                 force=True)
            self.ckpt.wait()
        except QuorumLostError:
            # Quorum lost: this member may be the minority island of a
            # partition — re-meshing would split the brain.  Persist the
            # state held, then halt.
            logger.error("quorum lost at step %d: checkpointing and "
                         "halting (no re-mesh without agreement)", step)
            self.ckpt.wait()
            self.ckpt.maybe_save(step, self._gathered(), force=True)
            self.ckpt.wait()
            raise
        finally:
            self.watchdog.stop()
        return self.report
