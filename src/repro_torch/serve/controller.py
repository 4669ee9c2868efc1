"""Elastic serving: the ``ServeController`` failure lifecycle.

Counterpart of ``repro.serve.controller``, the serving analogue of
``repro_torch.runtime.controller.ElasticController``: one entity owns the
whole failure story for a ``BatchScheduler`` over a
``repro_torch.comm`` Session.  On a ``DeviceLoss`` (injected by a
``FaultPlan``, classified from a real CUDA/NCCL error, announced by a
``PreemptionNotice``, or attributed by the decode-step watchdog) it

  1. **drains** — the scheduler only mutates at decode-step boundaries,
     so between ``sched.step()`` calls it is a consistent drained image;
  2. **snapshots** scheduler state — queue, slots, every request's
     generated-so-far tokens, and each decoding slot's live pages copied
     to host (optionally persisted through the atomic checkpoint layer:
     ``snapshot_dir``);
  3. **re-meshes** — ``Session.remesh_over(survivors)`` plans the new
     shape (aiming back at the original layout) and runs THE one
     invalidation path (CommPlan fingerprint rule, handle revoke and
     rebind).  The weights stay where they are: every rank of a mesh
     computes on the same card;
  4. **rebuilds** batch-shaped state on the new mesh —
     ``plan_serve_batch`` shrinks ``ServeCfg.batch`` with the data
     extent (graceful degradation: admission sheds queued load instead
     of crashing), a fresh pool is built, and the drained slots
     re-splice;
  5. **re-admits and resumes** — every request that was decoding
     continues from its drained pages (no re-prefill, no token replay):
     sampling is pure in (seed, rid, position), so its remaining tokens
     equal an uninterrupted run on the survivor mesh.  Requests that
     were mid-prefill go back to the queue head and prefill again from
     their first chunk, as in the reference.

``rehearse_recovery()`` runs the same drain -> snapshot -> re-mesh ->
rebuild -> re-admit machinery over the CURRENT healthy set (a fire
drill, nothing lost): the recovery latency of a deployment that cannot
lose a member.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Dict, List, Optional, Tuple

from repro_torch.runtime import health
from repro_torch.runtime.controller import (DeviceLoss, FaultPlan,
                                            SurvivorAgreement,
                                            TooManyRecoveries)
from repro_torch.runtime.ctrlplane import Membership, QuorumLostError
from repro_torch.runtime.watchdog import StepWatchdog
from repro_torch.serve.engine import (BatchScheduler, Request, ServeCfg,
                                      data_extent)
from repro_torch.serve.state import load_snapshot, save_snapshot

logger = logging.getLogger("repro_torch.serve")


def plan_serve_batch(batch0: int, data0: int, data_new: int) -> int:
    """Shrink (or restore) the decode batch with the data extent.

    The original ``batch0`` slots over ``data0`` data ranks put
    ``ceil(batch0 / data0)`` sequences on each rank; a survivor mesh with
    ``data_new`` data ranks keeps that load a rank, capped at the
    original batch — graceful degradation that never over-commits a
    shrunken mesh and snaps back to full capacity on regrowth."""
    if batch0 < 1 or data0 < 1 or data_new < 1:
        raise ValueError("plan_serve_batch needs positive extents")
    per_device = -(-batch0 // data0)          # ceil
    return max(1, min(batch0, per_device * data_new))


@dataclasses.dataclass
class ServeRecovery:
    step: int                        # decode step the fault surfaced at
    kind: str                        # "lose" | "grow" | "rehearsal"
    before_shape: Tuple[int, ...]
    after_shape: Tuple[int, ...]
    healthy_after: Tuple[int, ...]
    batch_before: int
    batch_after: int
    resumed: int                     # in-flight requests back in a slot
    parked: int                      # in-flight awaiting a freed slot
    shed: int                        # queued requests shed by admission
    plan_rebuilt: bool
    snapshot_s: float = 0.0
    remesh_s: float = 0.0
    rebuild_s: float = 0.0
    snapshot_bytes: int = 0          # page-granular bytes the drain moved
    snapshot_bytes_contiguous: int = 0   # what full max_len rows would
                                         # have cost
    requeued: int = 0                # mid-prefill requests sent back to
                                     # the queue (they prefill again)
    requeued_chunks: int = 0         # prefill chunks those requests had
                                     # run (they run again)
    epoch: Optional[int] = None      # committed membership epoch (None:
                                     # no control plane attached)

    @property
    def total_s(self) -> float:
        return self.snapshot_s + self.remesh_s + self.rebuild_s


@dataclasses.dataclass
class ServeReport:
    completed: List[Request] = dataclasses.field(default_factory=list)
    shed: List[Request] = dataclasses.field(default_factory=list)
    recoveries: List[ServeRecovery] = dataclasses.field(default_factory=list)
    stalls: List[int] = dataclasses.field(default_factory=list)
    decode_steps: int = 0
    mesh_history: List[Tuple[int, ...]] = dataclasses.field(
        default_factory=list)
    batch_history: List[int] = dataclasses.field(default_factory=list)

    def tokens(self) -> Dict[int, List[int]]:
        """rid -> generated tokens, what tests compare against a
        survivor-mesh baseline."""
        return {r.rid: list(r.generated) for r in self.completed}

    def describe(self) -> str:
        rows = [f"ServeReport(completed={len(self.completed)}, "
                f"shed={len(self.shed)}, "
                f"recoveries={len(self.recoveries)}, "
                f"stalls={len(self.stalls)}, "
                f"decode_steps={self.decode_steps}, "
                f"meshes={self.mesh_history}, "
                f"batches={self.batch_history})"]
        for r in self.recoveries:
            rows.append(
                f"  step {r.step}: {r.kind} {r.before_shape}->"
                f"{r.after_shape} batch {r.batch_before}->{r.batch_after} "
                f"resumed={r.resumed} parked={r.parked} shed={r.shed} "
                f"rebuilt={r.plan_rebuilt} "
                f"({r.snapshot_s * 1e3:.0f}+{r.remesh_s * 1e3:.0f}"
                f"+{r.rebuild_s * 1e3:.0f} ms)")
        return "\n".join(rows)


class ServeController(SurvivorAgreement):
    """Supervised elastic decode loop over a ``BatchScheduler``.

    ``comm`` is the ``Communicator`` whose session's mesh serves; the
    controller owns its lifecycle and drives every re-mesh through
    ``Session.remesh_over`` (the one invalidation path).  ``fault_plan``
    injects deterministic failures keyed on the controller's step
    counter (one ``sched.step()`` each); ``preemption`` and the classify
    arm for real CUDA/NCCL errors steer real signals into the same
    recovery.  ``snapshot_dir`` persists each drained snapshot through
    the atomic checkpoint layer — the fallback image when the live drain
    itself fails (the reference's periodic ``snapshot_every`` has no
    caller and is not ported).  ``membership`` attaches the control plane: re-meshes
    happen only on committed, fenced epochs, and quorum loss snapshots
    and halts with ``QuorumLostError``.
    """

    def __init__(self, model, params, cfg: ServeCfg, *, comm,
                 fault_plan: Optional[FaultPlan] = None,
                 max_recoveries: int = 8,
                 watchdog_timeout: float = 300.0,
                 snapshot_dir: Optional[str] = None,
                 preemption: Optional[health.PreemptionNotice] = None,
                 membership: Optional[Membership] = None):
        self.model = model
        self.params = params
        self.cfg0 = cfg
        self.comm = comm
        self.fault_plan = fault_plan or FaultPlan()
        self.max_recoveries = max_recoveries
        self.snapshot_dir = snapshot_dir
        self.preemption = preemption
        self.membership = membership
        self._ctrl_epoch = 0         # last membership epoch acted on
        self.report = ServeReport()

        mesh = comm.mesh
        self._pool: List[int] = list(mesh.members)   # canonical order
        self._healthy = set(self._pool)
        if membership is not None:
            # The reader runs on the membership receive thread: _healthy
            # is only ever rebound to a new set, never mutated in place.
            membership.bind_view(lambda: sorted(self._healthy))
            membership.start()
        sizes = mesh.shape
        # The ORIGINAL layout: re-planning aims back at it, so a shrunken
        # deployment regains its full batch when members return.
        self._mp0 = sizes.get("model", 1)
        self._pods0 = sizes.get("pod", 1)
        self._data0 = data_extent(mesh)
        self._stall_pending = False
        self._fired: set = set()     # fault events consumed (index-keyed)
        self._step = 0               # step counter (the fault clock)
        self.watchdog = StepWatchdog(timeout=watchdog_timeout,
                                     on_stall=self._on_stall)
        self.sched = BatchScheduler(model, params, cfg, comm=comm)
        self._note_mesh(mesh)

    # -- topology bookkeeping ---------------------------------------------

    def _note_mesh(self, mesh) -> None:
        shape = mesh.axis_sizes
        if not self.report.mesh_history \
                or self.report.mesh_history[-1] != shape:
            self.report.mesh_history.append(shape)
        if not self.report.batch_history \
                or self.report.batch_history[-1] != self.sched.cfg.batch:
            self.report.batch_history.append(self.sched.cfg.batch)

    def _healthy_members(self) -> List[int]:
        return [m for m in self._pool if m in self._healthy]

    # -- request surface ---------------------------------------------------

    def submit(self, req: Request) -> bool:
        return self.sched.submit(req)

    # -- fault surfaces ----------------------------------------------------

    def _on_stall(self, silence: float) -> None:
        # Watchdog monitor thread: note only; the decode loop acts at the
        # next boundary.
        self._stall_pending = True

    def _apply_faults(self, step: int) -> None:
        # keyed by event *index*: duplicates are distinct injections, and
        # recovery never replays a consumed event
        for i, ev in enumerate(self.fault_plan.events):
            if ev.step != step or i in self._fired:
                continue
            self._fired.add(i)
            if ev.kind == "lose":
                victims = self.fault_plan.pick_victims(
                    sorted(self._healthy), ev.count, step)
                self._healthy = self._healthy - set(victims)
                logger.warning("decode step %d: injected loss of "
                               "members %s", step, victims)
                raise DeviceLoss(victims)
            if ev.kind == "gain":
                lost = [m for m in self._pool if m not in self._healthy]
                back = lost[:ev.count]
                if not back:
                    logger.warning("decode step %d: gain with nothing "
                                   "lost — ignored", step)
                    continue
                self._healthy = self._healthy | set(back)
                logger.warning("decode step %d: members %s returned",
                               step, back)
                self._recover(step, kind="grow")
            elif ev.kind == "stall":
                self._stall_pending = True

    def _check_stall(self, step: int) -> None:
        """A stall with every member healthy retries in place (a
        transient straggler — no re-mesh); a stall with flagged members
        is attributed to them and recovers."""
        if not self._stall_pending:
            return
        self._stall_pending = False
        self.report.stalls.append(step)
        if len(self._healthy_members()) >= self.comm.mesh.size:
            logger.warning("decode step %d: stall, all members healthy "
                           "— retrying in place", step)
            return
        raise DeviceLoss(())

    # -- recovery ----------------------------------------------------------

    def _snapshot(self):
        """Steps (1)+(2): drain + snapshot.  Outside ``sched.step()`` the
        scheduler IS the drained image; a loss so hard that the live page
        extraction itself fails falls back to the last disk snapshot
        (when one is kept)."""
        try:
            return self.sched.snapshot()
        except Exception as e:
            if self.snapshot_dir is None:
                raise
            logger.warning("live drain failed (%s); restoring last disk "
                           "snapshot", e)
            return load_snapshot(self.snapshot_dir, self.model)

    def _recover(self, step: int, kind: str) -> None:
        """The full lifecycle, steps (1)-(5); see the module docstring."""
        if kind == "lose" and \
                len(self.report.recoveries) >= self.max_recoveries:
            raise TooManyRecoveries(
                f"{len(self.report.recoveries)} recoveries reached the "
                f"--max-recoveries cap")
        before_shape = self.comm.mesh.axis_sizes
        batch_before = self.sched.cfg.batch
        # (0) agree before re-meshing: survivors must be a committed,
        # fenced epoch (rehearsals vote too — the drill is the protocol).
        epoch = self._sync_membership()

        t0 = time.perf_counter()
        requeued = len(self.sched._prefills)
        requeued_chunks = sum(pf.chunks_done
                              for pf in self.sched._prefills.values())
        snap = self._snapshot()
        snapshot_s = time.perf_counter() - t0
        # Page-granular drain cost against the contiguous layout.
        row_bytes = self.sched.pool.layout.row_bytes()
        snapshot_bytes = sum(s.cache.nbytes() for s in snap.resumable)
        snapshot_bytes_contig = len(snap.resumable) * row_bytes
        if self.snapshot_dir is not None and kind != "rehearsal":
            save_snapshot(self.snapshot_dir, snap, self._step)
        self.sched = None                    # the old pool's memory

        # (3) plan + remesh over the survivors: Session.remesh_over is
        # the one invalidation path (CommPlan fingerprint, handles).
        t0 = time.perf_counter()
        mesh, rebuilt = self.comm.session.remesh_over(
            self._healthy_members(), model_parallel=self._mp0,
            pods=self._pods0)
        remesh_s = time.perf_counter() - t0

        # (4)+(5) rebuild batch-shaped state and re-admit.
        t0 = time.perf_counter()
        new_batch = plan_serve_batch(self.cfg0.batch, self._data0,
                                     data_extent(mesh))
        cfg = dataclasses.replace(snap.cfg, batch=new_batch)
        self.sched = BatchScheduler.from_snapshot(
            self.model, self.params, cfg, snap, comm=self.comm)
        rebuild_s = time.perf_counter() - t0

        rec = ServeRecovery(
            step=step, kind=kind, before_shape=before_shape,
            after_shape=mesh.axis_sizes,
            healthy_after=tuple(sorted(self._healthy)),
            batch_before=batch_before, batch_after=new_batch,
            resumed=len(snap.resumable) - len(self.sched.parked),
            parked=len(self.sched.parked),
            shed=len(self.sched.shed) - len(snap.shed),
            plan_rebuilt=rebuilt, snapshot_s=snapshot_s,
            remesh_s=remesh_s, rebuild_s=rebuild_s,
            snapshot_bytes=snapshot_bytes,
            snapshot_bytes_contiguous=snapshot_bytes_contig,
            requeued=requeued, requeued_chunks=requeued_chunks,
            epoch=epoch)
        self.report.recoveries.append(rec)
        self._note_mesh(mesh)
        logger.warning("recovered: %s", self.report.describe()
                       .splitlines()[-1].strip())

    def rehearse_recovery(self) -> ServeRecovery:
        """Fire drill: the full drain -> snapshot -> re-mesh -> rebuild ->
        re-admit path over the CURRENT healthy set.  Nothing is lost and
        every in-flight request resumes with the same tokens; the record's
        ``total_s`` is the recovery latency."""
        self._recover(self._step, kind="rehearsal")
        return self.report.recoveries[-1]

    # -- the loop ----------------------------------------------------------

    def run(self) -> ServeReport:
        """Drive the scheduler to completion under supervision.  Returns
        the report (completed + shed requests, recoveries, mesh and batch
        history)."""
        self.watchdog.start()
        try:
            while self.sched.pending():
                try:
                    self._drain_preemptions()
                    self._drain_membership()
                    self._apply_faults(self._step)
                    self._check_stall(self._step)
                    self.sched.step()
                    self.watchdog.beat()
                    self._step += 1
                except DeviceLoss:
                    self._recover(self._step, kind="lose")
                except Exception as e:
                    victims = health.classify_failure(e)
                    if victims is None:
                        raise          # a bug, not a device failure
                    logger.warning("decode step %d: runtime error "
                                   "classified as device failure "
                                   "(victims=%s): %s", self._step,
                                   victims, e)
                    self.mark_unhealthy(victims)
                    self._recover(self._step, kind="lose")
        except QuorumLostError:
            # Below quorum this member must not re-mesh (it may be the
            # minority island of a partition): snapshot what it holds,
            # then halt — the saved image re-admits on restart.
            logger.error("quorum lost at decode step %d: snapshotting "
                         "and halting (no re-mesh without agreement)",
                         self._step)
            snap = self.sched.snapshot()
            if self.snapshot_dir is not None:
                save_snapshot(self.snapshot_dir, snap, self._step)
            raise
        finally:
            self.watchdog.stop()
        self.report.completed = list(self.sched.completed)
        self.report.shed = list(self.sched.shed)
        self.report.decode_steps = self.sched.decode_steps
        return self.report
