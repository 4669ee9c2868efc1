"""Ranks of one mesh, run as threads of one process on one device.

Counterpart of ``repro.runtime.substrate`` (mesh construction and the
manual SPMD region ``shard_map``) and of ``repro.launch.mesh.
make_host_mesh``.  The reference runs its ranks in one process as well:
XLA host devices, or ``jax.vmap(axis_name=...)`` in its protocol tests.
Here every rank of a ``Mesh`` is a thread with a rank context (its
coordinates on each named axis); ``run_spmd`` starts them and returns
their results in rank order.

``ppermute`` is the single primitive every protocol hop passes through.
It deposits the tensor in a mailbox, waits at a barrier for every rank,
and takes its peer's tensor as a copy, so the receiver owns its buffer.
A transport for several cards replaces ``ThreadTransport`` alone.

- Every barrier wait has a timeout, and a rank that raises aborts the
  barrier, so the other ranks fail at their next hop instead of hanging.
- All ranks launch on one CUDA stream (a new thread starts on the
  device's default stream): a hand-over needs no event, since the
  receiver's copy is enqueued after the sender's producing work.
- Nothing here draws random numbers.

``recording()`` is the §2.2 application scan's transport: under it,
``run_spmd`` runs rank 0 alone, on ``meta`` tensors, and every hop and
rank query is recorded instead of executed (``repro_torch.core.trace``).
``instrument(rank, factory)`` runs one rank of every ``run_spmd`` of a
block inside a context of the caller's making, on that rank's thread
(dispatch modes are thread-local): the dry-run's meters
(``repro_torch.launch.stepanalysis``) read one rank of a real step so,
as they read rank 0 of a recorded one.  ``collective(fn, x)`` labels the
hops of a block as a call of the collective ``fn``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch import resolve_device

#: seconds a rank waits at a hop for the others before the run fails
DEFAULT_TIMEOUT = 300.0


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Named axes of in-process ranks; ``device`` is where every rank
    computes (``None`` for an abstract mesh, which only the application
    scan runs over).

    ``members`` names, for each rank in rank order, the member id it
    stands for (default ``0..size-1``): the reference's device ids.  A
    survivor mesh keeps the ids of the original ranks that survive, so
    a fault can always be traced back to the rank it hit."""

    axis_names: Tuple[str, ...]
    axis_sizes: Tuple[int, ...]
    device: Optional[torch.device] = None
    members: Optional[Tuple[int, ...]] = None

    def __post_init__(self):
        if len(self.axis_names) != len(self.axis_sizes):
            raise ValueError(f"{self.axis_names} vs {self.axis_sizes}")
        if any(s < 1 for s in self.axis_sizes):
            raise ValueError(f"axis sizes must be >= 1: {self.axis_sizes}")
        members = (tuple(range(self.size)) if self.members is None
                   else tuple(int(m) for m in self.members))
        if len(members) != self.size or len(set(members)) != self.size:
            raise ValueError(f"{self.size} ranks need {self.size} distinct "
                             f"member ids, got {members}")
        object.__setattr__(self, "members", members)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)

    @property
    def abstract(self) -> bool:
        return self.device is None

    def coords(self, rank: int) -> Dict[str, int]:
        """Row-major coordinates of ``rank`` (the last axis fastest)."""
        out = {}
        for name, size in reversed(list(zip(self.axis_names,
                                            self.axis_sizes))):
            out[name] = rank % size
            rank //= size
        return {name: out[name] for name in self.axis_names}

    def rank_of(self, coords: Dict[str, int]) -> int:
        rank = 0
        for name, size in zip(self.axis_names, self.axis_sizes):
            rank = rank * size + coords[name]
        return rank


def make_mesh(shape: Sequence[int], axis_names: Sequence[str], *,
              device="cuda", members: Optional[Sequence[int]] = None
              ) -> Mesh:
    """A mesh of ``prod(shape)`` in-process ranks on ``device`` (raises
    when CUDA is asked for and missing; ``cuda`` without an index means
    the caller's current card).  ``members``: the member ids of the
    ranks, in rank order (default ``0..size-1``)."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return Mesh(tuple(axis_names), tuple(int(s) for s in shape), dev,
                None if members is None else tuple(members))


def abstract_mesh(shape: Sequence[int], axis_names: Sequence[str]) -> Mesh:
    return Mesh(tuple(axis_names), tuple(int(s) for s in shape), None)


@contextlib.contextmanager
def set_mesh(mesh: Mesh):
    """Run the block with ``mesh``'s card as the current CUDA device (the
    reference's ``substrate.set_mesh``; ranks, and so collectives, are
    bound by ``run_spmd``, not by a context).  Yields the mesh."""
    dev = mesh.device
    with (torch.cuda.device(dev) if dev is not None and dev.type == "cuda"
          else contextlib.nullcontext()):
        yield mesh


def make_host_mesh(data: int = 2, *, model_parallel: int = 1,
                   pods: int = 1, device="cuda") -> Mesh:
    """``pods x data x model_parallel`` ranks on one device, as the
    reference's ``make_host_mesh`` lays them out: ``("data",)``, with
    ``model_parallel > 1`` ``("data", "model")``, with ``pods > 1``
    ``"pod"`` outermost, "model" always innermost.  The reference sizes
    "data" from the devices it finds; here ``data`` gives it."""
    for name, n in (("data", data), ("model_parallel", model_parallel),
                    ("pods", pods)):
        if n < 1:
            raise ValueError(f"{name}={n}: every axis needs a rank")
    shape, names = [data], ["data"]
    if pods > 1:
        shape, names = [pods] + shape, ["pod"] + names
    if model_parallel > 1:
        shape, names = shape + [model_parallel], names + ["model"]
    return make_mesh(shape, names, device=device)


# ---------------------------------------------------------------------------
# Rank contexts and transports
# ---------------------------------------------------------------------------


class SpmdAbort(RuntimeError):
    """A rank left a hop because a peer failed or the wait timed out."""


class RankFailure(RuntimeError):
    """A rank of ``run_spmd`` failed.  ``rank`` is its rank in the mesh,
    ``member`` the member id it stands for, ``exc`` its own error (the
    ``__cause__`` too).  When every error was a peer's ``SpmdAbort`` (a
    rank never reached its hop), ``rank`` is the rank the others waited
    for and ``exc`` the first abort."""

    def __init__(self, rank: int, member: int, size: int,
                 exc: BaseException, *, hung: bool = False):
        what = "did not reach its hop" if hung else "failed"
        super().__init__(f"rank {rank} of {size} {what}: "
                         f"{type(exc).__name__}: {exc}")
        self.rank = rank
        self.member = member
        self.exc = exc
        self.hung = hung


@dataclasses.dataclass
class _Rank:
    transport: Any
    rank: int
    mesh: Mesh
    coords: Dict[str, int]


_local = threading.local()


def _current() -> _Rank:
    ctx = getattr(_local, "rank", None)
    if ctx is None:
        raise RuntimeError("not inside a rank: collectives run under "
                           "substrate.run_spmd")
    return ctx


@contextlib.contextmanager
def _as_rank(transport, rank: int, mesh: Mesh):
    prev = getattr(_local, "rank", None)
    _local.rank = _Rank(transport, rank, mesh, mesh.coords(rank))
    try:
        yield
    finally:
        _local.rank = prev


def current_rank() -> Optional[int]:
    """The calling thread's rank in its ``run_spmd``, or None outside
    one."""
    ctx = getattr(_local, "rank", None)
    return None if ctx is None else ctx.rank


def current_mesh() -> Mesh:
    """The mesh of the calling rank's ``run_spmd`` (raises outside
    one)."""
    return _current().mesh


def axis_size(axis: str) -> int:
    ctx = _current()
    if axis not in ctx.coords:
        raise KeyError(f"axis {axis!r} not in mesh {ctx.mesh.axis_names}")
    return ctx.mesh.shape[axis]


def axis_index(axis: str) -> int:
    """This rank's coordinate on ``axis`` (a Python int)."""
    ctx = _current()
    if axis not in ctx.coords:
        raise KeyError(f"axis {axis!r} not in mesh {ctx.mesh.axis_names}")
    ctx.transport.note("axis_index", 0, axis)
    return ctx.coords[axis]


def ppermute(x: torch.Tensor, axis: str, perm) -> torch.Tensor:
    """Send ``x`` to ``dst`` and receive from ``src`` for every
    ``(src, dst)`` of ``perm`` (indices on ``axis``); a rank that no pair
    sends to receives zeros, as ``lax.ppermute`` gives."""
    ctx = _current()
    return ctx.transport.ppermute(ctx, x, axis, tuple(perm))


def sent_bytes() -> int:
    """Bytes the calling rank has handed to a peer through ``ppermute``
    in its ``run_spmd`` so far: the wire bytes its hops moved, measured
    by the transport (a hop to itself moves nothing)."""
    ctx = _current()
    return ctx.transport.sent[ctx.rank]


def _source(perm, me: int) -> Optional[int]:
    for src, dst in perm:
        if dst == me:
            return src
    return None


class ThreadTransport:
    """Mailboxes and one barrier for the ranks of one ``run_spmd``.

    A hop writes the rank's tensor into this hop's mailbox, waits until
    every rank has, and copies its peer's.  Mailboxes alternate between
    two generations: a rank can only write generation g again after the
    barrier of hop g + 1, which every rank passes only once it has read
    generation g.  With ``settle`` (an ``instrument``ed run) a hop also
    waits until every rank has its copy and then empties the rank's own
    mailbox: a mailbox then holds a tensor only while its rank is inside
    the hop, so the bytes a rank holds live at any point of its program
    do not depend on how the threads interleave (the dry-run's peak is
    held against a real rank's to the byte).  That costs a second
    barrier a hop, which a run that is not metered does not pay."""

    def __init__(self, mesh: Mesh, timeout: float = DEFAULT_TIMEOUT,
                 settle: bool = False) -> None:
        self.mesh = mesh
        self.timeout = timeout
        self.settle = settle
        self.barrier = threading.Barrier(mesh.size, timeout=timeout)
        self._boxes: List[List[Optional[torch.Tensor]]] = [
            [None] * mesh.size, [None] * mesh.size]
        self._hops = [0] * mesh.size
        self.sent = [0] * mesh.size      # wire bytes a rank has sent

    def note(self, fn: str, nbytes: int, axis: str) -> None:
        pass

    def call(self, fn: str, nbytes: int) -> None:
        pass

    def wait(self) -> None:
        try:
            self.barrier.wait()
        except threading.BrokenBarrierError:
            raise SpmdAbort("a peer rank failed, or a rank waited at a hop "
                            f"longer than {self.timeout}s"
                            ) from None

    def abort(self) -> None:
        self.barrier.abort()

    def ppermute(self, ctx: _Rank, x: torch.Tensor, axis: str,
                 perm) -> torch.Tensor:
        gen = self._hops[ctx.rank] % 2
        self._hops[ctx.rank] += 1
        boxes = self._boxes[gen]
        boxes[ctx.rank] = x
        me = ctx.coords[axis]
        self.sent[ctx.rank] += _wire_bytes(x, perm, me)
        self.wait()
        src = _source(perm, me)
        if src is None:
            out = torch.zeros_like(x)
        else:
            peer = self.mesh.rank_of(dict(ctx.coords, **{axis: src}))
            out = boxes[peer].clone(memory_format=torch.contiguous_format)
            boxes[peer] = None           # this rank is its one receiver
        if self.settle:
            self.wait()                  # every rank has its copy
            boxes[ctx.rank] = None
        elif not any(s == me for s, _ in perm):
            boxes[ctx.rank] = None       # nobody reads this rank's tensor
        return out


def _wire_bytes(x: torch.Tensor, perm, me: int) -> int:
    """The bytes a hop moves out of the rank at ``me``: ``x``'s, when
    ``perm`` sends it to another rank (a hop to itself moves nothing)."""
    if any(s == me and d != me for s, d in perm):
        return x.numel() * x.element_size()
    return 0


@dataclasses.dataclass
class Site:
    """One recorded hop or rank query of the application scan."""

    function: str          # registry name: "permute" | "axis_index"
    nbytes: int
    axis: str
    sent: int = 0          # wire bytes rank 0 sent (as ``sent_bytes``)
    call: str = ""         # the collective that issued it (``collective``)


@dataclasses.dataclass
class Call:
    """One recorded call of a collective (``collective``): its function
    and the bytes of the tensor it was given."""

    function: str
    nbytes: int


class RecordingTransport:
    """The application scan's transport: records every hop (its bytes)
    and rank query, and returns an empty ``meta`` tensor for a hop."""

    def __init__(self) -> None:
        self.sites: List[Site] = []
        self.calls: List[Call] = []

    def note(self, fn: str, nbytes: int, axis: str) -> None:
        self.sites.append(Site(fn, nbytes, axis, call=_call_label()))

    def call(self, fn: str, nbytes: int) -> None:
        self.calls.append(Call(fn, nbytes))

    @property
    def sent(self) -> List[int]:
        """Rank 0's wire bytes so far (``sent_bytes``)."""
        return [sum(s.sent for s in self.sites)]

    def ppermute(self, ctx: _Rank, x: torch.Tensor, axis: str,
                 perm) -> torch.Tensor:
        nbytes = x.numel() * x.element_size()
        self.sites.append(Site("permute", nbytes, axis,
                               _wire_bytes(x, perm, ctx.coords[axis]),
                               _call_label()))
        return torch.empty_like(x, device="meta")


def _call_label() -> str:
    labels = getattr(_local, "labels", None)
    return labels[0] if labels else ""


@contextlib.contextmanager
def collective(fn: str, x: Optional[torch.Tensor] = None):
    """Label the hops of the block as made by a call of the collective
    ``fn`` (the outermost label wins: a collective built of others is
    one call).  ``x`` is the tensor a call starts on; without it (a wait
    or progress arm) the block continues a call already counted."""
    labels = getattr(_local, "labels", None)
    if labels is None:
        labels = _local.labels = []
    ctx = getattr(_local, "rank", None)
    if ctx is not None and not labels and x is not None:
        ctx.transport.call(fn, x.numel() * x.element_size())
    labels.append(fn)
    try:
        yield
    finally:
        labels.pop()


@contextlib.contextmanager
def instrument(rank: int, factory: Callable[[Sequence[Any]], Any]):
    """Within the block, every ``run_spmd`` called from this thread runs
    rank ``rank``'s function inside ``factory(args)`` (a context manager;
    ``args``: the rank's arguments), on that rank's own thread (under
    ``recording()``, rank 0's run).  Yields nothing."""
    prev = getattr(_local, "instrument", None)
    _local.instrument = (rank, factory)
    try:
        yield
    finally:
        _local.instrument = prev


def _instrumented(hook, rank: int, args: Sequence[Any]):
    if hook is None or hook[0] != rank:
        return contextlib.nullcontext()
    return hook[1](args)


@contextlib.contextmanager
def recording():
    """Run ``run_spmd`` calls as the application scan: rank 0 only, on
    ``meta`` tensors, hops recorded.  Yields the transport."""
    prev = getattr(_local, "recorder", None)
    rec = RecordingTransport()
    _local.recorder = rec
    try:
        yield rec
    finally:
        _local.recorder = prev


def run_spmd(fn: Callable, per_rank_args: Sequence[Sequence[Any]],
             mesh: Mesh, *, timeout: float = DEFAULT_TIMEOUT) -> List[Any]:
    """Run ``fn(*per_rank_args[r])`` as rank r of ``mesh``, one thread per
    rank, and return the results in rank order.  If any rank raises, the
    others fail at their next hop and a ``RankFailure`` naming the first
    rank with an error of its own (never a peer's abort) is raised here,
    from that error."""
    if len(per_rank_args) != mesh.size:
        raise ValueError(f"{len(per_rank_args)} argument sets for "
                         f"{mesh.size} ranks")
    rec = getattr(_local, "recorder", None)
    hook = getattr(_local, "instrument", None)
    if rec is not None:
        with _as_rank(rec, 0, mesh), \
                _instrumented(hook, 0, per_rank_args[0]):
            out = fn(*per_rank_args[0])
        return [out] * mesh.size
    if mesh.abstract:
        raise ValueError("an abstract mesh runs only under recording()")
    transport = ThreadTransport(mesh, timeout, settle=hook is not None)
    results: List[Any] = [None] * mesh.size
    errors: List[Optional[BaseException]] = [None] * mesh.size

    def body(rank: int) -> None:
        try:
            if mesh.device.type == "cuda":
                torch.cuda.set_device(mesh.device)
            with _as_rank(transport, rank, mesh), \
                    _instrumented(hook, rank, per_rank_args[rank]):
                results[rank] = fn(*per_rank_args[rank])
        except BaseException as e:        # re-raised by the caller below
            errors[rank] = e
            transport.abort()

    threads = [threading.Thread(target=body, args=(r,),
                                name=f"spmd-rank{r}", daemon=True)
               for r in range(mesh.size)]
    for t in threads:
        t.start()
    # Once a rank has failed, the others get one more timeout to leave
    # (those waiting at a hop leave at once); a rank stuck elsewhere is
    # left behind, a daemon thread, rather than hanging the caller.
    deadline = None
    while any(t.is_alive() for t in threads):
        if deadline is None and any(e is not None for e in errors):
            deadline = time.monotonic() + timeout
        if deadline is not None and time.monotonic() > deadline:
            break
        next(t for t in threads if t.is_alive()).join(0.05)
    failed = [(r, e) for r, e in enumerate(errors) if e is not None]
    if failed:
        own = [(r, e) for r, e in failed if not isinstance(e, SpmdAbort)]
        if own:
            rank, err = own[0]
            raise RankFailure(rank, mesh.members[rank], mesh.size,
                              err) from err
        # only aborts: name a rank the others waited for, if one is left
        stuck = [r for r, t in enumerate(threads)
                 if t.is_alive() and errors[r] is None]
        rank, err = (stuck[0], failed[0][1]) if stuck else failed[0]
        raise RankFailure(rank, mesh.members[rank], mesh.size, err,
                          hung=bool(stuck)) from err
    return results
