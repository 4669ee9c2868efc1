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
    generation g."""

    def __init__(self, mesh: Mesh, timeout: float = DEFAULT_TIMEOUT) -> None:
        self.mesh = mesh
        self.timeout = timeout
        self.barrier = threading.Barrier(mesh.size, timeout=timeout)
        self._boxes: List[List[Optional[torch.Tensor]]] = [
            [None] * mesh.size, [None] * mesh.size]
        self._hops = [0] * mesh.size
        self.sent = [0] * mesh.size      # wire bytes a rank has sent

    def note(self, fn: str, nbytes: int, axis: str) -> None:
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
        if any(s == me and d != me for s, d in perm):
            self.sent[ctx.rank] += x.numel() * x.element_size()
        self.wait()
        src = _source(perm, me)
        if src is None:
            out = torch.zeros_like(x)
        else:
            peer = self.mesh.rank_of(dict(ctx.coords, **{axis: src}))
            out = boxes[peer].clone(memory_format=torch.contiguous_format)
            boxes[peer] = None           # this rank is its one receiver
        if not any(s == me for s, _ in perm):
            boxes[ctx.rank] = None       # nobody reads this rank's tensor
        return out


@dataclasses.dataclass
class Site:
    """One recorded hop or rank query of the application scan."""

    function: str          # registry name: "permute" | "axis_index"
    nbytes: int
    axis: str


class RecordingTransport:
    """The application scan's transport: records every hop (its bytes)
    and rank query, and returns an empty ``meta`` tensor for a hop."""

    def __init__(self) -> None:
        self.sites: List[Site] = []

    def note(self, fn: str, nbytes: int, axis: str) -> None:
        self.sites.append(Site(fn, nbytes, axis))

    def ppermute(self, ctx: _Rank, x: torch.Tensor, axis: str,
                 perm) -> torch.Tensor:
        self.note("permute", x.numel() * x.element_size(), axis)
        return torch.empty_like(x, device="meta")


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
    if rec is not None:
        with _as_rank(rec, 0, mesh):
            out = fn(*per_rank_args[0])
        return [out] * mesh.size
    if mesh.abstract:
        raise ValueError("an abstract mesh runs only under recording()")
    transport = ThreadTransport(mesh, timeout)
    results: List[Any] = [None] * mesh.size
    errors: List[Optional[BaseException]] = [None] * mesh.size

    def body(rank: int) -> None:
        try:
            if mesh.device.type == "cuda":
                torch.cuda.set_device(mesh.device)
            with _as_rank(transport, rank, mesh):
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
