"""Serving: prefill/decode steps + a slot-based continuous batcher over
the paged KV-cache pool (counterpart of ``repro.serve.engine``).

``decode_step`` advances EVERY slot one token per call; the scheduler
keeps the slot batch full by admitting queued requests into finished
slots — continuous batching at fixed shapes.

Cache memory is owned by one entity: ``PagePool``.  Slots hold page
*tables*, not ``max_len`` rows — admission is against free pages,
resident bytes scale with generated tokens, and prefill is *chunked*:
prompts run ``page_tokens`` at a time (right-padded to the page
boundary, so every chunk has the same shape and the flash kernel takes
the chunk offset at run time) interleaved with decode steps, so a long
prompt never stalls the batch.  Models without a chunked-prefill path
(those with Mamba layers: mamba2, jamba) fall back to one-shot prefill;
the pool adopts the finished row page by page and its state leaves (a
Mamba layer's conv tail and SSM state) into the request's slot.

Placement goes through the ``repro_torch.comm`` facade as in the
reference: pass ``comm=`` (a ``Communicator``, e.g. ``Session(mesh=
...).world``) and the scheduler serves on the session's mesh — its card,
with every step under ``Session.activate`` — and the mesh's data extent
(pod x data ranks) splits the batch: ``cfg.batch`` is rows a rank x data
ranks, and must divide.  This is the mesh the ``ServeController``
re-meshes.  On one card model parallelism is 1 and serving runs no
collective, so the rows of every data rank run in ONE batched call, as
the reference's one program runs them over its devices.  ``device=``
alone (no session: the reference's ``comm=None`` path) serves on that
device, ``cuda`` unless the caller says otherwise.

Elasticity contract (driven by ``repro_torch.serve.controller.
ServeController``): the scheduler only mutates at decode-step
boundaries, so ``snapshot()`` at any boundary is a *drained* image —
queue, per-slot requests with their generated tokens, and per-slot
caches, page-granular (``PagePool.extract``).  Mid-prefill requests
return to the queue head (no tokens emitted yet; re-prefilling them is
token-identical).  ``from_snapshot`` rebuilds a scheduler from that
image on a different (usually smaller) batch over a re-meshed session:
in-flight requests re-splice their pages and continue decoding where
they left off — no re-prefill, no token replay — and the ones the
shrunk batch cannot hold wait *parked* for a freed slot.

Determinism: every request's token stream is a pure function of
``(cfg.seed, rid, position)`` — independent of batch composition, slot
index, admission order, preemption and prefill chunking (chunked vs
one-shot is bit-identical).  Greedy decoding matches the reference
token for token; sampled decoding draws from a ``torch.Generator``
seeded from ``(seed, rid, position)``, so it is just as pure but does
not reproduce the reference's threefry draws.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.serve import paging
from repro_torch.serve.paging import OutOfPages, PagePool


#: Rows of every paged decode call.  A step decodes its slots in blocks
#: of this many rows, the last block padded, so every GEMM, every
#: batched attention product and the unembedding see one shape whatever
#: the batch: a row's logits do not depend on how many slots the batch
#: has (before and after an elastic drain).  Decode reads the weights
#: once a call, so a padded row costs little.
DECODE_ROWS = 8


@dataclasses.dataclass(frozen=True)
class ServeCfg:
    max_len: int
    batch: int                      # decode slots
    greedy: bool = True
    temperature: float = 1.0
    eos_id: int = -1                # -1: never stops early
    cache_dtype: Any = torch.bfloat16
    seed: int = 0                   # sampling seed; tokens are pure in
                                    # (seed, rid, position)
    max_queue: Optional[int] = None  # admission control: waiting backlog
                                     # bound, excess is SHED not crashed
    page_tokens: Optional[int] = None  # KV page size (pow2 dividing
                                       # max_len; == max_len is the
                                       # contiguous layout); None
                                       # auto-picks (<= 16)
    pool_pages: Optional[int] = None   # pool capacity; None = capacity
                                       # parity with contiguous
    chunked_prefill: bool = True    # interleave prompt chunks with decode
                                    # steps; False runs all chunks at
                                    # admission (same numerics)


def prompt_len(cfg, n: int) -> int:
    """A drawn prompt length ``n`` as the model of ``cfg`` can prefill
    it: a model with Mamba layers takes lengths that are a multiple of
    its SSD chunk (the reference's ``ssd_chunked`` asserts it), so ``n``
    is rounded down to one, and up to one chunk at least; any other
    model takes ``n``."""
    if not any(spec.mixer == "mamba" for st in cfg.stages
               for spec in st.layers):
        return n
    q = cfg.mamba.chunk
    return max(q, n // q * q)


def _sample_seed(seed: int, rid: int, pos: int) -> int:
    """A generator seed pure in (seed, rid, pos)."""
    return int(np.random.SeedSequence([seed, rid, pos]).generate_state(
        1, np.uint64)[0] >> np.uint64(1))


def _pick_tokens(logits: torch.Tensor, cfg: ServeCfg, rids, pos
                 ) -> torch.Tensor:
    """logits (B, V) -> (B,) int64 next tokens (argmax or seeded sample).
    ``rids``/``pos``: per-row request ids and positions (sampling only)."""
    if cfg.greedy:
        return torch.argmax(logits, dim=-1)
    rids = torch.as_tensor(rids).tolist()
    pos = torch.as_tensor(pos).tolist()
    probs = torch.softmax(logits.float().cpu() / cfg.temperature, dim=-1)
    out = []
    for row, (r, p) in enumerate(zip(rids, pos)):
        g = torch.Generator().manual_seed(_sample_seed(cfg.seed, r, p))
        out.append(int(torch.multinomial(probs[row], 1, generator=g)))
    return torch.tensor(out, dtype=torch.int64, device=logits.device)


def make_decode_step(model, cfg: ServeCfg) -> Callable:
    def decode_step(params, tokens, caches, rids, pos):
        """tokens: (B, 1) -> (next (B,), caches).  ``rids``/``pos`` (B,)
        feed the (seed, rid, pos) sampling seeds; unused when greedy."""
        logits, caches = model.decode_step(params, {"tokens": tokens},
                                           caches)
        return _pick_tokens(logits, cfg, rids, pos), caches
    return decode_step


def make_prefill_chunk_step(model) -> Callable:
    def chunk_step(params, tokens, caches, q_offset, valid_len, last_index):
        return model.prefill_chunk(params, {"tokens": tokens}, caches,
                                   q_offset=q_offset, valid_len=valid_len,
                                   last_index=last_index)
    return chunk_step


def generate(model, params, prompts: torch.Tensor, max_new: int,
             cfg: Optional[ServeCfg] = None) -> torch.Tensor:
    """Simple batched generation on ``prompts``' device.

    prompts: (B, S) int -> (B, S + max_new).  Rows act as their own
    request ids for the (seed, rid, pos) sampling contract."""
    b, s = prompts.shape
    cfg = cfg or ServeCfg(max_len=s + max_new, batch=b)
    dev = prompts.device
    caches = paging.contiguous_caches(model, b, cfg.max_len,
                                      dtype=cfg.cache_dtype, device=dev)
    logits, caches = model.prefill(params, {"tokens": prompts}, caches)
    decode = make_decode_step(model, cfg)
    rids = torch.arange(b, device=dev)
    tok = _pick_tokens(logits, cfg, rids, torch.zeros_like(rids))
    out = [tok]
    for i in range(max_new - 1):
        pos = torch.full((b,), i + 1, device=dev)
        tok, caches = decode(params, tok[:, None], caches, rids, pos)
        out.append(tok)
    return torch.cat([prompts.long(), torch.stack(out, dim=1)], dim=1)


def _mesh_scope(comm) -> contextlib.AbstractContextManager:
    """The communicator's mesh context (no-op without a communicator)."""
    return comm.session.activate() if comm is not None \
        else contextlib.nullcontext()


def data_extent(mesh) -> int:
    """Data ranks a serving mesh splits the batch over (pod x data)."""
    sizes = mesh.shape
    return sizes.get("pod", 1) * sizes.get("data", 1)


# ---------------------------------------------------------------------------
# Continuous batching over the page pool
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Request:
    rid: int
    prompt: List[int]
    max_new: int
    generated: List[int] = dataclasses.field(default_factory=list)
    t_submit: Optional[float] = None   # wall time of submit()
    t_first: Optional[float] = None    # wall time of the first token

    @property
    def done(self) -> bool:
        return len(self.generated) >= self.max_new

    @property
    def ttft_s(self) -> Optional[float]:
        """Submit-to-first-token latency."""
        if self.t_submit is None or self.t_first is None:
            return None
        return self.t_first - self.t_submit


@dataclasses.dataclass
class _Prefill:
    """A slot mid-chunked-prefill: the request, its carried batch-1 state
    leaves, and how many page-sized chunks have run."""
    req: Request
    state: List[Any]
    chunks_done: int = 0


def token_only_refusal(model) -> str:
    """Why the scheduler cannot serve ``model``, or "" when it can.  The
    scheduler feeds prefill and decode token ids only (as the
    reference's does, ``repro.serve.engine``'s one-shot prefill passes
    ``{"tokens": prompt}``): an encoder-decoder needs the encoder's
    ``frame_embeds`` and a model without an embedding table
    ``inputs_embeds``.  Both serve through ``Model.prefill`` and
    ``Model.decode_step`` on a batch."""
    if getattr(model, "kind", "decoder") == "encdec":
        return (f"{model.name}: the scheduler feeds token ids only (as the "
                "reference's does); an encoder-decoder also needs "
                "frame_embeds: serve it through Model.prefill and "
                "Model.decode_step")
    if not getattr(getattr(model, "cfg", None), "embed_inputs", True):
        return (f"{model.name}: the scheduler feeds token ids only (as the "
                "reference's does); a model without an embedding table "
                "needs inputs_embeds: serve it through Model.prefill and "
                "Model.decode_step")
    return ""


class BatchScheduler:
    """Slot-based continuous batching over a fixed decode batch backed by
    a ``PagePool``.

    Each slot holds one in-flight request; finished slots are refilled
    from the queue.  Admission is against free *pages*: a request only
    needs its first page to start prefilling and grows page by page as it
    prefills/decodes.  Chunk-capable models prefill one ``page_tokens``
    chunk per ``step()`` interleaved with decode; other models prefill
    one-shot on a contiguous batch-1 row that the pool then adopts page
    by page (``splice_row``).  Decode runs one step for all slots over an
    arena gathered from the pool, in blocks of ``DECODE_ROWS`` rows.

    If decode outgrows the pool (overcommitted ``pool_pages``), the most
    recently admitted active slot is preempted — parked page-granular to
    host — and resumes later with its token stream intact.

    Admission control: ``cfg.max_queue`` bounds the *waiting* backlog
    (queued + parked); a submit over the bound is shed (recorded in
    ``self.shed``, ``submit`` returns False).  In-flight work is never
    shed.
    """

    def __init__(self, model, params, cfg: ServeCfg, device="cuda",
                 comm=None):
        refusal = token_only_refusal(model)
        if refusal:
            raise ValueError(refusal)
        self.model = model
        self.params = params
        self.cfg = cfg
        self.comm = comm          # repro_torch.comm Communicator (mesh)
        if comm is not None:
            mesh = comm.mesh
            if mesh is None or mesh.abstract:
                raise ValueError("serving needs a session over a concrete "
                                 "mesh")
            self.data_ranks = data_extent(mesh)
            if cfg.batch % self.data_ranks:
                raise ValueError(
                    f"batch {cfg.batch} does not split over "
                    f"{self.data_ranks} data ranks (rows a rank x data "
                    f"ranks)")
            self.device = mesh.device
        else:
            self.data_ranks = 1
            self.device = resolve_device(device)
        self.rows_per_rank = cfg.batch // self.data_ranks
        self.queue: deque = deque()
        self.parked: deque = deque()   # SlotSnapshots awaiting a slot
        self.slots: List[Optional[Request]] = [None] * cfg.batch
        self.pool = PagePool(model, cfg, device=self.device)
        self._decode = self.pool.bind_decode(make_decode_step(model, cfg),
                                             DECODE_ROWS)
        self._chunkable = bool(getattr(model, "supports_chunked_prefill",
                                       False))
        self._chunk = self.pool.bind_prefill_chunk(
            make_prefill_chunk_step(model)) if self._chunkable else None
        self._prefills: Dict[int, _Prefill] = {}   # slot -> in-progress
        self._next_tok = torch.zeros(cfg.batch, dtype=torch.int64,
                                     device=self.device)
        self._rids = torch.zeros(cfg.batch, dtype=torch.int64,
                                 device=self.device)
        self._pos = torch.zeros(cfg.batch, dtype=torch.int64,
                                device=self.device)
        self.completed: List[Request] = []
        self.shed: List[Request] = []
        self.decode_steps = 0
        self._admit_seq: Dict[int, int] = {}   # rid -> admission order
        self._seq = 0

    # -- admission ---------------------------------------------------------

    def submit(self, req: Request) -> bool:
        """Admit (eagerly, into a free slot), queue, or — over the
        ``max_queue`` backlog bound — shed ``req``.  Returns False iff
        shed."""
        if req.t_submit is None:
            req.t_submit = time.time()
        if (self.cfg.max_queue is not None
                and not self._has_free_slot()
                and len(self.queue) + len(self.parked)
                >= self.cfg.max_queue):
            self.shed.append(req)
            return False
        self.queue.append(req)
        if self._has_free_slot():
            with _mesh_scope(self.comm):
                self._admit()
        return True

    def _has_free_slot(self) -> bool:
        return any(s is None for s in self.slots)

    def _n_chunks(self, req: Request) -> int:
        return -(-len(req.prompt) // self.pool.page_tokens)

    def _admit(self) -> None:
        for i, slot in enumerate(self.slots):
            if slot is not None:
                continue
            if self.parked:
                # Re-admission after a preemption: resume from the parked
                # pages, never re-prefill.  Needs room for every live page.
                snap = self.parked[0]
                if not self.pool.has_room(snap.cache.tokens):
                    break
                self.parked.popleft()
                self._resume_into(i, snap)
                continue
            admitted = False
            while self.queue:
                req = self.queue[0]
                if self._chunkable:
                    # Chunked prefill starts with just the first page and
                    # grows chunk by chunk.
                    first = min(self.pool.page_tokens, len(req.prompt))
                    if not self.pool.has_room(first):
                        break
                    self.queue.popleft()
                    self.pool.ensure(req.rid, first)
                    self._prefills[i] = _Prefill(req,
                                                 self.pool.fresh_state1())
                    self.slots[i] = req
                    self._admit_seq[req.rid] = self._seq
                    self._seq += 1
                    # Run the first chunk eagerly (short prompts keep
                    # their submit-time TTFT); with interleaving off, run
                    # them all — same numerics, no decode overlap.
                    self._advance_prefill(i)
                    while (not self.cfg.chunked_prefill
                           and i in self._prefills):
                        if not self._advance_prefill(i):
                            raise OutOfPages(
                                f"pool too small for one-shot prefill of "
                                f"rid {req.rid} "
                                f"({len(req.prompt)} prompt tokens)")
                    if self.slots[i] is None:
                        # Single-chunk prompt finished at prefill
                        # (max_new=1 or eos): the slot is free again.
                        continue
                    admitted = True
                    break
                # One-shot fallback: run the prompt through a contiguous
                # batch-1 row, then the pool adopts it page by page.
                if not self.pool.has_room(len(req.prompt)):
                    break
                self.queue.popleft()
                c1 = paging.contiguous_caches(self.model, 1,
                                              self.cfg.max_len,
                                              dtype=self.cfg.cache_dtype,
                                              device=self.device)
                prompt = torch.tensor([req.prompt], dtype=torch.int64,
                                      device=self.device)
                logits, c1 = self.model.prefill(self.params,
                                                {"tokens": prompt}, c1)
                tok = int(_pick_tokens(logits, self.cfg, [req.rid], [0])[0])
                req.generated.append(tok)
                if req.t_first is None:
                    req.t_first = time.time()
                if req.done or (self.cfg.eos_id >= 0
                                and tok == self.cfg.eos_id):
                    # Finished at prefill: never takes the slot.
                    self.completed.append(req)
                    continue
                self.pool.splice_row(req.rid, i, c1, len(req.prompt))
                self._place(i, req)
                admitted = True
                break
            if self.queue and not admitted:
                # Head of the queue can't fit in the pool: stop admitting
                # (FIFO order is the policy; no head-of-line skipping).
                break

    def _place(self, i: int, req: Request) -> None:
        """Wire a request into slot ``i``: next token and the (rid, pos)
        sampling coordinates (its pages are already in the pool)."""
        self._next_tok[i] = req.generated[-1]
        self._rids[i] = req.rid
        self._pos[i] = len(req.generated)
        self.slots[i] = req
        self._admit_seq.setdefault(req.rid, self._seq)
        self._seq += 1

    def _resume_into(self, i: int, snap) -> None:
        self.pool.splice(snap.req.rid, i, snap.cache)
        self._place(i, snap.req)

    # -- chunked prefill ---------------------------------------------------

    def _advance_prefill(self, i: int) -> bool:
        """Run ONE page-sized chunk for the prefilling slot ``i``.
        Returns False when the pool had no page for the next chunk (the
        slot waits; decode continues and frees pages).  On the final
        chunk, samples the first token and flips the slot to decoding."""
        pf = self._prefills[i]
        req = pf.req
        pt = self.pool.page_tokens
        c = pf.chunks_done
        valid_len = min((c + 1) * pt, len(req.prompt))
        try:
            self.pool.ensure(req.rid, valid_len)
        except OutOfPages:
            return False
        chunk = req.prompt[c * pt:(c + 1) * pt]
        chunk = list(chunk) + [0] * (pt - len(chunk))   # pad to the page
        last_index = (len(req.prompt) - 1) - c * pt     # final-chunk only
        logits, pf.state = self._chunk(
            self.params, req.rid,
            torch.tensor([chunk], dtype=torch.int64, device=self.device),
            c, valid_len, max(0, min(last_index, pt - 1)), pf.state)
        pf.chunks_done += 1
        if pf.chunks_done < self._n_chunks(req):
            return True
        # Prefill complete: the first token is sampled at (rid, pos=0) —
        # identical whether the chunks ran interleaved or back-to-back.
        tok = int(_pick_tokens(logits, self.cfg, [req.rid], [0])[0])
        req.generated.append(tok)
        if req.t_first is None:
            req.t_first = time.time()
        self.pool.write_state(i, pf.state)
        del self._prefills[i]
        if req.done or (self.cfg.eos_id >= 0 and tok == self.cfg.eos_id):
            self.completed.append(req)
            self.slots[i] = None
            self.pool.release(req.rid)
            self._admit_seq.pop(req.rid, None)
            return True
        self._next_tok[i] = tok
        self._rids[i] = req.rid
        self._pos[i] = 1
        return True

    # -- preemption --------------------------------------------------------

    def _park_slot(self, i: int) -> None:
        """Preempt slot ``i``: its pages move to host (page-granular) and
        it rejoins at the parked queue's head — resumed first once pages
        free up, tokens bit-identical."""
        from repro_torch.serve.state import SlotSnapshot
        req = self.slots[i]
        snap = SlotSnapshot(req=req, cache=self.pool.park(req.rid, i))
        self.parked.appendleft(snap)
        self.slots[i] = None
        self._admit_seq.pop(req.rid, None)

    def _ensure_decode_pages(self, active: List[int]) -> List[int]:
        """Every active slot needs a page for the position it is about to
        write.  On exhaustion, preempt the most recently admitted active
        slot (LIFO — the one with least sunk cost) and retry; ``ensure``
        is idempotent so rescanning is safe."""
        active = list(active)
        while True:
            try:
                for s in active:
                    rid = self.slots[s].rid
                    self.pool.ensure(rid, self.pool.tables[rid].tokens + 1)
                return active
            except OutOfPages:
                if len(active) <= 1:
                    raise OutOfPages(
                        "page pool cannot sustain a single active "
                        "request; raise pool_pages")
                victim = max(active,
                             key=lambda s2: self._admit_seq.get(
                                 self.slots[s2].rid, -1))
                self._park_slot(victim)
                active.remove(victim)

    # -- the decode loop ---------------------------------------------------

    def step(self) -> int:
        """Admit + advance prefill chunks + one decode step for all
        decoding slots (under the comm session's mesh when there is one).
        Returns the number of in-flight requests touched."""
        with _mesh_scope(self.comm):
            return self._step()

    def _step(self) -> int:
        before = set(self._prefills)
        n_done = len(self.completed)
        self._admit()
        progressed = bool(set(self._prefills) - before) \
            or len(self.completed) > n_done
        if self.cfg.chunked_prefill:
            # One chunk per prefilling slot per step — interleaved with
            # decode so long prompts never stall the batch.  Slots
            # admitted THIS call already ran their first chunk.
            for i in sorted(before & set(self._prefills)):
                progressed |= self._advance_prefill(i)
        active = [i for i, s in enumerate(self.slots)
                  if s is not None and i not in self._prefills]
        prefilling = len(self._prefills)
        if not active:
            if not prefilling and (self.queue or self.parked):
                raise OutOfPages(
                    "pool too small to admit any waiting request; "
                    "raise pool_pages")
            if prefilling and not progressed:
                raise OutOfPages(
                    "page pool cannot cover the prefilling prompt(s) "
                    "and nothing is decoding to free pages; raise "
                    "pool_pages")
            return prefilling
        active = self._ensure_decode_pages(active)
        mask = [False] * self.cfg.batch
        for i in active:
            mask[i] = True
        slot_rids = [s.rid if s is not None and mask[j] else None
                     for j, s in enumerate(self.slots)]
        nxt = self._decode(self.params, self._next_tok[:, None],
                           self._rids, self._pos, slot_rids, mask)
        self._pos += 1
        self._next_tok = nxt
        self.decode_steps += 1
        toks = nxt.tolist()
        for i in active:
            req = self.slots[i]
            req.generated.append(toks[i])
            if req.done or (self.cfg.eos_id >= 0
                            and req.generated[-1] == self.cfg.eos_id):
                self.completed.append(req)
                self.slots[i] = None
                self.pool.release(req.rid)
                self._admit_seq.pop(req.rid, None)
        return len(active) + prefilling

    def pending(self) -> bool:
        """Anything left to do (queued, parked, or in a slot)?"""
        return bool(self.queue or self.parked
                    or any(s is not None for s in self.slots))

    def run(self) -> List[Request]:
        while self.pending():
            self.step()
        return self.completed

    # -- drain / resume ----------------------------------------------------

    def snapshot(self):
        """Drained image of the scheduler at the current decode-step
        boundary: every decoding request with its host-copied PAGES, the
        parked backlog, the queue, and the books.  Mid-prefill slots (no
        token emitted yet) rejoin at the queue's head — re-prefilling them
        after restore is bit-identical.  Read-only: the live scheduler
        keeps running."""
        from repro_torch.serve.state import SchedulerSnapshot, SlotSnapshot
        inflight = []
        requeue = []
        for i, req in enumerate(self.slots):
            if req is None:
                continue
            if i in self._prefills:
                requeue.append(req)
            else:
                inflight.append(SlotSnapshot(
                    req=req, cache=self.pool.extract(req.rid, i)))
        return SchedulerSnapshot(
            cfg=self.cfg, decode_steps=self.decode_steps,
            inflight=inflight, parked=list(self.parked),
            queue=requeue + list(self.queue), completed=list(self.completed),
            shed=list(self.shed))

    @classmethod
    def from_snapshot(cls, model, params, cfg: ServeCfg, snap,
                      device="cuda", comm=None) -> "BatchScheduler":
        """Rebuild a scheduler from a drained snapshot on a (possibly
        smaller) batch, over ``comm``'s (re-meshed) session or on
        ``device``.  In-flight requests re-splice their pages in slot
        order; the ones past ``cfg.batch`` stay parked for freed slots;
        the queue tail past the ``max_queue`` backlog bound is shed."""
        sched = cls(model, params, cfg, device=device, comm=comm)
        sched.decode_steps = snap.decode_steps
        sched.completed = list(snap.completed)
        sched.shed = list(snap.shed)
        sched.parked = deque(snap.resumable)
        queue = list(snap.queue)
        if cfg.max_queue is not None:
            # Waiting backlog AFTER re-admission: parked overflow beyond
            # the new slots, plus whatever queue we keep.  In-flight work
            # is never shed.
            parked_after = max(0, len(sched.parked) - cfg.batch)
            allowed = max(0, cfg.max_queue - parked_after)
            if len(queue) > allowed:
                sched.shed.extend(queue[allowed:])
                queue = queue[:allowed]
        sched.queue = deque(queue)
        with _mesh_scope(comm):
            sched._admit()          # re-admit up to cfg.batch slots NOW
        return sched
