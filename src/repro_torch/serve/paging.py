"""Paged KV-cache subsystem: ``PagePool`` + ``PageTable`` own ALL serving
cache memory (counterpart of ``repro.serve.paging``).

One pool owns a device-resident region of fixed-size pages
(``ServeCfg.page_tokens`` positions each, pow2), preallocated once and
reused: allocation, free, splice, extract, park and defragmentation
happen here or not at all.

Layout
------
A model's cache tree is probed once on the ``meta`` device (vary the
batch, then the max_len argument) to classify every leaf:

- **token leaves** carry a per-position axis (attention K/V rows).  The
  pool stores them as ``(num_pages + 1, page_tokens, *rest)`` — page id 0
  is a reserved, never-allocated zero page so unoccupied page-table
  entries always have somewhere harmless to point.  A *logical page*
  spans page_tokens positions across EVERY token leaf (all layers at
  once), so one allocation covers a token range for the whole model.
- **state leaves** have no position axis: the ``len`` counters, and a
  Mamba layer's ``conv`` tail and ``ssm`` state (f32 whatever the cache
  dtype).  They live in a batch-shaped slot arena ``(batch, *rest)``,
  spliced per slot, each leaf in its own dtype.  A model with no token
  leaf (mamba2) has zero-byte pages: they are still allocated, counted
  and freed, so admission and preemption work on token counts as for
  any model.

Per request, a ``PageTable`` maps logical token positions to physical
pages (``pages[i]`` backs positions ``[i*page_tokens, (i+1)*page_tokens)``)
plus the logical token count.  Each decode or prefill step gathers the
arena it computes on from the pool (``pool[table]``), runs the model on
it, and writes back only each active slot's touched page, so persistent
device memory is the pool itself.

Degenerate layout: ``page_tokens == max_len`` is the contiguous layout
(one page per slot).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.tree import Path, flatten, unflatten


class OutOfPages(RuntimeError):
    """The pool cannot back the requested tokens with free pages."""


def resolve_page_tokens(max_len: int, page_tokens: Optional[int]) -> int:
    """Validate/derive the page size.  Explicit values must be pow2 and
    divide ``max_len`` (or equal it — the degenerate contiguous layout);
    ``None`` auto-picks the largest pow2 <= 16 that divides ``max_len``."""
    if page_tokens is not None:
        pt = int(page_tokens)
        if pt == max_len:
            return pt
        if pt < 1 or (pt & (pt - 1)) != 0:
            raise ValueError(f"page_tokens={pt} must be a power of two")
        if max_len % pt != 0:
            raise ValueError(
                f"page_tokens={pt} must divide max_len={max_len}")
        return pt
    pt = 1
    while pt * 2 <= min(16, max_len) and max_len % (pt * 2) == 0:
        pt *= 2
    return pt


# ---------------------------------------------------------------------------
# Cache creation chokepoints
# ---------------------------------------------------------------------------


def contiguous_caches(model, batch: int, max_len: int, *, dtype, device,
                      enc_len: int = 0, mesh=None, rank=None):
    """A plain contiguous cache (the pre-paging layout) for the simple
    ``generate`` path and the one-shot prefill fallback; an
    encoder-decoder's holds ``enc_len`` frames of memory.  A model split
    over "model" gets the calling rank's blocks of it (or rank
    ``rank``'s of ``mesh``: ``Model.init_caches``)."""
    kw = {} if mesh is None else {"mesh": mesh, "rank": rank}
    if enc_len:
        kw["enc_len"] = enc_len
    return model.init_caches(batch, max_len, dtype=dtype, device=device,
                             **kw)


def abstract_caches(model, batch: int, max_len: int, *, dtype,
                    enc_len: int = 0):
    """A contiguous cache on the ``meta`` device (no memory)."""
    return contiguous_caches(model, batch, max_len, dtype=dtype,
                             device=torch.device("meta"), enc_len=enc_len)


# ---------------------------------------------------------------------------
# Layout probe
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class LeafLayout:
    shape: Tuple[int, ...]         # shape at (batch=1, max_len)
    dtype: Any
    batch_axis: int
    token_axis: Optional[int]      # None: state leaf (no position axis)

    def rest(self) -> List[int]:
        """Sizes of the axes other than batch and token."""
        return [s for ax, s in enumerate(self.shape)
                if ax not in (self.batch_axis, self.token_axis)]


def _diff_axes(a: torch.Tensor, b: torch.Tensor) -> List[int]:
    assert a.dim() == b.dim(), (a.shape, b.shape)
    return [i for i, (x, y) in enumerate(zip(a.shape, b.shape)) if x != y]


@dataclasses.dataclass
class PageLayout:
    """Probed per-leaf cache layout for one model + max_len + dtype."""
    paths: List[Path]              # leaf paths in tree order
    leaves: List[LeafLayout]
    max_len: int
    page_tokens: int

    @property
    def pages_per_slot(self) -> int:
        return self.max_len // self.page_tokens

    @property
    def token_leaf_ids(self) -> List[int]:
        return [i for i, l in enumerate(self.leaves)
                if l.token_axis is not None]

    @property
    def state_leaf_ids(self) -> List[int]:
        return [i for i, l in enumerate(self.leaves) if l.token_axis is None]

    def page_bytes(self) -> int:
        """Bytes one logical page occupies across every token leaf."""
        return sum(self.page_tokens * math.prod(self.leaves[i].rest())
                   * self.leaves[i].dtype.itemsize
                   for i in self.token_leaf_ids)

    def row_bytes(self) -> int:
        """Bytes one full contiguous ``max_len`` row occupies."""
        return self.pages_per_slot * self.page_bytes()


def probe_layout(model, max_len: int, page_tokens: int, *,
                 dtype) -> PageLayout:
    """Classify cache leaves by varying ``batch`` then ``max_len`` on the
    ``meta`` device — model-agnostic."""
    bl, paths = flatten(abstract_caches(model, 1, max_len, dtype=dtype))
    wl, _ = flatten(abstract_caches(model, 2, max_len, dtype=dtype))
    dl, _ = flatten(abstract_caches(model, 1, 2 * max_len, dtype=dtype))
    leaves = []
    for b, w, d in zip(bl, wl, dl):
        baxes = _diff_axes(b, w)
        if len(baxes) != 1:
            raise ValueError(
                f"cache leaf {tuple(b.shape)} has no unique batch axis "
                f"({baxes})")
        taxes = _diff_axes(b, d)
        if len(taxes) > 1:
            raise ValueError(
                f"cache leaf {tuple(b.shape)} has no unique token axis "
                f"({taxes})")
        leaves.append(LeafLayout(
            shape=tuple(b.shape), dtype=b.dtype, batch_axis=baxes[0],
            token_axis=taxes[0] if taxes else None))
    return PageLayout(paths=paths, leaves=leaves, max_len=max_len,
                      page_tokens=page_tokens)


def layout_for(model, cfg) -> PageLayout:
    """The probed page layout a ``ServeCfg`` implies (no pool memory)."""
    return probe_layout(model, cfg.max_len,
                        resolve_page_tokens(cfg.max_len, cfg.page_tokens),
                        dtype=cfg.cache_dtype)


# ---------------------------------------------------------------------------
# Page table + extracted request cache
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class PageTable:
    """One request's logical-position -> physical-page mapping."""
    pages: List[int] = dataclasses.field(default_factory=list)
    tokens: int = 0                # cache positions occupied (logical len)

    def page_of(self, position: int, page_tokens: int) -> int:
        return self.pages[position // page_tokens]


@dataclasses.dataclass
class RequestCache:
    """A request's cache extracted to host memory, page-granular: ONLY its
    live pages move, never a full max_len row."""
    pages: List[torch.Tensor]      # per token leaf: (n_pages, pt, *rest)
    state: List[torch.Tensor]      # per state leaf: batch axis of size 1
    tokens: int

    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for t in list(self.pages) + list(self.state))


def abstract_request_cache(layout: PageLayout, tokens: int
                           ) -> RequestCache:
    """The ``meta`` image of an extracted request with ``tokens`` cache
    positions — what a snapshot restore is shaped by, built from the
    probed layout instead of a stored tree."""
    n = -(-tokens // layout.page_tokens) if tokens > 0 else 0
    pages = [torch.empty((n, layout.page_tokens,
                          *layout.leaves[i].rest()),
                         dtype=layout.leaves[i].dtype, device="meta")
             for i in layout.token_leaf_ids]
    state = [torch.empty(layout.leaves[i].shape,
                         dtype=layout.leaves[i].dtype, device="meta")
             for i in layout.state_leaf_ids]
    return RequestCache(pages=pages, state=state, tokens=tokens)


# ---------------------------------------------------------------------------
# The pool
# ---------------------------------------------------------------------------


class PagePool:
    """Device-resident page pool + slot-state arena: the ONE owner of
    serving cache memory.

    ``num_pages`` defaults to ``batch * max_len / page_tokens`` (capacity
    parity with the contiguous layout); ``ServeCfg.pool_pages`` overcommits
    or undercommits it.  Free pages are reused LIFO.  ``rid``-keyed
    ``PageTable``s are the only route from a logical token position to
    pool memory.
    """

    def __init__(self, model, cfg, device="cuda"):
        self.model = model
        self.cfg = cfg
        self.device = resolve_device(device)
        self.page_tokens = resolve_page_tokens(cfg.max_len, cfg.page_tokens)
        self.layout = probe_layout(model, cfg.max_len, self.page_tokens,
                                   dtype=cfg.cache_dtype)
        pps = self.layout.pages_per_slot
        self.num_pages = int(cfg.pool_pages) if cfg.pool_pages \
            else cfg.batch * pps
        if self.num_pages < 1:
            raise ValueError("pool needs at least one page")
        # page 0 is the reserved zero page; allocatable ids are 1..num_pages
        self._free: List[int] = list(range(self.num_pages, 0, -1))
        self.tables: Dict[int, PageTable] = {}
        self.pool: List[torch.Tensor] = []       # token leaves
        self.state: List[torch.Tensor] = []      # slot-state arena leaves
        for l in self.layout.leaves:
            if l.token_axis is not None:
                self.pool.append(torch.zeros(
                    (self.num_pages + 1, self.page_tokens, *l.rest()),
                    dtype=l.dtype, device=self.device))
            else:
                # the arena keeps the slot axis where the batch axis was
                shape = l.rest()
                shape.insert(min(l.batch_axis, len(shape)), cfg.batch)
                self.state.append(torch.zeros(tuple(shape), dtype=l.dtype,
                                              device=self.device))

    # -- books -------------------------------------------------------------

    @property
    def pages_total(self) -> int:
        return self.num_pages

    @property
    def pages_free(self) -> int:
        return len(self._free)

    @property
    def pages_allocated(self) -> int:
        return self.num_pages - len(self._free)

    def pages_for(self, n_tokens: int) -> int:
        return -(-n_tokens // self.page_tokens) if n_tokens > 0 else 0

    def _state_bytes(self) -> int:
        return sum(s.numel() * s.element_size() for s in self.state)

    def resident_bytes(self) -> int:
        """Cache bytes actually backing live tokens: allocated pages x
        page bytes + the slot-state arena."""
        return self.pages_allocated * self.layout.page_bytes() \
            + self._state_bytes()

    def contiguous_bytes(self, rows: Optional[int] = None) -> int:
        """What the same occupancy costs in the contiguous layout."""
        rows = self.cfg.batch if rows is None else rows
        return rows * self.layout.row_bytes() + self._state_bytes()

    def has_room(self, n_tokens: int) -> bool:
        return self.pages_free >= self.pages_for(n_tokens)

    def ensure(self, rid: int, n_tokens: int) -> List[int]:
        """Grow ``rid``'s table to cover ``n_tokens`` positions; returns
        the newly allocated page ids.  Raises ``OutOfPages`` (allocating
        nothing) when the pool cannot back the growth."""
        table = self.tables.setdefault(rid, PageTable())
        need = self.pages_for(n_tokens) - len(table.pages)
        if need <= 0:
            return []
        if need > len(self._free):
            raise OutOfPages(
                f"rid {rid} needs {need} page(s), {len(self._free)} free "
                f"of {self.num_pages}")
        new = [self._free.pop() for _ in range(need)]
        table.pages.extend(new)
        return new

    def release(self, rid: int) -> int:
        """Free every page ``rid`` holds; returns how many."""
        table = self.tables.pop(rid, None)
        if table is None:
            return 0
        for p in reversed(table.pages):
            self._free.append(p)
        return len(table.pages)

    def check_integrity(self) -> None:
        """Allocator invariants: every page allocated at most once,
        free+allocated partitions the pool, page 0 never handed out,
        tables consistent with their token counts."""
        seen: Dict[int, int] = {}
        for rid, t in self.tables.items():
            assert len(t.pages) >= self.pages_for(t.tokens), (rid, t)
            for p in t.pages:
                assert 1 <= p <= self.num_pages, (rid, p)
                assert p not in seen, f"page {p} owned by {seen[p]} and {rid}"
                seen[p] = rid
        free = set(self._free)
        assert len(free) == len(self._free), "free list holds duplicates"
        assert 0 not in free, "zero page on the free list"
        assert not (free & set(seen)), "page both free and allocated"
        assert len(free) + len(seen) == self.num_pages, \
            (len(free), len(seen), self.num_pages)

    # -- table materialization --------------------------------------------

    def _table_row(self, rid: Optional[int]) -> List[int]:
        pps = self.layout.pages_per_slot
        if rid is None or rid not in self.tables:
            return [0] * pps
        pages = self.tables[rid].pages
        return list(pages) + [0] * (pps - len(pages))

    def table_array(self, slot_rids: Sequence[Optional[int]]
                    ) -> torch.Tensor:
        return torch.tensor([self._table_row(r) for r in slot_rids],
                            dtype=torch.int64, device=self.device)

    # -- assemble / writeback ----------------------------------------------

    def _assemble(self, state: Sequence[torch.Tensor], table: torch.Tensor):
        """Gather a (B, max_len, ...) cache tree from pages: the arena is
        a temporary of the step, not resident memory."""
        b = table.shape[0]
        n = self.page_tokens * self.layout.pages_per_slot
        out: List[Optional[torch.Tensor]] = [None] * len(self.layout.leaves)
        ti = si = 0
        for i, l in enumerate(self.layout.leaves):
            if l.token_axis is not None:
                g = self.pool[ti][table]             # (B, pps, pt, *rest)
                g = g.reshape((b, n) + tuple(g.shape[3:]))
                out[i] = torch.movedim(g, (0, 1), (l.batch_axis, l.token_axis))
                ti += 1
            else:
                arena = state[si]
                src_ax = min(l.batch_axis, arena.dim() - 1)
                out[i] = torch.movedim(arena, src_ax, l.batch_axis)
                si += 1
        return unflatten(self.layout.paths, out)

    def _split(self, caches) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
        """Inverse bookkeeping of ``_assemble``: (token leaves, state
        leaves) of a cache tree."""
        flat, _ = flatten(caches)
        return ([flat[i] for i in self.layout.token_leaf_ids],
                [flat[i] for i in self.layout.state_leaf_ids])

    def _writeback(self, tok_leaves: Sequence[torch.Tensor],
                   slots: Sequence[int], pids: Sequence[int],
                   ks: Sequence[int]) -> None:
        """Scatter page ``ks[j]`` of slot ``slots[j]`` of the computed
        arena into pool page ``pids[j]``, every token leaf at once; one
        index tensor each, built once per step."""
        if not slots:
            return
        pt = self.page_tokens
        rows = torch.tensor(slots, dtype=torch.int64, device=self.device)
        kk = torch.tensor(ks, dtype=torch.int64, device=self.device)
        dst = torch.tensor(pids, dtype=torch.int64, device=self.device)
        for ti, i in enumerate(self.layout.token_leaf_ids):
            l = self.layout.leaves[i]
            g = torch.movedim(tok_leaves[ti], (l.batch_axis, l.token_axis),
                              (0, 1))                 # (B, max_len, *rest)
            g = g.reshape((g.shape[0], self.layout.pages_per_slot, pt)
                          + tuple(g.shape[2:]))
            self.pool[ti][dst] = g[rows, kk].to(self.pool[ti].dtype)

    def bind_decode(self, decode_fn, rows: int) -> Callable:
        """One paged decode step: for each block of ``rows`` slots,
        gather the block's arena from pages -> ``decode_fn`` -> write
        each active slot's touched page back.  The model always sees
        ``rows`` rows: padding rows fill the last block, reading the zero
        page with zeroed state; they write no page and their state is
        dropped.  Returns ``run(params, tok, rids, pos, slot_rids,
        active_mask)`` -> next tokens (and commits pool/state)."""
        b = self.cfg.batch
        n_blocks = -(-b // rows)
        pad = n_blocks * rows - b

        def padded(t: torch.Tensor, ax: int) -> torch.Tensor:
            if not pad:
                return t
            shape = list(t.shape)
            shape[ax] = pad
            return torch.cat([t, t.new_zeros(shape)], dim=ax)

        def run(params, tok, rids, pos, slot_rids, active_mask):
            table = self.table_array(list(slot_rids) + [None] * pad)
            state_ax = [min(self.layout.leaves[li].batch_axis, st.dim() - 1)
                        for st, li in zip(self.state,
                                          self.layout.state_leaf_ids)]
            state = [padded(st, ax) for st, ax in zip(self.state, state_ax)]
            tok, rids, pos = (padded(t, 0) for t in (tok, rids, pos))
            pt = self.page_tokens
            nxt, new_state = [], [[] for _ in state]
            for k in range(n_blocks):
                lo = k * rows
                slots, pids, ks = [], [], []
                for i in range(lo, min(lo + rows, b)):
                    r = slot_rids[i]
                    t = self.tables.get(r) if r is not None else None
                    if active_mask[i] and t is not None:
                        slots.append(i - lo)
                        pids.append(t.page_of(t.tokens, pt))
                        ks.append(t.tokens // pt)
                caches = self._assemble(
                    [st.narrow(ax, lo, rows)
                     for st, ax in zip(state, state_ax)],
                    table[lo:lo + rows])
                blk, new_caches = decode_fn(
                    params, tok[lo:lo + rows], caches, rids[lo:lo + rows],
                    pos[lo:lo + rows])
                tok_leaves, blk_state = self._split(new_caches)
                self._writeback(tok_leaves, slots, pids, ks)
                nxt.append(blk)
                for acc, st in zip(new_state, blk_state):
                    acc.append(st)
            # inactive slots keep their arena state bit-intact; the
            # padding rows' state is dropped
            active = torch.tensor(list(active_mask), dtype=torch.bool,
                                  device=self.device)
            out_state = []
            for si, li in enumerate(self.layout.state_leaf_ids):
                l = self.layout.leaves[li]
                old, ax = self.state[si], state_ax[si]
                new = torch.cat(new_state[si], dim=l.batch_axis).narrow(
                    l.batch_axis, 0, b)
                new = torch.movedim(new, l.batch_axis, ax)
                mask = torch.movedim(
                    active.reshape((b,) + (1,) * (new.dim() - 1)), 0, ax)
                out_state.append(torch.where(mask, new.to(old.dtype), old))
            self.state = out_state
            for r, a in zip(slot_rids, active_mask):
                if a and r is not None:
                    self.tables[r].tokens += 1
            return torch.cat(nxt)[:b]

        return run

    def bind_prefill_chunk(self, chunk_fn) -> Callable:
        """One prefill chunk over a batch-1 arena gathered from the
        request's pages: ``chunk_fn(params, tokens, caches, q_offset,
        valid_len, last_index)`` -> (logits, caches).  Writes the chunk's
        page back and returns (logits, state leaves) for the caller to
        carry between chunks."""

        def run(params, rid, tokens, chunk_idx, valid_len, last_index,
                state1):
            table1 = self.table_array([rid])
            t = self.tables[rid]
            caches = self._assemble(state1, table1)
            logits, new_caches = chunk_fn(
                params, tokens, caches, chunk_idx * self.page_tokens,
                valid_len, last_index)
            tok_leaves, new_state = self._split(new_caches)
            self._writeback(tok_leaves, [0], [t.pages[chunk_idx]],
                            [chunk_idx])
            t.tokens = min(valid_len, (chunk_idx + 1) * self.page_tokens)
            return logits, new_state

        return run

    # -- state arena -------------------------------------------------------

    def fresh_state1(self) -> List[torch.Tensor]:
        """Zeroed batch-1 state leaves (a new request's non-positional
        cache state, carried across prefill chunks), each in its leaf's
        dtype."""
        out = []
        for li in self.layout.state_leaf_ids:
            l = self.layout.leaves[li]
            shape = [1 if ax == l.batch_axis else s
                     for ax, s in enumerate(l.shape)]
            out.append(torch.zeros(shape, dtype=l.dtype, device=self.device))
        return out

    def read_state(self, slot: int) -> List[torch.Tensor]:
        out = []
        for si, li in enumerate(self.layout.state_leaf_ids):
            l = self.layout.leaves[li]
            ax = min(l.batch_axis, self.state[si].dim() - 1)
            row = self.state[si].narrow(ax, slot, 1).clone()
            out.append(torch.movedim(row, ax, l.batch_axis))
        return out

    def write_state(self, slot: int, state1: Sequence[torch.Tensor]) -> None:
        for si, li in enumerate(self.layout.state_leaf_ids):
            l = self.layout.leaves[li]
            arena = self.state[si]
            ax = min(l.batch_axis, arena.dim() - 1)
            one = torch.as_tensor(state1[si]).to(arena.device, arena.dtype)
            arena.narrow(ax, slot, 1).copy_(
                torch.movedim(one, l.batch_axis, ax))

    # -- one-shot splice (models without chunked prefill) ------------------

    def splice_row(self, rid: int, slot: int, cache_b1, n_tokens: int
                   ) -> None:
        """Adopt a contiguous batch-1 cache (a one-shot prefill result)
        into pool pages + slot state; pages are allocated here."""
        self.ensure(rid, n_tokens)
        t = self.tables[rid]
        n = len(t.pages)
        dst = torch.tensor(t.pages, dtype=torch.int64, device=self.device)
        flat, _ = flatten(cache_b1)
        for ti, i in enumerate(self.layout.token_leaf_ids):
            l = self.layout.leaves[i]
            row = flat[i].squeeze(l.batch_axis)
            t_ax = l.token_axis - (1 if l.batch_axis < l.token_axis else 0)
            row = torch.movedim(row, t_ax, 0)         # (max_len, *rest)
            pages = row.reshape((self.layout.pages_per_slot,
                                 self.page_tokens) + tuple(row.shape[1:]))
            self.pool[ti][dst] = pages[:n].to(self.pool[ti].dtype)
        self.write_state(slot, [flat[i] for i in self.layout.state_leaf_ids])
        t.tokens = n_tokens

    # -- extract / splice / park (the preemption surface) ------------------

    def extract(self, rid: int, slot: int) -> RequestCache:
        """Page-granular extract to host: ONLY ``rid``'s live pages and
        its slot state move."""
        t = self.tables[rid]
        idx = torch.tensor(t.pages, dtype=torch.int64, device=self.device)
        pages = [leaf[idx].cpu() for leaf in self.pool]
        state = [s.cpu() for s in self.read_state(slot)]
        return RequestCache(pages=pages, state=state, tokens=t.tokens)

    def splice(self, rid: int, slot: int, rc: RequestCache) -> None:
        """The inverse of ``extract``: allocate pages for ``rc.tokens``
        and write the host pages + state back.  Raises ``OutOfPages``
        without side effects when the pool has no room."""
        if rid in self.tables and self.tables[rid].pages:
            raise ValueError(f"rid {rid} already holds pages")
        self.ensure(rid, rc.tokens)
        t = self.tables[rid]
        idx = torch.tensor(t.pages, dtype=torch.int64, device=self.device)
        for leaf, pg in zip(self.pool, rc.pages):
            leaf[idx] = torch.as_tensor(pg).to(leaf.device, leaf.dtype)
        self.write_state(slot, rc.state)
        t.tokens = rc.tokens

    def park(self, rid: int, slot: int) -> RequestCache:
        """Extract + free: the request leaves the pool (host-parked) so
        its pages serve someone else."""
        rc = self.extract(rid, slot)
        self.release(rid)
        return rc

    # -- defragmentation ---------------------------------------------------

    def defragment(self) -> int:
        """Compact allocated pages into the lowest ids (tables rewritten,
        page data moved on the device).  Returns pages moved."""
        owners: Dict[int, Tuple[int, int]] = {}
        for rid, t in self.tables.items():
            for j, p in enumerate(t.pages):
                owners[p] = (rid, j)
        moves: List[Tuple[int, int]] = []
        target = 1
        for p in sorted(owners):
            if p != target:
                moves.append((p, target))
            target += 1
        if moves:
            src = torch.tensor([m[0] for m in moves], dtype=torch.int64,
                               device=self.device)
            dst = torch.tensor([m[1] for m in moves], dtype=torch.int64,
                               device=self.device)
            for leaf in self.pool:
                leaf[dst] = leaf[src]     # the gather copies before the write
            for old, new in moves:
                rid, j = owners[old]
                self.tables[rid].pages[j] = new
        n_alloc = len(owners)
        self._free = list(range(self.num_pages, n_alloc, -1))
        return len(moves)
