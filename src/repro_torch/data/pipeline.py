"""Deterministic synthetic data, pure in (seed, step, row).

Counterpart of ``repro.data.pipeline``: ``SyntheticLMDataset``, its
``sharded_batch`` and ``Prefetcher``.  ``host_batch`` is the reference's
numpy code, so both packages give byte-identical batches; a restart
resumes mid-epoch with the same data.  The token stream is a Zipf-ish
mixture with local n-gram structure, so losses fall during smoke
training runs.  With ``with_embeds`` a batch also carries
``inputs_embeds`` (B, S, ``embed_dim``) f32 and, with ``mrope``, text
``positions`` (3, B, S), as the reference's does.

The reference builds a step's batch as sharded global arrays, each
device given its rows; ``sharded_batch`` gives each thread rank of a
mesh its rows on the mesh's device (``shard_batch``), split over the
batch axes, each key at its ``batch_dim`` (M-RoPE ``positions`` at dim
1).  The trainer's step splits a global batch through ``shard_batch``
too.  The ranks of one data coordinate share one copy.  ``Prefetcher``
fetches ahead of the step on a thread.
"""

from __future__ import annotations

import math
import queue
import threading
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch



def batch_dim(name: str, x) -> int:
    """The dim of batch key ``name`` that holds its rows: 1 for M-RoPE
    ``positions`` (3, B, S), 0 for every other key (the reference's
    ``batch_specs`` and ``_split_micro`` key on the name)."""
    return 1 if name == "positions" and x.ndim == 3 else 0


def batch_rows(name: str, x, lo: int, hi: int):
    """Rows [lo, hi) of batch key ``name`` (numpy or a tensor), cut at
    its ``batch_dim``."""
    return x[:, lo:hi] if batch_dim(name, x) == 1 else x[lo:hi]


class SyntheticLMDataset:
    """{"tokens": (B, S) int32, "labels": (B, S) int32} batches."""

    def __init__(self, vocab_size: int, seq_len: int, global_batch: int,
                 seed: int = 0, embed_dim: Optional[int] = None,
                 with_embeds: bool = False, mrope: bool = False):
        self.vocab_size = vocab_size
        self.seq_len = seq_len
        self.global_batch = global_batch
        self.seed = seed
        self.embed_dim = embed_dim
        self.with_embeds = with_embeds
        self.mrope = mrope

    def _rows(self, step: int, lo: int, hi: int) -> np.ndarray:
        """Rows [lo, hi) of the step's global batch."""
        out = np.empty((hi - lo, self.seq_len + 1), np.int32)
        for r in range(lo, hi):
            rng = np.random.default_rng(
                np.random.SeedSequence([self.seed, step, r]))
            base = rng.zipf(1.3, size=self.seq_len + 1) % self.vocab_size
            motif = rng.integers(0, self.vocab_size, size=8)
            pos = rng.integers(0, max(1, self.seq_len - 8),
                               size=max(1, self.seq_len // 32))
            for p in pos:
                base[p:p + 8] = motif
            out[r - lo] = base
        return out

    def host_batch(self, step: int) -> Dict[str, np.ndarray]:
        rows = self._rows(step, 0, self.global_batch)
        batch = {"tokens": rows[:, :-1], "labels": rows[:, 1:]}
        if self.with_embeds:
            rng = np.random.default_rng(
                np.random.SeedSequence([self.seed, step, 1 << 30]))
            emb = rng.standard_normal(
                (self.global_batch, self.seq_len, self.embed_dim),
                np.float32) * 0.02
            batch["inputs_embeds"] = emb
            if self.mrope:
                pos = np.broadcast_to(
                    np.arange(self.seq_len, dtype=np.int32),
                    (3, self.global_batch, self.seq_len)).copy()
                batch["positions"] = pos
        return batch

    def sharded_batch(self, step: int, mesh,
                      batch_axes: Sequence[str] = ("pod", "data")
                      ) -> List[Dict[str, torch.Tensor]]:
        """The step's global batch as each rank's rows on ``mesh``'s
        device, in rank order (``shard_batch``)."""
        return shard_batch(self.host_batch(step), mesh, batch_axes)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.host_batch(step)
            step += 1


def shard_batch(host: Dict[str, Any], mesh,
                batch_axes: Sequence[str] = ("pod", "data")
                ) -> List[Dict[str, torch.Tensor]]:
    """Rank r's rows of the global batch ``host`` (numpy arrays or
    tensors) for every rank of ``mesh``, on its device: the batch split
    over ``batch_axes`` (filtered to the mesh's axes) in row-major order
    of their coordinates, each key at its ``batch_dim``.  Ranks that
    differ only on other axes ("model") get the same tensors.  An
    abstract mesh (no device) leaves the rows where they are."""
    axes = [a for a in batch_axes if a in mesh.axis_names]
    shape = mesh.shape
    n = math.prod(shape[a] for a in axes)
    per = {}
    for k, v in host.items():
        rows = v.shape[batch_dim(k, v)]
        if rows % n:
            raise ValueError(f"{k}: {rows} rows do not split over {n} "
                             f"ranks of {tuple(axes)}")
        per[k] = rows // n
    slices: Dict[int, Dict[str, torch.Tensor]] = {}
    out = []
    for r in range(mesh.size):
        coords = mesh.coords(r)
        d = 0
        for a in axes:
            d = d * shape[a] + coords[a]
        if d not in slices:
            one = {}
            for k, v in host.items():
                x = batch_rows(k, v, d * per[k], (d + 1) * per[k])
                if isinstance(x, np.ndarray):
                    x = torch.from_numpy(np.ascontiguousarray(x))
                one[k] = x.to(mesh.device)
            slices[d] = one
        out.append(slices[d])
    return out


class Prefetcher:
    """Fetches ``fetch(step)`` for step = ``start_step``, +1, ... on a
    background thread, up to ``depth`` ahead of the consumer
    (``next(prefetcher)``).  An error of the fetch is raised in the
    consumer, in its place in the order; ``close()`` stops the thread
    and drains the queue."""

    def __init__(self, fetch: Callable[[int], Any], depth: int = 2,
                 start_step: int = 0):
        if depth < 1:
            raise ValueError(f"depth={depth}: prefetch at least one step")
        self._fetch = fetch
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._step = start_step
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="prefetch")
        self._thread.start()

    def _run(self):
        step = self._step
        while not self._stop.is_set():
            try:
                item = self._fetch(step)
            except Exception as e:           # surface in the consumer
                self._q.put(_Failed(e))
                return
            self._q.put(item)
            step += 1

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if isinstance(item, _Failed):
            raise item.error
        return item

    def close(self):
        self._stop.set()
        while self._thread.is_alive():
            self._drain()                    # unblock a waiting put
            self._thread.join(0.01)
        self._drain()

    def _drain(self):
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass


class _Failed:
    """An error of the fetch, queued in its step's place."""

    def __init__(self, error: Exception):
        self.error = error
