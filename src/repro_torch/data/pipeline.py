"""Deterministic synthetic data, pure in (seed, step, row).

Counterpart of ``repro.data.pipeline.SyntheticLMDataset`` (token
batches; the sharded-array and prefetch helpers arrive with later
slices).  ``host_batch`` is the reference's numpy code, so both packages
give byte-identical batches; a restart resumes mid-epoch with the same
data.  The token stream is a Zipf-ish mixture with local n-gram
structure, so losses fall during smoke training runs.  With
``with_embeds`` a batch also carries ``inputs_embeds`` (B, S,
``embed_dim``) f32 and, with ``mrope``, text ``positions`` (3, B, S),
as the reference's does.
"""

from __future__ import annotations

from typing import Dict, Iterator, Optional

import numpy as np


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

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.host_batch(step)
            step += 1
