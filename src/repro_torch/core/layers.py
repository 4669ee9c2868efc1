"""Tiered dispatch stack (paper §3): per-function layer assignment.

Counterpart of ``repro.core.layers``.  Each function sits at a layer
inversely related to its invocation frequency, minimizing the
frequency-weighted *average layer number*.  Tiers:

  L0  direct      — hot path: the selected protocol schedule, nothing else.
  L1  selected    — cost-model protocol selection indirection.
  L2  checked     — + argument validation, call/byte statistics, optional
                    finite-sanitizing op.
  L3  full        — + logging and a fence: the reference's optimization
                    barrier becomes a synchronize of the current CUDA
                    stream (correct for init/finalize/barrier/checkpoint
                    fences).
"""

from __future__ import annotations

import dataclasses
import logging
import threading
from collections import Counter
from typing import Callable, Dict, Mapping, Optional

import torch

from repro_torch.tree import map_tree

logger = logging.getLogger("repro_torch.engine")

#: the conventional stack puts every function at this depth (Fig 1-A).
CONVENTIONAL_TIER = 2

TIER_NAMES = ("L0:direct", "L1:selected", "L2:checked", "L3:full")


@dataclasses.dataclass(frozen=True)
class TierPolicy:
    """Frequency thresholds for tier assignment: freq >= thresholds[i]
    places the function at tier i; below all thresholds -> deepest tier."""

    thresholds: tuple = (1e6, 1e4, 1e2)

    def tier_of(self, freq: float) -> int:
        for i, t in enumerate(self.thresholds):
            if freq >= t:
                return i
        return len(self.thresholds)


def assign_tiers(frequencies: Mapping[str, float],
                 policy: TierPolicy | None = None) -> Dict[str, int]:
    policy = policy or TierPolicy()
    return {fn: policy.tier_of(f) for fn, f in frequencies.items()}


def conventional_tiers(functions) -> Dict[str, int]:
    return {fn: CONVENTIONAL_TIER for fn in functions}


def average_layer_number(tiers: Mapping[str, int],
                         frequencies: Mapping[str, float]) -> float:
    """Paper §3 objective: Σ f_i · L_i / Σ f_i over invoked functions."""
    num = sum(frequencies[fn] * tiers[fn] for fn in frequencies if fn in tiers)
    den = sum(frequencies[fn] for fn in frequencies if fn in tiers)
    return num / den if den else 0.0


class CommStats:
    """Statistics the checked tiers record (host-side, per call).

    ``phase_bytes`` attributes wire bytes to the two-phase split of the
    nonblocking collectives (``"<fn>.start"``, ``"<fn>.wait"``,
    ``"<fn>.progress"``), summed over the ranks; ``rank_phase_bytes[r]``
    is the share of rank r (as its caller names it), what a schedule's
    per-rank prediction compares with.  Ranks may share one engine, so
    every update takes a lock."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.calls: Counter = Counter()
        self.bytes: Counter = Counter()
        self.phase_bytes: Counter = Counter()
        self.rank_phase_bytes: Dict[int, Counter] = {}
        self.events: list = []

    def record(self, fn: str, nbytes: int) -> None:
        with self._lock:
            self.calls[fn] += 1
            self.bytes[fn] += nbytes

    def record_phase(self, fn: str, phase: str, nbytes: int,
                     rank: Optional[int] = None) -> None:
        """``rank``: the caller's rank in its mesh, None outside one."""
        with self._lock:
            self.phase_bytes[f"{fn}.{phase}"] += nbytes
            self.rank_phase_bytes.setdefault(
                rank, Counter())[f"{fn}.{phase}"] += nbytes

    def event(self, what: str) -> None:
        with self._lock:
            self.events.append(what)

    def summary(self) -> str:
        rows = [f"{fn:<22s} calls={self.calls[fn]:<6d} "
                f"bytes={self.bytes[fn]:,d}" for fn in sorted(self.calls)]
        return "\n".join(rows) if rows else "(no traffic recorded)"


def nbytes(x) -> int:
    return x.numel() * x.element_size() if isinstance(x, torch.Tensor) else 0


def _validate(fn_name: str, x, axis_name) -> None:
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"{fn_name}: expected a tensor, got {type(x)}")
    if axis_name is None:
        raise ValueError(f"{fn_name}: axis_name is required")


def fence(x):
    """The L3 fence: a synchronize of the current CUDA stream for a CUDA
    tensor (identity for values)."""
    if isinstance(x, torch.Tensor) and x.is_cuda:
        torch.cuda.current_stream(x.device).synchronize()
    return x


def tier_input(fn_name: str, tier: int, x, axis_name,
               stats: CommStats | None, sanitize: bool = False):
    """The input-side half of the L2/L3 stack: validation, stats, the
    optional finite-sanitize, and (L3) the event + input fence."""
    if tier <= 1:
        return x
    _validate(fn_name, x, axis_name)
    if stats is not None:
        stats.record(fn_name, nbytes(x))
    if sanitize:
        x = torch.where(torch.isfinite(x), x, torch.zeros_like(x))
    if tier >= 3:
        logger.debug("collective %s over axis %r: %d bytes",
                     fn_name, axis_name, nbytes(x))
        if stats is not None:
            stats.event(f"{fn_name}@{axis_name}")
        x = fence(x)
    return x


def tier_output(tier: int, y):
    """The output-side half of the L3 stack: a fence on every tensor of
    the result (impls may return (y, ef_state)).  Identity below L3."""
    if tier >= 3:
        if isinstance(y, tuple):
            return tuple(map_tree(fence, v) for v in y)
        return map_tree(fence, y)
    return y


def wrap_tier(fn_name: str, tier: int, impl: Callable,
              stats: CommStats | None, sanitize: bool = False) -> Callable:
    """Stack wrapper layers under ``impl`` according to the tier:
    ``tier_input`` -> schedule -> ``tier_output``."""
    if tier <= 1:
        return impl

    def wrapped(x, axis_name, **kw):
        x = tier_input(fn_name, tier, x, axis_name, stats,
                       sanitize=sanitize)
        return tier_output(tier, impl(x, axis_name, **kw))

    return wrapped
