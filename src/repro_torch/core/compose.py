"""Dynamic composition (paper §2): build the thin per-application library.

Given the traced function set 𝓕 and the basic blocks F_1..F_n, find the
minimum number m of blocks whose union covers 𝓕 (paper: "m is such a
minimum number that 𝓕 ⊆ F_i1 ∪ … ∪ F_im").  n is small (≤ 20), so we
solve the set cover exactly with a bitmask DP; a greedy fallback guards
pathological partitions.  The composed library is the input to engine
construction: one application ↔ one engine.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, FrozenSet, Iterable, Mapping, Sequence, Tuple

from repro_torch.core import registry


class NotComposedError(AttributeError):
    """Raised when an application calls a collective outside its composed
    library — the function simply is not in the thin library (paper §2.1:
    functions not invoked are absent)."""


@dataclasses.dataclass(frozen=True)
class ComposedLibrary:
    """The thin library: minimal block cover of the application's 𝓕."""

    functions: FrozenSet[str]        # 𝓕 — what the application invokes
    blocks: Tuple[str, ...]          # F_{i1}..F_{im} — the chosen cover
    provided: FrozenSet[str]         # union of chosen blocks (⊇ functions)

    @property
    def m(self) -> int:
        return len(self.blocks)

    def supports(self, fn: str) -> bool:
        return fn in self.provided

    def require(self, fn: str) -> None:
        if fn not in self.provided:
            raise NotComposedError(
                f"'{fn}' is not part of this application's composed library "
                f"(blocks={list(self.blocks)}; provided="
                f"{sorted(self.provided)}). Re-compose with the function in "
                f"the traced set, or use the monolithic engine."
            )

    def describe(self) -> str:
        return (
            f"ComposedLibrary(m={self.m}, blocks={list(self.blocks)}, "
            f"|F|={len(self.functions)}, |provided|={len(self.provided)})"
        )


def _exact_cover(universe: FrozenSet[str],
                 blocks: Mapping[str, FrozenSet[str]]) -> Tuple[str, ...]:
    """Exact minimum set cover via breadth over cover sizes (n ≤ ~20)."""
    names = sorted(blocks)
    useful = [b for b in names if blocks[b] & universe]
    for m in range(0, len(useful) + 1):
        for combo in itertools.combinations(useful, m):
            covered = frozenset().union(*(blocks[b] for b in combo)) if combo \
                else frozenset()
            if universe <= covered:
                return tuple(combo)
    raise ValueError(
        f"function set {sorted(universe)} is not coverable by blocks "
        f"{names} — registry partition is incomplete"
    )


def _greedy_cover(universe: FrozenSet[str],
                  blocks: Mapping[str, FrozenSet[str]]) -> Tuple[str, ...]:
    remaining = set(universe)
    chosen = []
    while remaining:
        best = max(blocks, key=lambda b: (len(blocks[b] & remaining), -len(blocks[b])))
        gain = blocks[best] & remaining
        if not gain:
            raise ValueError(f"uncoverable functions: {sorted(remaining)}")
        chosen.append(best)
        remaining -= gain
    return tuple(sorted(chosen))


def compose(functions: Iterable[str],
            blocks: Mapping[str, FrozenSet[str]] | None = None,
            exact: bool = True) -> ComposedLibrary:
    """Build the thin library for an application's traced function set."""
    fns = frozenset(functions)
    unknown = fns - set(registry.ALL_FUNCTIONS)
    if unknown:
        raise KeyError(f"unknown collective functions: {sorted(unknown)}")
    blocks = dict(blocks if blocks is not None else registry.BLOCKS)
    if exact and len(blocks) <= 20:
        chosen = _exact_cover(fns, blocks)
    else:
        chosen = _greedy_cover(fns, blocks)
    provided = frozenset().union(*(blocks[b] for b in chosen)) if chosen \
        else frozenset()
    return ComposedLibrary(functions=fns, blocks=chosen, provided=provided)


def compose_from_trace(report, extra: Sequence[str] = ()) -> ComposedLibrary:
    """Compose from a TraceReport.  ``extra`` adds functions the runtime
    needs but the scan of the step cannot see (init/finalize/barrier live
    outside the step; every real application needs F_setup)."""
    fns = set(report.function_set)
    fns.update(extra)
    fns.update({registry.INIT, registry.FINALIZE})
    return compose(fns)
