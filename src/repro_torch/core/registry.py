"""The collective function set and the basic blocks F_1..F_n (paper §2.2).

The paper divides "the set of all MPI functions into n subsets F_1..F_n
according to functionalities"; a dynamically composable library for an
application invoking function set 𝓕 is the minimal union of blocks covering
𝓕.  This module defines our function set (the collective vocabulary of a
training or serving step) and the blocks.  Counterpart of
``repro.core.registry``, unchanged.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, FrozenSet, Mapping, Tuple

# ---------------------------------------------------------------------------
# The function set.  Names double as CollectiveEngine method names.
# ---------------------------------------------------------------------------

ALL_REDUCE = "all_reduce"
REDUCE_SCATTER = "reduce_scatter"
ALL_GATHER = "all_gather"
ALL_TO_ALL = "all_to_all"
BROADCAST = "broadcast"
PERMUTE = "permute"              # p2p shift: pipeline send/recv analogue
SEND_RECV = "send_recv"          # explicit pair exchange
BARRIER = "barrier"
INIT = "init"
FINALIZE = "finalize"
COMPRESSED_ALL_REDUCE = "compressed_all_reduce"
CHECKPOINT_FENCE = "checkpoint_fence"
AXIS_INDEX = "axis_index"        # rank/size queries (MPI_Comm_rank/size)
AXIS_SIZE = "axis_size"

ALL_FUNCTIONS: Tuple[str, ...] = (
    INIT, FINALIZE, AXIS_INDEX, AXIS_SIZE, BARRIER,
    ALL_REDUCE, REDUCE_SCATTER, ALL_GATHER, ALL_TO_ALL, BROADCAST,
    PERMUTE, SEND_RECV,
    COMPRESSED_ALL_REDUCE, CHECKPOINT_FENCE,
)

# ---------------------------------------------------------------------------
# Basic blocks F_i ("toy building blocks", paper §2.2), grouped by
# functionality.  Every composable engine is a union of these.
# ---------------------------------------------------------------------------

BLOCKS: Dict[str, FrozenSet[str]] = {
    "F_setup": frozenset({INIT, FINALIZE, AXIS_INDEX, AXIS_SIZE}),
    "F_sync": frozenset({BARRIER, CHECKPOINT_FENCE}),
    "F_reduce": frozenset({ALL_REDUCE, REDUCE_SCATTER}),
    "F_gather": frozenset({ALL_GATHER, BROADCAST}),
    "F_exchange": frozenset({ALL_TO_ALL}),
    "F_pt2pt": frozenset({PERMUTE, SEND_RECV}),
    "F_feature": frozenset({COMPRESSED_ALL_REDUCE}),
}


def block_for(fn: str) -> Tuple[str, ...]:
    """All blocks containing ``fn`` (a function may appear in one block only
    in the current partition, but the API allows overlapping partitions)."""
    return tuple(name for name, fns in BLOCKS.items() if fn in fns)


def validate_partition() -> None:
    """The blocks must cover the full function set."""
    covered = frozenset().union(*BLOCKS.values())
    missing = set(ALL_FUNCTIONS) - covered
    if missing:
        raise ValueError(f"functions not covered by any block: {missing}")


validate_partition()

# ---------------------------------------------------------------------------
# Global invocation frequencies (paper §3): measured by tracing our own
# train/serve steps over the assigned architectures (see
# benchmarks/bench_layers.py which regenerates this table).  Relative
# weights; absolute scale is irrelevant for layer assignment.
# INIT/FINALIZE are invoked once per application; the hot collectives run
# once or more per layer per step.
# ---------------------------------------------------------------------------

DEFAULT_FREQUENCIES: Mapping[str, float] = {
    INIT: 1.0,
    FINALIZE: 1.0,
    CHECKPOINT_FENCE: 1e2,
    BARRIER: 1e2,
    AXIS_INDEX: 1e3,
    AXIS_SIZE: 1e3,
    BROADCAST: 1e3,
    SEND_RECV: 1e4,
    ALL_TO_ALL: 1e6,          # 2x per MoE layer per microbatch
    COMPRESSED_ALL_REDUCE: 1e6,
    PERMUTE: 1e6,             # every ring/pipeline step
    ALL_GATHER: 1e7,          # FSDP gather: per layer per microbatch
    REDUCE_SCATTER: 1e7,      # FSDP grad scatter
    ALL_REDUCE: 1e7,          # TP reductions: several per layer
}


@dataclasses.dataclass(frozen=True)
class FunctionInfo:
    name: str
    blocks: Tuple[str, ...]
    default_frequency: float

    @property
    def is_hot(self) -> bool:
        return self.default_frequency >= 1e6


def info(fn: str) -> FunctionInfo:
    if fn not in ALL_FUNCTIONS:
        raise KeyError(f"unknown collective function: {fn}")
    return FunctionInfo(
        name=fn,
        blocks=block_for(fn),
        default_frequency=DEFAULT_FREQUENCIES.get(fn, 1.0),
    )
