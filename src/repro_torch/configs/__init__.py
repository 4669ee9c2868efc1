"""Config registry of the port.  Only the architectures the port runs are
registered; the rest of ``repro.configs`` arrives with later slices.

``get_config(arch_id)`` returns the full published config;
``get_config(arch_id, reduced=True)`` the test-sized variant of the same
family.  ``with_num_layers`` cuts depth and nothing else.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

from repro_torch.configs import (deepseek_v3_671b, granite_34b,
                                 mistral_large_123b, nemotron_4_340b,
                                 qwen2_72b, qwen3_moe_30b_a3b)

_MODULES = {m.ARCH_ID: m for m in (granite_34b, qwen2_72b,
                                    qwen3_moe_30b_a3b, mistral_large_123b,
                                    nemotron_4_340b, deepseek_v3_671b)}

ARCH_IDS: Tuple[str, ...] = tuple(_MODULES)


def get_config(arch_id: str, reduced: bool = False, param_dtype=None):
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {list(ARCH_IDS)}")
    module = _MODULES[arch_id]
    make = module.reduced if reduced else module.config
    return make() if param_dtype is None else make(param_dtype)


def with_num_layers(cfg, num_layers: int):
    """``cfg`` cut to its first ``num_layers`` layers: widths untouched,
    the last stages' ``repeat`` shortened (stages left empty are
    dropped).  deepseek-v3-671b at 4 layers keeps its 3 dense MLA layers
    and 1 MoE layer."""
    if not 1 <= num_layers <= cfg.num_layers:
        raise ValueError(
            f"num_layers={num_layers} outside 1..{cfg.num_layers}")
    stages, left = [], num_layers
    for st in cfg.stages:
        per = len(st.layers)
        if left < per:
            raise ValueError(
                f"num_layers={num_layers} splits a stage pattern of {per}")
        repeat = min(st.repeat, left // per)
        if repeat:
            stages.append(dataclasses.replace(st, repeat=repeat))
        left -= repeat * per
    if left:
        raise ValueError(f"num_layers={num_layers} not a stage boundary")
    return dataclasses.replace(cfg, stages=tuple(stages))


__all__ = ["ARCH_IDS", "get_config", "with_num_layers"]
