"""Config registry of the port: the reference's ten architectures, with
its family and shape metadata.

``get_config(arch_id)`` returns the full published config;
``get_config(arch_id, reduced=True)`` the test-sized variant of the same
family.  ``with_num_layers`` cuts depth and nothing else.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Tuple

from repro_torch.configs import (deepseek_v3_671b, granite_34b,
                                 jamba_1_5_large_398b, mamba2_1_3b,
                                 mistral_large_123b, nemotron_4_340b,
                                 qwen2_72b, qwen2_vl_7b, qwen3_moe_30b_a3b,
                                 seamless_m4t_large_v2)
from repro_torch.configs.shapes import SHAPE_NAMES, SHAPES, Shape, get_shape
from repro_torch.models.encdec import EncDecCfg

_MODULES = (granite_34b, qwen2_72b, qwen3_moe_30b_a3b, mistral_large_123b,
            nemotron_4_340b, deepseek_v3_671b, mamba2_1_3b,
            jamba_1_5_large_398b, qwen2_vl_7b, seamless_m4t_large_v2)


@dataclasses.dataclass(frozen=True)
class ArchInfo:
    arch_id: str
    family: str
    skip_shapes: Tuple[str, ...]
    uses_embeds: bool
    config: Callable
    reduced: Callable


ARCHS: Dict[str, ArchInfo] = {
    m.ARCH_ID: ArchInfo(
        arch_id=m.ARCH_ID, family=m.FAMILY, skip_shapes=m.SKIP_SHAPES,
        uses_embeds=m.USES_EMBEDS, config=m.config, reduced=m.reduced)
    for m in _MODULES
}

ARCH_IDS: Tuple[str, ...] = tuple(ARCHS)


def get_arch(arch_id: str) -> ArchInfo:
    if arch_id not in ARCHS:
        raise KeyError(f"unknown arch {arch_id!r}; known: {list(ARCHS)}")
    return ARCHS[arch_id]


def get_config(arch_id: str, reduced: bool = False, param_dtype=None):
    info = get_arch(arch_id)
    make = info.reduced if reduced else info.config
    return make() if param_dtype is None else make(param_dtype)


def cells(include_skipped: bool = False):
    """The reference's (arch, shape) dry-run cells, minus each arch's
    skipped shapes (unless ``include_skipped``)."""
    for arch_id, info in ARCHS.items():
        for shape_name in SHAPE_NAMES:
            skipped = shape_name in info.skip_shapes
            if skipped and not include_skipped:
                continue
            yield arch_id, shape_name, skipped


def with_num_layers(cfg, num_layers: int):
    """``cfg`` cut to its first ``num_layers`` layers: widths untouched.
    Whole repeats of each stage are kept while they fit; a cut inside a
    stage's pattern keeps one more stage of repeat 1 holding the
    pattern's first layers (jamba-1.5-large-398b at 4 layers:
    ``attn+dense``, ``mamba+moe``, ``mamba+dense``, ``mamba+moe``).
    deepseek-v3-671b at 4 layers keeps its 3 dense MLA layers and 1 MoE
    layer.  An encoder-decoder config (``EncDecCfg``) is not cut."""
    if isinstance(cfg, EncDecCfg):
        raise ValueError(f"{cfg.name}: with_num_layers cuts a decoder's "
                         "stages; an encoder-decoder config has none")
    if not 1 <= num_layers <= cfg.num_layers:
        raise ValueError(
            f"num_layers={num_layers} outside 1..{cfg.num_layers}")
    stages, left = [], num_layers
    for st in cfg.stages:
        if not left:
            break
        per = len(st.layers)
        repeat = min(st.repeat, left // per)
        if repeat:
            stages.append(dataclasses.replace(st, repeat=repeat))
            left -= repeat * per
        if left and repeat < st.repeat and left < per:
            stages.append(dataclasses.replace(st, layers=st.layers[:left],
                                              repeat=1))
            left = 0
    return dataclasses.replace(cfg, stages=tuple(stages))


__all__ = ["ARCHS", "ARCH_IDS", "ArchInfo", "SHAPES", "SHAPE_NAMES",
           "Shape", "cells", "get_arch", "get_config", "get_shape",
           "with_num_layers"]
