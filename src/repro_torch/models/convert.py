"""Carry a ``repro`` params tree into the port.

``params_from_numpy`` takes the JAX package's params as a tree of numpy
arrays (after ``jax.device_get``) and returns the port's params, so both
packages compute the same function from the same weights.  The tree
layouts are the same by construction (stacked per stage, ``(in, out)``
weights); every leaf is checked against the port's own shapes.  It
always returns the full tree: a model-parallel rank gets its shard from
``Model.shard`` (which ``trainer.init_states`` calls).

An ``EncDecCfg`` carries the encoder-decoder's tree (``embed``,
``encoder``, ``decoder``, ``enc_norm``, ``dec_norm``, ``lm_head``), and a
decoder with ``embed_inputs=False`` carries its tree without ``embed``.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.models import encdec as ED
from repro_torch.models import transformer as T
from repro_torch.tree import flatten, unflatten


def params_from_numpy(tree: Dict[str, Any],
                      cfg: T.TransformerCfg | ED.EncDecCfg,
                      device="cuda") -> Dict[str, Any]:
    """numpy params tree -> port params on ``device``, each leaf in the
    dtype ``init_params`` gives it: ``cfg.param_dtype``, except a MoE
    router and a Mamba layer's ``A_log`` / ``D`` / ``dt_bias``, f32
    whatever the param dtype (as the reference's).  Raises
    on a missing, extra or misshapen leaf."""
    dev = resolve_device(device)
    init = (ED.init_params if isinstance(cfg, ED.EncDecCfg)
            else T.init_params)
    want, want_paths = flatten(init(None, cfg, torch.device("meta")))
    got, got_paths = flatten(tree)
    if got_paths != want_paths:
        raise ValueError(
            f"params tree differs from {cfg.name}'s: missing "
            f"{sorted(set(want_paths) - set(got_paths))}, extra "
            f"{sorted(set(got_paths) - set(want_paths))}")
    out = []
    for path, w, g in zip(want_paths, want, got):
        a = np.asarray(g)
        if tuple(a.shape) != tuple(w.shape):
            raise ValueError(f"{'/'.join(path)}: shape {a.shape}, "
                             f"expected {tuple(w.shape)}")
        t = torch.from_numpy(np.ascontiguousarray(a.astype(np.float32)))
        out.append(t.to(device=dev, dtype=w.dtype))
    return unflatten(want_paths, out)
