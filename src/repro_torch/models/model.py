"""``Model``: the serving API over the decoder stack (counterpart of
``repro.models.model``).

  init / abstract_params / param_count          — parameters
  loss                                          — training
  init_caches / prefill / prefill_chunk / decode_step — serving

Prefill and decode write the caches they are given in place (see
``repro_torch.models.layers``) and return them.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.models import transformer as T
from repro_torch.tree import leaves

Params = Dict[str, Any]


@dataclasses.dataclass
class Model:
    cfg: T.TransformerCfg

    @property
    def name(self) -> str:
        return self.cfg.name

    # -- parameters -----------------------------------------------------

    def init(self, generator: torch.Generator) -> Params:
        """Random params on the generator's device."""
        return T.init_params(generator, self.cfg, generator.device)

    def abstract_params(self) -> Params:
        """Params as ``meta`` tensors: shapes and dtypes, no memory."""
        return T.init_params(None, self.cfg, torch.device("meta"))

    def param_count(self) -> int:
        return sum(math.prod(t.shape) for t in leaves(self.abstract_params()))

    # -- training ---------------------------------------------------------

    def loss(self, params: Params, batch: Dict[str, torch.Tensor]
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """(scalar f32 loss, metrics) of a {"tokens", "labels"} batch,
        differentiable in ``params``."""
        return T.loss_fn(params, self.cfg, batch)

    # -- serving ----------------------------------------------------------

    def init_caches(self, batch: int, max_len: int, *,
                    dtype=torch.bfloat16, device="cuda") -> Params:
        return T.init_caches(self.cfg, batch, max_len, dtype,
                             resolve_device(device))

    def prefill(self, params: Params, batch: Dict[str, torch.Tensor],
                caches: Params) -> Tuple[torch.Tensor, Params]:
        """Fill the cache from a prompt; returns (last-position logits,
        caches)."""
        h, new_caches = T.forward(params, self.cfg, batch, caches=caches,
                                  q_offset=0)
        logits = T._unembed(params, self.cfg, h[:, -1:])
        return logits[:, 0], new_caches

    @property
    def supports_chunked_prefill(self) -> bool:
        """Every mixer of this slice (attention) has an absolute-position
        chunked prefill path."""
        return all(spec.mixer == "attn"
                   for st in self.cfg.stages for spec in st.layers)

    def prefill_chunk(self, params: Params, batch: Dict[str, torch.Tensor],
                      caches: Params, *, q_offset: int, valid_len: int,
                      last_index: int) -> Tuple[torch.Tensor, Params]:
        """One page-sized prefill chunk at ``q_offset``.  The chunk is
        right-padded to the page boundary; ``valid_len`` clamps the cache
        length counters so pad positions don't count, and ``last_index``
        (chunk-local) picks which position's logits to return —
        meaningful on the final chunk, where it is the prompt's last real
        token."""
        h, new_caches = T.forward(params, self.cfg, batch, caches=caches,
                                  q_offset=q_offset, chunked=True,
                                  valid_len=valid_len)
        logits = T._unembed(params, self.cfg,
                            h[:, last_index:last_index + 1])
        return logits[:, 0], new_caches

    def decode_step(self, params: Params, batch: Dict[str, torch.Tensor],
                    caches: Params) -> Tuple[torch.Tensor, Params]:
        """One token for every sequence.  batch: {"tokens": (B, 1)}."""
        h, new_caches = T.forward(params, self.cfg, batch, caches=caches,
                                  decode=True)
        logits = T._unembed(params, self.cfg, h)
        return logits[:, 0], new_caches


def build_model(cfg: T.TransformerCfg) -> Model:
    return Model(cfg=cfg)
