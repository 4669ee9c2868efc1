"""Mixture-of-Experts of the port: token-choice top-k routing with static
capacity (counterpart of ``repro.models.moe``).

Dispatch is scatter-based, with the reference's arithmetic: routing
logits in f32 from an f32 router, the top k sorted descending,
positions inside each expert from a token-major cumsum over the
(T·k, E) assignment matrix, tokens beyond capacity dropped, and the
(E, C, D) expert buffers built with one indexed add per choice ``j``
(``index_add_`` into the flattened buffer; its backward, like the
gather's ``index_select``, is the other of the two).  A dropped choice
is clipped to slot ``C-1`` with a zero contribution, so the only
colliding adds add zeros: the buffer's bits do not depend on the order
the card's atomic adds land in.  The expert FFN is a batched product over
experts (the reference computes it outside any Pallas kernel; so does
the port, with ``torch.bmm``).

Three paths:
  - ``moe_forward``: one rank's tokens, every expert (serving, data-
    parallel training).
  - ``moe_forward_sharded``: the reference's ``moe_forward_shardmap``.
    Experts split over "model"; every model rank routes its data
    shard's tokens redundantly, runs its own experts, and the partial
    token outputs are summed over "model" (*g*, one all-reduce a
    layer).  The routed part enters through *f*, and so do the routing
    weights, so the router's gradient is whole on every model rank.
  - ``moe_forward_ep``: the reference's function of the same name, the
    expert buffers exchanged by an all-to-all (dispatch and combine),
    through ``comm.collectives`` (the composed session's planned
    protocol when one is installed).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.comm import collectives
from repro_torch.models import layers as L
from repro_torch.parallel import sharding as S

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class MoECfg:
    d_model: int
    d_ff: int                     # per-expert (routed) intermediate size
    num_experts: int
    top_k: int
    num_shared: int = 0           # deepseek-v3: 1 shared expert
    shared_d_ff: int = 0          # 0 -> d_ff
    capacity_factor: float = 1.25
    activation: str = "swiglu"
    scoring: str = "softmax"      # softmax | sigmoid (deepseek-v3)
    norm_topk: bool = True        # renormalize weights over the chosen k
    aux_loss_coef: float = 0.001
    #: the port's: the model ranks the experts split over (a model
    #: rank's local config; its params hold ``num_experts //
    #: expert_shards`` experts, its router all of them)
    expert_shards: int = 1


def _check(cfg: MoECfg) -> None:
    if cfg.activation != "swiglu":
        raise NotImplementedError(
            f"MoE activation {cfg.activation!r}: every MoE config of the "
            "reference is SwiGLU, the only one ported")
    if cfg.scoring not in ("softmax", "sigmoid"):
        raise ValueError(f"MoE scoring {cfg.scoring!r}")


def _shared_cfg(cfg: MoECfg) -> L.MLPCfg:
    sf = cfg.shared_d_ff or cfg.d_ff
    return L.MLPCfg(cfg.d_model, sf * cfg.num_shared, cfg.activation)


def init_moe(gen, cfg: MoECfg, dtype, device, lead: Tuple[int, ...] = ()
             ) -> Params:
    """The router is f32 whatever ``dtype`` (as the reference's) and
    scores every expert; the stacks hold this rank's experts."""
    _check(cfg)
    D, Fd, E = cfg.d_model, cfg.d_ff, cfg.num_experts // cfg.expert_shards
    p: Params = {
        "router": L.dense_init(gen, lead + (D, cfg.num_experts),
                               torch.float32, device),
        "w_gate": L.dense_init(gen, lead + (E, D, Fd), dtype, device),
        "w_up": L.dense_init(gen, lead + (E, D, Fd), dtype, device),
        "w_down": L.dense_init(gen, lead + (E, Fd, D), dtype, device),
    }
    if cfg.num_shared:
        p["shared"] = L.init_mlp(gen, _shared_cfg(cfg), dtype, device, lead)
    return p


def capacity_of(tokens: int, cfg: MoECfg) -> int:
    c = int(math.ceil(tokens * cfg.top_k / cfg.num_experts
                      * cfg.capacity_factor))
    return max(8, -(-c // 8) * 8)  # round up to 8, as the reference


def router_logits(x2d: torch.Tensor, router_w: torch.Tensor
                  ) -> torch.Tensor:
    """(T, D) -> (T, E) f32 logits."""
    return x2d.float() @ router_w.float()


def route_logits(logits: torch.Tensor, cfg: MoECfg, capacity: int):
    """The dispatch plan of (T, E) f32 logits: (expert_idx (T, k),
    weights (T, k) f32, pos (T, k), keep (T, k), aux)."""
    T = logits.shape[0]
    if cfg.scoring == "sigmoid":
        probs = torch.sigmoid(logits)
    else:
        probs = torch.softmax(logits, dim=-1)
    top_vals, top_idx = torch.topk(probs, cfg.top_k, dim=-1)  # descending
    if cfg.norm_topk:
        top_vals = top_vals / torch.clamp(
            top_vals.sum(dim=-1, keepdim=True), min=1e-9)

    # Position of each (token, choice) within its expert: token-major.
    flat = top_idx.reshape(-1)
    onehot = F.one_hot(flat, cfg.num_experts)               # (T*k, E)
    pos = torch.cumsum(onehot, dim=0).gather(1, flat[:, None])[:, 0] - 1
    keep = (pos < capacity).reshape(T, cfg.top_k)
    pos = pos.reshape(T, cfg.top_k)

    # Switch-style load-balance auxiliary loss.
    me = torch.softmax(logits, dim=-1).mean(dim=0)          # (E,)
    ce = F.one_hot(top_idx[:, 0], cfg.num_experts).float().mean(dim=0)
    aux = cfg.aux_loss_coef * cfg.num_experts * torch.sum(me * ce)
    return top_idx, top_vals, pos, keep, aux


def route(x2d: torch.Tensor, router_w: torch.Tensor, cfg: MoECfg,
          capacity: int):
    """x2d: (T, D) -> (expert_idx, weights, pos, keep, aux), as the
    reference's ``route``."""
    return route_logits(router_logits(x2d, router_w), cfg, capacity)


def _expert_ffn(params: Params, buf: torch.Tensor) -> torch.Tensor:
    """buf: (E, C, D) -> (E, C, D), batched over the experts that
    ``params`` holds (SwiGLU)."""
    g = torch.bmm(buf, params["w_gate"])
    u = torch.bmm(buf, params["w_up"])
    return torch.bmm(F.silu(g) * u, params["w_down"])


def _dispatch(x2d, rows, masks, n_experts: int, capacity: int):
    """(n_experts, capacity, D) buffers: one indexed add per choice of
    each token, into row ``expert * capacity + slot`` of the flattened
    buffer, its contribution zeroed where its mask is unset.  (An add,
    not an assignment: a dropped choice shares slot ``C-1`` with the
    token kept there.)"""
    d = x2d.shape[-1]
    buf = x2d.new_zeros((n_experts * capacity, d))
    for r, m in zip(rows, masks):
        buf.index_add_(0, r, x2d * m[:, None].to(x2d.dtype))
    return buf.view(n_experts, capacity, d)


def _combine(out_buf, rows, masks, weights):
    """Each token's outputs gathered per choice, weighted and summed in
    choice order, in the activations' dtype."""
    flat = out_buf.reshape(-1, out_buf.shape[-1])
    y = flat.new_zeros((rows[0].shape[0], flat.shape[-1]))
    for j, (r, m) in enumerate(zip(rows, masks)):
        g = flat.index_select(0, r) * m[:, None].to(flat.dtype)
        y = y + g * weights[:, j:j + 1].to(flat.dtype)
    return y


def moe_forward(params: Params, cfg: MoECfg, x: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (out, aux loss): every expert on this rank's
    tokens.  Under a ``StagedBackward`` (a step split over "data") the
    input and the logits are cut, as ``moe_forward_sharded`` cuts them:
    the aux loss reaches the loss apart from the layer's output."""
    _check(cfg)
    b, s, d = x.shape
    x = S.cut(x)
    x2d = x.reshape(-1, d)
    C = capacity_of(x2d.shape[0], cfg)
    logits = S.cut(router_logits(x2d, params["router"]))
    top_idx, top_vals, pos, keep, aux = route_logits(logits, cfg, C)
    rows = top_idx * C + pos.clamp(0, C - 1)          # (T, k)
    rows = [rows[:, j] for j in range(cfg.top_k)]
    masks = [keep[:, j] for j in range(cfg.top_k)]
    buf = _dispatch(x2d, rows, masks, cfg.num_experts, C)
    out_buf = _expert_ffn(params, buf)
    y = _combine(out_buf, rows, masks, top_vals)
    if cfg.num_shared:
        y = y + L.mlp_forward(params["shared"], _shared_cfg(cfg), x2d)
    return y.reshape(b, s, d), aux


def moe_apply(params: Params, cfg: MoECfg, x: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The transformer layer's entry: a config whose experts split over
    model ranks (``expert_shards`` > 1, a model rank's local config)
    runs ``moe_forward_sharded``, any other ``moe_forward``."""
    if cfg.expert_shards > 1:
        return moe_forward_sharded(params, cfg, x)
    return moe_forward(params, cfg, x)


def moe_forward_sharded(params_local: Params, cfg: MoECfg, x: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Experts split over "model" (the reference's
    ``moe_forward_shardmap``), called on every model rank with the same
    ``x`` (B, S, D): the rank's data shard of normed activations, and
    ``params_local`` holding E/m experts (block ``model_index()``; m =
    ``cfg.expert_shards``), the router and any shared expert whole.

    Each rank routes every token (the same plan on every rank), scatters
    the choices that land on its experts into a local (E/m, C, D)
    buffer, runs its experts, gathers and weights locally, and *g* sums
    the partial outputs over "model".  Gradients: the routed part enters
    through *f*, its input and its routing weights alike, so their
    gradients are summed over "model"; the router, the aux loss and a
    shared expert sit outside that region and get whole gradients on
    every rank.  Under a ``StagedBackward`` the input and the logits are
    cut, so each segment of the backward runs its nodes once."""
    _check(cfg)
    b, s, d = x.shape
    e_loc = cfg.num_experts // cfg.expert_shards
    e_lo = S.model_index() * e_loc
    x = S.cut(x)
    x2d = x.reshape(-1, d)
    C = capacity_of(x2d.shape[0], cfg)
    logits = S.cut(router_logits(x2d, params_local["router"]))
    top_idx, top_vals, pos, keep, aux = route_logits(logits, cfg, C)
    xin = S.copy_to_model(x).reshape(-1, d)
    weights = S.copy_to_model(top_vals)
    posc = pos.clamp(0, C - 1)
    rows, masks = [], []
    for j in range(cfg.top_k):
        e = top_idx[:, j]
        masks.append((e >= e_lo) & (e < e_lo + e_loc) & keep[:, j])
        rows.append((e - e_lo).clamp(0, e_loc - 1) * C + posc[:, j])
    buf = _dispatch(xin, rows, masks, e_loc, C)
    out_buf = _expert_ffn(params_local, buf)
    y = S.reduce_from_model(_combine(out_buf, rows, masks, weights))
    if cfg.num_shared:
        y = y + L.mlp_forward(params_local["shared"], _shared_cfg(cfg), x2d)
    return y.reshape(b, s, d), aux


def moe_forward_ep(params_local: Params, cfg: MoECfg, x: torch.Tensor, *,
                   axis: str, ep_size: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Expert parallelism by all-to-all (the reference's
    ``moe_forward_ep``), called on every rank of ``axis``: ``x`` is the
    rank's token shard (B_loc, S, D), ``params_local`` its E/ep_size
    experts and the whole router.  The (E, C, D) buffers are dispatched
    to (E/p, p·C, D) and combined back by ``collectives.all_to_all``
    (tiled ``lax.all_to_all`` semantics), so an installed composed
    session runs its planned protocol; the reference takes the exchange
    as an argument, which its engine binds the same way."""
    _check(cfg)
    b, s, d = x.shape
    x2d = x.reshape(-1, d)
    T = x2d.shape[0]
    C = capacity_of(T, cfg)
    if cfg.num_experts % ep_size:
        raise ValueError(f"{cfg.num_experts} experts do not split over "
                         f"{ep_size} ranks")
    top_idx, top_vals, pos, keep, aux = route(
        x2d, params_local["router"], cfg, C)

    flat_row = (top_idx * C + pos.clamp(0, C - 1)).reshape(-1)
    flat_keep = keep.reshape(-1)
    contrib = (x2d.repeat_interleave(cfg.top_k, dim=0)
               * flat_keep[:, None].to(x.dtype))
    buf = x.new_zeros((cfg.num_experts * C, d)).index_add_(0, flat_row,
                                                           contrib)
    buf = buf.view(cfg.num_experts, C, d)

    # Dispatch: (E, C, D) -> (E/p, p*C, D); combine: the inverse.
    buf = collectives.all_to_all(buf, axis, 0, 1)
    out_buf = collectives.all_to_all(_expert_ffn(params_local, buf), axis,
                                     1, 0)

    gathered = (out_buf.reshape(-1, d).index_select(0, flat_row)
                * flat_keep[:, None].to(x.dtype))
    weighted = (gathered.reshape(T, cfg.top_k, d)
                * top_vals[..., None].to(x.dtype))
    y = weighted.sum(dim=1)
    if cfg.num_shared:
        y = y + L.mlp_forward(params_local["shared"], _shared_cfg(cfg), x2d)
    return y.reshape(b, s, d), aux
