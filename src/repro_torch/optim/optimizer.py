"""Optimizers: AdamW, with global-norm clipping and a cosine schedule.

Counterpart of ``repro.optim.optimizer`` (AdamW; Adafactor arrives with
a later slice).  Same API: ``state = opt.init(params)``;
``params, state, metrics = opt.update(grads, state, params)``.  The
update runs in f32 whatever the param and state dtypes, in the
reference's operation order; the learning rate is computed in f32
tensors as the reference computes it in jnp.

The update writes the new params and moments INTO the tensors it is
given (the reference returns new trees), slice by slice, clipping each
slice's gradient as it goes: a replica of a large model then never holds
two copies of its params, moments or gradients, nor f32 temporaries of
more than one slice.  It runs under ``torch.no_grad``.

The update is elementwise (clipping aside), so it runs unchanged on
ZeRO-1's flat, padded per-rank chunks (``repro_torch.train.trainer``):
``init`` over the chunk leaves gives a rank its 1/p of the moments, and
``update(..., global_norm_fn=...)`` takes the norm the ranks computed
together.  Padding stays zero: a zero gradient moves a zero param by
nothing.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.tree import flatten, leaves, map_tree, unflatten

Params = Any


def cosine_schedule(base_lr: float, warmup: int, total: int,
                    min_ratio: float = 0.1) -> Callable:
    """step (int or tensor) -> f32 learning rate tensor."""
    def lr(step):
        step = torch.as_tensor(step, dtype=torch.float32, device="cpu")
        f32 = lambda v: torch.tensor(v, dtype=torch.float32)
        warm = base_lr * torch.minimum(step / max(warmup, 1), f32(1.0))
        frac = torch.clamp((step - warmup) / max(total - warmup, 1),
                           0.0, 1.0)
        cos = min_ratio + (1 - min_ratio) * 0.5 * (
            1 + torch.cos(f32(math.pi) * frac))
        return torch.where(step < warmup, warm, base_lr * cos)
    return lr


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in leaves(tree)))


def _clip_scale(max_norm: float, norm: torch.Tensor) -> torch.Tensor:
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)


def clip_by_global_norm(tree, max_norm: float, norm=None):
    n = global_norm(tree) if norm is None else norm
    scale = _clip_scale(max_norm, n)
    return map_tree(lambda g: (g.float() * scale).to(g.dtype), tree), n


@dataclasses.dataclass(frozen=True)
class AdamWCfg:
    lr: Callable | float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    state_dtype: Any = torch.float32


#: values updated at a time: the f32 temporaries of one slice, not of a
#: whole 302 M-value embedding, are alive at once
UPDATE_SLICE = 1 << 24


def _adamw_slice(cfg, p, g, m, v, bc1, bc2, lr, clip=None) -> None:
    """One slice of the update, written into ``p``, ``m`` and ``v``.
    Elementwise, so slicing changes no bit; the gradient is clipped in
    its own dtype first, as ``clip_by_global_norm`` does."""
    if clip is not None:
        g = (g.float() * clip).to(g.dtype)
    gf = g.float()
    mf = cfg.b1 * m.float() + (1 - cfg.b1) * gf
    vf = cfg.b2 * v.float() + (1 - cfg.b2) * gf * gf
    upd = (mf / bc1) / (torch.sqrt(vf / bc2) + cfg.eps)
    pf = p.float()
    pf = pf - lr * (upd + cfg.weight_decay * pf)
    p.copy_(pf)
    m.copy_(mf)
    v.copy_(vf)


@dataclasses.dataclass
class Optimizer:
    init: Callable[[Params], Any]
    update: Callable[..., Tuple[Params, Any, Dict[str, torch.Tensor]]]
    name: str = "adamw"


def _lr_at(lr, step) -> torch.Tensor:
    return lr(step) if callable(lr) else torch.tensor(lr,
                                                      dtype=torch.float32)


def make_adamw(cfg: AdamWCfg) -> Optimizer:
    def init(params):
        zeros = lambda p: torch.zeros(p.shape, dtype=cfg.state_dtype,
                                      device=p.device)
        return {"m": map_tree(zeros, params), "v": map_tree(zeros, params),
                "step": torch.zeros((), dtype=torch.int32)}

    @torch.no_grad()
    def update(grads, state, params, global_norm_fn=None):
        step = state["step"] + 1
        gnorm = (global_norm_fn or global_norm)(grads)
        if cfg.clip_norm:
            clip = _clip_scale(cfg.clip_norm, gnorm)
        t = step.to(torch.float32)
        bc1 = 1 - torch.pow(torch.tensor(cfg.b1, dtype=torch.float32), t)
        bc2 = 1 - torch.pow(torch.tensor(cfg.b2, dtype=torch.float32), t)
        lr = _lr_at(cfg.lr, step)
        ps, paths = flatten(params)
        gs = flatten(grads)[0]
        ms, vs = flatten(state["m"])[0], flatten(state["v"])[0]
        for p, g, m, v in zip(ps, gs, ms, vs):
            dev = p.device
            consts = [x.to(dev) for x in (bc1, bc2, lr)] + (
                [clip.to(dev)] if cfg.clip_norm else [])
            # view: p, m, v are written through the slices
            pf, gf, mf, vf = p.view(-1), g.reshape(-1), m.view(-1), \
                v.view(-1)
            for lo in range(0, p.numel(), UPDATE_SLICE):
                sl = slice(lo, lo + UPDATE_SLICE)
                _adamw_slice(cfg, pf[sl], gf[sl], mf[sl], vf[sl], *consts)
        new_state = {"m": state["m"], "v": state["v"], "step": step}
        return unflatten(paths, ps), new_state, {"grad_norm": gnorm,
                                                 "lr": lr}

    return Optimizer(init=init, update=update, name="adamw")


def make_optimizer(name: str, **kwargs) -> Optimizer:
    if name == "adamw":
        return make_adamw(AdamWCfg(**kwargs))
    raise ValueError(f"optimizer {name!r}: only adamw is ported")
