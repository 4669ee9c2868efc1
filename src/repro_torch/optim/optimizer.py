"""Optimizers: AdamW and Adafactor, with global-norm clipping and a
cosine schedule.

Counterpart of ``repro.optim.optimizer``.  Same API: ``state =
opt.init(params)``; ``params, state, metrics = opt.update(grads, state,
params)``.  The update runs in f32 whatever the param and state dtypes,
in the reference's operation order; the learning rate is computed in
f32 tensors as the reference computes it in jnp.  Adafactor's state is
the reference's tree (``{"f": <per param {"vr", "vc"} or {"v"}>,
"step"}``, all f32), so checkpoints cross.

The update writes the new params and moments INTO the tensors it is
given (the reference returns new trees), slice by slice, clipping each
slice's gradient as it goes: a replica of a large model then never holds
two copies of its params, moments or gradients, nor f32 temporaries of
more than one slice.  It runs under ``torch.no_grad``.  Adafactor's
means and its update-RMS clip span a whole leaf (one layer of it where
the reference's ``_map_leading`` maps the leaf), so it reads each
leaf's gradient in three passes of slices: the factored means, the
update's sum of squares, and the update itself, clipped.  Its sums run
in another order than the reference's: params and state agree to f32
rounding, not bit for bit.

AdamW's update is elementwise (clipping aside), so it runs unchanged on
ZeRO-1's flat, padded per-rank chunks (``repro_torch.train.trainer``):
``init`` over the chunk leaves gives a rank its 1/p of the moments, and
``update(..., global_norm_fn=...)`` takes the norm the ranks computed
together.  Adafactor runs on the chunks as the reference's runs inside
its ``shard_map``: 1-D chunks take the unfactored branch, and the RMS
clip is over the rank's chunk.  Padding stays zero: a zero gradient
moves a zero param by nothing.

With a "model" axis each rank updates its block of a split leaf, and
Adafactor's reductions over a split dim must span the whole leaf:
``update(..., split_sum=fn)`` takes the trainer's hook,
``fn(i, x, over, n) -> (sum, count)``, which sums a partial ``x`` of
leaf ``i``'s reduction over its columns (``over="cols"``), rows
(``"rows"``) or all of it (``"all"``) across the ranks holding the
other blocks of that dim, and gives the count of values the sum spans,
``n`` of them this rank's (``n`` where nothing crosses), or over a clip
group of leading slices this model rank owns (``"own"``: a sum over the
axes other than "model" that split the leaf, the ``auto`` step's "data");
ZeRO-1 over "model" passes a hook of its own
(``train.trainer.make_train_step``),
whose "all" spans the reference's chunk, of which each model rank holds
a piece; ``update(..., lead_blocks=fn)`` says into how many
blocks ``fn(i, ndim)`` leaf ``i``'s leading dim is cut.  The clip groups
of a leaf follow its whole leading dim, as the reference's
``_map_leading`` sees it: an expert stack of 8 cut in two is still
clipped one expert at a time, each rank its own experts.  AdamW has no
such reduction and ignores both.
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


def sum_of_squares(x: torch.Tensor) -> torch.Tensor:
    """The f32 sum of squares of ``x``; a leaf of more than
    ``UPDATE_SLICE`` values is summed slice by slice, so no f32
    temporary of the whole leaf is made (a 3.2 B-value expert stack's
    would be 12.9 GB)."""
    flat = x.reshape(-1)
    if flat.numel() <= UPDATE_SLICE:
        return torch.sum(torch.square(x.float()))
    return sum(torch.sum(torch.square(flat[lo:lo + UPDATE_SLICE].float()))
               for lo in range(0, flat.numel(), UPDATE_SLICE))


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(sum_of_squares(x) for x in leaves(tree)))


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
#: the reference's ``_map_leading`` threshold: Adafactor updates a leaf
#: of ndim >= 3 whose leading (stacked-layers) dim exceeds it one leading
#: slice at a time, each slice with its own means and RMS clip
MAP_LEADING = 4


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
    def update(grads, state, params, global_norm_fn=None, split_sum=None,
               lead_blocks=None):
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


# ---------------------------------------------------------------------------
# Adafactor
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AdafactorCfg:
    lr: Callable | float = 1e-2
    decay: float = 0.8                  # beta2(t) = 1 - t^-decay
    eps: float = 1e-30
    clip_threshold: float = 1.0         # update RMS clip (per tensor)
    weight_decay: float = 0.0
    clip_norm: float = 0.0              # 0 = rely on update clipping
    min_dim_factored: int = 128         # don't factor tiny tensors


def _factored(shape, min_dim: int = 128) -> bool:
    return len(shape) >= 2 and shape[-1] >= min_dim and shape[-2] >= min_dim


def clip_groups(shape, lead_blocks: int = 1) -> int:
    """The leaf's clip groups on this rank: its leading slices where the
    reference's ``_map_leading`` maps the whole leaf (whose leading dim
    is ``lead_blocks`` of this block's), else 1 (the whole leaf)."""
    mapped = len(shape) >= 3 and shape[0] * lead_blocks > MAP_LEADING
    return shape[0] if mapped else 1


def _spans(outer: int, inner: int, width: int):
    """Slices (over ``outer``, over ``inner``) of a leaf viewed as
    ``(outer, inner, width)`` that cover it with at most about
    UPDATE_SLICE values each: whole ``outer`` items together where one
    is small, else one item in runs of ``inner``."""
    per = inner * width
    if per <= UPDATE_SLICE:
        k = max(1, UPDATE_SLICE // per)
        return [(slice(o, o + k), slice(None)) for o in range(0, outer, k)]
    step = max(1, UPDATE_SLICE // width)
    return [(slice(o, o + 1), slice(i, i + step)) for o in range(outer)
            for i in range(0, inner, step)]


def _local_sum(x, over, n):
    return x, n


class _AdafactorLeaf:
    """One leaf's Adafactor update, in place, in the reference's
    arithmetic; ``reduce(x, over)`` is the leaf's model-axis hook, and
    its leading dim is ``lead_blocks`` of this block's."""

    def __init__(self, cfg, beta2, lr, clip, reduce, lead_blocks=1):
        self.cfg, self.beta2, self.lr, self.clip = cfg, beta2, lr, clip
        self.reduce, self.lead_blocks = reduce, lead_blocks

    def groups(self, shape) -> Tuple[int, bool]:
        """(the leaf's clip groups here, whether each is this rank's own:
        leading slices of a leading dim split over "model")."""
        G = clip_groups(shape, self.lead_blocks)
        return G, G > 1 and self.lead_blocks > 1

    def grad(self, g):
        """f32 gradient of a slice, clipped in its own dtype first, as
        ``clip_by_global_norm`` does."""
        if self.clip is not None:
            g = (g.float() * self.clip).to(g.dtype)
        return g.float()

    def clip_div(self, sq, n, own=False):
        """Each group's ``max(1, rms / clip_threshold)`` from its sum of
        squares ``sq`` over ``n`` values a block, summed over the ranks
        holding the group's other blocks (``"own"``: the group is this
        model rank's own, its leading slices; other axes may still split
        it)."""
        sq, count = self.reduce(sq, "own" if own else "all", n)
        rms = torch.sqrt(sq / count + 1e-30)
        return torch.clamp(rms / self.cfg.clip_threshold, min=1.0)

    def apply(self, p, u):
        pf = p.float()
        pf = pf - self.lr * (u + self.cfg.weight_decay * pf)
        p.copy_(pf)

    def factored(self, p, g, vr, vc):
        cfg, beta2, eps = self.cfg, self.beta2, self.cfg.eps
        R, C = p.shape[-2:]
        M = p.numel() // (R * C)            # the leaf's matrices
        G, own = self.groups(p.shape)
        pm, gm = p.view(M, R, C), g.reshape(M, R, C)
        vrm, vcm = vr.view(M, R), vc.view(M, C)
        spans = _spans(M, R, C)
        row, col = torch.empty_like(vrm), torch.zeros_like(vcm)
        for ms, rs in spans:
            gf = self.grad(gm[ms, rs])
            g2 = gf * gf + eps
            row[ms, rs] = g2.sum(-1)
            col[ms] += g2.sum(-2)
        row, cols = self.reduce(row, "cols", C)
        col, rows = self.reduce(col, "rows", R)
        vrm.copy_(beta2 * vrm + (1 - beta2) * (row / cols))
        vcm.copy_(beta2 * vcm + (1 - beta2) * (col / rows))
        vsum, _ = self.reduce(vrm.sum(-1), "rows", R)
        norm = torch.sqrt(torch.clamp(vsum / rows, min=eps))
        r_inv = torch.rsqrt(torch.clamp(vrm, min=eps))
        c_inv = torch.rsqrt(torch.clamp(vcm, min=eps))

        def upd(ms, rs):
            return (self.grad(gm[ms, rs]) * r_inv[ms, rs, None]
                    * c_inv[ms, None, :] * norm[ms, None, None])

        sq = torch.zeros(M, dtype=torch.float32, device=p.device)
        for ms, rs in spans:
            sq[ms] += upd(ms, rs).square().sum((-2, -1))
        div = self.clip_div(sq.view(G, M // G).sum(1), p.numel() // G, own)
        div = div.repeat_interleave(M // G)
        for ms, rs in spans:
            self.apply(pm[ms, rs], upd(ms, rs) / div[ms, None, None])

    def unfactored(self, p, g, v):
        beta2, eps = self.beta2, self.cfg.eps
        G, own = self.groups(p.shape)
        n = p.numel() // G
        pm, gm, vm = p.view(G, n), g.reshape(G, n), v.view(G, n)
        spans = _spans(G, n, 1)
        sq = torch.zeros(G, dtype=torch.float32, device=p.device)
        for gs, es in spans:
            gf = self.grad(gm[gs, es])
            vf = beta2 * vm[gs, es] + (1 - beta2) * (gf * gf + eps)
            vm[gs, es] = vf
            sq[gs] += (gf * torch.rsqrt(torch.clamp(vf, min=eps))
                       ).square().sum(-1)
        div = self.clip_div(sq, n, own)
        for gs, es in spans:
            u = self.grad(gm[gs, es]) * torch.rsqrt(
                torch.clamp(vm[gs, es], min=eps))
            self.apply(pm[gs, es], u / div[gs, None])


def make_adafactor(cfg: AdafactorCfg) -> Optimizer:
    def init(params):
        def leaf(p):
            f32 = lambda shape: torch.zeros(shape, dtype=torch.float32,
                                            device=p.device)
            if _factored(p.shape, cfg.min_dim_factored):
                return {"vr": f32(p.shape[:-1]),
                        "vc": f32(p.shape[:-2] + p.shape[-1:])}
            return {"v": f32(p.shape)}
        return {"f": map_tree(leaf, params),
                "step": torch.zeros((), dtype=torch.int32)}

    @torch.no_grad()
    def update(grads, state, params, global_norm_fn=None, split_sum=None,
               lead_blocks=None):
        step = state["step"] + 1
        gnorm = (global_norm_fn or global_norm)(grads)
        t = step.to(torch.float32)
        beta2 = 1.0 - torch.pow(t, -cfg.decay)
        lr = _lr_at(cfg.lr, step)
        clip = _clip_scale(cfg.clip_norm, gnorm) if cfg.clip_norm else None
        ps, paths = flatten(params)
        gs = flatten(grads)[0]
        for i, (p, g, path) in enumerate(zip(ps, gs, paths)):
            s = _subtree(state["f"], path)
            dev = p.device
            reduce = (_local_sum if split_sum is None else
                      (lambda x, over, n, i=i: split_sum(i, x, over, n)))
            leaf = _AdafactorLeaf(cfg, beta2.to(dev), lr.to(dev),
                                  None if clip is None else clip.to(dev),
                                  reduce, 1 if lead_blocks is None else
                                  lead_blocks(i, p.ndim))
            if "vr" in s:
                leaf.factored(p, g, s["vr"], s["vc"])
            else:
                leaf.unfactored(p, g, s["v"])
        new_state = {"f": state["f"], "step": step}
        return unflatten(paths, ps), new_state, {"grad_norm": gnorm,
                                                 "lr": lr}

    return Optimizer(init=init, update=update, name="adafactor")


def _subtree(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def make_optimizer(name: str, **kwargs) -> Optimizer:
    if name == "adamw":
        return make_adamw(AdamWCfg(**kwargs))
    if name == "adafactor":
        return make_adafactor(AdafactorCfg(**kwargs))
    raise ValueError(f"unknown optimizer {name!r}")
