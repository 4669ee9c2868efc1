"""Tensor parallelism over the "model" axis: the explicit counterpart of
what GSPMD does for the reference.

The reference annotates every parameter with a ``PartitionSpec``
(``repro/models/layers.py``, ``repro/models/transformer.py``) and lets
XLA partition the step and insert its collectives.  The port has no
partitioner, so it states the same Megatron-style split explicitly:

- ``leaf_split`` — the dim of each parameter a model rank holds, from
  the reference's specs: ``wq``/``bq``/``w_gate``/``w_up``/``lm_head``
  split their output columns, ``wo``/``w_down`` their input rows,
  ``embed`` its vocabulary rows, norms (a LayerNorm's bias too) are
  replicated.  The two-matrix MLPs (GELU, squared ReLU) split ``w_up``
  by columns and ``w_down`` by rows.  MLA is refused (``layout``).
- A MoE layer splits its experts (``w_gate``/``w_up``/``w_down`` under
  ``moe``: dim -3 of the stacked ``(R, E, D, F)`` leaf), as the
  reference's ``moe_forward_shardmap`` does; its router and any shared
  expert are replicated (``models.moe.moe_forward_sharded``).
- Attention splits by whole heads.  The reference's
  ``fitted_shardings`` drops a spec entry whose dim does not divide; the
  port instead requires ``num_heads % model == 0`` and replicates
  ``wk``/``wv``/``bk``/``bv`` when ``num_kv_heads % model != 0``
  (granite-34b's MQA: one KV head).  That is a storage difference with
  the same math: each rank computes the shared K/V itself, and their
  gradients are partial sums that the trainer adds over "model"
  (``partial_sum_leaves``).
- ``shard_params`` / ``unshard_params`` give a rank's shard of a full
  parameter tree and gather the shards back; they take a whole train
  state too, whose AdamW moments and per-leaf EF residual mirror their
  parameter's split (a leaf's path ends in its parameter's path) and
  whose Adafactor statistics split as ``opt_leaf`` says.
  ``leaf_block`` / ``leaf_box`` are one leaf's block and its global box:
  the trainer's checkpoint layout (``train.trainer.gather_state``) is
  built from them.
- The two Megatron operators: *f* (``copy_to_model``: identity forward,
  all-reduce over "model" backward) and *g* (``reduce_from_model``:
  all-reduce forward, identity backward), as ``torch.autograd.Function``s.
  Their collectives go through ``comm.collectives``' default session,
  the monolithic one, as XLA inserts its own under GSPMD: the composed
  application session never sees them.

**The staged backward.**  The ranks are threads of one process, and
PyTorch's autograd engine runs every CUDA node of a process on one
worker thread per device, shared by all threads' graph tasks.  A
backward node that waits for a peer rank (*f*'s all-reduce) can so wait
for a node queued behind it on the same thread: on the card that is a
deadlock, which the transport's timeout turns into a ``RankFailure``
(``tools/probe_autograd_thread.py`` shows it).  So the trainer runs the
backward under ``StagedBackward``: in the forward, each *f* (and each
residual-stream boundary, ``cut``) detaches its input into a leaf; the
backward then runs segment by segment in reverse, and all-reduces each
*f* leaf's gradient over "model" on the rank thread between segments.
*g* and the vocab-parallel loss communicate only in the forward, which
runs on the rank thread.  Without an active tape *f* is the plain
autograd function, whose backward all-reduces inside the node: right on
the CPU, where each thread runs its own backward, and refused on CUDA.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.comm import collectives
from repro_torch.tree import flatten, unflatten

MODEL_AXIS = "model"

#: leaves split by their last dim (output columns; the vocabulary for
#: ``lm_head``) and by their second-to-last (input rows; the vocabulary
#: for ``embed``)
_COLUMN = ("wq", "bq", "w_gate", "w_up", "lm_head", "wk", "wv", "bk", "bv")
_ROW = ("wo", "w_down", "embed")
_KV = ("wk", "wv", "bk", "bv")
#: a MoE layer's expert stacks, split by expert
_EXPERT = ("w_gate", "w_up", "w_down")
#: qwen3's per-head q/k norms: each model rank's heads add to their
#: gradients
_HEAD_NORMS = ("q_norm", "k_norm")


@dataclasses.dataclass(frozen=True)
class TPLayout:
    """How one configuration splits over ``model`` ranks."""

    model: int
    heads: int              # query heads a rank holds
    kv_heads: int           # KV heads a rank holds (all when replicated)
    kv_replicated: bool
    d_ff: int               # FFN columns a rank holds (0: no dense FFN)
    vocab: int              # vocabulary rows a rank holds
    experts: int            # experts a rank holds (0: no MoE)


def layout(cfg, model: int) -> TPLayout:
    """The split of ``cfg`` (a ``TransformerCfg``) over ``model`` ranks.
    Raises where a whole-head, FFN, expert or vocabulary split does not
    divide, and for MLA, Mamba, a model without an embedding table and
    an encoder-decoder (an ``EncDecCfg``, which has no stages), whose
    splits are not ported."""
    if not hasattr(cfg, "stages"):
        raise NotImplementedError(
            f"{cfg.name}: an encoder-decoder over a \"model\" axis arrives "
            "with a later slice of the port (encoder, decoder and "
            "cross-attention heads split)")
    if not cfg.embed_inputs:
        raise NotImplementedError(
            f"{cfg.name}: a model without an embedding table over a "
            "\"model\" axis arrives with a later slice of the port (it has "
            "no vocab-parallel embedding; its inputs_embeds enter whole)")
    mixers = {spec.mixer for st in cfg.stages for spec in st.layers}
    if "mla" in mixers:
        raise NotImplementedError(
            f"{cfg.name}: MLA over a \"model\" axis arrives with a later "
            "slice of the port (its latent cache stays whole, its heads "
            "split)")
    if "mamba" in mixers:
        raise NotImplementedError(
            f"{cfg.name}: Mamba over a \"model\" axis arrives with a later "
            "slice of the port (its heads, conv channels and state split)")
    a = cfg.attn
    d_ff = 0 if cfg.mlp is None else cfg.mlp.d_ff
    experts = 0 if cfg.moe is None else cfg.moe.num_experts
    for what, n in (("num_heads", a.num_heads), ("d_ff", d_ff),
                    ("num_experts", experts),
                    ("vocab_size", cfg.vocab_size)):
        if n % model:
            raise ValueError(f"{cfg.name}: {what}={n} does not split over "
                             f"{model} model ranks")
    kv_rep = a.num_kv_heads % model != 0
    return TPLayout(model=model, heads=a.num_heads // model,
                    kv_heads=a.num_kv_heads if kv_rep
                    else a.num_kv_heads // model,
                    kv_replicated=kv_rep, d_ff=d_ff // model,
                    vocab=cfg.vocab_size // model,
                    experts=experts // model)


def leaf_split(path, lay: TPLayout) -> Optional[int]:
    """The dim (negative, from the end) of the leaf at ``path`` (in a
    params tree or a train state) that a model rank holds a block of, or
    None for a replicated leaf; an Adafactor statistic's as ``opt_leaf``
    says."""
    if path[0] == "opt" and path[1] == "f":
        return opt_leaf(path, lay)[1]
    name = path[-1]
    if lay.model == 1 or (name in _KV and lay.kv_replicated):
        return None
    if "moe" in path:         # the experts split; router, shared: whole
        return -3 if path[-2] == "moe" and name in _EXPERT else None
    if name in _COLUMN:
        return -1
    if name in _ROW:
        return -2
    return None


def opt_leaf(path, lay: Optional[TPLayout]
             ) -> Tuple[Tuple[Any, ...], Optional[int]]:
    """The optimizer-state leaf at ``path`` in a train state
    (``("opt", key, *param_path)`` of an AdamW moment, ``("opt", "f",
    *param_path, stat)`` of Adafactor's statistic, ``("opt", "step")``):
    its param's path and the dim (negative) of the leaf a model rank
    holds a block of, or None (always without a ``lay``).  An AdamW
    moment and Adafactor's ``v`` split as their param.  Adafactor's
    ``vr`` (the param without its last dim) and ``vc`` (without its
    second-to-last) keep the split dim where they keep it: ``vr`` of a
    column-split param is whole and of a row-split one split at -1,
    ``vc`` the other way round, and both of an expert stack (split at
    -3) split at -2."""
    if path[1] != "f":
        pp = tuple(path[2:])
        return pp, None if lay is None else leaf_split(path, lay)
    pp, stat = tuple(path[2:-1]), path[-1]
    d = None if lay is None else leaf_split(pp, lay)
    if d is None or stat == "v":
        return pp, d
    if d == -3:
        return pp, -2
    return pp, {("vr", -1): None, ("vr", -2): -1, ("vc", -1): -1,
                ("vc", -2): None}[stat, d]


def partial_sum_leaves(paths, lay: TPLayout) -> List[bool]:
    """Per leaf: is its gradient a partial sum over the model ranks?
    (the K/V projections replicated under MQA, and the per-head q/k
    norms: every rank's heads add to them).  Those are summed over
    "model", without a mean."""
    return [lay.model > 1 and ((lay.kv_replicated and p[-1] in _KV)
                               or (len(p) > 1 and p[-2] in _HEAD_NORMS))
            for p in paths]


def sharded_leaves(paths, lay: TPLayout) -> List[bool]:
    """Per leaf: does each model rank hold a different block of it?"""
    return [leaf_split(p, lay) is not None for p in paths]


def leaf_block(path, leaf: torch.Tensor, lay: TPLayout, index: int
               ) -> torch.Tensor:
    """Model rank ``index``'s block of the global ``leaf`` at ``path``
    (a view; the leaf itself when it is replicated)."""
    d = leaf_split(path, lay)
    return leaf if d is None else leaf.chunk(lay.model, dim=d)[index]


def leaf_box(path, shape, lay: TPLayout, index: int
             ) -> Tuple[Tuple[int, ...], List[List[int]]]:
    """(global shape, ``[[lo, hi], ...]`` per dim) of model rank
    ``index``'s block of the leaf at ``path``, ``shape`` being the
    block's (local) shape: one ``[lo, hi]`` along the split dim, every
    other dim whole."""
    shape = list(shape)
    box = [[0, n] for n in shape]
    d = leaf_split(path, lay)
    if d is not None:
        n = shape[d]
        shape[d] = n * lay.model
        box[d] = [index * n, (index + 1) * n]
    return tuple(shape), box


def shard_params(full: Dict[str, Any], lay: TPLayout, index: int
                 ) -> Dict[str, Any]:
    """Model rank ``index``'s shard of a full parameter tree (or train
    state), as contiguous copies: a block of every split leaf, every
    replicated leaf whole."""
    ls, paths = flatten(full)
    return unflatten(paths, [leaf_block(path, leaf, lay, index)
                             .contiguous().clone()
                             for path, leaf in zip(paths, ls)])


def unshard_params(shards: List[Dict[str, Any]], lay: TPLayout
                   ) -> Dict[str, Any]:
    """The full tree from the model ranks' shards (in model-rank order):
    split leaves concatenated, replicated (and partial-sum) leaves from
    rank 0."""
    per = [flatten(s) for s in shards]
    paths = per[0][1]
    out = []
    for i, path in enumerate(paths):
        d = leaf_split(path, lay)
        out.append(per[0][0][i] if d is None else
                   torch.cat([ls[i] for ls, _ in per], dim=d))
    return unflatten(paths, out)


# ---------------------------------------------------------------------------
# The Megatron operators and the staged backward
# ---------------------------------------------------------------------------

_local = threading.local()


def psum(x: torch.Tensor) -> torch.Tensor:
    """Sum over "model" through the monolithic default session."""
    return collectives.psum(x, MODEL_AXIS)


class _ReduceFromModel(torch.autograd.Function):
    """*g*: all-reduce over "model" forward, identity backward."""

    @staticmethod
    def forward(ctx, x):
        return psum(x)

    @staticmethod
    def backward(ctx, g):
        return g


class _CopyToModel(torch.autograd.Function):
    """*f*: identity forward, all-reduce over "model" backward (inside
    the autograd node: the thread-local CPU backward only)."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if g.is_cuda:
            raise RuntimeError(
                "a CUDA backward cannot all-reduce inside an autograd node "
                "(every rank thread's CUDA nodes share one engine thread); "
                "run it under sharding.StagedBackward")
        return psum(g)


def reduce_from_model(x: torch.Tensor) -> torch.Tensor:
    """*g* after a row-parallel product (and the vocab-parallel
    embedding): the sum of the model ranks' partials."""
    return _ReduceFromModel.apply(x)


def copy_to_model(x: torch.Tensor) -> torch.Tensor:
    """*f* ahead of a column-parallel product: under an active
    ``StagedBackward`` a recorded cut whose gradient is all-reduced
    between segments, else the autograd function."""
    tape = getattr(_local, "tape", None)
    if tape is not None:
        return tape.cut(x, reduce=True)
    return _CopyToModel.apply(x)


def cut(x: torch.Tensor) -> torch.Tensor:
    """A segment boundary of the staged backward with no reduction (the
    residual stream at each *f*); the identity without a tape."""
    tape = getattr(_local, "tape", None)
    return x if tape is None else tape.cut(x, reduce=False)


class StagedBackward:
    """The cuts of one forward and the backward that runs them in
    reverse.  ``with tape:`` makes it the calling thread's tape."""

    def __init__(self) -> None:
        self._cuts: List[Tuple[torch.Tensor, torch.Tensor, bool]] = []

    def __enter__(self) -> "StagedBackward":
        if getattr(_local, "tape", None) is not None:
            raise RuntimeError("a StagedBackward is already active")
        _local.tape = self
        return self

    def __exit__(self, *exc) -> None:
        _local.tape = None

    def cut(self, x: torch.Tensor, reduce: bool) -> torch.Tensor:
        if not x.requires_grad:
            return x
        leaf = x.detach().requires_grad_(True)
        self._cuts.append((x, leaf, reduce))
        return leaf

    def backward(self, loss: torch.Tensor) -> None:
        """Gradients of ``loss`` into the ``.grad`` of every leaf it
        depends on: the last segment from the loss, then each cut's
        segment in reverse order, its leaf's gradient complete (and, for
        an *f* cut, all-reduced over "model") before its segment runs."""
        loss.backward()
        while self._cuts:
            x, leaf, reduce = self._cuts.pop()
            g = leaf.grad
            if g is None:
                continue
            x.backward(psum(g) if reduce else g)


def vocab_parallel_embed(embed: torch.Tensor, tokens: torch.Tensor,
                         index: int) -> torch.Tensor:
    """Rows of this rank's vocabulary block (zeros for tokens outside
    it), summed over "model": every rank gets the full embedding, the
    same bits as a lookup in the whole table (one row plus zeros)."""
    rows = embed.shape[0]
    local = tokens.long() - index * rows
    inside = (local >= 0) & (local < rows)
    e = embed[local.clamp(0, rows - 1)]
    return reduce_from_model(torch.where(inside[..., None], e,
                                         torch.zeros((), dtype=e.dtype,
                                                     device=e.device)))


def vocab_parallel_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                                 index: int) -> torch.Tensor:
    """``transformer.cross_entropy`` over logits split by vocabulary
    block (this rank's ``(..., V / model)``): the forward gathers the row
    max and all-reduces the sum of exponentials and the label's logit
    over "model"; the backward is local (``softmax - onehot`` of the
    rank's block), since *g*'s identity backward gives each rank's block
    its share of both sums."""
    lf = logits.float()
    cols = lf.shape[-1]
    local_max = lf.detach().amax(dim=-1)
    m = collectives.all_gather(local_max[None], MODEL_AXIS, dim=0).amax(0)
    sumexp = reduce_from_model(torch.exp(lf - m[..., None]).sum(dim=-1))
    local = labels.long() - index * cols
    inside = (local >= 0) & (local < cols)
    picked = torch.gather(lf, -1, local.clamp(0, cols - 1)[..., None])[..., 0]
    ll = reduce_from_model(torch.where(inside, picked, 0.0))
    valid = labels >= 0
    nll = torch.where(valid, torch.log(sumexp) + m - ll, 0.0)
    return nll.sum() / torch.clamp(valid.sum(), min=1)


def model_index() -> int:
    """This rank's coordinate on "model"."""
    return collectives.axis_index(MODEL_AXIS)
