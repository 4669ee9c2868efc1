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
  by columns and ``w_down`` by rows.  An encoder-decoder splits its
  encoder's and decoder's attention and MLP so, its cross-attention by
  heads too.
- A MoE layer splits its experts (``w_gate``/``w_up``/``w_down`` under
  ``moe``: dim -3 of the stacked ``(R, E, D, F)`` leaf), as the
  reference's ``moe_forward_shardmap`` does; its router and any shared
  expert are replicated (``models.moe.moe_forward_sharded``).
- Attention splits by whole heads (all of them on every rank where
  ``num_heads % model != 0``, below) and replicates
  ``wk``/``wv``/``bk``/``bv`` when ``num_kv_heads % model != 0``
  (granite-34b's MQA: one KV head).  That is a storage difference with
  the same math: each rank computes the shared K/V itself, and their
  gradients are partial sums that the trainer adds over "model"
  (``partial_sum_leaves``).
- MLA splits by heads: ``w_uq`` and ``w_ukv`` by columns, ``w_o`` by
  rows.  Its low-rank leaves (``w_dq``, ``w_dkv``, ``w_kr`` and the two
  latent norms) are whole on every rank, which computes the latents
  itself: their gradients are partial sums, each rank's heads' share.
- Mamba splits by heads: ``A_log``, ``D``, ``dt_bias``, the gated
  norm's scale and ``out_proj``'s rows.  ``in_proj`` and the conv are
  *sectioned* (``leaf_sections``): along the split dim they are the
  concatenation of the (z, x, B, C, dt) or (x, B, C) sections, each
  split evenly, and a rank's block is its block of each section, joined.
  B and C are split too, so that every value has one owner, though
  every rank needs all of them (``models.mamba``).  The reference
  replicates the norm's scale; the port splits it with its channels.
- A split that does not divide is not made (``TPLayout.whole``).  Where
  the vocabulary does not split over the model ranks (mamba2-1.3b's
  50280, seamless-m4t-large-v2's 256206 over 16) the embedding and the
  head are whole on every rank, as the reference's ``fit_spec`` drops a
  spec entry whose dim does not divide.  Where a decoder's query heads
  do not (qwen2-vl-7b's 28 over 16) its attention is whole on every
  rank: a departure, since the reference's ``wq`` (3584, 3584) divides
  and stays split, its columns cut across heads.  Each rank computes a
  whole part on the same input, without *f* or *g* around it: its
  gradients are the same on every rank (replicated, not partial sums).
- ``shard_params`` / ``unshard_params`` give a rank's shard of a full
  parameter tree and gather the shards back; they take a whole train
  state too, whose AdamW moments and per-leaf EF residual mirror their
  parameter's split (a leaf's path ends in its parameter's path) and
  whose Adafactor statistics split as ``opt_leaf`` says.
  ``leaf_block`` / ``join_blocks`` / ``put_block`` / ``leaf_pieces``
  are the one set of helpers that slice and join a split leaf, sections
  included: the trainer's checkpoint layout (``train.trainer.gather_state``)
  is built from them.
- The two Megatron operators: *f* (``copy_to_model``: identity forward,
  all-reduce over "model" backward) and *g* (``reduce_from_model``:
  all-reduce forward, identity backward), as ``torch.autograd.Function``s.
  Their collectives go through ``comm.collectives``' default session,
  the monolithic one, as XLA inserts its own under GSPMD: the composed
  application session never sees them.

Every value of a split leaf has exactly one owner, and a leaf every
rank holds whole is either replicated with bit-equal gradients or a
partial sum (``partial_sum_leaves``), never partly both: Adafactor's
sums over a split dim (``train.trainer._ModelAxis.split_sum``), the
checkpoints' global boxes and the EF residual's layout rely on it.

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
Each segment's nodes run in one backward call only, so a tensor read
both by a cut and by later work must be cut itself (a Mamba mixer's
projection and conv output, the MTP head's normed hidden): a second
call through its nodes would find their saved tensors freed.
*g* and the vocab-parallel loss communicate only in the forward, which
runs on the rank thread.  Without an active tape *f* is the plain
autograd function, whose backward all-reduces inside the node: right on
the CPU, where each thread runs its own backward, and refused on CUDA.

A segment may also be a checkpointed block (``StagedBackward.block``,
``models.remat.staged``: rematerialization over "model").  The forward
runs the block without a graph and keeps its input; when the backward
reaches it, the rank's thread reruns the block under a tape of its own
(its cuts, *f*s and *g*s again, in the same order on every model rank),
checks that the rerun gave the forward's bits, runs that tape's backward
and hands the input's gradient on.  Nothing is recomputed on autograd's
device thread.

**The split over "data".**  The reference's specs also give each weight
the dim its "model" split leaves over to "data" (the input rows of a
column-parallel product, the output columns of a row-parallel one, the
embedding's width, a router's and MLA's low-rank inputs): its ``auto``
layout, FSDP, in which GSPMD gathers each block's weights as it runs
and reduce-scatters their gradients.  ``data_split`` /
``opt_data_leaf`` name that dim on the port's (stacked) leaves, whole
where it does not divide (``fit_spec``), and ``data_block`` /
``join_data`` / ``data_pieces`` cut and join it, on a model rank's block
as on a whole leaf.  In the trainer's ``auto`` step
(``train.trainer``) the rank's ``DataSplit`` hands the model a
``DataBlock`` for each split param: a block (the model code's
``gathered``) all-gathers its whole weights over "data" on entry, in the
forward and again in its rerun, and on the tape the gathered weights are
leaves (``_Gather``) whose gradient is reduce-scattered over "data" and
added into the rank's accumulator block once the later segments have
run, the whole weights then let go.  Those collectives wait for peers,
so the split step always runs under a tape, model axis or not: its
cuts then cut the residual stream of every layer (and a MoE layer's
input and logits), as they do over "model".

**Serving over "data" and "model".**  The reference's prefill and
decode cells place the params as its training does and the caches by
``serve_cache_shardings``: ``cache_split`` is that rule, the one the
models (``Model.init_caches``) and the dry-run read.  A rank's
``ServeSplit`` (carried by its ``CacheBlocks``, made the thread's for
a step) tells each layer how its cache leaves split; where a sequence
(or an encoder's memory) splits, the layer attends over its block and
``combine_partials`` merges the ranks' partial softmaxes.  The params'
data blocks are gathered forward only, without a tape.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.comm import collectives
from repro_torch.tree import flatten, map_tree, unflatten

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
#: MLA's split leaves; the others (the low-rank projections and the two
#: latent norms) are whole partial sums
_MLA = {"w_uq": -1, "w_ukv": -1, "w_o": -2}
_MLA_NORMS = ("q_norm", "kv_norm")
#: a Mamba mixer's leaves, all split by head (the gated norm's scale
#: under ``norm``, split at -1 too)
_MAMBA = {"in_proj": -1, "conv_w": -1, "conv_b": -1, "A_log": -1, "D": -1,
          "dt_bias": -1, "out_proj": -2}


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
    mla_heads: int = 0      # MLA heads a rank holds (0: no MLA)
    #: the global widths of the sections along the split dim of a Mamba
    #: mixer's sectioned leaves, by name: ``in_proj`` (z, x, B, C, dt),
    #: ``conv_w`` and ``conv_b`` (x, B, C)
    sections: Tuple[Tuple[str, Tuple[int, ...]], ...] = ()
    #: the parts every model rank holds whole because their split does
    #: not divide: "attn" (a decoder's attention), "vocab" (the
    #: embedding and the head)
    whole: Tuple[str, ...] = ()


def _check_divides(name: str, model: int, sizes) -> None:
    for what, n in sizes:
        if n % model:
            raise ValueError(f"{name}: {what}={n} does not split over "
                             f"{model} model ranks")


def layout(cfg, model: int) -> TPLayout:
    """The split of ``cfg`` (a ``TransformerCfg``, or an ``EncDecCfg``,
    which has no stages) over ``model`` ranks.  A decoder's attention
    heads or the vocabulary that do not divide are held whole
    (``TPLayout.whole``); raises a ``ValueError`` where an FFN, expert,
    MLA-head, Mamba-head or B/C-state split, or an encoder-decoder's
    head split, does not divide."""
    if not hasattr(cfg, "stages"):
        return _encdec_layout(cfg, model)
    mixers = {spec.mixer for st in cfg.stages for spec in st.layers}
    a = cfg.attn if "attn" in mixers else None
    d_ff = 0 if cfg.mlp is None else cfg.mlp.d_ff
    experts = 0 if cfg.moe is None else cfg.moe.num_experts
    mla = cfg.mla.num_heads if "mla" in mixers else 0
    whole = _whole(a is not None and a.num_heads % model != 0,
                   cfg.vocab_size % model != 0)
    sizes = [("d_ff", d_ff), ("num_experts", experts),
             ("mla num_heads", mla)]
    sections = ()
    if "mamba" in mixers:
        m = cfg.mamba
        gn = m.ngroups * m.d_state
        sizes += [("mamba nheads", m.nheads), ("mamba ngroups*d_state", gn)]
        sections = (("in_proj", (m.d_inner, m.d_inner, gn, gn, m.nheads)),
                    ("conv_w", (m.d_inner, gn, gn)),
                    ("conv_b", (m.d_inner, gn, gn)))
    _check_divides(cfg.name, model, sizes)
    heads = 1 if "attn" in whole else model
    kv_rep = (a is not None and "attn" not in whole
              and a.num_kv_heads % model != 0)
    return TPLayout(
        model=model, heads=0 if a is None else a.num_heads // heads,
        kv_heads=(0 if a is None else a.num_kv_heads if kv_rep
                  else a.num_kv_heads // heads),
        kv_replicated=kv_rep, d_ff=d_ff // model,
        vocab=cfg.vocab_size // (1 if "vocab" in whole else model),
        experts=experts // model, mla_heads=mla // model,
        sections=sections, whole=whole)


def _whole(attn: bool, vocab: bool) -> Tuple[str, ...]:
    return (("attn",) if attn else ()) + (("vocab",) if vocab else ())


def _encdec_layout(cfg, model: int) -> TPLayout:
    """An encoder-decoder's split: its self-attention (encoder and
    decoder) and its cross-attention by heads, the MLPs by columns, the
    embedding and the head by vocabulary."""
    a, c = cfg.attn, cfg.cross
    _check_divides(cfg.name, model, [
        ("num_heads", a.num_heads), ("cross num_heads", c.num_heads),
        ("d_ff", cfg.mlp.d_ff)])
    whole = _whole(False, cfg.vocab_size % model != 0)
    kv_rep = a.num_kv_heads % model != 0
    if kv_rep != (c.num_kv_heads % model != 0):
        raise ValueError(f"{cfg.name}: the self- and cross-attention's KV "
                         f"heads ({a.num_kv_heads}, {c.num_kv_heads}) must "
                         f"both split over {model} model ranks or neither")
    return TPLayout(model=model, heads=a.num_heads // model,
                    kv_heads=(a.num_kv_heads if kv_rep
                              else a.num_kv_heads // model),
                    kv_replicated=kv_rep, d_ff=cfg.mlp.d_ff // model,
                    vocab=cfg.vocab_size // (1 if whole else model),
                    experts=0, whole=whole)


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
    if ("vocab" in lay.whole and name in ("embed", "lm_head")) or (
            "attn" in lay.whole and "attn" in path):
        return None
    if "moe" in path:         # the experts split; router, shared: whole
        return -3 if path[-2] == "moe" and name in _EXPERT else None
    if len(path) > 1 and path[-2] == "mla":
        return _MLA.get(name)
    if len(path) > 1 and path[-2] == "mamba":
        return _MAMBA.get(name)
    if len(path) > 2 and path[-3:-1] == ("mamba", "norm"):
        return -1
    if name in _COLUMN:
        return -1
    if name in _ROW:
        return -2
    return None


def leaf_sections(path, lay: TPLayout) -> Optional[Tuple[int, ...]]:
    """The global widths of the sections along the split dim of the leaf
    at ``path``, each split evenly over the model ranks (None: one
    section, the whole dim).  An Adafactor statistic or an optimizer
    moment has its param's sections where it keeps the split dim."""
    if leaf_split(path, lay) is None:
        return None
    if path[0] == "opt":
        path = opt_leaf(path, lay)[0]
    if len(path) < 2 or path[-2] != "mamba":
        return None
    return dict(lay.sections).get(path[-1])


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
    (the K/V projections replicated under MQA, qwen3's per-head q/k
    norms, and MLA's low-rank projections and latent norms: every rank's
    heads add to them).  Those are summed over "model", without a
    mean."""
    def partial(p):
        if lay.model == 1:
            return False
        if len(p) > 1 and p[-2] == "mla":
            return p[-1] not in _MLA
        if len(p) > 2 and p[-3] == "mla":
            return p[-2] in _MLA_NORMS
        if "attn" in lay.whole and "attn" in p:
            return False
        return ((lay.kv_replicated and p[-1] in _KV)
                or (len(p) > 2 and p[-2] in _HEAD_NORMS
                    and p[-3] in ("attn", "self_attn", "cross")))
    return [partial(p) for p in paths]


def sharded_leaves(paths, lay: TPLayout) -> List[bool]:
    """Per leaf: does each model rank hold a different block of it?"""
    return [leaf_split(p, lay) is not None for p in paths]


def _pieces(path, lay: TPLayout, width: int, index: int
            ) -> List[Tuple[int, int, int]]:
    """(global offset, offset in the block, length) along the split dim
    of each piece of model rank ``index``'s block of the leaf at
    ``path``, ``width`` wide there globally: one piece a section."""
    secs = leaf_sections(path, lay) or (width,)
    if sum(secs) != width:
        raise ValueError(f"{'/'.join(map(str, path))}: sections {secs} "
                         f"do not add up to its width {width}")
    out, lo, at = [], 0, 0
    for w in secs:
        n = w // lay.model
        out.append((lo + index * n, at, n))
        lo, at = lo + w, at + n
    return out


def leaf_block(path, leaf: torch.Tensor, lay: TPLayout, index: int
               ) -> torch.Tensor:
    """Model rank ``index``'s block of the global ``leaf`` at ``path``:
    the leaf itself when it is replicated, a view of one section, a
    copy joining the blocks of a sectioned leaf's sections."""
    d = leaf_split(path, lay)
    if d is None:
        return leaf
    pieces = _pieces(path, lay, leaf.shape[d], index)
    if len(pieces) == 1:
        return leaf.chunk(lay.model, dim=d)[index]
    return torch.cat([leaf.narrow(d, g, n) for g, _, n in pieces], dim=d)


def put_block(path, leaf: torch.Tensor, lay: TPLayout, index: int,
              block: torch.Tensor) -> None:
    """Write model rank ``index``'s ``block`` into the global ``leaf``
    (in place): the inverse of ``leaf_block`` for a split leaf."""
    d = leaf_split(path, lay)
    for g, b, n in _pieces(path, lay, leaf.shape[d], index):
        leaf.narrow(d, g, n).copy_(block.narrow(d, b, n))


def join_blocks(path, blocks: List[torch.Tensor], lay: TPLayout
                ) -> torch.Tensor:
    """The global leaf from the model ranks' blocks (in model-rank
    order): each section's blocks concatenated, the sections in order;
    a replicated leaf is rank 0's."""
    d = leaf_split(path, lay)
    if d is None:
        return blocks[0]
    pieces = _pieces(path, lay, blocks[0].shape[d] * lay.model, 0)
    return torch.cat([x.narrow(d, b, n) for _, b, n in pieces
                      for x in blocks], dim=d)


def leaf_pieces(path, block: torch.Tensor, lay: TPLayout, index: int
                ) -> Tuple[Tuple[int, ...], List[Tuple[List[List[int]],
                                                       torch.Tensor]]]:
    """(global shape, ``[(box, piece), ...]``) of model rank ``index``'s
    ``block`` of the leaf at ``path``: one piece (a view of the block)
    for each section, its box ``[[lo, hi], ...]`` per dim in the global
    leaf, the split dim's part of it and every other dim whole."""
    shape = list(block.shape)
    d = leaf_split(path, lay)
    if d is None:
        return tuple(shape), [([[0, n] for n in shape], block)]
    shape[d] *= lay.model
    out = []
    for g, b, n in _pieces(path, lay, shape[d], index):
        box = [[0, k] for k in shape]
        box[d] = [g, g + n]
        out.append((box, block.narrow(d, b, n)))
    return tuple(shape), out


def global_shape(path, shape, lay: TPLayout) -> Tuple[int, ...]:
    """The global shape of the leaf at ``path`` whose model-rank block
    has ``shape``."""
    shape = list(shape)
    d = leaf_split(path, lay)
    if d is not None:
        shape[d] *= lay.model
    return tuple(shape)


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
    split leaves joined, replicated (and partial-sum) leaves from rank
    0."""
    per = [flatten(s) for s in shards]
    paths = per[0][1]
    return unflatten(paths, [join_blocks(path, [ls[i] for ls, _ in per],
                                         lay)
                             for i, path in enumerate(paths)])


# ---------------------------------------------------------------------------
# The reference's split over "data" (its FSDP: the ``auto`` step's state)
# ---------------------------------------------------------------------------

#: the dim (negative, from the end) each leaf's reference spec gives
#: "data": the input rows of a column-parallel product, the output
#: columns of a row-parallel one (``repro/models/layers.py``,
#: ``transformer.py``, ``encdec.py``, ``mla.py``, ``mamba.py``,
#: ``moe.py``)
_DATA = {"wq": -2, "wk": -2, "wv": -2, "wo": -1, "w_gate": -2, "w_up": -2,
         "w_down": -1, "embed": -1, "lm_head": -2, "mtp_proj": -1,
         "in_proj": -2, "out_proj": -1, "w_dq": -2, "w_dkv": -2,
         "w_kr": -2, "w_o": -1, "router": -2}
#: the leaves whose names above mean something else under a parent
#: (the Mamba norm's ``scale`` and the like carry no "data")
_DATA_PARENTS = {"in_proj": ("mamba",), "out_proj": ("mamba",),
                 "w_dq": ("mla",), "w_dkv": ("mla",), "w_kr": ("mla",),
                 "w_o": ("mla",), "router": ("moe",)}


def data_split(path, lay: Optional[TPLayout], data: int, shape
               ) -> Optional[int]:
    """The dim (negative) of the param at ``path`` (in a params tree, or
    ``("params", ...)`` in a train state; ``shape`` its shape, global or
    a model rank's block: the data dim is never the model split's) that
    the reference's ``auto`` layout splits over a "data" axis of
    ``data`` ranks, or None where the leaf is whole over "data": its
    spec names no "data" (norms, biases, a Mamba mixer's conv,
    ``A_log``, ``D``, ``dt_bias``), or its dim does not divide by
    ``data``, as the reference's ``fit_spec`` drops the entry.  ``lay``
    (the model split, or None) is ``leaf_split``'s; the data split does
    not depend on it.  An optimizer leaf's: ``opt_data_leaf``."""
    name = path[-1]
    d = _DATA.get(name)
    if data <= 1 or d is None or len(shape) < 2:
        return None
    parents = _DATA_PARENTS.get(name)
    if parents is not None and (len(path) < 2 or path[-2] not in parents):
        return None
    return d if shape[d] % data == 0 else None


def opt_data_leaf(path, lay: Optional[TPLayout], data: int, param_shape
                  ) -> Tuple[Tuple[Any, ...], Optional[int]]:
    """``opt_leaf``'s counterpart over "data": the optimizer-state leaf
    at ``path``'s param path and the dim (negative) of the leaf split
    over "data", as the reference's ``optimizer.state_specs`` derives it
    from the param's spec (``param_shape``: the param's shape).  An
    AdamW moment and Adafactor's ``v`` split as their param; ``vr`` (the
    param without its last dim) keeps a split of the param's rows at -1
    and drops one of its columns, ``vc`` (without its second-to-last)
    the other way round."""
    pp = opt_leaf(path, None)[0]
    d = data_split(pp, lay, data, param_shape)
    if path[1] != "f" or path[-1] == "v":
        return pp, d
    return pp, {("vr", -2): -1, ("vc", -1): -1}.get((path[-1], d))


def data_block(leaf: torch.Tensor, dim: Optional[int], data: int,
               index: int) -> torch.Tensor:
    """Data rank ``index``'s block (a view) of ``leaf`` split at ``dim``
    over ``data`` ranks; the leaf itself where ``dim`` is None."""
    if dim is None:
        return leaf
    return leaf.chunk(data, dim=dim)[index]


def join_data(blocks: List[torch.Tensor], dim: Optional[int]
              ) -> torch.Tensor:
    """The leaf from the data ranks' blocks (in data-rank order); data
    rank 0's where the leaf is whole over "data"."""
    if dim is None:
        return blocks[0]
    return torch.cat(blocks, dim=dim)


def data_pieces(path, block: torch.Tensor, lay: Optional[TPLayout],
                model_index: int, dim: Optional[int], data: int,
                index: int):
    """``leaf_pieces`` of rank (data ``index``, model ``model_index``)'s
    ``block``, a data block of its model block: each piece's box cut to
    the data block along ``dim``."""
    if lay is None:
        shape = list(block.shape)
        pieces = [([[0, n] for n in shape], block)]
    else:
        shape, pieces = leaf_pieces(path, block, lay, model_index)
        shape = list(shape)
    if dim is None:
        return tuple(shape), pieces
    w = block.shape[dim]
    shape[dim] *= data
    out = []
    for box, piece in pieces:
        box = [list(b) for b in box]
        box[dim] = [index * w, (index + 1) * w]
        out.append((box, piece))
    return tuple(shape), out


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
    """The segments of one forward and the backward that runs them in
    reverse: the cuts, and the checkpointed blocks (``block``).  ``with
    tape:`` makes it the calling thread's tape."""

    def __init__(self) -> None:
        self._segments: List[Any] = []

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
        self._segments.append(_Cut(x, leaf, reduce))
        return leaf

    def block(self, fn: Callable, x: torch.Tensor, keep=None
              ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
        """``fn(x) -> (y, auxes)`` checkpointed on the tape: run without
        a graph (its *g*s all-reduce as ever; its cuts and *f*s, with
        nothing to differentiate, record nothing), keeping ``x`` and
        whatever ``keep`` keeps (``models.remat``'s "dots": a recorder
        with ``recording()`` / ``replaying()`` contexts), and record a
        segment whose outputs are leaves.  The backward reruns ``fn``
        there, on the rank's thread (``_Block``)."""
        with torch.no_grad(), _context(keep, "recording"):
            y, auxes = fn(x.detach())
        outs = tuple(t.requires_grad_(True) for t in (y,) + tuple(auxes))
        self._segments.append(_Block(fn, x, outs, keep))
        return outs[0], outs[1:]

    def backward(self, loss: torch.Tensor) -> None:
        """Gradients of ``loss`` into the ``.grad`` of every leaf it
        depends on: the last segment from the loss, then each segment in
        reverse order, its leaves' gradients complete (and, for an *f*
        cut, all-reduced over "model") before it runs."""
        loss.backward()
        self._unwind()

    def _unwind(self) -> None:
        while self._segments:
            self._segments.pop().run()


def _context(keep, name: str):
    return contextlib.nullcontext() if keep is None else getattr(keep, name)()


@dataclasses.dataclass
class _Cut:
    """A cut: ``x``'s graph ends at ``leaf``."""

    x: torch.Tensor
    leaf: torch.Tensor
    reduce: bool

    def run(self) -> None:
        g = self.leaf.grad
        if g is not None:
            self.x.backward(psum(g) if self.reduce else g)


@dataclasses.dataclass
class _Block:
    """A checkpointed block: ``fn`` of the input ``x`` gave ``outs``
    (leaves: the residual stream, then the aux losses)."""

    fn: Callable
    x: torch.Tensor
    outs: Tuple[torch.Tensor, ...]
    keep: Any

    def run(self) -> None:
        """Rerun ``fn`` with a graph under a tape of its own, so that its
        cuts, *f*s and *g*s run in the forward's order on every model
        rank; check that it gave the forward's bits; run that tape's
        backward from the outputs' gradients; hand the input's gradient
        on to ``x``."""
        grads = [o.grad for o in self.outs]
        if all(g is None for g in grads):
            return
        xin = self.x.detach().requires_grad_(self.x.requires_grad)
        tape = StagedBackward()
        with tape, torch.enable_grad(), _context(self.keep, "replaying"):
            y, auxes = self.fn(xin)
        again = (y,) + tuple(auxes)
        # ``meta`` tensors (the dry-run's) hold no bits to compare
        if not all(a.is_meta or bits_equal(a, b)
                   for a, b in zip(again, self.outs)):
            raise RuntimeError(
                "a checkpointed block's recompute gave other bits than its "
                "forward (a nondeterministic op in the block)")
        pairs = [(a, g) for a, g in zip(again, grads)
                 if g is not None and a.requires_grad]
        if pairs:
            torch.autograd.backward([a for a, _ in pairs],
                                    [g for _, g in pairs])
        tape._unwind()
        if xin.grad is not None:
            self.x.backward(xin.grad)


def bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Whether ``a`` and ``b`` hold the same bits (NaNs included)."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if not a.is_floating_point():
        return torch.equal(a, b)
    return torch.equal(a.detach().contiguous().reshape(-1).view(torch.uint8),
                       b.detach().contiguous().reshape(-1).view(torch.uint8))


def checkpoint_block(fn: Callable, x: torch.Tensor, keep=None
                     ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
    """``fn(x) -> (y, auxes)`` checkpointed on the calling thread's
    ``StagedBackward`` (``StagedBackward.block``); run plainly without
    one."""
    tape = getattr(_local, "tape", None)
    if tape is None:
        return fn(x)
    return tape.block(fn, x, keep)


def on_tape() -> bool:
    """Whether the calling thread records a ``StagedBackward``."""
    return getattr(_local, "tape", None) is not None


# ---------------------------------------------------------------------------
# The data split in the step: gather on entry, reduce-scatter backward
# ---------------------------------------------------------------------------

DATA_AXIS = "data"


class DataSplit:
    """One rank's data split for one step: ``dims`` (per param leaf, the
    dim split over "data", or None) and ``acc``, the gradient
    accumulator (per leaf; the rank's data block of each split one).
    ``with split:`` makes it the calling thread's, so that
    ``Model.loss_and_grads`` hands the model a ``DataBlock`` for each
    split leaf."""

    def __init__(self, dims, acc: List[Optional[torch.Tensor]]) -> None:
        self.dims, self.acc = tuple(dims), acc

    def __enter__(self) -> "DataSplit":
        if getattr(_local, "data", None) is not None:
            raise RuntimeError("a DataSplit is already active")
        _local.data = self
        return self

    def __exit__(self, *exc) -> None:
        _local.data = None

    def add(self, part: "DataBlock", grad: torch.Tensor) -> None:
        """Add the reduced ``grad`` of ``part`` into its accumulator
        block, in place, in the accumulator's dtype."""
        acc = self.acc[part.index]
        if part.r is not None:
            acc = acc[part.r]
        acc.add_(grad.to(acc.dtype))


def active_data_split() -> Optional[DataSplit]:
    """The calling thread's ``DataSplit`` (None outside a split step)."""
    return getattr(_local, "data", None)


@dataclasses.dataclass(eq=False)
class DataBlock:
    """A param the rank holds its "data" block of, as the model's
    forward reads it: ``[r]`` is layer ``r`` of a stacked leaf, and
    ``gathered`` turns it into the whole weights (over "data"; the
    rank's block of them over "model")."""

    split: DataSplit
    index: int
    block: torch.Tensor
    dim: int
    r: Optional[int] = None

    def __getitem__(self, r: int) -> "DataBlock":
        if self.r is not None:
            raise IndexError("a DataBlock selects one layer only")
        return dataclasses.replace(self, r=r)

    def gather(self) -> torch.Tensor:
        """The whole weights, all-gathered over "data" on the rank's
        thread.  While a graph is recorded on a tape they are a leaf of
        it, whose gradient the tape reduce-scatters over "data" into the
        accumulator (``_Gather``); else (a checkpointed block's forward)
        a plain tensor, freed with the block's forward."""
        x = self.block if self.r is None else self.block[self.r]
        whole = collectives.all_gather(x, DATA_AXIS, dim=self.dim)
        tape = getattr(_local, "tape", None)
        if tape is None or not torch.is_grad_enabled():
            return whole
        leaf = whole.detach().requires_grad_(True)
        tape._segments.append(_Gather(leaf, self))
        return leaf


@dataclasses.dataclass(eq=False)
class _Gather:
    """A gathered weight ``leaf`` of ``part``: its gradient is complete
    once every later segment has run; it is summed over "data", this
    rank's block of it added into the accumulator, and the whole weight
    and its gradient let go."""

    leaf: Optional[torch.Tensor]
    part: DataBlock

    def run(self) -> None:
        leaf, self.leaf = self.leaf, None
        g = leaf.grad if leaf.grad is not None else torch.zeros_like(leaf)
        del leaf
        self.part.split.add(self.part, collectives.psum_scatter(
            g, DATA_AXIS, dim=self.part.dim))


def gathered(tree: Any, r: Optional[int] = None) -> Any:
    """``tree`` (a layer's params; ``r``: layer ``r`` of a stacked one)
    with each ``DataBlock`` gathered to its whole weights: where the
    step splits params over "data", every block calls it on entry (in
    its forward and its rerun), and so do the embedding, the head and
    the MTP head where they are used."""
    def one(t):
        if r is not None:
            t = t[r]
        return t.gather() if isinstance(t, DataBlock) else t
    return map_tree(one, tree)


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


# ---------------------------------------------------------------------------
# Serving over "data" and "model": the caches' split and the rank's blocks
# ---------------------------------------------------------------------------

#: a spec: one entry a dim, each None, an axis name or a tuple of them
Spec = Tuple[Any, ...]

#: the axes a serving batch's rows split over (the reference's
#: ``batch_specs`` and cache specs: ``("pod", "data")``)
BATCH_AXES = ("pod", "data")


def filter_spec(spec: Spec, axis_names) -> Spec:
    """Drop mesh-axis names not present in ``axis_names`` from a spec (an
    entry left with one name is that name, as a ``PartitionSpec`` reads
    a 1-tuple)."""
    names = set(axis_names)
    out = []
    for entry in spec:
        if entry is None:
            out.append(None)
        elif isinstance(entry, (tuple, list)):
            kept = tuple(a for a in entry if a in names)
            out.append(kept[0] if len(kept) == 1 else (kept or None))
        else:
            out.append(entry if entry in names else None)
    return tuple(out)


def entry_axes(entry) -> Tuple[str, ...]:
    """The axes of one spec entry, major first (``()`` for None)."""
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


def fit_spec(spec: Spec, shape, sizes: Dict[str, int]) -> Spec:
    """``spec`` filtered to the mesh's axes (``sizes``: axis -> size),
    an entry dropped where its dim does not split evenly over its axes
    (the reference's ``fit_spec``)."""
    fs = filter_spec(spec, sizes)
    out = []
    for i, entry in enumerate(fs):
        if entry is None or i >= len(shape):
            out.append(None if i >= len(shape) else entry)
            continue
        n = 1
        for a in entry_axes(entry):
            n *= sizes.get(a, 1)
        out.append(None if shape[i] % n else entry)
    return tuple(out)


def _kv_cache_specs() -> Dict[str, Spec]:
    return {"k": (BATCH_AXES, None, "model", None),
            "v": (BATCH_AXES, None, "model", None), "len": (BATCH_AXES,)}


def _mixer_cache_specs(mixer: str) -> Dict[str, Spec]:
    if mixer == "attn":
        return _kv_cache_specs()
    if mixer == "mla":
        # the latent cache is shared by all heads: replicated over "model"
        return {"ckv": (BATCH_AXES, None, None),
                "krope": (BATCH_AXES, None, None), "len": (BATCH_AXES,)}
    return {"conv": (BATCH_AXES, None, "model"),
            "ssm": (BATCH_AXES, "model", None, None)}


def _stacked(specs: Dict[str, Spec]) -> Dict[str, Spec]:
    return {k: (None,) + v for k, v in specs.items()}


def cache_specs(model) -> Dict[str, Any]:
    """The reference's ``Model.cache_specs``: each cache leaf's spec, the
    batch over ("pod", "data") and heads over "model", stacked layers a
    leading None."""
    if model.kind == "encdec":
        return {"self": _stacked(_kv_cache_specs()),
                "memory": (BATCH_AXES, None, None)}
    return {f"stage{i}": {f"layer{j}": _stacked(_mixer_cache_specs(
        spec.mixer)) for j, spec in enumerate(st.layers)}
        for i, st in enumerate(model.cfg.stages)}


def _spec_leaves(tree) -> list:
    """A spec tree's leaves in ``tree.flatten``'s order (sorted keys): a
    spec tuple is a leaf, not a node."""
    if isinstance(tree, dict):
        return [s for k in sorted(tree) for s in _spec_leaves(tree[k])]
    return [tree]


def cache_split(model, sizes: Dict[str, int], batch: int, max_len: int,
                enc_len: int = 0) -> Tuple[List[Spec], Any]:
    """(the fitted spec of every cache leaf, in ``tree.flatten``'s order;
    the whole caches on ``meta``) of ``model`` serving ``batch`` rows of
    ``max_len`` positions (``enc_len`` frames of an encoder-decoder's
    memory) on a mesh of ``sizes`` (axis -> size): the reference's
    ``serve_cache_shardings``.  The template puts the batch over ("pod",
    "data") and heads over "model"; where those do not divide (batch 1,
    K/V heads fewer than the model ranks) the longest dim left whole
    (the sequence, or the memory's frames), if it is at least 1024 long,
    is split over the axes left free, each taken in the order "model",
    "data", "pod" while the dim still splits into at least two positions
    a rank: a context-parallel cache."""
    specs = _spec_leaves(cache_specs(model))
    abstract = model.cache_shapes(
        batch, max_len, enc_len=enc_len if model.kind == "encdec" else 0)
    leaves_, _ = flatten(abstract)
    if len(specs) != len(leaves_):
        raise ValueError(f"{len(specs)} cache specs for {len(leaves_)} "
                         f"cache leaves")

    def one(spec, leaf):
        fitted = list(fit_spec(spec, tuple(leaf.shape), sizes))
        while len(fitted) < leaf.ndim:
            fitted.append(None)
        used = {a for e in fitted for a in entry_axes(e)}
        free = [a for a in ("model", "data", "pod") if a in sizes
                and a not in used]
        if free and leaf.ndim >= 2:
            dims = [(d, i) for i, d in enumerate(leaf.shape)
                    if fitted[i] is None]
            if dims:
                dmax, imax = max(dims)
                axes = []
                for a in free:
                    n = sizes[a]
                    cur = 1
                    for x in axes:
                        cur *= sizes[x]
                    if dmax % (cur * n) == 0 and dmax >= 2 * cur * n:
                        axes.append(a)
                if axes and dmax >= 1024:   # only worth it for seq dims
                    fitted[imax] = tuple(axes) if len(axes) > 1 else axes[0]
        return tuple(fitted)

    return [one(s, l) for s, l in zip(specs, leaves_)], abstract


def row_axes(sizes: Dict[str, int], batch: int) -> Tuple[str, ...]:
    """The axes a serving batch of ``batch`` rows splits over: ("pod",
    "data") as the mesh has them, or none where the rows do not divide
    (the batch is then whole on every rank, as ``fit_spec`` leaves it)."""
    return entry_axes(fit_spec((BATCH_AXES,), (batch,), sizes)[0])


def block_index(axes: Tuple[str, ...], sizes: Dict[str, int],
                coords: Dict[str, int]) -> Tuple[int, int]:
    """(this rank's block, the number of blocks) of a dim split over
    ``axes`` (major first)."""
    i, n = 0, 1
    for a in axes:
        i, n = i * sizes[a] + coords[a], n * sizes[a]
    return i, n


@dataclasses.dataclass(frozen=True)
class ServeSplit:
    """One rank's share of serving caches of ``max_len`` positions
    (``enc_len`` frames of memory) on a mesh of ``sizes`` at ``coords``:
    ``specs`` is ``cache_split``'s, one a cache leaf at ``paths``.  ``axes(name, dim)`` says how the leaves called ``name``
    ("k", "ckv", "conv", "ssm", "memory", ...) split at ``dim``, which
    is the same for every layer's."""

    sizes: Tuple[Tuple[str, int], ...]
    coords: Tuple[Tuple[str, int], ...]
    max_len: int
    enc_len: int
    paths: Tuple[Tuple[Any, ...], ...]
    specs: Tuple[Spec, ...]

    def __post_init__(self):
        seen: Dict[str, Spec] = {}
        for path, spec in zip(self.paths, self.specs):
            # a stacked leaf's leading entry (its layers) is None
            tail = spec if path[0] == "memory" else spec[1:]
            if seen.setdefault(path[-1], tail) != tail:
                raise ValueError(f"cache leaves {path[-1]!r} split two "
                                 f"ways: {seen[path[-1]]} and {tail}")

    @property
    def mesh_sizes(self) -> Dict[str, int]:
        return dict(self.sizes)

    @property
    def mesh_coords(self) -> Dict[str, int]:
        return dict(self.coords)

    def axes(self, name: str, dim: int) -> Tuple[str, ...]:
        """The axes (major first) the leaves called ``name`` split over
        at ``dim`` (negative)."""
        for path, spec in zip(self.paths, self.specs):
            if path[-1] == name:
                return entry_axes(spec[dim])
        raise KeyError(f"no cache leaf {name!r}")

    def index(self, name: str, dim: int) -> Tuple[Tuple[str, ...], int]:
        """(the axes, this rank's block) of ``name``'s leaves at ``dim``."""
        axes = self.axes(name, dim)
        return axes, block_index(axes, self.mesh_sizes,
                                 self.mesh_coords)[0]

    def block(self, i: int, shape) -> Tuple[slice, ...]:
        """This rank's block of cache leaf ``i`` (whole shape ``shape``),
        one slice a dim."""
        out = []
        for n, entry in zip(shape, self.specs[i]):
            j, k = block_index(entry_axes(entry), self.mesh_sizes,
                               self.mesh_coords)
            out.append(slice(j * (n // k), (j + 1) * (n // k)))
        return tuple(out)

    def active(self):
        """``with split.active():`` makes it the calling thread's (the
        model's layers read it through ``serve_split()``)."""
        return _serving(self)


@contextlib.contextmanager
def _serving(split: ServeSplit):
    if getattr(_local, "serve", None) is not None:
        raise RuntimeError("a ServeSplit is already active")
    _local.serve = split
    try:
        yield split
    finally:
        _local.serve = None


def serve_split() -> Optional[ServeSplit]:
    """The calling thread's ``ServeSplit`` (None outside a split serving
    step)."""
    return getattr(_local, "serve", None)


class CacheBlocks(dict):
    """A rank's cache blocks (the tree of ``Model.init_caches``) with the
    split they are blocks of (``split``): ``Model.prefill`` and
    ``decode_step`` serve a rank from it and return the new blocks so."""

    def __init__(self, tree: Dict[str, Any], split: ServeSplit) -> None:
        super().__init__(tree)
        self.split = split


def gather_axes(x: torch.Tensor, axes: Tuple[str, ...], dim: int
                ) -> torch.Tensor:
    """``x`` all-gathered along ``dim`` over ``axes`` (major first): the
    blocks in the order a spec entry of those axes lays them out."""
    for a in reversed(axes):
        x = collectives.all_gather(x, a, dim=dim)
    return x


def combine_partials(o: torch.Tensor, m: torch.Tensor, l: torch.Tensor,
                     axes: Tuple[str, ...]) -> torch.Tensor:
    """Softmax attention from the partials of the ranks over ``axes``
    (each a block of the keys): ``o`` (..., Dv) the unnormalized output
    over the rank's keys, ``m`` (...) their row max (-inf where the rank
    saw no key), ``l`` (...) the row sum of exp(s - m) (0 there).  The
    partials are all-gathered (one tensor of (..., Dv + 2) values) and
    merged in block order, so every rank gets the same bits; a row no
    rank saw a key of gives 0."""
    if axes:
        x = gather_axes(torch.cat([o, m[..., None], l[..., None]],
                                  dim=-1)[None], axes, dim=0)
        o, m, l = x[..., :-2], x[..., -2], x[..., -1]
        top = m.amax(dim=0)
        top = torch.where(torch.isfinite(top), top, 0.0)
        w = torch.where(torch.isfinite(m), torch.exp(m - top), 0.0)
        o = (o * w[..., None]).sum(dim=0)
        l = (l * w).sum(dim=0)
    return o / torch.where(l == 0.0, 1.0, l)[..., None]
