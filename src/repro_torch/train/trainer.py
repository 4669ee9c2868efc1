"""Training step: gradient accumulation + communicator-mediated sync.

Counterpart of ``repro.train.trainer`` for its three sync modes:

  auto       — the conventional stack, the counterpart of the
               reference's compiler-inserted sync: every rank computes
               the loss and gradients of its rows of the batch, and
               each gradient leaf is averaged with
               ``comm.collectives.pmean`` through the monolithic default
               session (the generic path, what XLA's inserted ``psum`` is
               to the reference).  One collective per leaf, blocking; no
               buckets, overlap or ZeRO.  On a "data" axis of more than
               one rank the state is the reference's ``auto`` layout
               (its FSDP, ``data_width``): each rank holds its data
               block of every leaf the reference's specs split over
               "data" (params, gradient accumulator, optimizer state),
               gathers a block's weights as it runs and reduce-scatters
               their gradients (``_auto_train_step``).
  composed   — every rank computes the loss and gradients of its rows of
               the batch, and gradients are synced through a
               ``repro_torch.comm`` communicator whose per-function
               protocols are cost-model selected.
  compressed — composed + the int8 error-feedback compressed all-reduce;
               the EF residual lives in the train state across steps.

and the reference's ways of running that sync:

  per leaf   — one collective per gradient leaf (``_leaf_sync``).
  bucketed   — ``TrainCfg.bucket_grads``: leaves grouped by dtype (bf16
               stays bf16 on the wire) into buckets of at most
               ``TrainCfg.bucket_bytes``, one collective each, through
               persistent handles bound once (``_bucket_sync``).
  overlapped — ``TrainCfg.overlap``.  Every sync is a schedule-IR
               program: the communicator's canonical blocking program,
               which ``schedule.execute`` turns into start / progress /
               wait calls.  With ``overlap`` the planner's passes rewrite
               it first (reverse layout order, depth-``overlap_depth``
               interleaving, start hoisting).  Each unit's arithmetic is
               the same either way, so the bits are the same.  On one
               card the ranks share one stream and an in-process
               transport: the program sets the order of the hops, not
               concurrency.
  ZeRO-1     — ``TrainCfg.zero``: gradients sync with only the reduce-
               scatter half of the planned all-reduce, each rank updates
               its chunk of a flat, padded optimizer state, and the
               updated param chunks all-gather back; both halves are
               schedule-IR programs over persistent handles.  AdamW's
               update is elementwise, so at ``clip_norm=0`` on a
               power-of-two width the losses are bit-identical to the
               per-leaf path.  Adafactor runs on the 1-D chunks as the
               reference's does: unfactored, its RMS clip over the
               rank's chunk (padding included), not across ranks.  With
               a "model" axis the reference's chunk is still data rank
               d's slice of the WHOLE param's flat padded vector (its
               shard_map is manual over the data axis only), so
               Adafactor's state is laid out so too (``_piece``): rank
               (d, j) owns the j-th of ``model`` pieces of chunk d, the
               gradient is gathered over "model" one leaf at a time and
               reduce-scattered over "data" in those pieces, the clip's
               sum of squares is summed over "model", and the new
               pieces are all-gathered over "data" and "model" back into
               each rank's block.  AdamW, elementwise, keeps the chunks
               of each model rank's block.

``TrainSession`` bundles what survives a re-mesh (model, optimizer,
``TrainCfg``) for the elastic controller.

The checkpoint layout is the reference's global tree on any mesh
(``gather_state`` / ``scatter_state``): every leaf whole (a split
leaf's blocks, over "model" and over "data", carry their global boxes),
ZeRO's optimizer leaves flat over the whole param and padded to the
data width, the bucketed EF residual in the global params' buckets.  A
tree gathered on one ``(data, model)`` mesh, in any sync mode, scatters
onto any other.

A mesh with a "model" axis trains a model built for it
(``build_model(cfg, model_parallel=...)``): each rank holds its shard
(``init_states``), its backward is staged (``Model.loss_and_grads``),
and its gradients are local leaves.  Each sync flavour above runs on
them unchanged over the data axes, with the mean over the data size.
Two things cross the model axis, through the monolithic default session
(what XLA inserts for the reference under GSPMD): the gradients of the
leaves every model rank computes a part of (the K/V projections
replicated under MQA: ``sharding.partial_sum_leaves``) are summed over
"model", without a mean, before the sync; and the global gradient norm
adds the model ranks' squares of the split leaves.  Adafactor's
reductions over a split dim (its factored means and normaliser, its RMS
clip) are summed over "model" too, through the optimizer's
``split_sum`` hook (``_ModelAxis.split_sum``), and its state is the
block of the global state, factored by the global shapes
(``sharding.opt_leaf`` says where each statistic splits).  Norm gradients are
the same on every model rank already: nothing sums them, and
``TrainCfg.check_model_replicas`` asserts it each step.

Ranks are the threads of ``substrate.run_spmd``.  Each holds its own
state (a list, one per rank); ``train_step(states, batch)`` gives every
rank its rows of the global batch, as the reference's ``shard_map``
splits the batch over the data axes (``batch_dim``: M-RoPE
``positions`` (3, B, S) at dim 1, every other key at dim 0; microbatches
split the same way).  Handles, schedules and the bucket
layout are static in (param shapes, dtypes, data-parallel width) and are
built once per ``make_train_step``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.checkpoint import ShardedTensor
from repro_torch.comm import Communicator, collectives
from repro_torch.core import plan as plan_mod
from repro_torch.core import schedule as schedule_mod
from repro_torch.core import trace
from repro_torch.core.compression import bucket_ef_zeros
from repro_torch.core.engine import check_bucket_ef, scale_by
from repro_torch.data.pipeline import batch_dim, batch_rows, shard_batch
from repro_torch.optim.optimizer import sum_of_squares
from repro_torch.parallel import sharding
from repro_torch.runtime import substrate
from repro_torch.tree import flatten, leaves, map_tree, unflatten

Params = Any


@dataclasses.dataclass(frozen=True)
class TrainCfg:
    microbatches: int = 1
    sync_mode: str = "composed"          # auto | composed | compressed
    data_axes: Tuple[str, ...] = ("pod", "data")   # filtered to the mesh
    grad_dtype: Any = torch.float32      # accumulation dtype (microbatches)
    bucket_grads: bool = False           # fused dtype-grouped buckets
    bucket_bytes: int = plan_mod.DEFAULT_BUCKET_BYTES  # cap per bucket
    overlap: bool = False                # schedule-IR start/wait sync
    # in-flight collectives the interleave pass keeps live: 2 is the
    # classic software pipeline (no progress hops); >= 3 adds per-stage
    # progress hops on the younger in-flight units
    overlap_depth: int = 2
    zero: bool = False                   # ZeRO-1 optimizer-state sharding
    # with a model axis: raise unless the gradients of the leaves every
    # model rank holds whole are bit-equal across "model" (one
    # all-gather of them a step; a check for tests, off by default)
    check_model_replicas: bool = False

    def __post_init__(self):
        if self.sync_mode not in ("auto", "composed", "compressed"):
            raise ValueError(f"unknown sync_mode {self.sync_mode!r}")
        if self.microbatches < 1:
            raise ValueError(f"microbatches={self.microbatches}")
        if self.sync_mode == "auto" and (self.bucket_grads or self.overlap
                                         or self.zero):
            raise ValueError(
                "sync_mode='auto' is the conventional per-leaf sync of the "
                "monolithic stack: buckets, overlap and ZeRO need "
                "sync_mode='composed' (or 'compressed')")
        if not self.zero:
            return
        if self.sync_mode != "composed":
            raise ValueError(
                f"zero=True shards the optimizer update on the planned "
                f"all-reduce's RS/AG seam, which only the composed sync "
                f"path exposes (compression's EF residual would defeat "
                f"the sharding); got sync_mode={self.sync_mode!r}")
        if self.bucket_grads:
            raise ValueError(
                "zero=True runs one RS/AG pair per parameter leaf — "
                "fused buckets cross leaf boundaries and have no "
                "per-param shard to update; disable bucket_grads")


def _grad_structs(params, cfg: TrainCfg) -> List[torch.Tensor]:
    """``meta`` leaves with the dtype gradients have in the step: the
    accumulation casts to ``grad_dtype``; one microbatch keeps each
    param's own dtype."""
    return [torch.empty(l.shape, dtype=cfg.grad_dtype
                        if cfg.microbatches > 1 else l.dtype, device="meta")
            for l in leaves(params)]


def grad_bucket_plan(params, cfg: TrainCfg, layout=None) -> tuple:
    """The dtype-grouped bucket layout of the step's fused sync
    (deterministic in shapes, dtypes, order and ``bucket_bytes``).  With
    a model axis (``layout``, of a model rank's shard ``params``) a leaf
    split over "model" never shares a bucket with one every model rank
    holds whole: the compressed sync's int8 blocks would span both, so
    each rank's blocks would give the whole leaf other scales, and the
    model ranks other updates of it."""
    keys = (None if layout is None else
            sharding.sharded_leaves(flatten(params)[1], layout))
    return plan_mod.plan_buckets(_grad_structs(params, cfg),
                                 cfg.bucket_bytes, keys=keys)


# ---------------------------------------------------------------------------
# ZeRO-1 state layout (it depends on the data-parallel width)
# ---------------------------------------------------------------------------

def zero_layout(cfg: TrainCfg, mesh) -> Tuple[str, int]:
    """(axis, size) of the single data axis ZeRO-1 shards over."""
    if mesh is None:
        raise ValueError("zero=True makes the optimizer-state layout "
                         "data-parallel-width dependent; pass mesh=")
    sizes = dict(mesh.shape)
    axes = tuple(a for a in cfg.data_axes if a in sizes)
    if len(axes) != 1:
        raise ValueError(
            f"zero=True shards optimizer state over exactly ONE data "
            f"axis; cfg.data_axes={cfg.data_axes} resolves to {axes} on "
            f"mesh axes {tuple(sizes)}")
    return axes[0], int(sizes[axes[0]])


def _zero_pad_len(n: int, p: int) -> int:
    return ((int(n) + p - 1) // p) * p


def _zero_chunk(x: torch.Tensor, p: int, idx: int) -> torch.Tensor:
    """Rank ``idx``'s chunk of ``x`` flattened and zero-padded to a
    multiple of ``p``: the pad-and-split layout of the RS protocols, so
    param chunks line up with the reduced gradient chunks.  A copy."""
    return _piece_of(x, p, 1, idx, 0)


def _whole_chunks(opt) -> bool:
    """Whether ZeRO-1 over a "model" axis lays out the optimizer state
    ``opt`` (a state tree) in pieces of each whole param's chunk, the
    reference's layout (``_piece``), rather than in chunks of each model
    rank's block: so for Adafactor's (``{"f": ...}``), whose unfactored
    statistic and update-RMS clip span the reference's chunk.  AdamW's
    update is elementwise, so its chunks stay its block's: fewer
    collectives, and the same bits."""
    return "f" in opt


def _piece(n: int, p: int, m: int) -> Tuple[int, int]:
    """(c, k): the reference's ZeRO chunk length of a leaf of ``n``
    values over ``p`` data ranks, and the length of the piece of it each
    of ``m`` model ranks owns.  Rank (data d, model j) owns values
    [d*c + j*k, d*c + min((j+1)*k, c)) of the flat leaf padded to p*c,
    zero-padded to k."""
    c = _zero_pad_len(n, p) // p
    return c, -(-c // m)


def _piece_of(x: torch.Tensor, p: int, m: int, d: int, j: int
              ) -> torch.Tensor:
    """Rank (data ``d``, model ``j``)'s piece of ``x`` flattened (a
    copy)."""
    flat = x.reshape(-1)
    c, k = _piece(flat.numel(), p, m)
    out = flat.new_zeros(k)
    lo = d * c + j * k
    hi = min(d * c + min((j + 1) * k, c), flat.numel())
    if hi > lo:
        out[:hi - lo] = flat[lo:hi]
    return out


def _from_pieces(ys: torch.Tensor, n: int, p: int) -> torch.Tensor:
    """The flat leaf of ``n`` values from every rank's piece of it,
    ``ys`` (model, data * k) as the two all-gathers give them."""
    m = ys.shape[0]
    c, k = _piece(n, p, m)
    return ys.view(m, p, k).transpose(0, 1).reshape(p, m * k)[:, :c] \
        .reshape(-1)[:n]


def make_train_state(model, optimizer, params: Params,
                     cfg: TrainCfg = TrainCfg(), mesh=None,
                     data_index: Optional[int] = None) -> Dict[str, Any]:
    """One rank's {"params", "opt", "step"[, "ef"]}.  Optimizer moments
    and the EF residual start at zero, as in the reference.  With
    ``cfg.zero`` the optimizer state covers this rank's flat padded chunk
    of every param (``mesh=`` gives the width); it starts at zero on
    every rank, so one state replicates to all.  With a model axis
    (``params`` a model rank's shard) the state is the block of the
    global params' state: Adafactor factors a leaf by its global shape,
    as the reference's does under GSPMD.  With ``data_index`` (an
    ``auto`` step whose "data" axis on ``mesh`` splits the state,
    ``data_width``) every leaf the reference's specs split over "data"
    is data rank ``data_index``'s block of it, and every leaf a copy."""
    device = leaves(params)[0].device
    if cfg.zero:
        p = zero_layout(cfg, mesh)[1]
        lay = model.layout
        ls, paths = flatten(params)
        if lay is not None and _whole_chunks(optimizer.init({})):
            sizes = [_piece(w.numel(), p, lay.model)[1] for w in leaves(
                with_model_parallel(model, 1).abstract_params())]
        else:
            sizes = [_zero_pad_len(l.numel(), p) // p for l in ls]
        opt = optimizer.init(unflatten(paths, [
            torch.empty((k,), dtype=l.dtype, device=device)
            for k, l in zip(sizes, ls)]))
    elif model.layout is not None:
        whole = optimizer.init(
            with_model_parallel(model, 1).abstract_params())
        ls, paths = flatten(whole)
        opt = unflatten(paths, [
            torch.zeros(sharding.leaf_block(("opt",) + path, l,
                                            model.layout, 0).shape,
                        dtype=l.dtype, device=device)
            if l.is_meta else l for path, l in zip(paths, ls)])
    else:
        opt = optimizer.init(params)
    state = {"params": params, "opt": opt,
             "step": torch.zeros((), dtype=torch.int32)}
    if data_index is not None:
        data = data_width(cfg, mesh)
        dims = _state_data_dims(model, data, state)
        ls, paths = flatten(state)
        # copies, whole leaves too: each data rank updates its own
        state = unflatten(paths, [
            sharding.data_block(l, d, data, data_index).contiguous().clone()
            for l, d in zip(ls, dims)])
    if cfg.sync_mode == "compressed":
        if cfg.bucket_grads:
            state["ef"] = bucket_ef_zeros(
                grad_bucket_plan(params, cfg, model.layout), device=device)
        else:
            state["ef"] = map_tree(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params)
    return state


def abstract_state(model, optimizer, cfg: TrainCfg = TrainCfg(),
                   mesh=None):
    """Rank 0's state as ``meta`` tensors (shapes and dtypes, no
    memory): its data block of each leaf the ``auto`` step splits over
    "data"."""
    return make_train_state(model, optimizer, model.abstract_params(), cfg,
                            mesh=mesh,
                            data_index=0 if data_width(cfg, mesh) > 1
                            else None)


def data_width(cfg: TrainCfg, mesh) -> int:
    """The width of the "data" axis the step splits its state over, the
    reference's ``auto`` layout: ``mesh``'s "data" axis for an ``auto``
    step that syncs over it, else 1 (the state whole over "data")."""
    if (mesh is None or cfg.sync_mode != "auto"
            or sharding.DATA_AXIS not in cfg.data_axes):
        return 1
    return int(dict(mesh.shape).get(sharding.DATA_AXIS, 1))


def _state_data_dims(model, data: int, state) -> List[Optional[int]]:
    """Per leaf of ``state`` (a rank's, or the global tree: the paths
    are what count), the dim split over ``data`` ranks
    (``sharding.data_split``), from the shapes of ``model``'s params
    (a model rank's block: the data dim is never the model split's)."""
    ps, pp = flatten(model.abstract_params())
    shapes = {p: tuple(l.shape) for p, l in zip(pp, ps)}
    out = []
    for path in flatten(state)[1]:
        if path[0] == "params":
            out.append(sharding.data_split(path, model.layout, data,
                                           shapes[tuple(path[1:])]))
        elif path[0] == "opt" and path[1] != "step":
            param = shapes[sharding.opt_leaf(path, None)[0]]
            out.append(sharding.opt_data_leaf(path, model.layout, data,
                                              param)[1])
        else:
            out.append(None)
    return out


def replicate(state: Dict[str, Any], n: int) -> List[Dict[str, Any]]:
    """``n`` replicas: ``state`` itself and n - 1 copies on its device."""
    return [state] + [map_tree(lambda t: t.clone(), state)
                      for _ in range(n - 1)]


def _model_size(mesh) -> int:
    return dict(mesh.shape).get(sharding.MODEL_AXIS, 1)


def init_states(model, optimizer, params: Params, cfg: TrainCfg, mesh
                ) -> List[Dict[str, Any]]:
    """One fresh state per rank of ``mesh`` from the full ``params``:
    replicas of one state without a model axis or a data split, else
    rank r's state over its model coordinate's shard, and its data
    coordinate's block of it where the ``auto`` step splits over "data"
    (the ranks of one (data, model) coordinate hold copies)."""
    split = data_width(cfg, mesh) > 1
    if _model_axis(model, mesh) is None and not split:
        return replicate(make_train_state(model, optimizer, params, cfg,
                                          mesh=mesh), mesh.size)
    firsts: Dict[Tuple[int, Optional[int]], Dict[str, Any]] = {}
    states = []
    for r in range(mesh.size):
        c = mesh.coords(r)
        idx = (c.get(sharding.MODEL_AXIS, 0),
               c[sharding.DATA_AXIS] if split else None)
        if idx not in firsts:
            firsts[idx] = make_train_state(
                model, optimizer, model.shard(params, idx[0]), cfg,
                mesh=mesh, data_index=idx[1])
            states.append(firsts[idx])
        else:
            states.append(map_tree(lambda t: t.clone(), firsts[idx]))
    return states


# ---------------------------------------------------------------------------
# The run's state as one tree: the checkpoint layout
# ---------------------------------------------------------------------------

def _zero_opt_leaf(path) -> bool:
    """ZeRO shards every optimizer leaf but its step counter."""
    return path[0] == "opt" and path[1:] != ("step",)


def with_model_parallel(model, m: int):
    """``model`` built for a "model" axis of ``m`` ranks (itself when it
    is): the width is a property of the model a mesh runs, not of the
    state, which the checkpoint layout holds whole."""
    if model.model_parallel == m:
        return model
    return dataclasses.replace(model, model_parallel=m)


def _model_on(model, mesh):
    """``model`` built for ``mesh``'s "model" axis."""
    return with_model_parallel(model, _model_size(mesh))


def _layout_on(model, mesh) -> Optional[sharding.TPLayout]:
    """The split of ``model``'s config over ``mesh``'s "model" axis (None
    without a model axis)."""
    return _model_on(model, mesh).layout


def _bucket_leaves(flats, buckets, n: int) -> List[torch.Tensor]:
    """Each gradient leaf's slice of a bucketed EF residual (views)."""
    out = [None] * n
    for b, flat in zip(buckets, flats):
        for sl in b.slots:
            out[sl.index] = flat[sl.offset:sl.offset + sl.size].view(
                sl.shape)
    return out


def _bucket_plans(model, cfg: TrainCfg, lay):
    """(param paths, the bucket plan of a model rank's shard, of the
    global params): the EF layouts of a compressed, bucketed run."""
    local = with_model_parallel(model, lay.model).abstract_params()
    whole = with_model_parallel(model, 1).abstract_params()
    return (flatten(local)[1], grad_bucket_plan(local, cfg, lay),
            grad_bucket_plan(whole, cfg))


def _global_ef(model, cfg: TrainCfg, lay, efs) -> tuple:
    """The reference's bucketed EF residual (one flat f32 vector a
    bucket of the global params) from each model rank's (one a bucket of
    its shard; ``efs`` in model-rank order).  The residual is per value,
    so each leaf's values move: a split leaf's blocks join, and a leaf
    every model rank holds whole is model rank 0's, as data rank 0's
    stands for the data ranks'."""
    paths, local, whole = _bucket_plans(model, cfg, lay)
    per = [_bucket_leaves(ef, local, len(paths)) for ef in efs]
    leaves_ = [sharding.join_blocks(path, [pm[j] for pm in per], lay)
               for j, path in enumerate(paths)]
    return tuple(torch.cat([leaves_[sl.index].reshape(-1)
                            for sl in b.slots]) for b in whole)


def _local_ef(model, cfg: TrainCfg, lay, ef, m: int) -> tuple:
    """Model rank ``m``'s bucketed EF residual from the global one."""
    paths, local, whole = _bucket_plans(model, cfg, lay)
    per = _bucket_leaves(ef, whole, len(paths))
    return tuple(torch.cat([
        sharding.leaf_block(paths[sl.index], per[sl.index], lay, m)
        .reshape(-1) for sl in b.slots]) for b in local)


def global_abstract_state(model, optimizer, cfg: TrainCfg = TrainCfg(),
                          mesh=None):
    """The checkpoint layout as ``meta`` tensors: the reference's global
    tree, built from the whole config (every leaf whole, whatever the
    model axis); with ``cfg.zero`` each optimizer leaf is the whole
    param's flat length padded to a multiple of the data width."""
    whole = with_model_parallel(model, 1)
    st = make_train_state(whole, optimizer, whole.abstract_params(), cfg,
                          mesh=mesh)
    if not cfg.zero:
        return st
    p = zero_layout(cfg, mesh)[1]
    ls, paths = flatten(st)
    return unflatten(paths, [
        torch.empty((l.shape[0] * p,), dtype=l.dtype, device="meta")
        if _zero_opt_leaf(path) else l for path, l in zip(paths, ls)])


def _model_groups(mesh, zaxis: Optional[str]) -> List[List[int]]:
    """For each model coordinate, in order: its ranks at coordinate 0 of
    every other axis, except ``zaxis`` (ZeRO's), whose ranks it lists in
    coordinate order."""
    groups: Dict[int, List[Tuple[int, int]]] = {}
    for r in range(mesh.size):
        c = mesh.coords(r)
        if any(v for a, v in c.items() if a not in (sharding.MODEL_AXIS,
                                                     zaxis)):
            continue
        groups.setdefault(c.get(sharding.MODEL_AXIS, 0), []).append(
            (c.get(zaxis, 0), r))
    return [[r for _, r in sorted(groups[m])] for m in sorted(groups)]


def gather_state(states: List[Dict[str, Any]], cfg: TrainCfg, mesh,
                 model) -> Any:
    """The run's state on ``mesh`` (of ``model``, built for any model
    width) as one tree in the reference's global layout (what a
    checkpoint saves), read from the ranks at data coordinate 0 (the EF
    residual is each rank's own; like the reference's checkpoint, this
    keeps theirs).  No copies are made, except for ZeRO's optimizer
    leaves of split params and a bucketed EF residual over "model":

    - a leaf every model rank holds whole is rank 0's tensor;
    - a leaf split over "model" is a ``ShardedTensor`` of the model
      ranks' blocks, each with its global box, so a sharded save writes
      one file a block (a sectioned leaf, ``sharding.leaf_sections``:
      one box a section a rank);
    - with ``cfg.zero`` an optimizer leaf is a ``ShardedTensor`` of the
      data ranks' chunks of the flat padded leaf where the ranks hold
      those chunks: of a whole param, and (Adafactor's over "model",
      ``_whole_chunks``) of every param, each chunk in its model ranks'
      pieces.  AdamW's leaf of a split param is written dense, on the
      host: the
      chunks are of each model rank's flat block, which a column split
      strides through the global flat order, so each model rank's chunks
      are joined, cut to its block, the blocks joined over "model", and
      the whole leaf flattened and padded to the data width;
    - a bucketed EF residual over "model" is the global params' buckets,
      each leaf's values moved from its model ranks' buckets;
    - a leaf the ``auto`` step splits over "data" (``data_width``) is a
      ``ShardedTensor`` of every (data, model) rank's block, each box cut
      to the rank's rows or columns."""
    lay = _layout_on(model, mesh)
    zaxis, p = zero_layout(cfg, mesh) if cfg.zero else (None, 1)
    data = data_width(cfg, mesh)
    if data > 1:
        zaxis = sharding.DATA_AXIS
        ddims = _state_data_dims(_model_on(model, mesh), data, states[0])
    groups = _model_groups(mesh, zaxis)
    ef = None
    if lay is not None and isinstance(states[0].get("ef"), tuple):
        ef = _global_ef(model, cfg, lay,
                        [states[g[0]]["ef"] for g in groups])
        states = [{k: v for k, v in st.items() if k != "ef"}
                  for st in states]
    paths = flatten(states[0])[1]
    per_rank = {r: flatten(states[r])[0] for g in groups for r in g}
    first = per_rank[groups[0][0]]
    shapes = {path[1:]: tuple(l.shape) for path, l in zip(paths, first)
              if path[0] == "params"}
    by_piece = (cfg.zero and lay is not None
                and _whole_chunks(states[0]["opt"]))
    out = []
    for i, path in enumerate(paths):
        l = first[i]
        d = None if lay is None else sharding.leaf_split(path, lay)
        if data > 1 and ddims[i] is not None:
            pieces = [sharding.data_pieces(path, per_rank[r][i], lay, m,
                                           ddims[i], data, k)
                      for m, g in enumerate(groups)
                      for k, r in enumerate(g)]
            out.append(ShardedTensor(pieces[0][0], l.dtype, [
                piece for _, ps in pieces for piece in ps]))
        elif by_piece and _zero_opt_leaf(path):
            pp = sharding.opt_leaf(path, lay)[0]
            c, k = _piece(math.prod(sharding.global_shape(pp, shapes[pp],
                                                          lay)), p,
                          lay.model)
            out.append(ShardedTensor((c * p,), l.dtype, [
                ([[q * c + j * k, q * c + min((j + 1) * k, c)]],
                 per_rank[r][i][:min(k, c - j * k)])
                for j, g in enumerate(groups) for q, r in enumerate(g)
                if j * k < c]))
        elif cfg.zero and _zero_opt_leaf(path) and d is None:
            c = l.shape[0]
            out.append(ShardedTensor((c * p,), l.dtype, [
                ([[k * c, (k + 1) * c]], per_rank[r][i])
                for k, r in enumerate(groups[0])]))
        elif cfg.zero and _zero_opt_leaf(path):
            shape = shapes[sharding.opt_leaf(path, lay)[0]]
            n = math.prod(shape)
            whole = sharding.global_shape(path, shape, lay)
            flat = torch.empty(_zero_pad_len(math.prod(whole), p),
                               dtype=l.dtype)
            flat[math.prod(whole):].zero_()
            dense = flat[:math.prod(whole)].view(whole)
            c = l.shape[0]       # staged in pinned memory off a card
            own = torch.empty(c * p, dtype=l.dtype, pin_memory=l.is_cuda)
            for m, g in enumerate(groups):
                for k, r in enumerate(g):     # this model rank's chunks
                    own[k * c:(k + 1) * c].copy_(per_rank[r][i])
                sharding.put_block(path, dense, lay, m,
                                   own[:n].view(shape))
            out.append(flat)
        elif d is not None:
            pieces = [sharding.leaf_pieces(path, per_rank[g[0]][i], lay,
                                           m) for m, g in enumerate(groups)]
            out.append(ShardedTensor(pieces[0][0], l.dtype, [
                piece for _, ps in pieces for piece in ps]))
        else:
            out.append(l)
    tree = unflatten(paths, out)
    if ef is not None:
        tree["ef"] = ef
    return tree


def scatter_state(tree: Any, cfg: TrainCfg, mesh, model
                  ) -> List[Dict[str, Any]]:
    """Per-rank states on ``mesh`` from a tree in the checkpoint layout
    (``global_abstract_state`` for this mesh's data width, saved at any
    model width): rank r takes its model coordinate's block of every
    split leaf (``model`` on a mesh with a model axis) and, with
    ``cfg.zero``, its data coordinate's chunk of the flat padded block of
    every optimizer leaf (Adafactor's over a model axis: its piece of
    the whole param's chunk, ``_piece``), and, where the ``auto`` step
    splits over "data" (``data_width``; a dim that does not divide held
    whole), its data coordinate's block of every split leaf; every
    other leaf is copied whole.  Tensors go to
    the mesh's device, the step counters to the host, where
    ``make_train_state`` puts them."""
    lay = _layout_on(model, mesh)
    zaxis, p = zero_layout(cfg, mesh) if cfg.zero else (None, 1)
    ef = None
    if lay is not None and isinstance(tree.get("ef"), tuple):
        ef = tree["ef"]
        tree = {k: v for k, v in tree.items() if k != "ef"}
    ls, paths = flatten(tree)
    data = data_width(cfg, mesh)
    ddims = (_state_data_dims(_model_on(model, mesh), data, tree)
             if data > 1 else [None] * len(ls))
    shapes = {path[1:]: tuple(l.shape) for path, l in zip(paths, ls)
              if path[0] == "params"}
    by_piece = (cfg.zero and lay is not None
                and _whole_chunks(tree["opt"]))
    blocks: Dict[Tuple[int, int], torch.Tensor] = {}

    def block(i, path, l, m):
        """Model rank m's block of leaf i; a ZeRO optimizer leaf's flat
        and padded to the data width."""
        if (i, m) in blocks:
            return blocks[i, m]
        d = None if lay is None else sharding.leaf_split(path, lay)
        if d is None:
            x = l
        elif cfg.zero and _zero_opt_leaf(path):
            shape = shapes[sharding.opt_leaf(path, lay)[0]]
            x = sharding.leaf_block(path, l[:math.prod(shape)].view(shape),
                                    lay, m).reshape(-1)
            x = torch.cat([x, x.new_zeros(
                _zero_pad_len(x.numel(), p) - x.numel())])
        else:
            x = sharding.leaf_block(path, l, lay, m)
        blocks[i, m] = x
        return x

    states = []
    for r in range(mesh.size):
        c = mesh.coords(r)
        m, k = c.get(sharding.MODEL_AXIS, 0), c.get(zaxis, 0)
        out = []
        for i, (path, l) in enumerate(zip(paths, ls)):
            if by_piece and _zero_opt_leaf(path):
                n = math.prod(shapes[sharding.opt_leaf(path, lay)[0]])
                x = _piece_of(l[:n], p, lay.model, k, m)
            else:
                x = block(i, path, l, m if lay is not None else 0)
            if cfg.zero and _zero_opt_leaf(path) and not by_piece:
                cs = x.shape[0] // p
                x = x[k * cs:(k + 1) * cs]
            if ddims[i] is not None:
                x = sharding.data_block(x, ddims[i], data,
                                        c[sharding.DATA_AXIS])
            y = x.to("cpu" if path[-1] == "step" else mesh.device,
                     copy=True)
            out.append(y if y.is_contiguous() else y.contiguous())
        st = unflatten(paths, out)
        if ef is not None:
            st["ef"] = tuple(t.to(mesh.device, copy=True)
                             for t in _local_ef(model, cfg, lay, ef, m))
        states.append(st)
    return states


def logical_state(tree) -> Any:
    """A tree in the checkpoint layout with each ``ShardedTensor`` made
    dense and each flat optimizer leaf cut to its param's size: ZeRO's
    padding dropped, so the states of two widths compare leaf for
    leaf."""
    ls, paths = flatten(tree)
    sizes = {path[1:]: math.prod(l.shape) for path, l in zip(paths, ls)
             if path[0] == "params"}
    out = []
    for path, l in zip(paths, ls):
        if isinstance(l, ShardedTensor):
            l = l.dense(device=l.shards[0][1].device)
        n = (sizes.get(sharding.opt_leaf(path, None)[0])
             if path[0] == "opt" else None)
        out.append(l[:n] if n is not None and l.ndim == 1 else l)
    return unflatten(paths, out)


# ---------------------------------------------------------------------------
# Grad accumulation over microbatches
# ---------------------------------------------------------------------------

def _split_micro(batch: Dict[str, torch.Tensor], n: int):
    """``n`` microbatches of equal rows, in order; a microbatch's
    ``positions`` is ``positions[:, i*b:(i+1)*b]``."""
    out = []
    for i in range(n):
        mb = {}
        for k, v in batch.items():
            b = v.shape[batch_dim(k, v)] // n
            mb[k] = batch_rows(k, v, i * b, (i + 1) * b)
        out.append(mb)
    return out


def _accumulate_grads(model, params: Params, batch, n_micro: int,
                      grad_dtype, data_dims=None
                      ) -> Tuple[torch.Tensor, Params]:
    """Loss and gradients of ``batch``, averaged over ``n_micro``
    microbatches accumulated in ``grad_dtype`` (one microbatch keeps each
    param's own dtype, as the reference's ``value_and_grad`` does).

    Each microbatch's gradients are added into the accumulator in place,
    leaf by leaf, each let go once added, and the sum is scaled in place:
    the accumulator and one microbatch's gradients are all that is live
    at once.  ``data_dims`` (per leaf, the dim the ``auto`` step splits
    over "data", or None) makes the step's ``sharding.DataSplit``: a
    split leaf's accumulator is the rank's data block, into which the
    staged backward reduce-scatters each microbatch's gradient (the sum
    over "data", not yet its mean)."""
    ps, paths = flatten(params)
    dims = [None] * len(ps) if data_dims is None else list(data_dims)
    acc = [torch.zeros(p.shape, dtype=grad_dtype if n_micro > 1
                       else p.dtype, device=p.device)
           if n_micro > 1 or d is not None else None
           for p, d in zip(ps, dims)]
    trace.label(acc, "grads")
    split = (contextlib.nullcontext() if data_dims is None
             else sharding.DataSplit(dims, acc))
    loss_sum = None
    with split:
        for mb in (_split_micro(batch, n_micro) if n_micro > 1
                   else [batch]):
            loss, grads = model.loss_and_grads(params, mb)
            gl = leaves(grads)
            del grads
            for i, g in enumerate(gl):
                gl[i] = None
                if g is None:            # reduce-scattered into acc[i]
                    continue
                if acc[i] is None:       # one microbatch: its gradient
                    acc[i] = g
                else:
                    acc[i].add_(g.to(acc[i].dtype))
                del g
            loss_sum = loss if loss_sum is None else loss_sum + loss
    if n_micro == 1:
        return loss_sum, unflatten(paths, acc)
    inv = 1.0 / n_micro
    for a in acc:
        a.mul_(inv)
    return loss_sum * inv, unflatten(paths, acc)


# ---------------------------------------------------------------------------
# Gradient sync flavours (all scale through the communicator's mean_scale)
# ---------------------------------------------------------------------------

def _sync_program(base: schedule_mod.Schedule, overlap: bool,
                  depth: int) -> schedule_mod.Schedule:
    """The blocking program ``base``, rewritten by the canonical overlap
    pass pipeline when ``overlap`` is set."""
    if not overlap:
        return base
    sched, timings = plan_mod.run_passes(
        base, plan_mod.canonical_overlap_passes(depth))
    sched.meta["depth"] = depth
    sched.meta["pass_us"] = timings
    return sched


def _bucket_sync(dcomm, axis_comms, handles, buckets, grads, compress, ef,
                 sched):
    """Fused dtype-grouped buckets (the reference's ``_bucket_sync``), in
    the order of the program ``sched``: uncompressed buckets go through
    persistent handles, compressed ones through the communicator's
    two-phase sync (the EF residual changes in its wait arm, in place,
    nowhere else)."""
    gl, paths = flatten(grads)
    out = [None] * len(gl)
    if compress:
        if ef is None:
            ef = bucket_ef_zeros(buckets, device=gl[0].device)
        else:
            check_bucket_ef(ef, buckets)

    def start(u):
        flat = plan_mod.gather_bucket(gl, buckets[u.index])
        if compress:
            # mean=False: as engine.sync_gradients_bucketed, scale once,
            # over all data axes, after the cross-axis reductions
            return axis_comms[0].sync_gradient_start(
                flat, mean=False, compress=True, ef_residual=ef[u.index])
        return handles[u.index].start(flat)

    def progress(u, tok, stages):
        if compress:
            axis_comms[0].sync_gradient_progress(tok, stages)
        else:
            handles[u.index].progress(tok, stages)
        return tok

    def wait(u, tok):
        bi = u.index
        if compress:
            y, res = axis_comms[0].sync_gradient_wait(tok)
            for acomm in axis_comms[1:]:
                y = acomm.all_reduce(y)
            y = scale_by(y, dcomm.mean_scale())
            ef[bi].copy_(res)
        else:
            y = handles[bi].wait(tok)
        plan_mod.scatter_bucket(y, buckets[bi], out)
        return None

    schedule_mod.execute(sched, start=start, wait=wait, progress=progress)
    return unflatten(paths, out), ef


def _leaf_sync(dcomm, axis_comms, grads, compress, ef_tree, sched):
    """One collective per gradient leaf (the reference's ``_leaf_sync``):
    one two-phase sync per leaf, in the order of the program
    ``sched``.  Each leaf of ``grads`` (the step's own tree, which
    nothing reads after) is dropped from it once its sync is done, so
    that a rank holds its gradients once, not twice, by the end of the
    sync."""
    gl, paths = flatten(grads)
    out = [None] * len(gl)
    ef_leaves = flatten(ef_tree)[0] if compress else None
    comm = axis_comms[0] if compress else dcomm

    def start(u):
        i = u.index
        if compress:
            return comm.sync_gradient_start(gl[i], compress=True,
                                            ef_residual=ef_leaves[i])
        return comm.sync_gradient_start(gl[i])

    def progress(u, tok, stages):
        comm.sync_gradient_progress(tok, stages)
        return tok

    def wait(u, tok):
        i = u.index
        y, res = comm.sync_gradient_wait(tok)
        if compress:
            for acomm in axis_comms[1:]:
                y = acomm.all_reduce(y, mean=True)
            ef_leaves[i].copy_(res)
        out[i] = y
        gl[i] = None
        _drop(grads, paths[i])
        return None

    schedule_mod.execute(sched, start=start, wait=wait, progress=progress)
    return unflatten(paths, out), ef_tree


def _drop(tree, path) -> None:
    """Set the leaf at ``path`` of the nested dict ``tree`` to None."""
    for k in path[:-1]:
        tree = tree[k]
    tree[path[-1]] = None


# ---------------------------------------------------------------------------
# Step builder
# ---------------------------------------------------------------------------

def make_train_step(model, optimizer, cfg: TrainCfg = TrainCfg(), *,
                    comm: Communicator) -> Callable:
    """Returns ``train_step(states, batch) -> (states, metrics)``.

    ``states``: one state per rank of the communicator's mesh;
    ``batch``: the global batch (numpy arrays or tensors, rows at
    ``batch_dim``), split over the data axes (``data.shard_batch``).
    ``metrics`` are rank 0's (every rank holds the same all-reduced
    loss).  ``train_step.schedule``
    is the executed sync program (ZeRO: its RS half; the AG half is
    ``train_step.ag_schedule``, None without ZeRO).

    Every sync flavour runs on a mesh with a "model" axis too, ZeRO-1
    with either optimizer: Adafactor's ZeRO state is then each rank's
    piece of the reference's chunk of every whole param (``_piece``),
    AdamW's the chunks of the rank's block.  The model's remat applies
    over "model" as without it: each block is checkpointed on the
    staged backward's tape (``models.remat``)."""
    mesh = comm.mesh
    if mesh is None:
        raise ValueError("the communicator's session has no mesh")
    data_axes = tuple(a for a in cfg.data_axes if a in mesh.axis_names)
    if not data_axes:
        raise ValueError(
            f"sync_mode={cfg.sync_mode!r} has nothing to sync over: none "
            f"of cfg.data_axes={cfg.data_axes} exist in the mesh axes "
            f"{mesh.axis_names}")
    tp = _model_axis(model, mesh)
    split_sum = None if tp is None else tp.split_sum
    lead_blocks = None if tp is None else tp.lead_blocks
    if cfg.sync_mode == "auto":
        return _auto_train_step(model, optimizer, cfg, mesh, data_axes, tp)
    compress = cfg.sync_mode == "compressed"
    dcomm = comm.split(*data_axes)
    axis_comms = tuple(comm.split(a) for a in data_axes)
    overlap, depth = bool(cfg.overlap), int(cfg.overlap_depth)
    params_abs = model.abstract_params()
    gstructs = _grad_structs(params_abs, cfg)

    # The unit layout is static, so the sync program is built (and, with
    # ``overlap``, rewritten) once, and uncompressed buckets get
    # persistent handles bound once (sync_stats: their starts record the
    # wire bytes of the planned call).
    buckets, bucket_handles, sched = (), (), None
    if cfg.bucket_grads:
        buckets = grad_bucket_plan(params_abs, cfg, model.layout)
        if not compress:
            bucket_handles = tuple(
                dcomm.persistent("all_reduce", (b.size,), b.wire_dtype,
                                 mean=True, sync_stats=True)
                for b in buckets)
        specs = [(f"bucket{i}", b.size, b.wire_dtype)
                 for i, b in enumerate(buckets)]
    else:
        specs = [(f"leaf{i}", math.prod(s.shape), s.dtype)
                 for i, s in enumerate(gstructs)]
    if not cfg.zero:
        sched = _sync_program(dcomm.sync_schedule(specs, compress=compress),
                              overlap, depth)

    # ZeRO-1: two persistent arms a leaf (RS of the grad, AG of the
    # updated param chunk) and the two programs sequencing them; the
    # optimizer update sits between the programs.
    rs_handles = ag_handles = ()
    rs_sched = ag_sched = None
    # Adafactor over "model" (``by_piece``): rank (d, j)'s pieces of the
    # whole params' chunks; its reduce-scatter sums its pieces of every
    # data rank's chunk
    by_piece = (cfg.zero and tp is not None
                and _whole_chunks(optimizer.init({})))
    if cfg.zero:
        _, zp = zero_layout(cfg, mesh)
        zcomm = axis_comms[0]
        pleaves_abs = leaves(params_abs)
        if by_piece:
            wshapes = [tuple(w.shape) for w in leaves(
                with_model_parallel(model, 1).abstract_params())]
            pieces = [_piece(math.prod(sh), zp, tp.model) for sh in wshapes]
            chunk_sizes = [k for _, k in pieces]
            rs_shapes = [(zp * k,) for k in chunk_sizes]
        else:
            chunk_sizes = [_zero_pad_len(g.numel(), zp) // zp
                           for g in gstructs]
            rs_shapes = [g.shape for g in gstructs]
        rs_handles = tuple(
            zcomm.persistent("reduce_scatter", shape, g.dtype,
                             mean=True, sync_stats=True, zero=True)
            for shape, g in zip(rs_shapes, gstructs))
        ag_handles = tuple(
            zcomm.persistent("all_gather", (csz,), l.dtype, zero=True)
            for csz, l in zip(chunk_sizes, pleaves_abs))
        rs_sched = _sync_program(zcomm.zero_sync_schedule(
            [(f"leaf{i}", math.prod(shape), g.dtype)
             for i, (shape, g) in enumerate(zip(rs_shapes, gstructs))],
            kind="rs"), overlap, depth)
        # the AG's compute op models the NEXT step's forward, which the
        # passes place the AG starts ahead of
        ag_sched = _sync_program(zcomm.zero_sync_schedule(
            [(f"param{i}", csz * zp, l.dtype)
             for i, (csz, l) in enumerate(zip(chunk_sizes, pleaves_abs))],
            kind="ag", compute=(("next_forward", True),)), overlap, depth)

    def zero_inner(st, loss, gl, gpaths):
        """The ZeRO-1 step body of one rank: RS-program the gradient
        leaves ``gl`` down to this rank's chunks, update the local state
        chunk, AG-program the new param chunks back into the params (in
        place)."""
        chunks = [None] * len(gl)
        if by_piece:
            j = sharding.model_index()

        def rs_start(u):
            i = u.index
            if by_piece:    # the whole gradient, one leaf at a time
                g = tp.gather(i, gl[i])
                gl[i] = None
                return rs_handles[i].start(torch.cat([
                    _piece_of(g, zp, tp.model, d, j) for d in range(zp)]))
            return rs_handles[i].start(gl[i])

        def rs_progress(u, tok, stages):
            rs_handles[u.index].progress(tok, stages)
            return tok

        def rs_wait(u, tok):
            chunks[u.index] = rs_handles[u.index].wait(tok)
            gl[u.index] = None           # the full gradient is done with
            return None

        schedule_mod.execute(rs_sched, start=rs_start, wait=rs_wait,
                             progress=rs_progress)
        for acomm in axis_comms:
            loss = acomm.all_reduce(loss)
        loss = scale_by(loss, dcomm.mean_scale())
        # the global grad norm from chunk-local sums and one scalar
        # all-reduce: the unsharded path's value up to summation order,
        # so bit-identical losses need clip_norm=0 (a metric only)
        if tp is None or by_piece:
            gsq = zcomm.all_reduce(sum(sum_of_squares(ch) for ch in chunks))
            if by_piece:    # each value in one rank's piece
                gsq = sharding.psum(gsq)
        else:
            # split leaves' squares add over "model" too
            sq_split, sq_rep = _split_squares(chunks, tp.split)
            gsq = sharding.psum(zcomm.all_reduce(sq_split)) + \
                zcomm.all_reduce(sq_rep)
        idx = zcomm.axis_index()
        pleaves = leaves(st["params"])
        if by_piece:
            pchunks = [_piece_of(tp.gather(i, l), zp, tp.model, idx, j)
                       for i, l in enumerate(pleaves)]
            hooks = dict(split_sum=lambda i, x, over, n: (
                sharding.psum(x), pieces[i][0]))
        else:
            pchunks = [_zero_chunk(l, zp, idx) for l in pleaves]
            hooks = {}
        new_pc, new_opt, om = optimizer.update(
            unflatten(gpaths, chunks), st["opt"],
            unflatten(gpaths, pchunks),
            global_norm_fn=lambda _tree: torch.sqrt(gsq), **hooks)
        npc = leaves(new_pc)

        def ag_start(u):
            return ag_handles[u.index].start(npc[u.index])

        def ag_progress(u, tok, stages):
            ag_handles[u.index].progress(tok, stages)
            return tok

        def ag_wait(u, tok):
            i = u.index
            y = ag_handles[i].wait(tok)
            ref = pleaves[i]
            if by_piece:    # every model rank's pieces, then its block
                ys = collectives.all_gather(y[None], sharding.MODEL_AXIS,
                                            dim=0)
                y = tp.block(i, _from_pieces(
                    ys, math.prod(wshapes[i]), zp).view(wshapes[i]))
            ref.copy_(y.reshape(-1)[:ref.numel()].view(ref.shape))
            return None

        schedule_mod.execute(ag_sched, start=ag_start, wait=ag_wait,
                             progress=ag_progress)
        return ({"params": st["params"], "opt": new_opt,
                 "step": st["step"] + 1}, {"loss": loss, **om})

    def rank_step(st, batch):
        loss, grads = _accumulate_grads(model, st["params"], batch,
                                        cfg.microbatches, cfg.grad_dtype)
        trace.label(grads, "grads")
        with torch.no_grad():
            if tp is not None:
                grads = tp.reduce_partials(grads)
                if cfg.check_model_replicas:
                    tp.check_replicated(grads)
            if cfg.zero:
                gl, gpaths = flatten(grads)
                del grads                # each leaf goes once it is reduced
                return zero_inner(st, loss, gl, gpaths)
            ef = st.get("ef")
            if cfg.bucket_grads:
                grads, new_ef = _bucket_sync(
                    dcomm, axis_comms, bucket_handles, buckets, grads,
                    compress, ef, sched)
            else:
                grads, new_ef = _leaf_sync(dcomm, axis_comms, grads,
                                           compress, ef, sched)
            for acomm in axis_comms:
                loss = acomm.all_reduce(loss)
            loss = scale_by(loss, dcomm.mean_scale())
            new_params, new_opt, om = optimizer.update(
                grads, st["opt"], st["params"],
                global_norm_fn=None if tp is None else tp.global_norm,
                split_sum=split_sum, lead_blocks=lead_blocks)
        new_state = {"params": new_params, "opt": new_opt,
                     "step": st["step"] + 1}
        if compress:
            new_state["ef"] = new_ef
        return new_state, {"loss": loss, **om}

    train_step = _spmd_step(rank_step, mesh, data_axes)
    train_step.schedule = rs_sched if cfg.zero else sched
    train_step.ag_schedule = ag_sched
    return train_step


@dataclasses.dataclass(frozen=True)
class _ModelAxis:
    """What the step does across a model axis, static in the param
    layout: ``partial`` marks the gradient leaves that are partial sums
    over the model ranks, ``dims`` the dim each leaf is split at (None:
    every model rank holds it whole), ``model`` the axis size, ``paths``
    the leaves' paths and ``layout`` the split (what ``gather`` and
    ``block`` join and cut by)."""

    partial: Tuple[bool, ...]
    dims: Tuple[Optional[int], ...]
    model: int
    paths: Tuple[Tuple[str, ...], ...] = ()
    layout: Optional[sharding.TPLayout] = None

    @property
    def split(self) -> Tuple[bool, ...]:
        """Per leaf: is it a block of a split leaf?"""
        return tuple(d is not None for d in self.dims)

    def split_sum(self, i: int, x: torch.Tensor, over: str, n: int
                  ) -> Tuple[torch.Tensor, int]:
        """The optimizer's hook (``optimizer.update(..., split_sum=)``):
        ``x``, a partial of a reduction of leaf ``i`` over its columns
        (``over="cols"``), rows (``"rows"``) or all of it (``"all"``) of
        ``n`` values, summed over "model" when that reduction crosses the
        leaf's split dim, with the count of values summed.  A replicated
        or partial-sum leaf is whole on every rank, and an expert stack's
        (split at -3) rows and columns are each rank's own, as is a clip
        group of its own experts (``over="own"``)."""
        d = self.dims[i]
        if d is None or over == "own" or (over == "cols" and d != -1) or (
                over == "rows" and d != -2):
            return x, n
        return sharding.psum(x), n * self.model

    def gather(self, i: int, block: torch.Tensor) -> torch.Tensor:
        """The whole leaf ``i`` from every model rank's ``block`` of it
        (all-gathered over "model"; the block itself where every model
        rank holds the leaf whole)."""
        if self.dims[i] is None:
            return block
        seen = collectives.all_gather(block[None], sharding.MODEL_AXIS,
                                      dim=0)
        return sharding.join_blocks(self.paths[i], list(seen), self.layout)

    def block(self, i: int, whole: torch.Tensor) -> torch.Tensor:
        """This model rank's block of the whole leaf ``i``."""
        return sharding.leaf_block(self.paths[i], whole, self.layout,
                                   sharding.model_index())

    def lead_blocks(self, i: int, ndim: int) -> int:
        """The optimizer's hook (``optimizer.update(..., lead_blocks=)``):
        into how many blocks leaf ``i`` (of ``ndim`` dims) is cut along
        its leading dim (an expert stack of one layer, split at -3)."""
        return self.model if self.dims[i] == -ndim else 1

    def reduce_partials(self, grads):
        """Sum the partial-sum leaves over "model" (no mean)."""
        gl, paths = flatten(grads)
        return unflatten(paths, [sharding.psum(g) if p else g
                                 for g, p in zip(gl, self.partial)])

    def check_replicated(self, grads) -> None:
        """Raise unless every leaf the model ranks hold whole (norms,
        and the partial-sum leaves once summed) has the same gradient on
        every model rank, bit for bit."""
        gl, paths = flatten(grads)
        rep = [(p, g) for p, g, s in zip(paths, gl, self.split) if not s]
        flat = torch.cat([g.reshape(-1).float() for _, g in rep])
        seen = collectives.all_gather(flat[None], sharding.MODEL_AXIS,
                                      dim=0)
        if seen.is_meta:         # the dry-run's: no bits to compare
            return
        blocks = seen.split([g.numel() for _, g in rep], dim=1)
        bad = ["/".join(p) for (p, _), b in zip(rep, blocks)
               if not all(torch.equal(b[0], r) for r in b[1:])]
        if bad:
            raise RuntimeError(f"model rank {sharding.model_index()}: the "
                               f"gradients of {bad} differ across "
                               f"\"model\"")

    def global_norm(self, grads) -> torch.Tensor:
        """The whole model's gradient norm: the split leaves' squares
        summed over "model", the replicated leaves' counted once."""
        sq_split, sq_rep = _split_squares(leaves(grads), self.split)
        return torch.sqrt(sharding.psum(sq_split) + sq_rep)


@dataclasses.dataclass(frozen=True)
class _DataAxis:
    """What the ``auto`` step does across the "data" axis it splits the
    state over (``data_width``), static in the param layout: ``dims``
    the dim of each param leaf split over ``data`` ranks (None: whole on
    every data rank), ``model`` the step's ``_ModelAxis`` (None without
    a model axis), whose hooks it extends."""

    dims: Tuple[Optional[int], ...]
    data: int
    model: Optional[_ModelAxis] = None

    def mean(self, grads, data_axes):
        """The mean over the data axes (in their order): a split leaf's
        block, already summed over "data" by its reduce-scatters, scaled
        by 1 / data in place, and averaged over the other axes ("pod"
        replicates the blocks); a whole leaf averaged over every axis
        (``collectives.pmean``)."""
        gl, paths = flatten(grads)
        for a in data_axes:
            for i, g in enumerate(gl):
                if self.dims[i] is not None and a == sharding.DATA_AXIS:
                    g.div_(self.data)
                else:
                    gl[i] = collectives.pmean(g, a)
        return unflatten(paths, gl)

    def split_sum(self, i: int, x: torch.Tensor, over: str, n: int
                  ) -> Tuple[torch.Tensor, int]:
        """The optimizer's hook: the model axis's (``_ModelAxis.
        split_sum``), then a sum over "data" where the reduction crosses
        the leaf's data split (a clip group, ``"all"`` or ``"own"``,
        always spans the data blocks: "data" never splits a leaf's
        leading dim)."""
        if self.model is not None:
            x, n = self.model.split_sum(i, x, over, n)
        d = self.dims[i]
        if d is None or (over == "cols" and d != -1) or (
                over == "rows" and d != -2):
            return x, n
        return collectives.psum(x, sharding.DATA_AXIS), n * self.data

    def global_norm(self, grads) -> torch.Tensor:
        """The whole model's gradient norm: a leaf's squares summed over
        each axis that splits it, once on every rank that holds it
        whole (one all-reduce over "model", one over "data")."""
        gs = leaves(grads)
        split_m = ((False,) * len(gs) if self.model is None
                   else self.model.split)
        zero = torch.zeros((), dtype=torch.float32, device=gs[0].device)
        sq = {}
        for g, m, d in zip(gs, split_m, self.dims):
            key = (m, d is not None)
            sq[key] = sq.get(key, zero) + sum_of_squares(g)
        part = [sq.get((True, True), zero), sq.get((True, False), zero)]
        if self.model is not None:
            part = list(sharding.psum(torch.stack(part)))
        over_data = collectives.psum(part[0] + sq.get((False, True), zero),
                                     sharding.DATA_AXIS)
        return torch.sqrt(over_data + part[1] + sq.get((False, False),
                                                       zero))


def _data_axis(model, cfg: TrainCfg, mesh, tp: Optional[_ModelAxis]
               ) -> Optional[_DataAxis]:
    """The step's data split (None where ``data_width`` is 1)."""
    data = data_width(cfg, mesh)
    if data == 1:
        return None
    ps, paths = flatten(model.abstract_params())
    return _DataAxis(
        dims=tuple(sharding.data_split(("params",) + p, model.layout, data,
                                       l.shape)
                   for p, l in zip(paths, ps)),
        data=data, model=tp)


def _split_squares(gs, split):
    """(sum of squares of the split leaves, of the replicated ones), in
    f32 (tensors, ``gs[0]``'s device)."""
    zero = torch.zeros((), dtype=torch.float32, device=gs[0].device)
    sq = [sum_of_squares(g) for g in gs]
    return (sum((q for q, s in zip(sq, split) if s), zero),
            sum((q for q, s in zip(sq, split) if not s), zero))


def _model_axis(model, mesh) -> Optional[_ModelAxis]:
    """The step's model-axis plan (None without a model axis); raises
    when the model was built for another model-axis size."""
    m = _model_size(mesh)
    if m != model.model_parallel:
        raise ValueError(f"the mesh's model axis has {m} ranks, the model "
                         f"is built for {model.model_parallel} "
                         f"(build_model(cfg, model_parallel={m}))")
    if m == 1:
        return None
    paths = flatten(model.abstract_params())[1]
    return _ModelAxis(
        partial=tuple(sharding.partial_sum_leaves(paths, model.layout)),
        dims=tuple(sharding.leaf_split(p, model.layout) for p in paths),
        model=m, paths=tuple(paths), layout=model.layout)


def _spmd_step(rank_step, mesh, data_axes) -> Callable:
    """``train_step(states, batch)``: ``rank_step(state, rows)`` on every
    rank of ``mesh``, rank r given its rows of the global batch, split
    over ``data_axes`` by ``data.shard_batch``.  Returns the new states
    and rank 0's metrics."""

    def train_step(states, batch):
        rows = shard_batch(batch, mesh, data_axes)
        out = substrate.run_spmd(
            rank_step, [(states[r], rows[r]) for r in range(mesh.size)],
            mesh)
        return [o[0] for o in out], out[0][1]

    return train_step


def _auto_train_step(model, optimizer, cfg: TrainCfg, mesh,
                     data_axes, tp: Optional[_ModelAxis]) -> Callable:
    """The ``auto`` step: each rank's gradients of its rows, every leaf
    (and the loss) averaged over the data axes by
    ``collectives.pmean`` through the monolithic default session, then
    the optimizer update, as the reference's step with the compiler's
    inserted sync.

    On a "data" axis of more than one rank (``data_width``) the state is
    the reference's ``auto`` layout, its FSDP: each rank holds its data
    block of every leaf the reference's specs split over "data"
    (``sharding.data_split``), params, gradient accumulator and
    optimizer state alike.  Each block's whole weights are all-gathered
    over "data" as it runs, in its forward and its rerun, and their
    gradients reduce-scattered into the accumulator in the staged
    backward (``sharding.DataBlock``), so those leaves need no
    all-reduce; the optimizer updates the blocks, its sums and the clip's
    norm spanning the data blocks (``_DataAxis``)."""
    da = _data_axis(model, cfg, mesh, tp)
    if da is None:
        norm_fn = None if tp is None else tp.global_norm
        split_sum = None if tp is None else tp.split_sum
    else:
        norm_fn, split_sum = da.global_norm, da.split_sum
        blocks = [tuple(sharding.data_block(l, d, da.data, 0).shape)
                  for l, d in zip(leaves(model.abstract_params()), da.dims)]

    def rank_step(st, batch):
        if da is not None and [tuple(l.shape) for l in
                               leaves(st["params"])] != blocks:
            raise ValueError(
                f"the auto step on a \"data\" axis of {da.data} ranks "
                f"takes each rank's data block of the params "
                f"(trainer.init_states, TrainSession.init_state / "
                f"scatter), not whole params")
        loss, grads = _accumulate_grads(
            model, st["params"], batch, cfg.microbatches, cfg.grad_dtype,
            None if da is None else da.dims)
        trace.label(grads, "grads")
        with torch.no_grad():
            if tp is not None:
                grads = tp.reduce_partials(grads)
                if cfg.check_model_replicas:
                    tp.check_replicated(grads)
            if da is not None:
                grads = da.mean(grads, data_axes)
            for a in data_axes:
                if da is None:
                    grads = map_tree(lambda g: collectives.pmean(g, a),
                                     grads)
                loss = collectives.pmean(loss, a)
            new_params, new_opt, om = optimizer.update(
                grads, st["opt"], st["params"], global_norm_fn=norm_fn,
                split_sum=split_sum,
                lead_blocks=None if tp is None else tp.lead_blocks)
        return ({"params": new_params, "opt": new_opt,
                 "step": st["step"] + 1}, {"loss": loss, **om})

    train_step = _spmd_step(rank_step, mesh, data_axes)
    train_step.schedule = None
    train_step.ag_schedule = None
    return train_step


# ---------------------------------------------------------------------------
# TrainSession: one (model, optimizer, cfg) bundle, many meshes
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TrainSession:
    """Everything about a training run that survives a re-mesh (the
    reference's ``TrainSession``).

    The elastic controller rebuilds the mesh-bound pieces (the per-rank
    states, the step function, the communicator's plan) after every
    topology change; the pieces that must NOT change across a recovery —
    model, optimizer, ``TrainCfg``, and through them the state structure
    and bucket layout — live here, so the launcher and the controller
    build them once and the same way.  ``mesh=`` is required with
    ``cfg.zero`` (the state layout depends on the data-parallel width)
    and with a model axis.

    The checkpoint layout is the reference's global tree, whatever the
    model axis: ``gather`` reads it off the states of any mesh and
    ``scatter`` lays it onto any other, at another data width or another
    model width.  The model a mesh runs is ``model`` rebuilt for the
    mesh's "model" axis (``model_for``), so a plan that had to shrink
    the model axis runs the same run on fewer model ranks.
    """

    model: Any
    optimizer: Any
    cfg: TrainCfg = TrainCfg()

    def model_for(self, mesh):
        """The model for ``mesh``'s "model" axis."""
        return with_model_parallel(self.model, _model_size(mesh))

    def abstract_state(self, mesh=None):
        """The run's state in the checkpoint layout as ``meta`` tensors
        (``global_abstract_state``): what a restore is shaped by."""
        return global_abstract_state(self.model, self.optimizer, self.cfg,
                                     mesh=mesh)

    def init_state(self, gen: Optional[torch.Generator] = None, mesh=None
                   ) -> List[Dict[str, Any]]:
        """Fresh per-rank states on ``mesh``'s device: weights from
        ``model.init(gen)``, each rank given its shard."""
        if mesh is None:
            raise ValueError("init_state needs the mesh its ranks run on")
        if gen is None:
            gen = torch.Generator(device=mesh.device).manual_seed(0)
        return init_states(self.model_for(mesh), self.optimizer,
                           self.model.init(gen), self.cfg, mesh)

    def step_fn(self, comm: Communicator) -> Callable:
        """The topology-bound train step over ``comm`` (the session's
        world communicator); built again after every re-mesh."""
        return make_train_step(self.model_for(comm.mesh), self.optimizer,
                               self.cfg, comm=comm)

    def gather(self, states: List[Dict[str, Any]], mesh) -> Any:
        """The per-rank states of ``mesh`` as one tree in the checkpoint
        layout."""
        return gather_state(states, self.cfg, mesh, self.model)

    def scatter(self, tree: Any, mesh) -> List[Dict[str, Any]]:
        """Per-rank states on ``mesh`` from a checkpoint-layout tree."""
        return scatter_state(tree, self.cfg, mesh, self.model)

    def batch_axes(self) -> Tuple[str, ...]:
        """Axes the global batch splits over (filtered to the mesh's
        axes by the step)."""
        return tuple(self.cfg.data_axes)
