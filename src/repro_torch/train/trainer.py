"""Training step: gradient accumulation + communicator-mediated sync.

Counterpart of ``repro.train.trainer`` for the two composed sync modes:

  composed   — every rank computes the loss and gradients of its rows of
               the batch, and gradients are synced through a
               ``repro_torch.comm`` communicator whose per-function
               protocols are cost-model selected (``_leaf_sync``: one
               collective per leaf).
  compressed — composed + the int8 error-feedback compressed all-reduce;
               the EF residual lives in the train state across steps.

The reference's ``auto`` mode (collectives inserted by the compiler)
has no counterpart here.  Bucketed sync, overlap, ZeRO-1 and the
elastic ``TrainSession`` arrive with later slices.

Ranks are the threads of ``substrate.run_spmd``.  Each holds its own
replica of the state (a list, one per rank); ``train_step(states,
batch)`` gives every rank its rows of the global batch, as the
reference's ``shard_map`` splits the batch over the data axes.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Tuple

import numpy as np
import torch

from repro_torch.comm import Communicator
from repro_torch.core.compression import EFState
from repro_torch.core.engine import scale_by
from repro_torch.runtime import substrate
from repro_torch.tree import flatten, leaves, map_tree, unflatten

Params = Any


@dataclasses.dataclass(frozen=True)
class TrainCfg:
    microbatches: int = 1
    sync_mode: str = "composed"          # composed | compressed
    data_axes: Tuple[str, ...] = ("data",)
    grad_dtype: Any = torch.float32      # accumulation dtype (microbatches)

    def __post_init__(self):
        if self.sync_mode not in ("composed", "compressed"):
            raise ValueError(
                f"sync_mode={self.sync_mode!r}: the port runs 'composed' "
                "and 'compressed' (the compiler-inserted 'auto' mode has "
                "no counterpart)")
        if self.microbatches < 1:
            raise ValueError(f"microbatches={self.microbatches}")


def make_train_state(model, optimizer, params: Params,
                     cfg: TrainCfg = TrainCfg()) -> Dict[str, Any]:
    """One replica's {"params", "opt", "step"[, "ef"]}.  Optimizer moments
    and the EF residual start at zero, as in the reference."""
    state = {"params": params, "opt": optimizer.init(params),
             "step": torch.zeros((), dtype=torch.int32)}
    if cfg.sync_mode == "compressed":
        state["ef"] = map_tree(lambda p: torch.zeros(
            p.shape, dtype=torch.float32, device=p.device), params)
    return state


def abstract_state(model, optimizer, cfg: TrainCfg = TrainCfg()):
    """The state as ``meta`` tensors (shapes and dtypes, no memory)."""
    return make_train_state(model, optimizer, model.abstract_params(), cfg)


def replicate(state: Dict[str, Any], n: int) -> List[Dict[str, Any]]:
    """``n`` replicas: ``state`` itself and n - 1 copies on its device."""
    return [state] + [map_tree(lambda t: t.clone(), state)
                      for _ in range(n - 1)]


def _split_micro(batch: Dict[str, torch.Tensor], n: int):
    return [{k: v[i * (v.shape[0] // n):(i + 1) * (v.shape[0] // n)]
             for k, v in batch.items()} for i in range(n)]


def _accumulate_grads(model, params: Params, batch, n_micro: int,
                      grad_dtype) -> Tuple[torch.Tensor, Params]:
    """Loss and gradients of ``batch``, averaged over ``n_micro``
    microbatches accumulated in ``grad_dtype`` (one microbatch keeps each
    param's own dtype, as the reference's ``value_and_grad`` does)."""
    ps, paths = flatten(params)

    def one(mb):
        xs = [p.detach().requires_grad_(True) for p in ps]
        loss, _ = model.loss(unflatten(paths, xs), mb)
        grads = torch.autograd.grad(loss, xs)
        return loss.detach(), list(grads)

    if n_micro == 1:
        loss, grads = one(batch)
        return loss, unflatten(paths, grads)
    loss_sum = None
    acc = [torch.zeros(p.shape, dtype=grad_dtype, device=p.device)
           for p in ps]
    for mb in _split_micro(batch, n_micro):
        loss, grads = one(mb)
        acc = [a + g.to(grad_dtype) for a, g in zip(acc, grads)]
        loss_sum = loss if loss_sum is None else loss_sum + loss
    inv = 1.0 / n_micro
    return loss_sum * inv, unflatten(paths, [g * inv for g in acc])


def _leaf_sync(dcomm: Communicator, axis_comms, grads, compress: bool,
               ef_tree):
    """One collective per gradient leaf (the reference's ``_leaf_sync``)."""
    if not compress:
        synced, _ = dcomm.sync_gradients(grads, mean=True)
        return synced, ef_tree
    ef_states = map_tree(lambda r: EFState(residual=r), ef_tree)
    synced, new_states = axis_comms[0].sync_gradients(
        grads, mean=True, compress=True, ef_state=ef_states)
    for acomm in axis_comms[1:]:
        synced = map_tree(lambda g, _c=acomm: _c.all_reduce(g, mean=True),
                          synced)
    return synced, map_tree(lambda s: s.residual, new_states)


def _rank_rows(x, lo: int, hi: int, device) -> torch.Tensor:
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.ascontiguousarray(x[lo:hi]))
    else:
        x = x[lo:hi]
    return x.to(device)


def make_train_step(model, optimizer, cfg: TrainCfg = TrainCfg(), *,
                    comm: Communicator) -> Callable:
    """Returns ``train_step(states, batch) -> (states, metrics)``.

    ``states``: one replica per rank of the communicator's mesh;
    ``batch``: the global batch (numpy arrays or tensors, rows first),
    split over the data axes.  ``metrics`` are rank 0's (every rank
    holds the same all-reduced loss)."""
    mesh = comm.mesh
    if mesh is None:
        raise ValueError("the communicator's session has no mesh")
    data_axes = tuple(a for a in cfg.data_axes if a in mesh.axis_names)
    if not data_axes:
        raise ValueError(
            f"sync_mode={cfg.sync_mode!r} has nothing to sync over: none "
            f"of cfg.data_axes={cfg.data_axes} exist in the mesh axes "
            f"{mesh.axis_names}")
    compress = cfg.sync_mode == "compressed"
    dcomm = comm.split(*data_axes)
    axis_comms = tuple(comm.split(a) for a in data_axes)
    n_data = dcomm.size

    def rank_step(st, host_batch, lo, hi):
        dev = leaves(st["params"])[0].device
        batch = {k: _rank_rows(v, lo, hi, dev)
                 for k, v in host_batch.items()}
        loss, grads = _accumulate_grads(model, st["params"], batch,
                                        cfg.microbatches, cfg.grad_dtype)
        with torch.no_grad():
            grads, new_ef = _leaf_sync(dcomm, axis_comms, grads, compress,
                                       st.get("ef"))
            for acomm in axis_comms:
                loss = acomm.all_reduce(loss)
            loss = scale_by(loss, dcomm.mean_scale())
            new_params, new_opt, om = optimizer.update(
                grads, st["opt"], st["params"])
        new_state = {"params": new_params, "opt": new_opt,
                     "step": st["step"] + 1}
        if compress:
            new_state["ef"] = new_ef
        return new_state, {"loss": loss, **om}

    def train_step(states, batch):
        rows = next(iter(batch.values())).shape[0]
        if rows % n_data:
            raise ValueError(f"global batch {rows} does not split over "
                             f"{n_data} data ranks")
        per = rows // n_data
        args = []
        for r in range(mesh.size):
            coords = mesh.coords(r)
            d = 0
            for a in data_axes:
                d = d * mesh.shape[a] + coords[a]
            args.append((states[r], batch, d * per, (d + 1) * per))
        out = substrate.run_spmd(rank_step, args, mesh)
        return [o[0] for o in out], out[0][1]

    return train_step
