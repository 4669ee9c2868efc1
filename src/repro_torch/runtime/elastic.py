"""Elastic re-meshing: keep training on whatever ranks survive.

Counterpart of ``repro.runtime.elastic``.  ``plan_mesh_shape`` picks the
largest usable (pod, data, model) grid not exceeding the healthy count,
holding the model axis fixed and shrinking the data axis — lost
throughput, not lost progress; it gives the reference's shapes for every
input the reference takes, and also plans the port's one-axis
``("data",)`` meshes (``ndim=1``).  ``make_mesh_from_shape`` builds the
thread-rank mesh for a planned shape over chosen member ids, and
``remesh`` re-lays live per-rank train states onto it through the
checkpoint layout, the reference's global tree (``trainer.gather_state``
/ ``scatter_state``), over "data" and "model" alike.  The
crash-recovery path:

    ranks die -> plan_mesh_shape -> restore the latest checkpoint in the
    new layout -> scatter it to the new ranks -> continue at the
    recorded step (the data pipeline is a pure function of step, so the
    token stream is unchanged).

``repro_torch.runtime.controller.ElasticController`` drives this loop.
"""

from __future__ import annotations

from typing import Any, List, Optional, Sequence, Tuple

import torch

from repro_torch.checkpoint import ShardedTensor
from repro_torch.runtime import substrate
from repro_torch.tree import flatten, unflatten


def plan_mesh_shape(n_devices: int, model_parallel: int,
                    pods: int = 1, *,
                    ndim: Optional[int] = None) -> Tuple[int, ...]:
    """Largest (pod, data, model) grid with <= n_devices members.

    Keeps ``model_parallel`` fixed (changing it would re-layout params);
    drops to fewer pods before shrinking data parallelism within a pod.
    Falls back to shrinking model parallelism only when a single
    model-parallel group no longer fits.

    ``ndim`` normalizes the rank of the result: 3 always gives
    ``(pod, data, model)``, 2 gives ``(data, model)`` (raising when more
    than one pod remains), and 1 — the port's data-only mesh — gives
    ``(data,)`` (raising when a model or pod axis wider than 1 remains).
    Without it the rank follows ``pods``, as in the reference."""
    if n_devices < 1:
        raise ValueError("no healthy devices")
    if ndim not in (None, 1, 2, 3):
        raise ValueError(f"ndim must be 1, 2 or 3, got {ndim!r}")
    mp = model_parallel
    while mp > 1 and n_devices < mp:
        mp //= 2                         # degraded: shrink TP as last resort
    best = None
    for p in range(pods, 0, -1):
        per_pod = n_devices // p
        data = per_pod // mp
        if data >= 1:
            plan = (p, data, mp) if pods > 1 else (data, mp)
            used = p * data * mp
            if best is None or used > best[0]:
                best = (used, plan)
    shape = ((1, mp) if pods == 1 else (1, 1, mp)) if best is None \
        else best[1]
    if ndim == 3 and len(shape) == 2:
        shape = (1,) + shape
    elif ndim in (1, 2) and len(shape) == 3:
        if shape[0] != 1:
            raise ValueError(
                f"cannot normalize {shape} to {ndim} axes: pod axis is "
                f"{shape[0]} > 1")
        shape = shape[1:]
    if ndim == 1:
        if shape[1] != 1:
            raise ValueError(f"cannot normalize {shape} to 1 axis: model "
                             f"axis is {shape[1]} > 1")
        shape = shape[:1]
    return shape


def plan_from_mesh(mesh, n_devices: int) -> Tuple[int, ...]:
    """``plan_mesh_shape`` for the survivors of an existing mesh: model
    parallelism, pod budget and rank are read off the mesh, so the
    planned shape always matches its axis names."""
    sizes = dict(mesh.shape)
    return plan_mesh_shape(n_devices, sizes.get("model", 1),
                           pods=sizes.get("pod", 1), ndim=len(sizes))


def make_mesh_from_shape(shape: Sequence[int],
                         axis_names: Optional[Sequence[str]] = None, *,
                         members: Optional[Sequence[int]] = None,
                         device="cuda") -> substrate.Mesh:
    """The thread-rank mesh for a planned shape on ``device``.
    ``members`` names the member ids its ranks stand for, in rank order
    (the survivors, for a shrink; default ``0..size-1``)."""
    if axis_names is None:
        axis_names = {1: ("data",), 2: ("data", "model"),
                      3: ("pod", "data", "model")}[len(shape)]
    return substrate.make_mesh(tuple(shape), tuple(axis_names),
                               device=device, members=members)


def _fit_1d(x: torch.Tensor, n: int) -> torch.Tensor:
    """Truncate or zero-pad a flat leaf to length ``n`` (ZeRO's padded
    layout is [values, zeros], so only padding moves)."""
    if x.shape[0] >= n:
        return x[:n]
    return torch.cat([x, x.new_zeros(n - x.shape[0])])


def remesh(states: List[Any], cfg, abstract_tree: Any,
           new_mesh: substrate.Mesh, *, mesh: substrate.Mesh,
           model) -> List[Any]:
    """Re-lay per-rank train states of ``mesh`` onto ``new_mesh``: gather
    them into the checkpoint layout, the reference's global tree
    (``trainer.gather_state``), fit each flat leaf whose global length
    follows the data-parallel width (ZeRO) to ``abstract_tree`` — that
    layout for the new mesh (``trainer.global_abstract_state``) — and
    scatter it to the new ranks (``trainer.scatter_state``): the live
    grow's path, where no checkpoint is read.  ``mesh`` is the one the
    states run on and ``model`` the run's model (built for any width):
    together they say how the states are split over "data" and "model".
    The new mesh's "model" axis may be another width; each new rank
    takes its block of every split leaf.  The new states are copies on
    the new mesh's device."""
    from repro_torch.train import trainer   # trainer imports the runtime
    tree = trainer.gather_state(states, cfg, mesh, model)
    ls, paths = flatten(tree)
    want = flatten(abstract_tree)[0]
    if len(want) != len(ls):
        raise ValueError(f"{len(ls)} state leaves, the new layout has "
                         f"{len(want)}")
    out = []
    for l, ref in zip(ls, want):
        if isinstance(l, ShardedTensor):
            l = l.dense(device=l.shards[0][1].device)
        if l.ndim == 1 and tuple(l.shape) != tuple(ref.shape):
            l = _fit_1d(l, int(ref.shape[0]))
        out.append(l)
    return trainer.scatter_state(unflatten(paths, out), cfg, new_mesh, model)
