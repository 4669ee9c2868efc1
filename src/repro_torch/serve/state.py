"""Serving scheduler state: drained snapshots + disk persistence
(counterpart of ``repro.serve.state``, with its on-disk format).

A ``SchedulerSnapshot`` is the drained image ``BatchScheduler.snapshot()``
produces at a decode-step boundary — the unit of recovery the
``ServeController`` carries across a re-mesh (in memory) or, through
``save_snapshot`` / ``load_snapshot``, across a process death (on disk,
through the atomic tmp+rename checkpoint layer training uses).

Everything that is not a tensor (requests, their generated tokens, the
cfg, each slot's token count) rides in the checkpoint manifest's JSON
``meta`` sidecar; each slot's tensor leaves are its ``RequestCache`` —
live pages plus per-slot state, page-granular, so snapshot bytes scale
with generated tokens rather than ``max_len``.  ``load_snapshot``
rebuilds the structure from the model's probed page layout
(``paging.layout_for``), so restore needs no pickled trees.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Optional

import torch

from repro_torch.checkpoint import (load_manifest, restore_checkpoint,
                                    save_checkpoint)
from repro_torch.checkpoint.manager import dtype_name
from repro_torch.serve import paging
from repro_torch.serve.paging import RequestCache


@dataclasses.dataclass
class SlotSnapshot:
    """One in-flight request frozen mid-decode: the request (with its
    generated-so-far tokens) plus its ``RequestCache`` — the live pages
    and slot state ``PagePool.extract`` copied to host."""
    req: Any                      # repro_torch.serve.engine.Request
    cache: Any                    # repro_torch.serve.paging.RequestCache


@dataclasses.dataclass
class SchedulerSnapshot:
    """Drained ``BatchScheduler`` image at a decode-step boundary."""
    cfg: Any                      # ServeCfg at snapshot time
    decode_steps: int
    inflight: List[SlotSnapshot]  # occupied slots, slot order
    parked: List[SlotSnapshot]    # already waiting for a slot pre-drain
    queue: List[Any]              # Requests never admitted
    completed: List[Any]
    shed: List[Any]

    @property
    def resumable(self) -> List[SlotSnapshot]:
        """Every request with decode progress to preserve (in-flight
        first — they drained most recently — then the parked backlog)."""
        return list(self.inflight) + list(self.parked)


def _req_to_json(req) -> dict:
    return {"rid": req.rid, "prompt": [int(t) for t in req.prompt],
            "max_new": int(req.max_new),
            "generated": [int(t) for t in req.generated],
            "t_submit": req.t_submit, "t_first": req.t_first}


def _req_from_json(d: dict):
    from repro_torch.serve.engine import Request
    return Request(rid=int(d["rid"]), prompt=list(d["prompt"]),
                   max_new=int(d["max_new"]),
                   generated=list(d["generated"]),
                   t_submit=d.get("t_submit"), t_first=d.get("t_first"))


def _cfg_to_json(cfg) -> dict:
    d = dataclasses.asdict(cfg)
    d["cache_dtype"] = dtype_name(cfg.cache_dtype)
    return d


def _cfg_from_json(d: dict):
    from repro_torch.serve.engine import ServeCfg
    d = dict(d)
    d["cache_dtype"] = getattr(torch, d["cache_dtype"])   # numpy's name
    return ServeCfg(**d)


def save_snapshot(directory: str, snap: SchedulerSnapshot,
                  step: int) -> None:
    """Persist a drained snapshot (atomic tmp+rename, the layout of the
    training checkpoints): each slot's live pages and state as tensor
    leaves, the books (and each slot's token count) as manifest meta."""
    slots = [{"pages": list(s.cache.pages), "state": list(s.cache.state)}
             for s in snap.resumable]
    meta = {
        "kind": "serve_scheduler",
        "cfg": _cfg_to_json(snap.cfg),
        "decode_steps": snap.decode_steps,
        "n_inflight": len(snap.resumable),
        "tokens": [int(s.cache.tokens) for s in snap.resumable],
        "inflight": [_req_to_json(s.req) for s in snap.resumable],
        "queue": [_req_to_json(r) for r in snap.queue],
        "completed": [_req_to_json(r) for r in snap.completed],
        "shed": [_req_to_json(r) for r in snap.shed],
    }
    save_checkpoint(directory, step, {"slots": slots}, meta=meta)


def load_snapshot(directory: str, model,
                  step: Optional[int] = None) -> SchedulerSnapshot:
    """Load a persisted snapshot (host tensors).  The structure of each
    slot comes from the model's probed page layout and the stored token
    count (pages = ceil(tokens / page_tokens)), so shapes are still
    checked without any stored tree."""
    manifest = load_manifest(directory, step=step)
    meta = manifest["meta"]
    if meta.get("kind") != "serve_scheduler":
        raise ValueError(
            f"checkpoint under {directory} is not a serve-scheduler "
            f"snapshot (meta.kind={meta.get('kind')!r})")
    cfg = _cfg_from_json(meta["cfg"])
    layout = paging.layout_for(model, cfg)
    tokens = [int(t) for t in meta["tokens"]]
    abstract = []
    for t in tokens:
        rc = paging.abstract_request_cache(layout, t)
        abstract.append({"pages": list(rc.pages), "state": list(rc.state)})
    tree = restore_checkpoint(directory, {"slots": abstract},
                              step=manifest["step"])
    slots = tree.get("slots", ()) if isinstance(tree, dict) else ()
    inflight = [
        SlotSnapshot(req=_req_from_json(rj),
                     cache=RequestCache(pages=list(slot["pages"]),
                                        state=list(slot["state"]),
                                        tokens=t))
        for rj, slot, t in zip(meta["inflight"], slots, tokens)]
    return SchedulerSnapshot(
        cfg=cfg, decode_steps=int(meta["decode_steps"]),
        inflight=inflight, parked=[],
        queue=[_req_from_json(d) for d in meta["queue"]],
        completed=[_req_from_json(d) for d in meta["completed"]],
        shed=[_req_from_json(d) for d in meta["shed"]])
