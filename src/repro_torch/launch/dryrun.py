"""The dry-run: every (arch x shape x mesh) cell at the production meshes,
one rank traced on ``meta`` tensors.

Counterpart of ``repro.launch.dryrun``.  The reference lowers and
compiles each cell for (16, 16) and (2, 16, 16) and reads the compiled
module: the proof that the distribution config is coherent, with the
memory a device needs, its flops, HBM bytes and wire bytes.  The port
runs one rank's real step instead: the model built for the cell's
"model" axis, rank 0's state (``trainer.abstract_state``) and batch, the
trainer's step over a session on the abstract mesh, all under the
substrate's recording transport (``launch.stepanalysis``).  Nothing
computes and nothing is allocated; the readings are the step's own.

A prefill, decode or ``long_500k`` cell runs one rank of the port's
split serving step (``serve_cell``): params, caches and rows placed as
the reference's ``build_prefill_cell`` / ``build_decode_cell`` place
them (``Model.rank_params``, ``sharding.cache_split``), the prefill's
caches made inside the step, the decode's given to it.  On ``meta``
the flash op allocates its output only and counts its two products'
flops (the kernel keeps its tiles on chip).

The fit verdict (``fits_hbm``, the reference's ``fits_16gb``) comes from
the analytic model, as in the reference; the traced peak stands beside
it where the reference puts its CPU-measured upper bound.

Run:  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-72b \\
          --shape train_4k --mesh both
      PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both \
          --jobs 4          (a subprocess a cell, 4 at once)

Records go to ``artifacts/dryrun_torch/``.  There is no ``--reanalyze``:
the port keeps no compiled module to read again.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import math
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Optional, Sequence, Tuple

import torch

from repro_torch.comm import Session
from repro_torch.configs import (ARCH_IDS, cells, get_arch, get_config,
                                 get_shape)
from repro_torch.data.pipeline import batch_rows, shard_batch
from repro_torch.launch import stepanalysis
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import build_model
from repro_torch.models.encdec import EncDecCfg
from repro_torch.models.transformer import TransformerCfg
from repro_torch.optim import make_optimizer
from repro_torch.parallel import sharding
from repro_torch.runtime import substrate
from repro_torch.serve import paging
from repro_torch.train import trainer
from repro_torch.tree import flatten

#: ``torch.cuda.get_device_properties(0).total_memory`` of an NVIDIA H100
#: 80GB HBM3 (power limit 700.00 W), read on the card by
#: ``chip_smoke.py`` [dryrun]
HBM_PER_CHIP = 85_017_493_504

# Per-arch dry-run training settings: the reference's (adafactor for the
# 123B-671B models, adamw below).
_TRAIN_SETTINGS: Dict[str, Dict[str, Any]] = {
    "qwen2-vl-7b": dict(optimizer="adamw", microbatches=2),
    "mistral-large-123b": dict(optimizer="adafactor", microbatches=8),
    "nemotron-4-340b": dict(optimizer="adafactor", microbatches=8,
                            grad_dtype=torch.bfloat16),
    "qwen2-72b": dict(optimizer="adamw", microbatches=8,
                      opt_kwargs=dict(state_dtype=torch.bfloat16)),
    "granite-34b": dict(optimizer="adamw", microbatches=8,
                        opt_kwargs=dict(state_dtype=torch.bfloat16)),
    "jamba-1.5-large-398b": dict(optimizer="adafactor", microbatches=8,
                                 grad_dtype=torch.bfloat16),
    "mamba2-1.3b": dict(optimizer="adamw", microbatches=4),
    "seamless-m4t-large-v2": dict(optimizer="adamw", microbatches=1),
    "deepseek-v3-671b": dict(optimizer="adafactor", microbatches=8,
                             grad_dtype=torch.bfloat16),
    "qwen3-moe-30b-a3b": dict(optimizer="adamw", microbatches=2,
                              opt_kwargs=dict(state_dtype=torch.bfloat16)),
}


def train_settings(arch_id: str) -> Dict[str, Any]:
    return dict(_TRAIN_SETTINGS.get(arch_id, {}))


# The reference's perf-iteration variants; records land as
# <arch>__<shape>__<mesh>@<variant>.json.
VARIANTS: Dict[str, Dict[str, Any]] = {
    "baseline": {},
    # gradient-sync family
    "composed": dict(sync="composed"),
    "bucketed": dict(sync="composed", bucket=True),
    "compressed": dict(sync="compressed", bucket=True),
    # sharding-scheme family
    "puredp": dict(puredp=True),
    "zero1": dict(zero1=True),
    "seqflash": dict(seqflash=True),
    "mb2_seqflash": dict(microbatches=2, seqflash=True),
    "mb4_seqflash": dict(microbatches=4, seqflash=True),
    "zero1_seqflash": dict(zero1=True, seqflash=True),
    "zero1_seqflash_mb1": dict(zero1=True, seqflash=True, microbatches=1),
    "mb1_seqflash": dict(microbatches=1, seqflash=True),
    # microbatch family
    "mb4": dict(microbatches=4),
    "mb2": dict(microbatches=2),
    "mb1": dict(microbatches=1),
    # compute/memory family
    "remat_dots": dict(remat_policy="dots"),
    "capacity_1x": dict(capacity_factor=1.0),
    "block_k_1024": dict(block_k=1024),
    "block_k_256": dict(block_k=256),
}

#: The variant knobs the port lacks, refused by name.
REFUSED = {
    "puredp": "folds \"model\" into data parallelism through GSPMD "
              "shardings; the port's model axis is its explicit tensor "
              "split, which has no such fold",
    "seqflash": "sequence-parallel flash tiles (the reference's "
                "REPRO_SEQ_FLASH) are not ported",
}


def variant_refusal(name: str) -> Optional[str]:
    """Why the port cannot run variant ``name`` (None if it can)."""
    why = _refusal(VARIANTS[name])
    return None if why is None else f"variant {name!r}: {why}"


def _refusal(variant: Dict[str, Any]) -> Optional[str]:
    return next((why for knob, why in REFUSED.items()
                 if variant.get(knob)), None)


def _apply_variant_cfg(cfg, variant: Dict[str, Any]):
    if not isinstance(cfg, TransformerCfg):
        return cfg
    if variant.get("capacity_factor") and cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=variant["capacity_factor"]))
    if variant.get("block_k"):
        cfg = dataclasses.replace(cfg, block_k=variant["block_k"])
    if variant.get("remat_policy"):
        cfg = dataclasses.replace(cfg, remat_policy=variant["remat_policy"])
    return cfg


# ---------------------------------------------------------------------------
# Input specs (``meta`` tensors: never allocated)
# ---------------------------------------------------------------------------

def input_specs(arch_id: str, shape_name: str) -> Dict[str, torch.Tensor]:
    """Batch stand-ins for one cell (the step's data inputs)."""
    info = get_arch(arch_id)
    cfg = get_config(arch_id)
    shape = get_shape(shape_name)
    b, s = shape.global_batch, shape.seq_len
    i32, bf16 = torch.int32, torch.bfloat16

    def spec(dims, dtype):
        return torch.empty(dims, dtype=dtype, device="meta")

    if isinstance(cfg, EncDecCfg):
        batch = {"frame_embeds": spec((b, s, cfg.d_model), bf16),
                 "tokens": spec((b, s), i32), "labels": spec((b, s), i32)}
    elif info.uses_embeds:   # vlm backbone: precomputed patch embeddings
        batch = {"inputs_embeds": spec((b, s, cfg.d_model), bf16),
                 "positions": spec((3, b, s), i32),
                 "labels": spec((b, s), i32)}
    else:
        batch = {"tokens": spec((b, s), i32), "labels": spec((b, s), i32)}

    if shape.kind == "prefill":
        batch.pop("labels", None)
    if shape.kind == "decode":
        # one new token against a seq_len cache
        batch = {"tokens": spec((b, 1), i32)}
        if isinstance(cfg, EncDecCfg):
            pass                       # memory lives in the cache
        elif info.uses_embeds:
            batch = {"inputs_embeds": spec((b, 1, cfg.d_model), bf16),
                     "positions": spec((3, b, 1), i32)}
    return batch


# ---------------------------------------------------------------------------
# Sharding fitting, over the port's spec tuples: a spec is a tuple with
# one entry a dim, each None, an axis name or a tuple of axis names
# ---------------------------------------------------------------------------

Spec = sharding.Spec


def _sizes(mesh) -> Dict[str, int]:
    return dict(zip(mesh.axis_names, mesh.axis_sizes))


def fit_spec(spec: Spec, shape: Tuple[int, ...], mesh) -> Spec:
    """Filter to mesh axes and drop entries that cannot shard their dim
    (dim % shards != 0)."""
    return sharding.fit_spec(spec, shape, _sizes(mesh))


def serve_cache_shardings(model, mesh, batch: int, max_len: int,
                          enc_len: int = 0):
    """(fitted spec of every cache leaf, the abstract caches) for a
    decode/prefill cell: ``sharding.cache_split``, the reference's
    arithmetic, on ``mesh``."""
    return sharding.cache_split(model, _sizes(mesh), batch, max_len,
                                enc_len)


def sharded_tree_bytes(tree, specs: Sequence[Spec], mesh) -> float:
    """Per-device bytes of a tree of tensors under ``specs`` (one a leaf,
    in ``tree.flatten``'s order)."""
    sizes = _sizes(mesh)
    total = 0.0
    for leaf, spec in zip(flatten(tree)[0], specs):
        n = math.prod(leaf.shape) * leaf.element_size()
        shards = 1
        for entry in spec:
            for a in (entry if isinstance(entry, tuple) else (entry,)):
                if a:
                    shards *= sizes.get(a, 1)
        total += n / shards
    return total


# ---------------------------------------------------------------------------
# Analytic memory model (the reference's, in its order)
# ---------------------------------------------------------------------------

def _dt_bytes(dt) -> int:
    return torch.empty((), dtype=dt).element_size()


def analytic_memory_serve(arch_id: str, shape_name: str, mesh
                          ) -> Dict[str, float]:
    """Expected footprint of a prefill/decode cell: sharded params +
    sharded cache + a per-layer transient estimate."""
    cfg = get_config(arch_id)
    shape = get_shape(shape_name)
    model = build_model(cfg)
    sizes = _sizes(mesh)
    devices = mesh.size
    data_shards = sizes.get("data", 1) * sizes.get("pod", 1)
    params_b = 2.0 * model.param_count() / devices
    cache_len = shape.seq_len + 512 if shape.kind == "decode" \
        else shape.seq_len
    cache_sh, caches = serve_cache_shardings(
        model, mesh, shape.global_batch, cache_len, enc_len=shape.seq_len)
    cache_b = sharded_tree_bytes(caches, cache_sh, mesh)
    d = cfg.d_model
    b_loc = max(shape.global_batch // data_shards, 1)
    if shape.kind == "prefill":
        transient = (6.0 * b_loc * shape.seq_len * d * 2.0
                     / min(sizes.get("model", 1), 16) + 2**30)
    else:
        transient = max(2**30, 0.05 * cache_b)
    total = params_b + cache_b + transient
    return {"params": params_b, "cache": cache_b, "transient": transient,
            "total": total, "fits_hbm": bool(total < HBM_PER_CHIP)}


def analytic_memory_train(arch_id: str, shape_name: str, mesh
                          ) -> Dict[str, float]:
    shape = get_shape(shape_name)
    return analytic_train(get_config(arch_id), shape.seq_len,
                          shape.global_batch, mesh, train_settings(arch_id))


def analytic_train(cfg, seq_len: int, global_batch: int, mesh,
                   settings: Dict[str, Any]) -> Dict[str, float]:
    """The reference's training memory model of one device for ``cfg``
    at ``seq_len`` x ``global_batch`` on ``mesh`` under ``settings``
    (``train_settings``' keys)."""
    model = build_model(cfg)
    st = settings
    n = model.param_count()
    devices = mesh.size
    sizes = _sizes(mesh)
    data_shards = sizes.get("data", 1) * sizes.get("pod", 1)
    model_shards = sizes.get("model", 1)
    mb = st.get("microbatches", 1)
    grad_b = _dt_bytes(st.get("grad_dtype", torch.float32))
    opt_name = st.get("optimizer", "adamw")
    state_b = _dt_bytes(st.get("opt_kwargs", {}).get("state_dtype",
                                                     torch.float32))

    params = 2.0 * n / devices
    grads = grad_b * n / devices
    opt = (2.0 * state_b * n / devices if opt_name == "adamw"
           else 0.02 * 4.0 * n / devices)

    d = cfg.d_model
    s = seq_len
    b_loc = max(global_batch // data_shards // mb, 1)
    n_layers = cfg.num_layers
    # saved layer boundaries are sequence-sharded over the TP axis
    sp = model_shards if s % model_shards == 0 else 1
    boundaries = n_layers * b_loc * s * d * 2.0 / sp
    logits = 6.0 * b_loc * s * cfg.vocab_size / model_shards  # bf16+f32 oh
    transient = 6.0 * b_loc * s * d * 4.0
    if not isinstance(cfg, EncDecCfg) and cfg.moe is not None:
        from repro_torch.models.moe import capacity_of
        t_loc = b_loc * s
        c_cap = capacity_of(t_loc, cfg.moe)
        e_loc = max(cfg.moe.num_experts // model_shards, 1)
        transient += 3.0 * e_loc * c_cap * d * 2.0 \
            + 2.0 * e_loc * c_cap * cfg.moe.d_ff * 2.0
    total = params + grads + opt + boundaries + logits + transient
    return {"params": params, "grads": grads, "opt_state": opt,
            "activation_boundaries": boundaries, "logits": logits,
            "transient": transient, "total": total,
            "fits_hbm": bool(total < HBM_PER_CHIP)}


# ---------------------------------------------------------------------------
# Analytic MODEL_FLOPS (6·N·D)
# ---------------------------------------------------------------------------

def active_param_count(cfg) -> int:
    """Params touched per token (MoE: shared + top_k/E of routed)."""
    total = build_model(cfg).param_count()
    if not isinstance(cfg, TransformerCfg) or cfg.moe is None:
        return total
    moe = cfg.moe
    n_moe_layers = sum(
        sum(1 for l in st.layers if l.ffn == "moe") * st.repeat
        for st in cfg.stages)
    per_expert = 3 * moe.d_model * moe.d_ff if moe.activation == "swiglu" \
        else 2 * moe.d_model * moe.d_ff
    routed = n_moe_layers * moe.num_experts * per_expert
    active_routed = n_moe_layers * moe.top_k * per_expert
    return total - routed + active_routed


def model_flops(arch_id: str, shape_name: str) -> float:
    cfg = get_config(arch_id)
    shape = get_shape(shape_name)
    n_active = active_param_count(cfg)
    if shape.kind == "train":
        return 6.0 * n_active * shape.tokens
    if shape.kind == "prefill":
        return 2.0 * n_active * shape.tokens
    return 2.0 * n_active * shape.global_batch   # decode: 1 token/seq


# ---------------------------------------------------------------------------
# Cell construction
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Cell:
    fn: Any
    args: Tuple
    meta: Dict[str, Any]
    trip_counts: Tuple[int, ...] = ()
    model: Any = None          # what the step was built of
    optimizer: Any = None
    train_cfg: Any = None


def _trip_counts(cfg) -> Tuple[int, ...]:
    if isinstance(cfg, EncDecCfg):
        return (cfg.enc_layers, cfg.dec_layers)
    return tuple(st.repeat for st in cfg.stages)


def train_cell(cfg, batch: Dict[str, torch.Tensor], mesh, *,
               settings: Optional[Dict[str, Any]] = None,
               variant: Optional[Dict[str, Any]] = None,
               optimizer=None, **train_cfg) -> Cell:
    """One rank's training step for ``cfg`` over ``mesh`` (abstract or
    not: the step runs only under the recording transport here) on the
    global ``batch`` (``meta`` tensors): the model built for the mesh's
    "model" axis, rank 0's state from ``trainer.abstract_state``, the
    trainer's step over a session on the mesh.  ``settings`` are
    ``train_settings``' keys, ``variant`` a ``VARIANTS`` entry;
    ``optimizer`` replaces the one ``settings`` names, ``train_cfg``
    sets other ``TrainCfg`` fields."""
    st = dict(settings or {})
    variant = dict(variant or {})
    if _refusal(variant):
        raise ValueError(_refusal(variant))
    model = build_model(cfg, model_parallel=_sizes(mesh).get("model", 1))
    opt = optimizer if optimizer is not None else make_optimizer(
        st.get("optimizer", "adamw"), **st.get("opt_kwargs", {}))
    zero = bool(variant.get("zero1"))
    sync = variant.get("sync", "composed" if zero else "auto")
    tcfg = trainer.TrainCfg(
        microbatches=variant.get("microbatches", st.get("microbatches", 1)),
        sync_mode=sync,
        data_axes=tuple(a for a in ("pod", "data") if a in mesh.axis_names),
        bucket_grads=bool(variant.get("bucket")),
        grad_dtype=st.get("grad_dtype", torch.float32), zero=zero,
        **train_cfg)
    state = trainer.abstract_state(model, opt, tcfg, mesh=mesh)
    if sync == "auto":
        session = Session(mesh=mesh, mode="monolithic")
    else:
        from repro_torch.launch.train import build_session
        # the collective set does not depend on the rows: probe with one
        probe = {k: batch_rows(k, v, 0, 1) for k, v in batch.items()}
        session = build_session(mesh, model, opt, None, tcfg, batch=probe)
    step = trainer.make_train_step(model, opt, tcfg, comm=session.world)
    return Cell(fn=step, args=([state] * mesh.size, batch),
                meta={"kind": "train", "microbatches": tcfg.microbatches,
                      "optimizer": opt.name, "sync": sync,
                      "variant": {k: str(v) for k, v in variant.items()}},
                trip_counts=_trip_counts(cfg), model=model, optimizer=opt,
                train_cfg=tcfg)


def build_train_cell(arch_id: str, shape_name: str, mesh,
                     variant: Optional[Dict[str, Any]] = None) -> Cell:
    variant = variant or {}
    cfg = _apply_variant_cfg(get_config(arch_id), variant)
    return train_cell(cfg, input_specs(arch_id, shape_name), mesh,
                      settings=train_settings(arch_id), variant=variant)


def trace_cell(cell: Cell) -> stepanalysis.ModuleCost:
    """Rank 0's accounting of ``cell``'s step (``stepanalysis``)."""
    return stepanalysis.analyze_step(cell.fn, *cell.args,
                                     trip_counts=cell.trip_counts)


def serve_cell(cfg, kind: str, batch: Dict[str, torch.Tensor], mesh, *,
               seq_len: int, params=None) -> Cell:
    """One rank's prefill or decode step (``kind``) of ``cfg`` over
    ``mesh`` (abstract or not, as ``train_cell``'s) on the global
    ``batch``, as the reference's ``build_prefill_cell`` /
    ``build_decode_cell`` place it: each rank its "data" block of its
    "model" block of the params (``Model.rank_params`` of ``params``,
    the full params, by default on ``meta``), its rows
    (``sharding.row_axes``), its blocks of the caches
    (``Model.init_caches``; an enc-dec's memory of ``seq_len`` frames)
    of ``seq_len`` positions for a prefill, made inside the step, and of
    ``seq_len`` + 512 for a decode, given to it.  Returns the cell,
    whose ``fn(states, batch)`` returns each rank's (logits, caches)."""
    model = build_model(cfg, model_parallel=_sizes(mesh).get("model", 1))
    rows = batch[next(k for k in batch if k != "positions")].shape[0]
    device = torch.device("meta") if mesh.abstract else mesh.device
    if params is None:
        params = build_model(cfg).abstract_params()
    cache_len = seq_len + 512 if kind == "decode" else seq_len
    enc_len = seq_len if model.kind == "encdec" else 0
    caches = functools.partial(paging.contiguous_caches, model, rows,
                               cache_len, dtype=torch.bfloat16,
                               enc_len=enc_len)
    # the split's shapes, probed once here, outside the metered step
    caches(device="meta", mesh=mesh, rank=0)
    states = []
    for r in range(1 if mesh.abstract else mesh.size):
        st = {"params": model.rank_params(params, mesh, r)}
        if kind == "decode":
            st["caches"] = caches(device=device, mesh=mesh, rank=r)
        states.append(st)
    if mesh.abstract:        # only rank 0 runs, under recording()
        states = states * mesh.size
    axes = sharding.row_axes(_sizes(mesh), rows)

    def rank(state, b):
        if kind == "decode":
            return model.decode_step(state["params"], b, state["caches"])
        return model.prefill(state["params"], b, caches(device=device))

    def step(states, batch):
        return substrate.run_spmd(
            rank, list(zip(states, shard_batch(batch, mesh, axes))), mesh)

    return Cell(fn=step, args=(states, batch),
                meta={"kind": kind, "cache_len": cache_len,
                      "rows": list(axes)},
                trip_counts=_trip_counts(cfg), model=model)


def build_serve_cell(arch_id: str, shape_name: str, mesh) -> Cell:
    shape = get_shape(shape_name)
    return serve_cell(get_config(arch_id), shape.kind,
                      input_specs(arch_id, shape_name), mesh,
                      seq_len=shape.seq_len)


# ---------------------------------------------------------------------------
# Running one cell
# ---------------------------------------------------------------------------

def _suffix(variant_name: str) -> str:
    return "" if variant_name == "baseline" else f"@{variant_name}"


def run_cell(arch_id: str, shape_name: str, mesh_kind: str,
             out_dir: Optional[str] = None,
             variant_name: str = "baseline") -> Dict[str, Any]:
    mesh = make_production_mesh(multi_pod=mesh_kind == "multi")
    record: Dict[str, Any] = {
        "arch": arch_id, "shape": shape_name, "mesh": mesh_kind,
        "devices": int(mesh.size), "ok": False, "variant": variant_name,
    }
    t0 = time.time()
    try:
        kind = get_shape(shape_name).kind
        analytic = (analytic_memory_train(arch_id, shape_name, mesh)
                    if kind == "train"
                    else analytic_memory_serve(arch_id, shape_name, mesh))
        record.update({"memory": {"analytic_h100": analytic,
                                  "fits_hbm": analytic["fits_hbm"]},
                       "model_flops_global": model_flops(arch_id,
                                                         shape_name)})
        why = variant_refusal(variant_name)
        if why:
            raise ValueError(why)
        cell = (build_train_cell(arch_id, shape_name, mesh,
                                 VARIANTS[variant_name]) if kind == "train"
                else build_serve_cell(arch_id, shape_name, mesh))
        t_build = time.time() - t0
        cost = trace_cell(cell)
        record["memory"].update({
            "peak_per_device_traced": cost.peak_bytes,
            "peak_split_traced": cost.peak})
        record.update({"ok": True, "traced": True, "meta": cell.meta,
                       "seconds_build": round(t_build, 2),
                       "seconds_trace": round(time.time() - t0
                                              - t_build, 2),
                       "analysis": cost.as_dict()})
    except Exception as e:  # recorded: the caller, or --all, reports it
        record["error"] = f"{type(e).__name__}: {e}"[:2000]
    record["seconds_total"] = round(time.time() - t0, 2)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        path = os.path.join(out_dir, f"{arch_id}__{shape_name}__"
                            f"{mesh_kind}{_suffix(variant_name)}.json")
        with open(path, "w") as f:
            json.dump(record, f, indent=1, default=str)
    return record


def _print_record(r: Dict[str, Any]) -> None:
    if not r.get("ok"):
        print(f"[FAIL] {r['arch']:<24s} {r['shape']:<12s} {r['mesh']:<6s} "
              f"{r.get('error', '?')[:200]}")
        return
    mem = r["memory"]
    est = mem["analytic_h100"]["total"] / 1e9
    if not r.get("traced"):
        print(f"[AN ] {r['arch']:<24s} {r['shape']:<12s} {r['mesh']:<6s} "
              f"analytic={est:6.2f}GB fits={mem['fits_hbm']} (not traced)")
        return
    an = r["analysis"]
    print(f"[OK ] {r['arch']:<24s} {r['shape']:<12s} {r['mesh']:<6s} "
          f"peak/dev={mem['peak_per_device_traced'] / 1e9:6.2f}GB "
          f"analytic={est:6.2f}GB fits={mem['fits_hbm']} "
          f"flops/dev={an['flops']:.3e} wire/dev={an['wire_bytes']:.3e} "
          f"trace={r['seconds_trace']}s")


def _cell_process(arch: str, shape: str, mesh_kind: str, variant: str,
                  out_dir: str) -> Dict[str, Any]:
    """One cell's record: a saved ``ok`` one, or a fresh one from a
    subprocess of its own (one trace's memory a process)."""
    path = os.path.join(out_dir, f"{arch}__{shape}__{mesh_kind}"
                        f"{_suffix(variant)}.json")
    if os.path.exists(path):
        with open(path) as f:
            r = json.load(f)
        if r.get("ok"):
            return r
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
           arch, "--shape", shape, "--mesh", mesh_kind, "--variant",
           variant, "--out", out_dir]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    try:
        with open(path) as f:
            return json.load(f)
    except FileNotFoundError:
        return {"arch": arch, "shape": shape, "mesh": mesh_kind,
                "ok": False, "error": proc.stderr[-1500:]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list(ARCH_IDS))
    ap.add_argument("--shape", choices=["train_4k", "prefill_32k",
                                        "decode_32k", "long_500k"])
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="single")
    ap.add_argument("--variant", choices=list(VARIANTS), default="baseline")
    ap.add_argument("--all", action="store_true",
                    help="run every cell in a subprocess each")
    ap.add_argument("--jobs", type=int, default=1,
                    help="with --all: cells traced at once")
    ap.add_argument("--out", default="artifacts/dryrun_torch")
    ap.add_argument("--list", action="store_true")
    args = ap.parse_args(argv)

    if args.list:
        for a, s, skip in cells(include_skipped=True):
            print(f"{a:<24s} {s:<12s} {'SKIP' if skip else ''}")
        return 0
    why = variant_refusal(args.variant)
    if why:
        ap.error(why)

    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]

    if args.all:
        todo = [(a, s, mk) for a, s, _ in cells() for mk in meshes]
        with ThreadPoolExecutor(max(args.jobs, 1)) as pool:
            records = pool.map(lambda c: _cell_process(*c, args.variant,
                                                       args.out), todo)
            failures = 0
            for r in records:        # in cell order, as each is ready
                _print_record(r)
                failures += 0 if r.get("ok") else 1
        return 1 if failures else 0

    if not (args.arch and args.shape):
        ap.error("--arch and --shape required (or --all/--list)")
    if args.shape in get_arch(args.arch).skip_shapes:
        print(f"[SKIP] {args.arch} {args.shape}: inapplicable to the arch")
        return 0
    rc = 0
    for mk in meshes:
        r = run_cell(args.arch, args.shape, mk, out_dir=args.out,
                     variant_name=args.variant)
        _print_record(r)
        rc |= 0 if r.get("ok") else 1
    return rc


if __name__ == "__main__":
    sys.exit(main())
