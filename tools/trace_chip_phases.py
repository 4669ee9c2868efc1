"""Predict the peaks of ``chip_smoke.py``'s training phases without the
card: each phase's step traced as one rank on ``meta`` tensors by the
dry-run's tracer (``launch.dryrun.train_cell`` / ``trace_cell``), at the
phase's widths, layers, rows and optimizer.

    PYTHONPATH=src python tools/trace_chip_phases.py [--phase NAME ...]

Prints, for each phase, the traced peak a rank (params, gradients,
optimizer state and the rest at that moment), its flops and its wire
bytes.  Nothing is allocated: it runs on the CPU in a few minutes.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "..", "src"))
sys.path.insert(0, os.path.join(HERE, ".."))

import torch  # noqa: E402

import chip_smoke as C  # noqa: E402
from repro_torch.configs import get_config, with_num_layers  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.runtime import substrate  # noqa: E402


def _batch(ds):
    return {k: torch.empty(v.shape, dtype=torch.from_numpy(v).dtype,
                           device="meta")
            for k, v in ds.host_batch(0).items()}


def _trace(cfg, ds, shape, opt, variant, settings=None, **kw):
    mesh = substrate.abstract_mesh(shape, ("data", "model")[:len(shape)])
    cell = dryrun.train_cell(cfg, _batch(ds), mesh, settings=settings,
                             variant=variant, optimizer=opt, **kw)
    return dryrun.trace_cell(cell)


def phases():
    """{name: a function tracing that phase's step}."""
    granite = with_num_layers(get_config("granite-34b"), C.TRAIN_LAYERS)
    mistral = with_num_layers(get_config(C.ADAFACTOR_ARCH), C.TRAIN_LAYERS)
    r, m = C.TRAIN_RANKS, C.TP_MODEL
    deepseek = with_num_layers(get_config(C.DEEPSEEK_ARCH), C.TRAIN_LAYERS)
    # deepseek's shallowest cut with its MoE layers: one dense layer and
    # one MoE layer, and the MTP block (the last stage's layer: MoE)
    ds_full = get_config(C.DEEPSEEK_ARCH)
    deepseek_moe = dataclasses.replace(ds_full, stages=tuple(
        dataclasses.replace(st, repeat=1) for st in ds_full.stages))
    vl = with_num_layers(get_config(C.VL_ARCH), C.VL_TRAIN_LAYERS)
    return {
        "train (composed)": lambda: _trace(
            granite, C._train_data(granite), (r,), C._adamw(C.TRAIN_LR),
            {"sync": "composed"}),
        "train_auto": lambda: _trace(
            granite, C._train_data(granite), (r,), C._adamw(C.TRAIN_LR),
            {"sync": "auto"}),
        "train_adafactor (ZeRO-1 on (2, 2))": lambda: _trace(
            mistral, C._train_data(mistral), (r, m),
            C._adafactor(C.TRAIN_LR), {"zero1": True}, overlap=True,
            check_model_replicas=True),
        "train_fsdp_tp": lambda: _trace(
            mistral, C._train_data(mistral), (r, m),
            C._adafactor(C.LOW_LR), {"sync": "auto"},
            check_model_replicas=True),
        "train_deepseek (data-parallel)": lambda: _trace(
            deepseek, C._train_data(deepseek), (r,),
            C._adafactor(C.TRAIN_LR), {"sync": "composed",
                                       "microbatches": 2},
            {"grad_dtype": torch.bfloat16}),
        "train_deepseek_moe (composed, proposed)": lambda: _trace(
            deepseek_moe, C._train_data(deepseek_moe), (r,),
            C._adafactor(C.TRAIN_LR), {"sync": "composed",
                                       "microbatches": 2},
            {"grad_dtype": torch.bfloat16}),
        "train_deepseek_moe (auto, proposed)": lambda: _trace(
            deepseek_moe, C._train_data(deepseek_moe), (r,),
            C._adafactor(C.TRAIN_LR), {"sync": "auto", "microbatches": 2},
            {"grad_dtype": torch.bfloat16}),
        "train_vl (data-parallel)": lambda: _trace(
            vl, C.vl_workload_data(vl), (r,), C._adamw(C.TRAIN_LR),
            {"sync": "composed", "microbatches": C.VL_TRAIN_MICRO}),
    }


def main(argv=None) -> int:
    table = phases()
    ap = argparse.ArgumentParser()
    ap.add_argument("--phase", action="append", choices=list(table))
    args = ap.parse_args(argv)
    for name in args.phase or list(table):
        t0 = time.perf_counter()
        cost = table[name]()
        split = ", ".join(f"{k} {v / 2**30:.2f}"
                          for k, v in cost.peak.items())
        print(f"[{name}] traced peak {cost.peak_bytes / 2**30:.2f} GiB a "
              f"rank ({split}); flops {cost.flops:.6e}; wire bytes "
              f"{cost.wire_bytes:,.0f} ({time.perf_counter() - t0:.1f}s)",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
