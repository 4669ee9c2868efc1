#!/usr/bin/env python3
"""Where the port's training step time goes on one CUDA card.

    python3 tools/profile_torch_train.py [--out DIR] [--runs RUNS]

Builds the workload of ``chip_smoke.py``'s train phase
(``chip_smoke.train_workload``: granite-34b at its published widths, 2
of 88 layers, 2 thread ranks, seq 2048, global batch 4) and, for each
run (``--sync composed`` and ``compressed`` per leaf; with ``--runs``
also ``bucketed`` (composed, fused buckets, overlapped depth 2),
``zero`` (ZeRO-1, overlapped, with its per-leaf twin ``leaf0``, both at
clip_norm 0), ``adafactor`` (``chip_smoke.py`` [train_adafactor]'s
data-parallel composed run: mistral-large-123b, 2 of 88 layers,
Adafactor), ``vl`` and ``seamless`` ([train_vl]'s and
[train_seamless]'s, AdamW)), runs two warm-up steps and then one step
under ``torch.profiler``: device time by kernel, the gradient-sync kernels'
share, the optimizer update's share (its kernels, both ranks', run on
a stream of their own) with the kernels outside it, and the share of
the step's wall time the device was busy
(``DIR/train_<run>_trace.json`` holds the timeline).  All ranks launch
on one stream, and the update's stream waits for it and it for the
update, so kernels do not overlap and their summed time is the busy
time.

Exits non-zero when CUDA is unavailable.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import gc
import json
import os
import sys
import time

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SYNC_KERNEL_NAMES = ("sum_chunks_kernel", "quantize_kernel",
                     "dequantize_kernel", "dequant_add_kernel")


def _dev_us(e) -> float:
    return getattr(e, "self_device_time_total", None) \
        or getattr(e, "self_cuda_time_total", 0)


def _on_stream(opt, stream):
    """``opt`` with its update launched on ``stream``, ordered after the
    rank's earlier work and before its later work: the update's kernels
    are then the trace's kernels on that stream.  (The profiler records
    the CPU ops of the thread that starts it only, not of the rank
    threads, so a ``record_function`` range there would hold nothing.)"""
    def update(*a, **kw):
        main = torch.cuda.current_stream()
        stream.wait_stream(main)
        with torch.cuda.stream(stream):
            out = opt.update(*a, **kw)
        main.wait_stream(stream)
        return out
    return dataclasses.replace(opt, update=update)


def _stream_kernels(trace_path: str):
    """(device us by kernel name on the streams other than the one the
    step's first kernel ran on, how many such streams) from a timeline."""
    with open(trace_path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("cat") == "kernel"]
    main = min(events, key=lambda e: e["ts"])["args"]["stream"]
    out = collections.Counter()
    for e in events:
        if e["args"]["stream"] != main:
            out[e["name"]] += e["dur"]
    return out, len({e["args"]["stream"] for e in events} - {main})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=os.path.join(REPO, "build", "profile"),
                    help="directory for the profiler's timelines")
    ap.add_argument("--runs", default="composed,compressed",
                    help="comma-separated: composed, compressed, "
                         "bucketed, leaf0, zero, adafactor, vl, seamless")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_torch_train: CUDA is not available", file=sys.stderr)
        return 1
    sys.path[:0] = [REPO, os.path.join(REPO, "src")]
    import chip_smoke
    torch.backends.cuda.matmul.allow_tf32 = False
    os.makedirs(args.out, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    runs = {"composed": ("composed", None, {}),
            "compressed": ("compressed", None, {}),
            "bucketed": ("composed", None, dict(bucket_grads=True,
                                                overlap=True)),
            "leaf0": ("composed", chip_smoke._adamw(
                chip_smoke.TRAIN_LR, clip_norm=0.0), {}),
            "zero": ("composed", chip_smoke._adamw(
                chip_smoke.TRAIN_LR, clip_norm=0.0), dict(zero=True,
                                                          overlap=True)),
            "adafactor": ("composed", chip_smoke._adafactor(
                chip_smoke.TRAIN_LR), {}),
            "vl": ("composed", chip_smoke._adamw(chip_smoke.TRAIN_LR),
                   dict(microbatches=chip_smoke.VL_TRAIN_MICRO)),
            "seamless": ("composed", chip_smoke._adamw(chip_smoke.TRAIN_LR),
                         {})}
    granite, opt_stream = None, torch.cuda.Stream()
    for sync in args.runs.split(","):
        kind, run_opt, cfg = runs[sync]
        if sync == "adafactor":
            work = chip_smoke._large_workload(
                "profile", chip_smoke.ADAFACTOR_ARCH, chip_smoke.TRAIN_LAYERS)
        elif sync == "vl":
            work = chip_smoke.vl_workload("profile")
        elif sync == "seamless":
            work = chip_smoke.seamless_workload("profile")
        else:
            granite = granite or chip_smoke.train_workload()
            work, run_opt = granite[:4], run_opt or granite[4]
        session, states, step_fn = chip_smoke.train_run(
            *work, _on_stream(run_opt, opt_stream), kind, **cfg)
        ds = work[3]
        for step in range(2):
            states, _ = step_fn(states, ds.host_batch(step))
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            states, _ = step_fn(states, ds.host_batch(2))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        trace = os.path.join(args.out, f"train_{sync}_trace.json")
        prof.export_chrome_trace(trace)
        kernels = [e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        busy = sum(_dev_us(e) for e in kernels) / 1e6
        sync_us = sum(_dev_us(e) for e in kernels
                      if any(n in e.key for n in SYNC_KERNEL_NAMES))
        inside, n_streams = _stream_kernels(trace)
        opt_us = sum(inside.values())
        print(f"[profile] {sync}: step wall {wall * 1e3:.1f} ms (profiled), "
              f"device busy {busy * 1e3:.1f} ms = {busy / wall:.1%}; sync "
              f"kernels {sync_us / 1e3:.1f} ms = {sync_us / 1e6 / busy:.1%} "
              f"of busy; optimizer update {opt_us / 1e3:.1f} ms = "
              f"{opt_us / 1e6 / busy:.1%} of busy ({n_streams} stream "
              "besides the step's); kernels by device time:")
        for e in sorted(kernels, key=_dev_us, reverse=True)[:15]:
            print(f"[profile] {_dev_us(e) / 1e3:10.2f} ms {e.count:6d}x "
                  f"{_dev_us(e) / 1e6 / busy:6.1%}  {e.key[:100]}")
        outside = collections.Counter({e.key: _dev_us(e) for e in kernels})
        outside.subtract(inside)
        print(f"[profile] {sync}: outside the optimizer update, by device "
              "time:")
        for key, us in outside.most_common(10):
            print(f"[profile] {us / 1e3:10.2f} ms        "
                  f"{us / 1e6 / busy:6.1%}  {key[:100]}")
        del session, states, step_fn, prof
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
