#!/usr/bin/env python3
"""Where the port's serving time and memory go on one CUDA card.

    python3 tools/profile_torch_serve.py [--arch ARCH] [--out DIR]

Serves the workload of one of ``chip_smoke.py``'s serve phases
(``chip_smoke.serve_workload``: qwen2-72b for [serve], or with
``--arch`` the model of [serve_moe], [serve_nemotron],
[serve_deepseek], [serve_jamba] or [serve_mamba2], at its published
widths and that phase's depth, 16 requests of 256-3000 prompt tokens (a
multiple of the SSD chunk for the state-space models), 32 new tokens
each, batch 8, 256-token pages, f32 cache) three times after its
warm-up:

1. step by step: the host clock around each scheduler step, ended by a
   synchronize, and the step's peak of allocated memory, split into steps
   that prefilled (page-sized chunks, or whole prompts for a model that
   prefills one-shot: the scheduler's calls of ``Model.prefill_chunk``
   and ``Model.prefill``) and steps that only decoded;
2. under ``torch.profiler``: device time by kernel, by part of the
   model (the mixer: attention, MLA or Mamba; for a MoE model its expert
   products, its routing, and its scatter and gather; the rest), and the
   share of the wall time the device was busy
   (``DIR/serve_trace.json`` holds the timeline);
3. with the allocator's history recorded: the largest tensors alive at
   the peak of allocated memory, with the port's line that made each.

With ``--one-shot`` it profiles instead the phase's checked prompts
(``chip_smoke.CHECK_RIDS``) prefilled one-shot through ``Model.prefill``
(for deepseek-v3-671b MLA's materialized form, whose attention is the
flash kernel at (192, 128)): each prompt's wall time once warm, then
device time by kernel and by part (the flash kernel, launched through
ctypes, has no aten op above it, so it counts to no part: read it from
the kernels).

Exits non-zero when CUDA is unavailable.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GiB = 2 ** 30


@contextlib.contextmanager
def _prefills_counted(model):
    """Count the scheduler's prefill calls on ``model`` while the block
    runs: {"chunks": page-sized chunks, "prompts": one-shot prompts}."""
    counts = {"chunks": 0, "prompts": 0}

    def counted(name, key):
        fn = getattr(model, name)

        def run(*a, **kw):
            counts[key] += 1
            return fn(*a, **kw)
        return run

    model.prefill_chunk = counted("prefill_chunk", "chunks")
    model.prefill = counted("prefill", "prompts")
    try:
        yield counts
    finally:
        del model.prefill_chunk, model.prefill


def _timed(fn, prefills, decode_steps):
    """(prefill chunks, one-shot prompts, decode steps, seconds, peak
    bytes) of ``fn()``."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    c0, p0, d0 = prefills["chunks"], prefills["prompts"], decode_steps()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (prefills["chunks"] - c0, prefills["prompts"] - p0,
            decode_steps() - d0, time.perf_counter() - t0,
            torch.cuda.max_memory_allocated())


def _site(frames) -> str:
    """The innermost frames of the port (or this repo's scripts)."""
    ours = [f for f in frames if "repro_torch" in f["filename"]
            or "chip_smoke" in f["filename"]]
    return " <- ".join(f"{os.path.basename(f['filename'])}:{f['line']}"
                       for f in ours[:3]) or "?"


def _live_at_peak(snapshot):
    """Replay the recorded allocations; returns (peak bytes above the
    recording's start, the allocations alive at that peak)."""
    live, total, peak, at_peak = {}, 0, 0, {}
    for ev in snapshot["device_traces"][0]:
        if ev["action"] == "alloc":
            live[ev["addr"]] = ev
            total += ev["size"]
            if total > peak:
                peak, at_peak = total, dict(live)
        elif ev["action"] in ("free_requested", "free_completed") \
                and ev["addr"] in live:
            total -= live.pop(ev["addr"])["size"]
    return peak, list(at_peak.values())


#: (module, function) -> the part of the model its device time counts to
PARTS = ((("layers", "attention_forward"), "mixer: attention"),
         (("layers", "attention_decode"), "mixer: attention"),
         (("mla", "mla_forward"), "mixer: MLA"),
         (("mla", "mla_decode"), "mixer: MLA"),
         (("mamba", "mamba_forward"), "mixer: Mamba"),
         (("mamba", "mamba_decode"), "mixer: Mamba"),
         (("moe", "_expert_ffn"), "expert products"),
         (("moe", "route"), "routing"),
         (("moe", "_dispatch"), "scatter/gather"),
         (("moe", "_combine"), "scatter/gather"))


@contextlib.contextmanager
def _parts_marked():
    """Each function of PARTS wrapped in a ``record_function`` range of
    its part's name while the block runs (the model looks them up on
    their modules at each call)."""
    from repro_torch.models import layers, mamba, mla, moe
    mods = {"layers": layers, "mla": mla, "mamba": mamba, "moe": moe}
    saved = []
    for (mod, name), part in PARTS:
        fn = getattr(mods[mod], name)
        saved.append((mods[mod], name, fn))

        def marked(*a, _fn=fn, _part=part, **kw):
            with torch.profiler.record_function("part: " + _part):
                return _fn(*a, **kw)
        setattr(mods[mod], name, marked)
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def _device_us_by_part(prof):
    """The device time of every host op's kernels, summed by the
    innermost marked part above the op (else "other")."""
    out = {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CPU:
            continue          # the kernels themselves, the parts' spans
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if not us:
            continue
        part, up = "other", e
        while up is not None:
            if up.name.startswith("part: "):
                part = up.name[len("part: "):]
                break
            up = up.cpu_parent
        out[part] = out.get(part, 0) + us
    return out


def _dev_us(e):
    return getattr(e, "self_device_time_total", None) \
        or getattr(e, "self_cuda_time_total", 0)


def _print_profile(prof, wall):
    """Device busy share of ``wall`` seconds, the 15 kernels with the
    most device time, and device time by part of the model."""
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.key.startswith("part: ")]
    busy = sum(_dev_us(e) for e in kernels) / 1e6
    print(f"[profile] wall {wall:.3f}s (profiled), device busy {busy:.3f}s "
          f"= {busy / wall:.1%}; kernels by device time:")
    for e in sorted(kernels, key=_dev_us, reverse=True)[:15]:
        print(f"[profile] {_dev_us(e) / 1e3:10.1f} ms {e.count:6d}x "
              f"{_dev_us(e) / 1e6 / busy:6.1%}  {e.key[:100]}")
    parts = _device_us_by_part(prof)
    total = sum(parts.values()) / 1e6
    print(f"[profile] device time by part of the model ({total:.3f}s):")
    for part, us in sorted(parts.items(), key=lambda kv: -kv[1]):
        print(f"[profile] {us / 1e3:10.1f} ms {us / 1e6 / total:6.1%}  "
              f"{part}")


def _one_shot(model, params, scfg, prompts, out: str) -> int:
    """``--one-shot``: the checked prompts through ``Model.prefill``."""
    import chip_smoke

    def run(rid):
        caches = model.init_caches(1, scfg.max_len, dtype=scfg.cache_dtype)
        toks = torch.tensor([prompts[rid]], device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.prefill(params, {"tokens": toks}, caches)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    for rid in chip_smoke.CHECK_RIDS:
        run(rid)                                      # warm
    for rid in chip_smoke.CHECK_RIDS:
        print(f"[one-shot] rid {rid} ({len(prompts[rid])} tokens): "
              f"Model.prefill {run(rid) * 1e3:.3f} ms wall")
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with _parts_marked(), torch.profiler.profile(activities=acts) as prof:
        wall = sum(run(rid) for rid in chip_smoke.CHECK_RIDS)
    prof.export_chrome_trace(os.path.join(out, "one_shot_trace.json"))
    _print_profile(prof, wall)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=os.path.join(REPO, "build", "profile"),
                    help="directory for the profiler's timeline")
    ap.add_argument("--arch", default="qwen2-72b",
                    help="the served model (qwen2-72b: [serve]; "
                         "qwen3-moe-30b-a3b, nemotron-4-340b, "
                         "deepseek-v3-671b, jamba-1.5-large-398b, "
                         "mamba2-1.3b: their serve phases)")
    ap.add_argument("--one-shot", action="store_true",
                    help="profile Model.prefill of the checked prompts "
                         "one-shot instead of the scheduler")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_torch_serve: CUDA is not available", file=sys.stderr)
        return 1
    sys.path[:0] = [REPO, os.path.join(REPO, "src")]
    import chip_smoke
    from repro_torch.serve import BatchScheduler, Request
    torch.backends.cuda.matmul.allow_tf32 = False
    os.makedirs(args.out, exist_ok=True)

    model, params, scfg, prompts = chip_smoke.serve_workload(args.arch)
    if args.one_shot:
        return _one_shot(model, params, scfg, prompts, args.out)

    def submit(sched):
        for rid, p in enumerate(prompts):
            sched.submit(Request(rid=rid, prompt=p,
                                 max_new=chip_smoke.SERVE_MAX_NEW))

    # 1. step by step
    sched = BatchScheduler(model, params, scfg, device="cuda")
    base = torch.cuda.memory_allocated()
    with _prefills_counted(model) as prefills:
        steps = [_timed(lambda: submit(sched), prefills,
                        lambda: sched.decode_steps)]
        while sched.pending():
            steps.append(_timed(sched.step, prefills,
                                lambda: sched.decode_steps))
    pre = [s for s in steps if s[0] or s[1]]
    dec = [s for s in steps if not (s[0] or s[1]) and s[2]]
    print(f"[steps] allocated before serving {base / GiB:.2f} GiB "
          f"(weights + page pool); submit + {len(steps) - 1} steps in "
          f"{sum(s[3] for s in steps):.3f}s")
    if pre:
        print(f"[steps] {len(pre)} with prefill ({sum(s[0] for s in pre)} "
              f"chunks, {sum(s[1] for s in pre)} one-shot prompts, "
              f"{sum(s[2] for s in pre)} decodes): "
              f"{sum(s[3] for s in pre):.3f}s, peak "
              f"{max(s[4] for s in pre) / GiB:.2f} GiB")
    if dec:
        print(f"[steps] {len(dec)} decode-only: {sum(s[3] for s in dec):.3f}s,"
              f" median {np.median([s[3] for s in dec]) * 1e3:.2f} ms, peak "
              f"{max(s[4] for s in dec) / GiB:.2f} GiB")
    del sched

    # 2. profiler
    sched = BatchScheduler(model, params, scfg, device="cuda")
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with _parts_marked(), torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        submit(sched)
        sched.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    prof.export_chrome_trace(os.path.join(args.out, "serve_trace.json"))
    _print_profile(prof, wall)
    del sched, prof

    # 3. allocator history
    sched = BatchScheduler(model, params, scfg, device="cuda")
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.memory._record_memory_history(max_entries=500_000,
                                             stacks="python")
    submit(sched)
    sched.run()
    torch.cuda.synchronize()
    snap = torch.cuda.memory._snapshot()
    torch.cuda.memory._record_memory_history(enabled=None)
    peak, live = _live_at_peak(snap)
    print(f"[memory] peak {(base + peak) / GiB:.2f} GiB = "
          f"{base / GiB:.2f} GiB before serving + {peak / GiB:.2f} GiB; "
          f"largest of the {len(live)} tensors alive at the peak:")
    for ev in sorted(live, key=lambda e: e["size"], reverse=True)[:10]:
        print(f"[memory] {ev['size'] / 2**20:10.1f} MiB  "
              f"{_site(ev.get('frames', []))}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
