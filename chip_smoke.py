#!/usr/bin/env python3
"""Run the PyTorch port on one CUDA card and check it end to end.

    python3 chip_smoke.py

Phases (any failure exits non-zero; the last stdout line is the result):

1. build   — compile the flash-attention CUDA kernel from the checkout's
             sources (``nvcc``, sm_90a) and print the seconds it took.
2. kernels — the kernel against its plain PyTorch version on the card at
             the serving path's shapes (64 query / 8 KV heads, D = 128):
             page-sized chunks (Sq 256) against a 4096-token cache at
             q_offset 0, 256 and 3840, and a one-shot 1000-token prefill,
             with q bf16 (as served) and f32, each over an f32 and a bf16
             cache.  Prints the max error against its tolerance (a share
             of the plain output's largest value: 2**-6 for a bf16 output,
             1e-4 for f32), kernel / plain / SDPA times (SDPA is a
             yardstick only; the port never calls it) and the least time
             the card could take (the bound).
3. small   — the reduced qwen2-72b served through the kernel on the card
             and through the plain path on the CPU from the same weights:
             logits agree within tolerance, greedy streams are equal.
4. serve   — qwen2-72b at its published widths, depth cut to 4 layers,
             random bf16 weights from a seed: 16 requests (prompts of
             256-3000 tokens, 32 new tokens each, greedy) through the paged
             continuous-batching scheduler with chunked prefill, twice.
             The checked run holds, by a hook of this script, each layer's
             kernel output for two requests against the plain version on
             the same CUDA tensors.  The timed run, unhooked, gives the
             launch count, tokens/s, TTFT and peak memory, and must give
             the checked run's tokens.  Checks completion, pool integrity
             and that every prefill chunk of every layer went through the
             kernel.

Exits non-zero without a result when CUDA is unavailable.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))

# Kernel vs plain, as a share of the plain output's largest magnitude.
# Both compute in f32 and round once to q's dtype.  A bf16 rounding moves
# a value by at most 2**-8 of it, so two independent roundings differ by
# at most 2**-7 of the largest output: the limit is twice that.  An f32
# output differs only by summation order (~1e-6); 1e-4 still fails a
# dropped 64-key tile, a mis-masked edge or P rounded to bf16 (~1e-3).
REL_TOL = {torch.bfloat16: 2.0 ** -6, torch.float32: 1e-4}
SMALL_LOGIT_TOL = 1e-3  # f32 reduced model, card vs CPU summation order
HBM_BYTES_PER_S = 3.35e12                      # H100 SXM data sheet
PEAK_OPS = {"bf16": 989e12, "f32": 67e12}      # dense; f32 = CUDA cores
SERVE_LAYERS = 4
SERVE_REQUESTS = 16
SERVE_MAX_NEW = 32
CHECK_RIDS = (0, 1)    # requests whose every chunk is held against plain


def _ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device milliseconds of ``fn`` over ``iters`` back-to-back
    calls (CUDA events; the inputs stay hot in L2 between calls)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _bound(q, k, q_offset: int):
    """Least time (ms) the card could take for causal attention of ``q``
    over ``k``/``v``: bytes (q, the visible K/V prefix, the output, each
    once) over HBM bandwidth against FLOPs over the peak for the operand
    type.  Returns (ms, "bytes" | "operations", peak name)."""
    b, sq, h, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    prefix = min(skv, q_offset + sq)
    nbytes = (2 * q.numel() * q.element_size()
              + 2 * b * prefix * hkv * d * k.element_size())
    # query i sees min(skv, q_offset + i + 1) keys; 4*D FLOPs per key
    seen = sum(min(skv, q_offset + i + 1) for i in range(sq))
    flops = 4 * b * h * d * seen
    kind = "bf16" if q.dtype == k.dtype == torch.bfloat16 else "f32"
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_OPS[kind]
    by = "bytes" if t_bytes >= t_ops else "operations"
    return max(t_bytes, t_ops) * 1e3, by, kind


def _error(got, want):
    """(max abs error, its limit) of the kernel's ``got`` against the
    plain ``want``; the limit scales with ``want``'s largest value."""
    want = want.float()
    err = (got.float() - want).abs().max().item()
    return err, REL_TOL[got.dtype] * want.abs().max().item()


def phase_build(kernel):
    t0 = time.perf_counter()
    built = kernel.load()
    print(f"[build] flash_attention: nvcc {built.seconds:.1f}s "
          f"(load {time.perf_counter() - t0:.1f}s) -> "
          f"{os.path.relpath(built.path, HERE)}")
    for line in built.log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"[build]   {line.strip()}")


def phase_kernels(kernel, ref):
    """Kernel vs plain at the serving shapes; returns the rows printed."""
    import torch.nn.functional as F
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = [("chunk", 256, 4096, off) for off in (0, 256, 3840)] \
        + [("one-shot", 1000, 1000, 0)]
    dtypes = [(qdt, kvdt) for qdt in (torch.bfloat16, torch.float32)
              for kvdt in (torch.float32, torch.bfloat16)]
    rows = []
    for name, sq, skv, off in cases:
        for qdt, kvdt in dtypes:
            q = torch.randn(1, sq, 64, 128, generator=gen, device="cuda"
                            ).to(qdt)
            k = torch.randn(1, skv, 8, 128, generator=gen, device="cuda"
                            ).to(kvdt)
            v = torch.randn(1, skv, 8, 128, generator=gen, device="cuda"
                            ).to(kvdt)
            out = kernel.flash_attention(q, k, v, q_offset=off)
            want = ref.attention(q, k, v, q_offset=off)
            err, tol = _error(out, want)
            ms = _ms(lambda: kernel.flash_attention(q, k, v, q_offset=off),
                     20)
            plain_ms = _ms(lambda: ref.attention(q, k, v, q_offset=off), 5)
            # SDPA yardstick: (B, H, S, D), one dtype (q upcast for an f32
            # cache, outside the timed call), explicit mask for an offset.
            qt = q.to(kvdt).transpose(1, 2)
            kt, vt = k.transpose(1, 2), v.transpose(1, 2)
            mask = None
            if off or sq != skv:
                mask = (torch.arange(skv, device="cuda")[None, :]
                        <= torch.arange(sq, device="cuda")[:, None] + off)
            lib_ms = _ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, is_causal=mask is None,
                enable_gqa=True), 20)
            bound_ms, by, peak = _bound(q, k, off)
            row = dict(case=name, sq=sq, skv=skv, q_offset=off,
                       q_dtype=str(qdt).split(".")[-1],
                       kv_dtype=str(kvdt).split(".")[-1], max_abs_err=err,
                       tol=tol, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                       bound_ms=bound_ms, bound_by=by, bound_peak=peak)
            rows.append(row)
            print(f"[kernels] {name:8s} Sq={sq:4d} Skv={skv:4d} "
                  f"off={off:4d} q={row['q_dtype']:8s} "
                  f"kv={row['kv_dtype']:8s} err={err:.3e} (tol {tol:.3e} = "
                  f"{REL_TOL[qdt]:.3g} x max|plain|) kernel={ms:.4f}ms "
                  f"plain={plain_ms:.4f}ms sdpa={lib_ms:.4f}ms "
                  f"bound={bound_ms:.4f}ms ({by}, {peak} peak)")
            if not err <= tol:
                raise AssertionError(f"kernel disagrees with plain: {row}")
    return rows


def _serve(model, params, scfg, prompts, device, max_new):
    from repro_torch.serve import BatchScheduler, Request
    sched = BatchScheduler(model, params, scfg, device=device)
    for rid, p in enumerate(prompts):
        sched.submit(Request(rid=rid, prompt=list(p), max_new=max_new))
    return sched, sched.run()


def phase_small():
    """Reduced qwen2-72b: kernel path on the card vs plain path on CPU."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.serve import ServeCfg
    from repro_torch.tree import map_tree
    model = build_model(get_config("qwen2-72b", reduced=True))
    cpu_params = model.init(torch.Generator().manual_seed(0))
    gpu_params = map_tree(lambda t: t.cuda(), cpu_params)
    rng = np.random.RandomState(1)
    toks = rng.randint(0, 256, size=(2, 40))
    logits = []
    for params, dev in ((cpu_params, "cpu"), (gpu_params, "cuda")):
        caches = model.init_caches(2, 64, dtype=torch.float32, device=dev)
        lg, _ = model.prefill(params, {"tokens": torch.tensor(toks,
                                                              device=dev)},
                              caches)
        logits.append(lg.cpu())
    err = (logits[0] - logits[1]).abs().max().item()
    prompts = [rng.randint(0, 256, size=n).tolist() for n in (5, 17, 30, 41)]
    scfg = ServeCfg(max_len=64, batch=3, cache_dtype=torch.float32,
                    page_tokens=8)
    streams = []
    for params, dev in ((cpu_params, "cpu"), (gpu_params, "cuda")):
        _, done = _serve(model, params, scfg, prompts, dev, 8)
        streams.append({r.rid: r.generated for r in done})
    print(f"[small] reduced qwen2-72b prefill logits card vs CPU: "
          f"max err {err:.3e} (tol {SMALL_LOGIT_TOL}); greedy streams "
          f"equal: {streams[0] == streams[1]}")
    if not err <= SMALL_LOGIT_TOL or streams[0] != streams[1]:
        raise AssertionError(f"card disagrees with CPU: {streams}")


def serve_workload():
    """The serving workload, on the card: qwen2-72b at its published
    widths cut to SERVE_LAYERS layers with random bf16 weights from seed
    0, the scheduler's config, and SERVE_REQUESTS prompts of 256-3000
    tokens from ``RandomState(0)``.  Also serves one short request as a
    warm-up (cuBLAS handles, allocator).  Returns (model, params, scfg,
    prompts)."""
    from repro_torch.configs import get_config, with_num_layers
    from repro_torch.models import build_model
    from repro_torch.serve import ServeCfg
    from repro_torch.tree import leaves
    cfg = with_num_layers(get_config("qwen2-72b"), SERVE_LAYERS)
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    print(f"[serve] {cfg.name} d_model={cfg.d_model} heads="
          f"{cfg.attn.num_heads}/{cfg.attn.num_kv_heads} head_dim="
          f"{cfg.attn.head_dim} ff={cfg.mlp.d_ff} vocab={cfg.vocab_size} "
          f"layers={cfg.num_layers}: {model.param_count() / 1e9:.3f}B params, "
          f"{_nbytes(leaves(params)) / 1e9:.2f} GB bf16, init "
          f"{time.perf_counter() - t0:.1f}s")
    scfg = ServeCfg(max_len=4096, batch=8, page_tokens=256,
                    cache_dtype=torch.float32)
    rng = np.random.RandomState(0)
    lens = rng.randint(256, 3001, size=SERVE_REQUESTS)
    prompts = [rng.randint(0, cfg.vocab_size, size=n).tolist()
               for n in lens]
    _serve(model, params, scfg, [prompts[0][:300]], "cuda", 2)
    return model, params, scfg, prompts


def _checked_serve(model, params, scfg, submit, ref):
    """Serve once with this script's own hook, which holds the kernel's
    output for every layer of every prefill chunk of CHECK_RIDS against
    the plain version on the same CUDA tensors, right where the model
    calls it.  The plain calls and their host syncs slow the run, so it
    is not the one timed.  Returns ({rid: tokens}, [(max abs error,
    limit) per checked call]); the scheduler and its pool are freed on
    return."""
    from repro_torch.models import layers as L
    from repro_torch.serve import BatchScheduler
    errs = []
    current = {"rid": None}
    kernel_chunk = L.chunk_attention

    def checked_chunk(q, k_cache, v_cache, q_offset, sm_scale=None):
        out = kernel_chunk(q, k_cache, v_cache, q_offset, sm_scale)
        if current["rid"] in CHECK_RIDS:
            errs.append(_error(out, ref.attention(
                q, k_cache, v_cache, causal=True, q_offset=q_offset)))
        return out

    sched = BatchScheduler(model, params, scfg, device="cuda")
    chunk_run = sched._chunk

    def tagged_chunk(params_, rid, *args):
        current["rid"] = rid
        return chunk_run(params_, rid, *args)

    sched._chunk = tagged_chunk
    L.chunk_attention = checked_chunk
    try:
        submit(sched)
        checked = {r.rid: r.generated for r in sched.run()}
    finally:
        L.chunk_attention = kernel_chunk
    sched.pool.check_integrity()
    return checked, errs


def phase_serve(ops, ref):
    from repro_torch.serve import BatchScheduler, Request
    from repro_torch.tree import leaves
    model, params, scfg, prompts = serve_workload()
    cfg = model.cfg
    lens = np.array([len(p) for p in prompts])
    weight_bytes = _nbytes(leaves(params))

    def submit(sched):
        for rid, p in enumerate(prompts):
            sched.submit(Request(rid=rid, prompt=p, max_new=SERVE_MAX_NEW))

    checked, errs = _checked_serve(model, params, scfg, submit, ref)

    # Timed run of the main path, unhooked, with the counts set to 0 just
    # before it and read just after.
    sched = BatchScheduler(model, params, scfg, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    ops.launches = 0
    t0 = time.perf_counter()
    submit(sched)
    done = sched.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launches
    peak = torch.cuda.max_memory_allocated()

    n_chunks = sum(-(-n // scfg.page_tokens) for n in lens)
    n_tokens = sum(len(r.generated) for r in done)
    ttft = sorted(r.ttft_s for r in done)
    pool = sched.pool
    pool_bytes = _nbytes(pool.pool)
    card = torch.cuda.get_device_properties(0).total_memory
    print(f"[serve] prompts {sorted(lens.tolist())}")
    print(f"[serve] {len(done)}/{SERVE_REQUESTS} done, {len(sched.shed)} "
          f"shed, {n_tokens} tokens in {wall:.2f}s = "
          f"{n_tokens / wall:.1f} tok/s; {sched.decode_steps} decode steps; "
          f"TTFT p50 {np.percentile(ttft, 50):.3f}s p99 "
          f"{np.percentile(ttft, 99):.3f}s")
    print(f"[serve] flash launches {launches} = {SERVE_LAYERS} layers x "
          f"{n_chunks} prefill chunks: {launches == SERVE_LAYERS * n_chunks}")
    worst = max(errs, key=lambda e: e[0] / e[1])
    same = {r.rid: r.generated for r in done} == checked
    print(f"[serve] checked run: {len(errs)} chunk-layer outputs of rids "
          f"{CHECK_RIDS} vs plain, max err {max(e[0] for e in errs):.3e}; "
          f"worst {worst[0]:.3e} against its tol {worst[1]:.3e} "
          f"({REL_TOL[torch.bfloat16]:.3g} x max|plain|); token streams "
          f"equal to the timed run's: {same}")
    print(f"[serve] peak allocated {peak / 2**30:.2f} GiB of "
          f"{card / 2**30:.1f} GiB; {base / 2**30:.2f} GiB before the timed "
          f"run (weights {weight_bytes / 2**30:.2f} GiB, page pool "
          f"{pool_bytes / 2**30:.2f} GiB)")
    if base > weight_bytes + pool_bytes + 2 ** 28:
        raise AssertionError(f"{base} bytes held before the timed run: "
                             "an earlier run outlived its scheduler")
    if len(done) != SERVE_REQUESTS or sched.shed:
        raise AssertionError("not every request completed")
    for r in done:
        if len(r.generated) != SERVE_MAX_NEW or not all(
                0 <= t < cfg.vocab_size for t in r.generated):
            raise AssertionError(f"rid {r.rid}: bad tokens {r.generated}")
    pool.check_integrity()
    if not (launches > 0 and launches == SERVE_LAYERS * n_chunks):
        raise AssertionError(f"{launches} launches for {n_chunks} chunks")
    expect_checks = SERVE_LAYERS * sum(-(-lens[r] // scfg.page_tokens)
                                       for r in CHECK_RIDS)
    if len(errs) != expect_checks or not all(e <= t for e, t in errs):
        raise AssertionError(f"hook: {len(errs)} checks, errs {errs}")
    if not same:
        raise AssertionError("checked and timed runs gave other tokens")
    if not peak < 0.95 * card:
        raise AssertionError(f"peak {peak} exceeds the card")
    return dict(launches=launches, max_abs_err=max(e[0] for e in errs))


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(HERE, "src"))
    from repro_torch.kernels.flash_attention import kernel, ops, ref
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    phase_build(kernel)
    rows = phase_kernels(kernel, ref)
    phase_small()
    serve = phase_serve(ops, ref)
    print(f"[done] all phases in {time.perf_counter() - t0:.1f}s")

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card)
    main_row = next(r for r in rows if r["case"] == "chunk"
                    and r["q_offset"] == 3840 and r["q_dtype"] == "bfloat16"
                    and r["kv_dtype"] == "float32")
    print(json.dumps({"kernels": [{
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/"
                  "flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:93",
        "launches": serve["launches"],
        "max_abs_err": max(serve["max_abs_err"],
                           max(r["max_abs_err"] for r in rows)),
        "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"]}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
