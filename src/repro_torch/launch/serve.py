"""Serving launcher of the port: continuous-batching generation over a
serving session of ``--data`` thread ranks on one device, optionally
supervised by the elastic ``ServeController`` (counterpart of
``repro.launch.serve``).

    PYTHONPATH=src python -m repro_torch.launch.serve --requests 16 \
        --batch 4 --max-new 12                       # reduced, on CUDA

    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --requests 4 --max-new 4

    # qwen2-72b at its published widths, depth cut to 4 layers
    PYTHONPATH=src python -m repro_torch.launch.serve --full \
        --num-layers 4 --max-len 4096 --page-tokens 256 --batch 8

    # the MoE family: qwen3-moe-30b-a3b, reduced on the CPU
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --arch qwen3-moe-30b-a3b --requests 4 --max-new 4

    # the state-space families (one-shot prefill; prompts a multiple of
    # the SSD chunk long): mamba2-1.3b, jamba-1.5-large-398b
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --arch jamba-1.5-large-398b --requests 4 --max-new 4

    # elastic: 4 data ranks, lose 2 at step 3 (batch 4 -> 2)
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --data 4 --elastic --fault-plan lose@3:2

qwen2-vl-7b and seamless-m4t-large-v2 are refused: the scheduler feeds
token ids only, as the reference's does (whose launcher refuses the
encoder-decoder too); they serve through ``Model.prefill`` and
``Model.decode_step`` on a batch of embeddings.
"""

from __future__ import annotations

import argparse
import logging
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.comm import Session
from repro_torch.configs import ARCH_IDS, get_config, with_num_layers
from repro_torch.launch._elastic import (add_elastic_args,
                                         check_elastic_args,
                                         elastic_signals)
from repro_torch.models import build_model
from repro_torch.runtime import substrate
from repro_torch.runtime.controller import FaultPlan
from repro_torch.serve import (BatchScheduler, Request, ServeCfg,
                               ServeController)
from repro_torch.serve.engine import prompt_len, token_only_refusal

logger = logging.getLogger("repro_torch.serve")

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list(ARCH_IDS), default="qwen2-72b")
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (cuda | cpu)")
    size = ap.add_mutually_exclusive_group()
    size.add_argument("--reduced", dest="reduced", action="store_true",
                      default=True, help="test-sized config (default)")
    size.add_argument("--full", dest="reduced", action="store_false",
                      help="published widths")
    ap.add_argument("--num-layers", type=int, default=None,
                    help="cut depth to this many layers (widths unchanged)")
    ap.add_argument("--param-dtype", choices=list(_DTYPES), default=None,
                    help="weight dtype (default: the config's)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0,
                    help="sampling seed (ServeCfg.seed) and weight seed")
    ap.add_argument("--max-queue", type=int, default=None,
                    help="admission-control backlog bound (shed beyond)")
    ap.add_argument("--page-tokens", type=int, default=None,
                    help="KV page size (pow2 dividing max-len; equal to "
                         "max-len = contiguous layout; default auto)")
    ap.add_argument("--pool-pages", type=int, default=None,
                    help="page-pool capacity (default batch*max_len/"
                         "page_tokens; smaller values overcommit and "
                         "exercise preemption)")
    ap.add_argument("--no-chunked-prefill", action="store_true",
                    help="run prompts' chunks back to back at admission "
                         "instead of interleaved with decode")
    ap.add_argument("--data", type=int, default=1,
                    help="data-parallel ranks of the serving session "
                         "(threads on one device); the batch splits over "
                         "them")
    add_elastic_args(ap, what="serving")
    ap.add_argument("--snapshot-dir", default=None,
                    help="persist each drained scheduler snapshot here "
                         "(with --elastic)")
    args = ap.parse_args(argv)
    check_elastic_args(ap, args)
    if args.snapshot_dir and not args.elastic:
        ap.error("--snapshot-dir needs --elastic")
    return args


def main(argv=None) -> None:
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    device = resolve_device(args.device)

    dtype = _DTYPES[args.param_dtype] if args.param_dtype else None
    cfg = get_config(args.arch, reduced=args.reduced, param_dtype=dtype)
    if args.num_layers is not None:
        cfg = with_num_layers(cfg, args.num_layers)
    model = build_model(cfg)
    refusal = token_only_refusal(model)
    if refusal:
        raise SystemExit(f"the serve launcher serves through the scheduler: "
                         f"{refusal}")
    params = model.init(torch.Generator(device).manual_seed(args.seed))
    logger.info("model %s: %d layers, %.2fM params on %s", model.name,
                cfg.num_layers, model.param_count() / 1e6, device)

    scfg = ServeCfg(max_len=args.max_len, batch=args.batch,
                    cache_dtype=torch.float32, seed=args.seed,
                    max_queue=args.max_queue, page_tokens=args.page_tokens,
                    pool_pages=args.pool_pages,
                    chunked_prefill=not args.no_chunked_prefill)
    rng = np.random.RandomState(0)
    requests = [
        Request(rid=rid,
                prompt=rng.randint(0, cfg.vocab_size,
                                   size=prompt_len(cfg, rng.randint(4, 16))
                                   ).tolist(),
                max_new=args.max_new)
        for rid in range(args.requests)]

    # The session owns the serving mesh; the scheduler serves on it.
    session = Session(mesh=substrate.make_host_mesh(args.data,
                                                    device=device))
    logger.info("serving session: %s", session.world.describe())
    t0 = time.time()
    if args.elastic:
        preemption, membership = elastic_signals(args, session.mesh)
        try:
            ctl = ServeController(
                model, params, scfg, comm=session.world,
                fault_plan=(FaultPlan.parse(args.fault_plan,
                                            seed=args.fault_seed)
                            if args.fault_plan else None),
                max_recoveries=args.max_recoveries,
                watchdog_timeout=args.watchdog_timeout,
                snapshot_dir=args.snapshot_dir, preemption=preemption,
                membership=membership)
            for req in requests:
                ctl.submit(req)
            report = ctl.run()
        finally:
            if membership is not None:
                membership.close()
        done, shed = report.completed, report.shed
        pool = ctl.sched.pool
        logger.info("%s", report.describe())
    else:
        sched = BatchScheduler(model, params, scfg, comm=session.world)
        for req in requests:
            sched.submit(req)
        done, shed = sched.run(), sched.shed
        pool = sched.pool
    dt = time.time() - t0
    logger.info("page pool: %d-token pages, %d/%d allocated at exit, "
                "%d bytes resident (contiguous layout: %d)",
                pool.page_tokens, pool.pages_allocated, pool.pages_total,
                pool.resident_bytes(), pool.contiguous_bytes())
    total_tokens = sum(len(r.generated) for r in done)
    logger.info("served %d requests (%d shed), %d tokens in %.2fs "
                "(%.1f tok/s)", len(done), len(shed), total_tokens, dt,
                total_tokens / dt)
    for r in done[:4]:
        logger.info("req %d: %s", r.rid, r.generated)


if __name__ == "__main__":
    main()
