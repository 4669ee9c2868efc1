"""Training launcher of the port: composed data-parallel training with
in-process ranks on one device.

    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
        --arch granite-34b --reduced --sync composed --steps 8
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
        --arch granite-34b --reduced --sync composed --data 2 \\
        --model-parallel 2 --steps 8
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
        --arch qwen3-moe-30b-a3b --reduced --data 2 --model-parallel 2 \\
        --steps 8            # MoE: the experts split over "model"
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
        --arch granite-34b --reduced --sync composed --zero --overlap \\
        --ckpt-dir /tmp/ck --ckpt-sharded
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
        --arch granite-34b --reduced --data 4 --zero --elastic \\
        --fault-plan lose@3:2 --ckpt-dir /tmp/ck --ckpt-sharded --steps 8
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
        --arch granite-34b --reduced --data 4 --model-parallel 2 \\
        --ckpt-dir /tmp/ck --ckpt-sharded --elastic --fault-plan lose@5:2 \\
        --steps 8
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
        --arch mistral-large-123b --reduced --optimizer adafactor \\
        --data 2 --model-parallel 2 --steps 8   # the large archs' optimizer
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
        --arch jamba-1.5-large-398b --reduced --optimizer adafactor \\
        --data 2 --model-parallel 2 --steps 4 --seq-len 16 \\
        --global-batch 4     # Mamba, MoE and attention heads over "model"

Counterpart of ``repro.launch.train``: synthetic data -> the §2.2 scan
and composed session (``build_session``) -> ``--data`` x
``--model-parallel`` ranks (a ``("data", "model")`` mesh, the model split
over "model" by ``parallel.sharding``) running the train step through
the session's communicator, or with ``--sync auto``
the conventional stack (a monolithic session; gradients through
``comm.collectives``: on ``--data`` > 1 the state in the reference's
``auto`` layout, each rank its data block of every leaf the reference's
specs split over "data", the blocks gathered as each layer runs and
their gradients reduce-scattered; the other leaves averaged, as every
leaf is on ``--data 1``), per leaf or in fused
buckets (``--bucket-grads``), blocking or as an overlapped schedule-IR
program (``--overlap``), or as ZeRO-1 (``--zero``), with atomic async
checkpoints (``--ckpt-dir``) in the reference's global layout, which
restore onto another ``--data`` or ``--model-parallel`` width.
``--optimizer`` is ``adamw`` (the default) or ``adafactor``, as the
reference's launcher takes it; ZeRO-1 with Adafactor over
``--model-parallel`` keeps the reference's chunks (each rank a piece of
its data rank's chunk of every whole param).
``--elastic`` hands the loop to ``ElasticController``: injected faults
(``--fault-plan``), SIGTERM as a preemption notice, and with
``--ctrl-peers`` the control plane's epoch-fenced vote; it re-meshes
over "data" and "model" alike.  Runs on
``cuda`` unless ``--device cpu``; raises without CUDA.  The default
``--sync`` is ``composed`` (the reference's is ``auto``), so that
existing invocations keep their meaning.  qwen2-vl-7b and
seamless-m4t-large-v2 are refused (``missing_batch_keys``): their losses
need embeddings that the launcher's token batches do not carry.
``--production-mesh`` is refused with a pointer to the dry-run
(``launch.dryrun``), which is where the port runs the reference's
production meshes.
"""

from __future__ import annotations

import argparse
import logging
import time

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.comm import Session
from repro_torch.configs import ARCH_IDS, get_config, with_num_layers
from repro_torch.core.engine import EngineConfig
from repro_torch.core.plan import DEFAULT_BUCKET_BYTES
from repro_torch.data import SyntheticLMDataset
from repro_torch.data.pipeline import batch_dim
from repro_torch.models import build_model
from repro_torch.models.encdec import EncDecCfg
from repro_torch.optim import cosine_schedule, make_optimizer
from repro_torch.launch._elastic import (add_elastic_args,
                                         check_elastic_args,
                                         elastic_signals)
from repro_torch.runtime import substrate
from repro_torch.runtime.controller import ElasticController, FaultPlan
from repro_torch.train import trainer

logger = logging.getLogger("repro_torch.train")

PROBE_SHAPE = (4,)     # the reference probes its (data=4, model=2) mesh


def build_session(mesh, model, opt, ds, tcfg: trainer.TrainCfg,
                  config: EngineConfig | None = None,
                  batch=None) -> Session:
    """Paper §2.2 through the facade: run a probe step of the *actual*
    sync mode over ``Session.probe``'s abstract data axis, on ``meta``
    tensors, to find the collective set 𝓕; then
    ``Session.from_application`` composes the thin library and
    initializes the session for ``mesh`` with ``config``.  The sync's
    kernels need no switch: its ops take the CUDA kernels on the card and
    their plain versions on the CPU.  The probe's batch takes its keys,
    dtypes and shapes from ``ds.host_batch(0)``, or from ``batch`` (a
    batch of tensors, ``meta`` ones too) when it is given."""
    probe = Session.probe(PROBE_SHAPE, ("data",))
    # The probe steps the unsplit model: a model axis's collectives go
    # through the monolithic default session, never the composed one,
    # as the reference's GSPMD inserts its own outside the scanned jaxpr
    # (whose model-axis leaves are global), so the scan is the same.
    if model.model_parallel > 1:
        model = build_model(model.cfg)
    probe_step = trainer.make_train_step(model, opt, tcfg,
                                         comm=probe.world)
    # with ZeRO the state's chunks follow the probe's width
    abstate = trainer.abstract_state(model, opt, tcfg, mesh=probe.mesh)
    # the probe's ranks each take at least a row a microbatch (a batch
    # of fewer rows than the probe has ranks, e.g. 2 on (data 1, model
    # 2), still probes): the collective set does not depend on the rows
    m = tcfg.microbatches
    abatch = {}
    for k, v in (ds.host_batch(0) if batch is None else batch).items():
        shape, d = list(v.shape), batch_dim(k, v)
        per = -(-shape[d] // PROBE_SHAPE[0])
        shape[d] = -(-per // m) * m * PROBE_SHAPE[0]
        dtype = v.dtype if torch.is_tensor(v) else torch.from_numpy(v).dtype
        abatch[k] = torch.empty(shape, dtype=dtype, device="meta")
    return Session.from_application(
        probe_step, [abstate] * probe.mesh.size, abatch, mesh=mesh,
        probe=probe, config=config)


_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

def missing_batch_keys(cfg) -> tuple:
    """The batch keys ``cfg``'s loss needs beyond the launcher's token
    batches: an encoder-decoder's ``frame_embeds``, or the
    ``inputs_embeds`` and ``positions`` of a model without an embedding
    table (the reference's launcher builds token batches only)."""
    if isinstance(cfg, EncDecCfg):
        return ("frame_embeds",)
    if not cfg.embed_inputs:
        return ("inputs_embeds", "positions")
    return ()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list(ARCH_IDS), default="granite-34b")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--num-layers", type=int, default=None,
                    help="cut the depth (widths untouched)")
    ap.add_argument("--param-dtype", choices=list(_DTYPES), default=None)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--sync", choices=["auto", "composed", "compressed"],
                    default="composed",
                    help="auto: the monolithic stack (the reference's "
                         "layout over \"data\": params, gradients and "
                         "optimizer state split as its specs say, "
                         "through the generic path); composed: "
                         "the planned collectives; compressed: the int8 "
                         "error-feedback sync")
    ap.add_argument("--bucket-grads", action="store_true",
                    help="sync gradients in fused dtype-grouped buckets")
    ap.add_argument("--bucket-bytes", type=int,
                    default=DEFAULT_BUCKET_BYTES,
                    help="size cap per gradient bucket")
    ap.add_argument("--overlap", action="store_true", default=False,
                    help="run the sync as an overlapped schedule-IR "
                         "program (start/progress/wait; the same bits as "
                         "the blocking sync)")
    ap.add_argument("--no-overlap", dest="overlap", action="store_false",
                    help="the blocking sync")
    ap.add_argument("--overlap-depth", type=int, default=2,
                    help="collectives the interleave pass keeps in "
                         "flight (2 = software pipeline; >= 3 adds "
                         "progress hops)")
    ap.add_argument("--zero", action="store_true", default=False,
                    help="ZeRO-1: sync gradients with the reduce-scatter "
                         "half of the planned all-reduce, update each "
                         "rank's chunk of the optimizer state, all-gather "
                         "the params (needs --sync composed, excludes "
                         "--bucket-grads)")
    ap.add_argument("--ckpt-dir", default="",
                    help="checkpoint directory: restore the latest step "
                         "from it, save into it")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--ckpt-sharded", action="store_true", default=False,
                    help="write ZeRO optimizer leaves per rank chunk and "
                         "model-split leaves per model rank's block "
                         "(shard files with global indices)")
    ap.add_argument("--data", type=int, default=2,
                    help="data-parallel ranks (threads on one device)")
    ap.add_argument("--model-parallel", type=int, default=1,
                    help="tensor-parallel ranks a data rank (the mesh's "
                         "\"model\" axis; --data x --model-parallel "
                         "threads)")
    ap.add_argument("--optimizer", choices=["adamw", "adafactor"],
                    default="adamw",
                    help="adafactor: the factored second moment the "
                         "reference trains its 123B-671B archs with")
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--production-mesh", action="store_true",
                    help="the reference's (16, 16) mesh: refused here, "
                         "run it as the dry-run does")
    add_elastic_args(ap, what="training")
    args = ap.parse_args(argv)
    if args.production_mesh:
        ap.error("--production-mesh: 256 thread ranks on one card are no "
                 "deployment; the production meshes run one rank traced "
                 "on meta tensors in the dry-run: python -m "
                 "repro_torch.launch.dryrun --arch ARCH --shape train_4k "
                 "--mesh both")
    if args.zero and args.sync != "composed":
        ap.error("--zero needs --sync composed (the RS/AG seam only "
                 "exists on the composed planned-collective path)")
    if args.zero and args.bucket_grads:
        ap.error("--zero runs one RS/AG pair per parameter leaf and is "
                 "incompatible with --bucket-grads")
    if args.sync == "auto" and (args.overlap or args.bucket_grads):
        ap.error("--sync auto is the conventional per-leaf sync: "
                 "--overlap and --bucket-grads need --sync composed or "
                 "compressed")
    check_elastic_args(ap, args)
    if args.elastic and not args.ckpt_dir:
        ap.error("--elastic needs --ckpt-dir (recovery restores from the "
                 "atomic checkpoint store)")

    logging.basicConfig(level=logging.INFO)
    cfg = get_config(args.arch, reduced=args.reduced,
                     param_dtype=_DTYPES.get(args.param_dtype))
    missing = missing_batch_keys(cfg)
    if missing:
        raise SystemExit(
            f"the train launcher feeds token batches ({{tokens, labels}}); "
            f"{cfg.name} also needs {', '.join(missing)}, which the "
            "synthetic dataset does not supply here")
    if args.num_layers is not None:
        cfg = with_num_layers(cfg, args.num_layers)
    model = build_model(cfg, model_parallel=args.model_parallel)
    mesh = substrate.make_host_mesh(args.data,
                                    model_parallel=args.model_parallel,
                                    device=args.device)
    logger.info("mesh: %s  model: %s (%.2fM params)", mesh, model.name,
                model.param_count() / 1e6)
    opt = make_optimizer(
        args.optimizer, lr=cosine_schedule(
            args.lr, warmup=max(args.steps // 20, 1), total=args.steps))
    tcfg = trainer.TrainCfg(microbatches=args.microbatches,
                            sync_mode=args.sync,
                            bucket_grads=args.bucket_grads,
                            bucket_bytes=args.bucket_bytes,
                            overlap=args.overlap,
                            overlap_depth=args.overlap_depth,
                            zero=args.zero)
    ds = SyntheticLMDataset(vocab_size=cfg.vocab_size, seq_len=args.seq_len,
                            global_batch=args.global_batch, seed=args.seed)
    if args.sync == "auto":
        session = Session(mesh=mesh, mode="monolithic")
    else:
        session = build_session(mesh, model, opt, ds, tcfg)
    logger.info("%s session:\n%s", session.engine.config.mode,
                session.describe())

    sess = trainer.TrainSession(model, opt, tcfg)
    if args.elastic:
        preemption, membership = elastic_signals(args, mesh)
        try:
            ctl = ElasticController(
                sess, ds, mesh, total_steps=args.steps,
                ckpt_dir=args.ckpt_dir,
                comm=session, ckpt_every=args.ckpt_every,
                ckpt_sharded=args.ckpt_sharded,
                fault_plan=(FaultPlan.parse(args.fault_plan,
                                            seed=args.fault_seed)
                            if args.fault_plan else None),
                max_recoveries=args.max_recoveries,
                watchdog_timeout=args.watchdog_timeout, rng_seed=args.seed,
                preemption=preemption, membership=membership,
                on_step=lambda s, l: (s % args.log_every == 0 and
                                      logger.info("step %4d  loss %.4f",
                                                  s, l)))
            report = ctl.run()
        finally:
            if membership is not None:
                membership.close()
        logger.info("elastic run done:\n%s", report.describe())
        logger.info("session stats:\n%s", session.finalize())
        return

    ckpt = (CheckpointManager(args.ckpt_dir, every=args.ckpt_every,
                              sharded=args.ckpt_sharded)
            if args.ckpt_dir else None)
    restored, start = None, 0
    if ckpt is not None:
        restored, rstep = ckpt.restore_latest(sess.abstract_state(mesh),
                                              allow_resize_1d=tcfg.zero)
    if restored is not None:
        states, start = sess.scatter(restored, mesh), rstep
        logger.info("restored checkpoint at step %d", start)
    else:
        states = sess.init_state(torch.Generator(
            device=mesh.device).manual_seed(args.seed), mesh=mesh)
    step_fn = sess.step_fn(session.world)
    t0 = time.time()
    for step in range(start, args.steps):
        states, metrics = step_fn(states, ds.host_batch(step))
        if ckpt is not None and ckpt.due(step + 1):
            ckpt.maybe_save(step + 1, sess.gather(states, mesh))
        if step % args.log_every == 0 or step == args.steps - 1:
            logger.info("step %4d  loss %.4f  |g| %.3f  lr %.2e  "
                        "(%.2fs/step)", step, float(metrics["loss"]),
                        float(metrics["grad_norm"]), float(metrics["lr"]),
                        (time.time() - t0) / (step - start + 1))
    if ckpt is not None:
        ckpt.maybe_save(args.steps, sess.gather(states, mesh), force=True)
        ckpt.wait()
    logger.info("session stats:\n%s", session.finalize())


if __name__ == "__main__":
    main()
