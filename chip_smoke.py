#!/usr/bin/env python3
"""Run the PyTorch port on one CUDA card and check it end to end.

    python3 chip_smoke.py

Phases (any failure exits non-zero; the last stdout line is the result):

1. build   — compile the three CUDA kernel libraries (flash attention,
             local_reduce, quantize) from the checkout's sources
             (``nvcc``, sm_90a), all at once, and print each one's seconds.
2. kernels — flash attention against its plain PyTorch version on the
             card at the serving paths' shapes (qwen2-72b's 64 query / 8
             KV heads at D = 128, nemotron-4-340b's 96 / 8 at D = 192):
             page-sized chunks (Sq 256) against a 4096-token cache at
             q_offset 0, 256 and 3840, and a one-shot 1000-token prefill,
             with q bf16 (as served: the tensor-core variant) and f32 (the
             CUDA-core variant), each over an f32 and a bf16 cache; and
             deepseek-v3's MLA one-shot prefill (128 heads, 192-dim scores
             against 128-dim values, 1000 tokens: a bf16 q on the
             tensor-core variant, an f32 one on the CUDA cores);
             qwen2-vl-7b's 2048-position prefill (28 / 4
             heads, D 128, batch 8); and seamless-m4t-large-v2's launches
             at D 64 (16 / 16 heads, batch 8): the non-causal encoder
             over 1024 frames, the non-causal cross-attention of a
             4-token prompt and of one decode step over those frames, and
             the causal 4-token self-attention.  Prints the variant that
             ran, the max error against its tolerance (a share of the plain output's largest value:
             2**-6 for a bf16 output, 1e-4 for f32), kernel / plain / SDPA
             times (SDPA is a yardstick only; the port never calls it), the
             least time the card could take (the bound), and the host time
             of a launch of each variant.
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
             tensor-core kernel.
4b. serve_moe — qwen3-moe-30b-a3b at its published widths (d_model
             2048, 32/4 heads, head_dim 128, q/k norm, 128 experts of 768,
             top-8), depth cut to 4 of 48 layers, random bf16 weights
             from a seed, served as [serve] serves qwen2-72b (the checked
             and the timed run, the same checks); then the same requests
             back to back (``chunked_prefill=False``), whose streams
             must equal the interleaved run's, and 8 requests decoded at
             batch 8 and at batch 4, whose decode rows must be equal bit
             for bit (a block of 8 rows has expert capacity 8: nothing
             drops).  Prints tokens/s, TTFT and peak memory.
4c. serve_nemotron — nemotron-4-340b at its published widths (d_model
             18432, 96/8 heads, head_dim 192, squared-ReLU ff 73728,
             LayerNorm, vocab 256000), depth cut to 4 of 96 layers,
             random bf16 weights from a seed (23.25 B params), served as
             [serve] serves qwen2-72b: every chunk of every layer on the
             tensor-core kernel at D 192; then decode rows at batch 8 and
             4, bit for bit.
4d. serve_deepseek — deepseek-v3-671b at its published widths (d_model
             7168, MLA with 128 heads, q_lora 1536, kv_lora 512, dh_qk
             192, dh_v 128), depth cut to 4 of 61 layers (3 dense MLA
             layers, 1 MoE layer of 256 experts of 2048, top-8, sigmoid
             scoring, 1 shared expert) plus the MTP block, random bf16
             weights from a seed (26.7 B params), served as [serve]
             serves qwen2-72b.  Its chunked prefill attends in MLA's
             absorbed form (plain torch, as the reference's jnp): no flash
             launch.  Then back to back (same streams), decode rows at
             batch 8 and 4 (bit for bit), and the two checked prompts
             prefilled one-shot through ``Model.prefill``: MLA's
             materialized form, each layer's flash launch at (192, 128)
             on the tensor cores and held against plain, last logits
             within ``MLA_FORMS_TOL`` of the chunked path's (its expert
             choices replayed; the own-routing difference printed); then
             the same prompts one-shot again, unhooked, timed (wall
             seconds a prompt).
4e. serve_jamba — jamba-1.5-large-398b at its published widths (d_model
             8192, 64/8 heads at head_dim 128, Mamba2 blocks of 256
             heads x 64 with d_state 128, SwiGLU ff 24576, 16 experts
             of 24576, top-2, vocab 65536), depth cut to 4 of 72 layers
             (the stage pattern's first four: attention + dense,
             Mamba + MoE, Mamba + dense, Mamba + MoE), random bf16
             weights from a seed, [serve]'s scheduler and requests with
             each prompt rounded down to a multiple of the SSD chunk
             (256; the reference's ``ssd_chunked`` takes no other
             length).  Its Mamba layers have no chunked prefill, so
             each prompt prefills one-shot (``Model.prefill`` on a
             contiguous row the pool adopts, its conv and SSM state in
             the slot arena): the attention layer launches flash once a
             prompt, on the tensor cores, held against plain for the
             checked prompts.  Then decode rows at batch 8 and 4, bit
             for bit, and the forms check: for the two checked prompts,
             the last logits of a one-shot prefill of n tokens against
             a one-shot prefill of n - 256 tokens and 256 decode steps
             (the chunked SSD scan against the recurrent step), within
             ``SSM_FORMS_TOL`` of max|one-shot|.
4f. serve_mamba2 — mamba2-1.3b at its published widths and full depth
             (48 Mamba2 layers, d_model 2048, 64 heads x 64, d_state
             128, vocab 50280, tied embeddings), served as
             [serve_jamba]: no flash launch (attention-free), decode
             rows bit for bit, the forms check.
4g. serve_vl — qwen2-vl-7b at its published widths and full depth (28
             layers, d_model 3584, 28/4 heads at head_dim 128, QKV bias,
             M-RoPE sections (16, 24, 24), SwiGLU ff 18944, vocab
             152064, no embedding table), random bf16 weights from seed
             0, served through ``Model.prefill`` and
             ``Model.decode_step`` (the reference's scheduler feeds
             token ids only): batch 8, each row 2048 positions from
             ``frontends.vision_patch_embeds`` (512 image patches, then
             text, 3-D positions), an f32 cache, one-shot prefill, then
             64 decode steps each fed the stub's next embedding at the
             next text position (3, B, 1).  A checked prefill first holds
             every flash launch against plain (rows 0 and 1); the timed
             run counts 28 flash launches, all on the tensor cores; the
             prefill's and every step's logits must be within
             ``EMBEDS_FORMS_TOL`` of a teacher-forced forward over all
             2112 positions; rows 0-3 decoded from the batch-8 prefill in
             a block padded to 8 rows must give the batch-8 run's logits
             bit for bit.  Prints prefill s, decode ms a step, rows x
             steps / s and peak memory.
4h. serve_seamless — seamless-m4t-large-v2 at its published widths and
             full depth (24 encoder + 24 decoder layers, d_model 1024,
             16/16 heads at head_dim 64, GELU ff 8192, LayerNorm, vocab
             256206), random bf16 weights from seed 0, through
             ``Model.prefill`` and ``Model.decode_step``: batch 8, each
             row 1024 frames from ``frontends.audio_frame_embeds`` and a
             4-token prompt, an f32 cache, one prefill and 128 greedy
             decode steps.  Flash runs at D 64 on the tensor cores: the
             encoder non-causal over the frames, the decoder's
             self-attention causal, its cross-attention non-causal over
             the frames (Sq 4 at prefill, 1 a decode step).  A checked
             prefill and decode step hold every launch against plain; the
             timed run counts 24 + 24 + 24 launches a prefill and 24 a
             step, all on the tensor cores; the prefill's and every
             step's logits must be within ``EMBEDS_FORMS_TOL`` of the
             teacher-forced logits over prompt + generated tokens; rows
             0-3 decoded from the batch-8 prefill in a padded block give
             the batch-8 logits bit for bit.  Prints encode ms, TTFT,
             decode ms a step, tokens/s, peak memory and what a step
             spends recomputing the memory's cross K and V.  Each serve
             phase frees its weights before the next.
4i. serve_tp — serving over "data" and "model" as the reference's dry-run
             cells place it (``Model.rank_params``, ``Model.init_caches``
             inside each thread rank, ``sharding.cache_split``): bf16
             weights, an f32 cache, ``Model.prefill`` and then 8
             teacher-forced ``Model.decode_step``s at batch 8, each split
             run held at every step to the same cut run unsplit on the
             card within 2**-6 of max |unsplit logits| (the ranks' row and
             vocabulary blocks joined; each rank's ``Model.argmax`` equal
             to its rows' argmax of the joined logits):
             granite-34b (2 of 88 layers) on (data 1, model 2), its one
             K/V head's cache of 4096 positions split by sequence over
             "model", the 2046-token prompt's decode steps crossing the
             block boundary at 2048 (the partial softmaxes combined);
             qwen2-72b (4 of 80 layers) on (2, 2), heads over "model",
             rows and weight blocks over "data"; mamba2-1.3b at full
             depth on (1, 2), its conv and ssm state over "model", in f32
             weights (``SERVE_TP_RUNS``: at bf16 its logits move by more
             than the gate under any reordering of its sums).  Every
             prefill's flash launch runs on the tensor cores; prints the
             flash and ``sum_chunks`` launches, each run's prefill and
             decode ms and peak GiB.
5. collectives — the gradient-sync kernels (``sum_chunks``, ``quantize``,
             ``dequantize``, ``dequant_add``) against their plain versions,
             bit for bit, at the sizes granite-34b's sync gives them: the
             ``lm_head`` gradient's bidirectional-ring combine chunk at
             two ranks (n/4 of 6144 x 49152) and compressed-ring chunk
             (n/2), a 6144-value norm and a ragged length.  Prints kernel,
             plain and one-PyTorch-call times and the bound; the kernel and
             its PyTorch call are timed in turns (kernel, call, kernel,
             call) and each keeps its faster turn.
5b. collectives_lib — the whole collective library on CUDA thread
             ranks: every function (all_reduce, reduce_scatter,
             all_gather, all_to_all, broadcast, permute, send_recv) on
             every protocol of its cost-model menu that takes p, through a
             composed session with the protocol forced, and on the generic
             path through a monolithic one; p in {2, 4} at a full-width
             granite-34b MLP leaf (6144 x 24576 bf16, 302 MB a rank), p in
             {3, 8} at 6144 x 3072.  Data movement must equal its plain
             rearrangement on the card and reductions the same schedule
             rerun with the plain combine (``plain_sync_ops``), bit for
             bit; each rank's recorded phase bytes must equal
             ``plan.phase_wire_bytes``; ``sum_chunks`` launches must equal
             the schedule's count.  Then the multi-axis all-reduce:
             two-phase on (data 2, model 2) at the MLP leaf and on (4, 2)
             at 6144 x 3072, hierarchical on (pod 2, data 2) at the MLP
             leaf and on (pod 3, data 2) at 6144 x 3072; blocking,
             start/wait and a persistent handle must give the same bits,
             the plain-combine rerun's, the phase bytes the communicator's
             ``sync_schedule`` predicts, and the schedule's ``sum_chunks``
             count.  Prints each call's time and the wire bytes a rank,
             as the transport measured them.
6. train_small — the reduced granite-34b (f32) trained over 2 thread
             ranks for 3 steps, composed and compressed, through the sync
             kernels on the card and through the plain path on the CPU,
             from the same weights: the losses agree within tolerance.
             Seq 64 runs the training attention over 4 key blocks
             (block_k 16), forward and recompute backward.
7. train   — granite-34b at its published widths, depth cut to 2 of 88
             layers, random bf16 weights from a seed: data-parallel
             training over 2 thread ranks on the card (seq 2048, global
             batch 4), through ``launch.train.build_session`` and
             ``trainer.make_train_step``, 3 steps in each of four runs:
             {composed, compressed} x {sync kernels, plain}.  The
             package has no switch between the two: the sync's ops take
             the kernels for CUDA tensors, and for the plain runs this
             script alone points the ops at their plain versions
             (``plain_sync_ops``).  Checks bit-identical losses and
             parameters between the kernel and plain runs, identical
             replicas, finite losses, and each kernel's launch count
             against the count the plan predicts.  A fifth run, composed
             at lr 1e-5, must lower the loss: at lr 1e-3 the first AdamW
             step moves every weight of these 6144-wide layers by about
             1e-3, and the loss rises.  Every training phase runs with
             the config's default remat (each block's activations
             recomputed in the backward, as the reference's
             ``jax.checkpoint``); one more composed run with
             ``remat=False`` prints its step time and peak beside the
             remat run's and must give its losses and parameters bit for
             bit.
8. train (sync) — the same workload's sync three more ways, 3 steps a
             run, each run against the one it must equal bit for bit
             (losses and parameters): composed in fused dtype buckets,
             overlapped through the schedule IR (depth 2) against
             blocking; compressed in buckets, overlapped against
             blocking, its EF residual in bucket layout; ZeRO-1
             (composed, overlapped) against the per-leaf composed run,
             both at clip_norm 0 (p = 2 is a power of two), ZeRO's
             optimizer state a rank exactly half the unsharded state
             plus padding.  Each run prints its step time, tokens/s and
             peak memory, and each sync kernel's launches must equal the
             plan's count.
8b. train_auto — the same workload as ``sync="auto"``, the conventional
             stack, in the reference's layout over "data": each rank its
             data block of every leaf the reference's specs split over
             "data" (params, gradient accumulator, AdamW moments), the
             blocks all-gathered as each layer runs and their gradients
             reduce-scattered in the staged backward, the other leaves
             and the loss averaged by ``collectives.pmean``, all through
             the monolithic default session; 3 steps from [train]'s
             weights and batches.  Checks finite losses within 1e-4
             relative of [train]'s composed run (the tolerance the port
             holds composed training to the reference), the ranks'
             blocks joined into a finite global tree, each rank's state
             bytes as ``trainer.abstract_state`` plans them (half the
             whole layout's), the default session's average layer number
             2.0 and ``sum_chunks`` launches as ``split_collectives``
             counts the ring's combines.  Prints step time and peak
             memory beside [train]'s composed run's.
8c. train_tp — the train workload (granite-34b, 2 of 88 layers, [train]'s
             weights and batches) on a (data 2, model 2) mesh: each rank
             holds its shard (whole heads; granite-34b's one KV head
             replicated), its backward staged so that the model-axis
             all-reduces run on the rank threads.  {composed, compressed}
             x {sync kernels, plain}, 3 steps each: finite losses,
             identical data replicas and model-replicated leaves, the
             kernel and plain runs bit-identical, launches as planned
             (the data sync's plus p-1 a model-axis all-reduce), and the
             composed losses and gradient norms within ``TP_LOSS_RTOL``
             and ``TP_NORM_RTOL`` of [train]'s.  Each block is
             checkpointed over "model" (remat on, its rerun on the rank's
             thread, its *g*s counted in the plan); one more composed
             kernel run with ``remat=False`` must give the same losses
             and every model rank's parameters bit for bit.
             Prints step time, tokens/s and peak memory.
8d. train_pod — granite-34b at its widths cut to 1 layer (4 full
             replicas of 2 layers do not fit in 80 GB) on (pod 2, data 2),
             composed: every sync unit is the hierarchical all-reduce,
             replicas identical, ``sum_chunks`` launches as the schedule
             counts them, losses and gradient norms within
             ``POD_LOSS_RTOL`` and ``POD_NORM_RTOL`` of a flat data=4 run
             from the same weights.  Prints step time and
             peak memory of both.
8e. train_moe — qwen3-moe-30b-a3b at its published widths cut to 2 of
             48 layers, random bf16 weights from a seed, [train]'s data
             settings: data-parallel over 2 thread ranks, composed, with
             the sync kernels and plain (bit-identical), and at lr 1e-5
             (the last loss below the first); then on a (data 2, model
             2) mesh with the experts split over "model" and
             ``check_model_replicas`` on (the router's gradient bit-equal
             across "model"): losses and gradient norms within
             ``TP_LOSS_RTOL`` and ``TP_NORM_RTOL`` of the data-parallel
             run.  Every run: finite losses, identical replicas,
             ``sum_chunks`` launches as planned (17 model-axis
             all-reduces a rank a step with the model axis).  Prints
             step time, tokens/s and peak memory.
8f. train_adafactor — mistral-large-123b at its published widths cut to
             2 of 88 layers, random bf16 weights from a seed, [train]'s
             data, Adafactor: data-parallel composed with the sync
             kernels and plain (bit-identical) and at lr 1e-5 (the loss
             falls); ZeRO-1 (each rank's flat chunks unfactored); ZeRO-1
             on (data 2, model 2) with ``check_model_replicas`` (each
             rank a piece of its data rank's chunk of every whole param,
             the reference's chunk), losses and gradient norms within
             ``TP_LOSS_RTOL`` / ``TP_NORM_RTOL`` of ZeRO-1 on data 2,
             Adafactor's model-axis sums counted in the plan, each rank's
             optimizer-state bytes printed; compressed at 1 layer (2
             reckon over the card).
8f'. train_fsdp_tp — the same mistral-large-123b cut as ``auto`` on
             (data 2, model 2) in the reference's layout (each rank its
             data block of its model block), ``check_model_replicas`` on,
             at lr 1e-5 against [train_adafactor]'s data-parallel run at
             lr 1e-5 (losses within 1e-4, gradient norms within
             ``TP_NORM_RTOL``; ZeRO-1's Adafactor is unfactored, other
             arithmetic); its blocks joined finite, each rank's state
             bytes as planned, its peak printed beside ZeRO-1's on
             (2, 2).
8g. train_deepseek — deepseek-v3-671b at its published widths cut to
             its 2 first (dense MLA) layers and the MTP block, Adafactor,
             bf16 gradient accumulation over 2 microbatches: kernels and
             plain (bit-identical), lr 1e-5; the MTP metric finite.
8h. train_mamba2 — mamba2-1.3b at its published widths and full depth
             (48 layers; remat keeps one layer's SSD temporaries at a
             time), AdamW: kernels and plain (bit-identical), lr 1e-5;
             and one kernel run cut to ``MAMBA2_REMAT_CUT`` layers, whose
             peak is printed beside the one it took without remat.
8i. train_vl — qwen2-vl-7b at its published widths cut to 2 of 28
             layers, AdamW over 2 microbatches: ``SyntheticLMDataset``'s
             embeddings batches (``inputs_embeds`` 3584 wide, the text
             positions' taken from a fixed table by token, see
             ``_VLBatches``) with M-RoPE positions that differ per row
             (the vision positions, each row's text moved on by its own
             offset), so that the trainer's split of (3, B, S)
             positions at dim 1, over the ranks and the microbatches,
             runs on the card: kernels and plain (bit-identical), lr
             1e-5.
8j. train_seamless — seamless-m4t-large-v2 at its published widths cut
             to 12 + 12 of its 24 + 24 layers, AdamW, 1 microbatch: 2048
             frames x 1024 f32 a row from numpy seeded by (seed, step)
             (``_FrameBatches``) beside the dataset's tokens and labels;
             kernels and plain (bit-identical), lr 1e-5; then on (data 2,
             model 2), each layer checkpointed over "model", its peak
             printed.
8k. train_jamba — jamba-1.5-large-398b's first 2 of 72 layers, Adafactor,
             bf16 gradients, 4 rows a step: (data 1, model 1), then (data
             1, model 2) with the sync kernels and plain (bit-identical),
             the block checkpointed over "model", within
             ``TP_LOSS_RTOL`` / ``TP_NORM_RTOL`` of (1, 1), each run's
             peak printed and held below 95% of the card.  Every
             large-arch run: finite losses, identical replicas, every
             sync kernel's launches as planned, peak below 95% of the
             card; each phase prints the card, step time, tokens/s and
             peak memory.
8l. dryrun — the launch layer's dry-run (``launch.dryrun``: one rank's
             step traced on ``meta`` tensors under the recording
             transport) of [train]'s configuration, of [train_tp]'s
             (data 2, model 2) one and of [train_auto]'s step split over
             "data", each held against one real step on the
             card whose rank 0 is counted inside its thread
             (``launch.stepanalysis.measure_rank``): flops and rank 0's
             wire bytes must be equal.  For those three and [train_jamba]'s
             (data 1, model 2) run it prints the traced peak a rank times
             the ranks on the card beside the peak that phase measured
             and the analytic model's figure (readings, not gates), the
             card's total memory (``dryrun.HBM_PER_CHIP``), and its own
             seconds and the script's so far.  Then one decode step of
             [serve_tp]'s granite-34b run (``dryrun.serve_cell``, its
             cache's sequence over "model"): traced flops and rank 0's
             wire bytes must equal the real step's, and its traced peak
             (params / caches / rest) is printed beside rank 0's.
9. ckpt    — the reduced granite-34b as ZeRO-1 over 4 thread ranks for 2
             steps, an async sharded save of its CUDA tensors, a restore
             onto 2 ranks (``allow_resize_1d``) whose gathered logical
             state equals the saved one bit for bit, one more step with a
             finite loss, and no ``.tmp`` directory left; then the same
             from (data 2, model 2) onto (1, 2), the checkpoint in the
             reference's global layout (the model ranks' blocks and the
             data ranks' chunks as shard files).
10. elastic_train — the train workload (granite-34b, 2 of 88 layers) as
             ZeRO-1 over 4 thread ranks, 1 row a rank, under
             ``ElasticController`` with async sharded checkpoints every 2
             steps (``keep=1``) in a temporary directory under ``build/``
             and ``lose@3:2``: the step-2 checkpoint restores onto the 2
             survivors and the run goes on to step 5.  A fresh 2-rank run
             from the same checkpoint (the host tree the recovery read
             from it, kept by this script before ``keep=1`` collects the
             files) trains steps 2-4 and must give the same losses and
             gathered logical state bit for bit.  The 4-rank steps run
             again from the same seed with the combine patched to its
             plain version (``ref.sum_chunks``, as in [train]) and must
             give the same losses, and at step 2 the same state as the
             checkpoint, bit for bit: the p = 4 combines (chunks of an
             eighth of a leaf) held against their plain version.  The
             plan is rebuilt once; ``sum_chunks`` launches equal the
             plan's count at p = 4 and at p = 2.  Prints the recovery's
             seconds, each step's time before and after (flagged where a
             save was being written meanwhile), peak memory, and each
             full-width save's bytes, its wait for the previous save, its
             call time and its time until durable.
10b. elastic_tp — the train workload (granite-34b, 2 of 88 layers) as
             ZeRO-1 on (data 2, model 2) thread ranks under
             ``ElasticController`` with ``lose@3:2``, which plans (1,
             2), async sharded checkpoints every 2 steps (``keep=1``) in
             the reference's global layout, in a temporary directory
             under ``build/``: the step-2 checkpoint restores onto the
             2 survivors and the run goes on to step 5.  A fresh (1, 2)
             run from the same checkpoint trains steps 2-4 and must give
             the same losses bit for bit; the tree the recovery restored
             must equal the saved one leaf for leaf (this script keeps
             the last save's logical state on the host until then);
             ``check_model_replicas`` holds the model-replicated
             gradients bit-equal across "model" every step; the plan is
             rebuilt once and ``sum_chunks`` launches equal the plan's
             count on each mesh (the data sync's plus the model-axis
             all-reduces).  Prints the recovery's seconds, each step's
             time before and after, peak memory and each save's bytes
             and times.
11. elastic_serve — the serve workload over a serving session of 4 data
             thread ranks (batch 8) under ``ServeController`` with
             ``lose@8:2``: the batch shrinks to 4, the drained slots
             re-splice, and all 16 requests complete.  First, one decode
             step of 8 requests is called on the model directly (no row
             blocks) at batch 8 and at batch 4 with every GEMM and batched
             product recorded, and the ones whose rows differ are printed
             (which op makes a row depend on the batch).  Then 8 requests
             decode 16 tokens at batch 8 and at batch 4 through the
             scheduler, whose decode runs blocks of ``DECODE_ROWS`` rows:
             if their logits
             are equal bit for bit, the streams must equal an
             uninterrupted run on the survivors (data 2, batch 4) bit for
             bit; if not, the reduced f32 model's elastic streams must
             equal its survivor run's on the card, and each full-width
             stream must agree up to the first position where the
             survivor run's top-2 logit gap is at most twice the largest
             logit difference measured between the two batch sizes, and
             at least half of all tokens must be held so (each stream's
             held length is printed).
             Checks pool integrity after the recovery, the mesh history,
             that every prefill chunk took the tensor-core kernel and
             that the flash launches equal 4 layers x (the prompts'
             chunks + the chunks of requests that were mid-prefill at the
             drain, which prefill again as in the reference): no
             request that was decoding is prefilled again.  Prints the
             recovery's seconds, snapshot bytes paged against
             contiguous, and tokens/s before and after.

Exits non-zero without a result when CUDA is unavailable.
"""

from __future__ import annotations

import contextlib
import functools
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))

# Kernel vs plain, as a share of the plain output's largest magnitude.
# The plain version computes in f32 and rounds once to q's dtype.  A bf16
# query runs the tensor-core kernel, which also rounds K, V (an f32 cache)
# and P to bf16 before its products: 2**-9 of each value at most, errors
# that average over the keys of a row, plus the output's own rounding
# (2**-9 of it).  The same arithmetic written out in plain torch holds
# 2**-6 at GQA 8/1 and 64/8, offsets 0 to late and ragged lengths
# (tests/test_torch_flash_attention_tc.py).  An f32 query runs the
# CUDA-core kernel in f32 throughout: it
# differs only by summation order (~1e-6), and 1e-4 still fails a dropped
# 64-key tile, a mis-masked edge or P rounded to bf16 (~1e-3).
REL_TOL = {torch.bfloat16: 2.0 ** -6, torch.float32: 1e-4}
SMALL_LOGIT_TOL = 1e-3  # f32 reduced model, card vs CPU summation order
HBM_BYTES_PER_S = 3.35e12                      # H100 SXM data sheet
SLEEP_CYCLES_PER_S = 1.98e9        # H100 SXM top SM clock: sleeps no less
PEAK_OPS = {"bf16": 989e12, "f32": 67e12}      # dense; f32 = CUDA cores
TRAIN_LAYERS = 2
TRAIN_RANKS = 2
TRAIN_SEQ = 2048
TRAIN_BATCH = 4                         # global: 2 rows a rank
TRAIN_STEPS = 3
TRAIN_LR = 1e-3
LOW_LR = 1e-5                           # the run whose loss must fall
SMALL_TRAIN_SEQ = 64                    # 4 key blocks of the reduced 16
SMALL_LOSS_RTOL = {"composed": 1e-4, "compressed": 1e-3}
LM_HEAD = 6144 * 49152                  # granite-34b's largest gradient
SYNC_SIZES = (("combine chunk", LM_HEAD // 4), ("compressed chunk",
                                                 LM_HEAD // 2),
              ("norm", 6144), ("ragged", 1_000_003))
SYNC_KERNELS = ("sum_chunks", "quantize", "dequantize", "dequant_add")
F32_OPS_PER_VALUE = {"sum_chunks": 2, "quantize": 6, "dequantize": 1,
                     "dequant_add": 2}  # k adds; |x|, max, div, rint, 2 clamps
SERVE_LAYERS = 4
SERVE_REQUESTS = 16
SERVE_MAX_NEW = 32
#: [serve_tp]: (arch, layers (None: all), (data, model), cache
#: positions, prompt, weights' dtype); batch SERVE_TP_BATCH,
#: SERVE_TP_STEPS decode steps.  mamba2-1.3b runs in f32: at bf16 its 48
#: layers' logits move by more than SERVE_TP_TOL under any other order
#: of their sums (split against unsplit 6.2e-2 of max; [serve_mamba2]'s
#: one-shot against decoded forms 3.8e-2 to 4.7e-2), so only f32 weights
#: hold its split to its twin within the gate; it launches no flash.
SERVE_TP_RUNS = (("granite-34b", 2, (1, 2), 4096, 2046, torch.bfloat16),
                 ("qwen2-72b", 4, (2, 2), 4096, 2046, torch.bfloat16),
                 ("mamba2-1.3b", None, (1, 2), 4096, 2048, torch.float32))
SERVE_TP_BATCH = 8
SERVE_TP_STEPS = 8
SERVE_TP_TOL = 2.0 ** -6                 # of max |unsplit logits|
ELASTIC_TRAIN_RANKS = 4                 # 1 row a rank of the global 4
ELASTIC_TRAIN_STEPS = 5
ELASTIC_TRAIN_FAULTS = "lose@3:2"
ELASTIC_TP_SHAPE = (2, 2)               # (data, model): 2 rows a data rank
ELASTIC_TP_FAULTS = "lose@3:2"          # plans (1, 2)
ELASTIC_SERVE_RANKS = 4
ELASTIC_SERVE_FAULTS = "lose@8:2"
ROWS_PROMPTS = 8       # requests decoded at batch 8 and at batch 4
ROWS_MAX_NEW = 16
MIN_HELD_SHARE = 0.5   # of the full-width elastic tokens, equal to the
                       # survivor run's where the streams can be held
CHECK_RIDS = (0, 1)    # requests whose every chunk is held against plain
LIB_FULL = (6144, 24576)   # a full-width granite-34b MLP leaf: 302 MB bf16
LIB_SMALL = (6144, 3072)
LIB_RANKS = ((2, LIB_FULL), (4, LIB_FULL), (3, LIB_SMALL), (8, LIB_SMALL))
LIB_FUNCTIONS = ("all_reduce", "reduce_scatter", "all_gather", "all_to_all",
                 "broadcast", "permute", "send_recv")
AUTO_LOSS_RTOL = 1e-4  # LOSS_RTOL["composed"], tests/test_torch_train.py
# multi-axis all-reduce: (axes, mesh shape, per-rank payload)
LIB_MULTI = ((("data", "model"), (2, 2), LIB_FULL),
             (("data", "model"), (4, 2), LIB_SMALL),
             (("pod", "data"), (2, 2), LIB_FULL),
             (("pod", "data"), (3, 2), LIB_SMALL))
TP_MODEL = 2                # [train_tp]: (data TRAIN_RANKS, model TP_MODEL)
# [train_tp] against [train]'s composed run (no model axis).  In bf16
# the row-parallel products are summed over "model" after rounding each
# partial, so the runs differ by bf16 roundings of the activations.  The
# limits are about ten times this phase's own largest reading on the
# H100 (PERF.md, PR 17): losses 7.9e-6, 1.7e-4, 5.8e-6 relative, the
# global gradient norms 4.3e-5, 4.9e-4, 8.8e-6.  The norm engages the
# clip, so it is held too: with the model ranks' squares counted twice
# it moves by about 40%, while the losses stay within 1.1e-3.
TP_LOSS_RTOL = 2e-3
TP_NORM_RTOL = 5e-3
POD_LAYERS = 1              # 4 full replicas of 2 layers exceed 80 GB
# [train_pod] against a flat data=4 run: the same gradients summed in
# another order (bidir ring over 2 then recursive doubling over 2 pods,
# against one bidir ring over 4), each sum rounded to bf16.  Readings
# (PERF.md, PR 17): losses 0, 1.7e-5, 2.3e-4 relative; gradient norms
# 1.2e-5, 6.6e-5, 1.8e-3 (the third step's, after two updates apart).
POD_LOSS_RTOL = 2e-3
POD_NORM_RTOL = 2e-2
MOE_ARCH = "qwen3-moe-30b-a3b"   # [serve_moe], [train_moe]
ADAFACTOR_ARCH = "mistral-large-123b"   # [train_adafactor]
# [train_adafactor]'s compressed run is cut to 1 layer: at 2 the two
# replicas' f32 error-feedback residuals (28.6 GB) and the int8 ring's
# f32 temporaries of a 704 M-value leaf (~25 GB for two ranks) on top of
# the composed run's ~36 GB reckon ~89 GB, over the card (PERF.md §4)
ADAFACTOR_COMPRESSED_LAYERS = 1
MAMBA2_ARCH = "mamba2-1.3b"             # [train_mamba2], at full depth
# [train_mamba2] also trains this many layers once, to print its peak
# with remat beside the 64.97 GiB that 12 layers took without (PERF.md)
MAMBA2_REMAT_CUT = 12
# [train_vl]: 2 of qwen2-vl's 28 layers (4 before every model-axis block
# was rematerialized: the (2, 2) twins' reruns lengthened the script, and
# this cut pays for part of it; PERF.md)
VL_TRAIN_LAYERS = 2
VL_TRAIN_MICRO = 2                      # the reference's microbatches
# [train_seamless]: 12 + 12 of the 24 + 24 layers, for time: with the
# data-parallel runs at full depth beside the (2, 2) run the phase took
# 108 s and the whole script 1089 s on an H100 (PERF.md).  Its (data 2,
# model 2) run checkpoints each layer over "model" on the staged tape,
# as the data-parallel runs do through ``torch.utils.checkpoint``.
SEAMLESS_TRAIN_LAYERS = 12
# [train_jamba]: the first 2 of jamba's 72 layers, attn+dense and
# mamba+moe: the one cut with a Mamba and a MoE layer that one replica
# and its gradients fit (~11.9 B params, 47.6 GB bf16 with gradients)
JAMBA_TRAIN_LAYERS = 2
# one microbatch where the reference takes 8: with 2 the accumulation
# (``trainer._accumulate_grads``) holds the running sum, a microbatch's
# gradients and their sum beside the params, ~95 GB
JAMBA_TRAIN_MICRO = 1
# [train]'s 4 rows a step.  The cut is one block (both layers, the
# reference's unit), checkpointed over "model" on the staged tape: the
# forward keeps little (28 GiB after it), but the block's backward
# rebuilds all of its activations beside the experts' gradients, and the
# (data 1, model 2) run peaks there at 71.09 GiB on an H100, which fits
# only with expandable allocator segments (``_expandable_segments``;
# PERF.md)
JAMBA_TRAIN_BATCH = 4
NEMOTRON_ARCH = "nemotron-4-340b"   # [serve_nemotron]
DEEPSEEK_ARCH = "deepseek-v3-671b"  # [serve_deepseek]
# [serve_deepseek]'s one-shot prefill (MLA's materialized form, bf16 K/V
# through the flash kernel) against its chunked prefill (the absorbed
# form in f32) on the same weights: last-position logits within this
# share of the chunked logits' largest magnitude.  The two forms round
# at different places (K and V rounded to bf16 once per head, against
# f32 products of the bf16 latents; on the tensor cores P too): about
# 2**-9 of each attention output per layer, carried through 4 layers and
# the unembedding.  Both run with expert capacity factor CHECK_CAPACITY,
# so no token drops in either (the reference's twin test equalizes
# capacity the same way): at the served 1.25 a 256-token chunk and a
# 2988-token prompt drop different tokens, which is not a difference of
# the two forms.  For the same reason the one-shot replays the chunked
# path's expert choices: about one token in nine has a top-8 choice
# among 256 sigmoid scores whose 8th and 9th lie within the forms'
# rounding, and where that is the last token its logits move by several
# percent (on an H100, 7.1e-2 of max for one checked prompt through the
# tensor-core kernel and through its arithmetic in plain torch, 1.2e-2
# with the choices replayed; PERF.md §6).  The own-routing numbers
# are printed beside it.
MLA_FORMS_TOL = 2.0 ** -4
CHECK_CAPACITY = 8.0
JAMBA_ARCH = "jamba-1.5-large-398b"  # [serve_jamba], [train_jamba]
MAMBA2_ARCH = "mamba2-1.3b"         # [serve_mamba2], at full depth
# [serve_jamba] / [serve_mamba2]: the last logits of a one-shot prefill
# of n tokens against a prefill of n - SSM_FORMS_DECODE tokens followed by
# SSM_FORMS_DECODE decode steps, within this share of the one-shot
# logits' largest magnitude (``MLA_FORMS_TOL``'s).  The chunked SSD scan
# sums the recurrence in another order than the step-by-step state
# update, and the decode path carries the conv tail and state through
# the f32 cache, while the one-shot path's bf16 activations round at
# other places.  MoE layers run at capacity factor CHECK_CAPACITY so no
# token drops in either, and the decoded form replays the one-shot's
# expert choices: at bf16, 4-19 of 256 decoded tokens of a jamba MoE
# layer choose other experts than the one-shot did (a top-2 choice
# whose 2nd and 3rd scores lie within the forms' rounding), and each
# such token moves every later state of the Mamba layers after it (11%
# of the last logits for one prompt): a property of top-2 routing near
# ties, not of the two SSD forms.
SSM_FORMS_TOL = 2.0 ** -4
SSM_FORMS_DECODE = 256
VL_ARCH = "qwen2-vl-7b"                 # [serve_vl], at full depth
SEAMLESS_ARCH = "seamless-m4t-large-v2"  # [serve_seamless], at full depth
EMBEDS_BATCH = 8
VL_DECODE = 64
SEAMLESS_DECODE = 128
# [serve_vl] / [serve_seamless]: the prefill's last logits and every
# decode step's against a teacher-forced forward over all positions,
# within this share of the forward's largest logit (``MLA_FORMS_TOL``'s).
# The forward attends through the flash kernel (P rounded to bf16, about
# 2**-9 of each attention output), a decode step in f32 over the f32
# cache; and seamless's prefill projects its cross K/V from the f32
# memory it stores, the forward from the bf16 one.  Each such rounding
# enters a bf16 residual stream and is carried through 28 (48) layers
# and the unembedding.
EMBEDS_FORMS_TOL = 2.0 ** -4


def _ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device milliseconds of ``fn`` over ``iters`` back-to-back
    calls (CUDA events; the inputs stay hot in L2 between calls).  The
    calls are queued behind a device-side sleep that outlasts their
    enqueue, so a kernel shorter than its host launch time is timed on
    the device, not at the host's launch rate."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    one = time.perf_counter() - t0            # host + device, one call
    torch.cuda._sleep(int(min(1.5 * iters * one, 0.5) * SLEEP_CYCLES_PER_S))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _bound(q, k, v, q_offset: int, causal: bool = True):
    """Least time (ms) the card could take for attention of ``q`` over
    ``k``/``v``, causal or not: bytes (q, the visible K/V prefix (all of
    K/V when not causal), the output, each once) over HBM bandwidth
    against FLOPs over a peak.  A bf16 output
    can be computed with bf16 products on the tensor cores whatever the
    cache type (989 TFLOP/s); an f32 output, held to 1e-4, needs f32
    products on the CUDA cores (67 TFLOP/s).  Returns (ms, "bytes" |
    "operations", peak name)."""
    b, sq, h, d = q.shape
    skv, hkv, dv = k.shape[1], k.shape[2], v.shape[-1]
    prefix = min(skv, q_offset + sq) if causal else skv
    nbytes = ((q.numel() + b * sq * h * dv) * q.element_size()
              + b * prefix * hkv * (d + dv) * k.element_size())
    # query i sees min(skv, q_offset + i + 1) keys (all skv when not
    # causal); 2*(D + Dv) FLOPs each
    seen = (sum(min(skv, q_offset + i + 1) for i in range(sq)) if causal
            else sq * skv)
    flops = 2 * b * h * (d + dv) * seen
    kind = "bf16" if q.dtype == torch.bfloat16 else "f32"
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


def phase_build(libraries):
    """Build every kernel library at once (one nvcc each, in threads)."""
    from concurrent.futures import ThreadPoolExecutor
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(libraries)) as pool:
        built = list(pool.map(lambda lib: lib.load(), libraries))
    faults = []
    for lib, b in zip(libraries, built):
        print(f"[build] {lib.name}: nvcc {b.seconds:.1f}s -> "
              f"{os.path.relpath(b.path, HERE)}")
        for fn, regs, spills in _ptxas_usage(b.log):
            print(f"[build]   {fn}: {regs} registers; {spills}")
        # ptxas's notes, e.g. C7512-C7514: a kernel's wgmmas serialized
        for line in b.log.splitlines():
            if "warning" in line.lower() or "Performance Loss" in line:
                print(f"[build]   {line.strip()}")
        faults += _wgmma_faults(b.log)
    print(f"[build] all libraries in {time.perf_counter() - t0:.1f}s")
    if faults:
        raise AssertionError("the tensor-core flash kernel spills or has "
                             "its wgmmas serialized: " + "; ".join(faults))


def _wgmma_faults(log: str):
    """What ptxas says against a ``flash_wgmma_kernel`` instantiation:
    spill stores or loads, a stack frame (an array indexed at run time
    sits in local memory), or a note that its wgmmas were serialized
    (C7512-C7515: for lack of registers, or accumulators touched while a
    wgmma group may be open).  The tensor-core kernel is designed to
    have neither (PERF.md)."""
    import re
    faults = [f"{fn}: {spills}" for fn, _, spills in _ptxas_usage(log)
              if "flash_wgmma_kernel" in fn
              and re.search(r"[1-9]\d* bytes (spill|stack)", spills)]
    faults += [line.strip() for line in log.splitlines()
               if re.search(r"C751\d", line) and "flash_wgmma_kernel" in line]
    return faults


def _ptxas_usage(log: str):
    """(kernel, registers, spill line) for each kernel in an ``nvcc
    -Xptxas -v`` log, names demangled where ``c++filt`` exists."""
    import re
    out, fn, spills = [], "?", ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            fn = m.group(1)
        elif "spill" in line:
            spills = line.strip()
        else:
            m = re.search(r"Used (\d+) registers", line)
            if m:
                out.append([fn, int(m.group(1)), spills])
    try:
        names = subprocess.run(["c++filt"], input="\n".join(
            r[0] for r in out), capture_output=True, text=True,
            timeout=60).stdout.splitlines()
        if len(names) == len(out):
            for r, name in zip(out, names):
                r[0] = name.replace("(anonymous namespace)::", "").split(
                    "(")[0].removeprefix("void ")
    except (OSError, subprocess.SubprocessError):
        pass
    return out


def _host_us(fn, n: int = 200) -> float:
    """Host microseconds a call of ``fn``, the device kept idle enough
    that the enqueue, not the device, sets the pace."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / n * 1e6


#: (family, H, Hkv, D, Dv, cases) of [kernels], a case (name, batch, Sq,
#: Skv, q_offset, causal): the served head layouts at page-sized chunks
#: over a 4096-token cache and a 1000-token one-shot, MLA's materialized
#: one-shot prefill (one KV head a query head), and the two embeddings
#: families' launches as [serve_vl] and [serve_seamless] make them at
#: batch 8: qwen2-vl-7b's 2048-position prefill, and seamless's
#: non-causal encoder over 1024 frames, its non-causal cross-attention
#: of the 4-token prompt and of a decode step over those frames, and its
#: causal decoder self-attention over the prompt
KERNEL_CHUNKS = [("chunk", 1, 256, 4096, off, True) for off in (0, 256, 3840)]
KERNEL_ONE_SHOT = [("one-shot", 1, 1000, 1000, 0, True)]
SEAMLESS_FRAMES = 1024
SEAMLESS_PROMPT = 4
VL_PROMPT = 2048
KERNEL_HEADS = [("qwen2-72b", 64, 8, 128, 128,
                 KERNEL_CHUNKS + KERNEL_ONE_SHOT),
                ("nemotron-4-340b", 96, 8, 192, 192,
                 KERNEL_CHUNKS + KERNEL_ONE_SHOT),
                ("deepseek-v3-671b", 128, 128, 192, 128, KERNEL_ONE_SHOT),
                ("qwen2-vl-7b", 28, 4, 128, 128,
                 [("vl prefill", 8, VL_PROMPT, VL_PROMPT, 0, True)]),
                ("seamless-m4t-large-v2", 16, 16, 64, 64,
                 [("encoder", 8, SEAMLESS_FRAMES, SEAMLESS_FRAMES, 0, False),
                  ("cross", 8, SEAMLESS_PROMPT, SEAMLESS_FRAMES, 0, False),
                  ("cross decode", 8, 1, SEAMLESS_FRAMES, 0, False),
                  ("self", 8, SEAMLESS_PROMPT, SEAMLESS_PROMPT, 0, True)])]


@functools.lru_cache(maxsize=None)
def card() -> str:
    """The card's name and power limit, as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def phase_kernels(kernel, ref):
    """Flash attention vs plain at the serving shapes; returns the rows
    printed."""
    import torch.nn.functional as F
    gen = torch.Generator(device="cuda").manual_seed(0)
    dtypes = [(qdt, kvdt) for qdt in (torch.bfloat16, torch.float32)
              for kvdt in (torch.float32, torch.bfloat16)]
    rows = []
    cases = [head[:5] + case for head in KERNEL_HEADS for case in head[5]]
    print(f"[kernels] card: {card()} (every time below)")
    for family, h, hkv, d, dv, name, b, sq, skv, off, causal in cases:
        for qdt, kvdt in dtypes:
            q = torch.randn(b, sq, h, d, generator=gen, device="cuda"
                            ).to(qdt)
            k = torch.randn(b, skv, hkv, d, generator=gen, device="cuda"
                            ).to(kvdt)
            v = torch.randn(b, skv, hkv, dv, generator=gen, device="cuda"
                            ).to(kvdt)
            out, variant = kernel.launch(q, k, v, causal=causal,
                                         q_offset=off)
            want = ref.attention(q, k, v, causal=causal, q_offset=off)
            err, tol = _error(out, want)
            ms = _ms(lambda: kernel.flash_attention(
                q, k, v, causal=causal, q_offset=off), 20)
            plain_ms = _ms(lambda: ref.attention(
                q, k, v, causal=causal, q_offset=off), 5)
            # SDPA yardstick: (B, H, S, D), one dtype (q upcast for an f32
            # cache, outside the timed call); no mask when not causal, an
            # explicit one for a causal offset (SDPA takes Dv != D).
            qt = q.to(kvdt).transpose(1, 2)
            kt, vt = k.transpose(1, 2), v.transpose(1, 2)
            mask = None
            if causal and (off or sq != skv):
                mask = (torch.arange(skv, device="cuda")[None, :]
                        <= torch.arange(sq, device="cuda")[:, None] + off)
            lib_ms = _ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask,
                is_causal=causal and mask is None, enable_gqa=True), 20)
            bound_ms, by, peak = _bound(q, k, v, off, causal)
            row = dict(family=family, heads=f"{h}/{hkv}", d=d, dv=dv,
                       case=name, batch=b, sq=sq, skv=skv, q_offset=off,
                       causal=causal, q_dtype=str(qdt).split(".")[-1],
                       kv_dtype=str(kvdt).split(".")[-1], variant=variant,
                       max_abs_err=err, tol=tol, ms=ms, plain_ms=plain_ms,
                       library_ms=lib_ms, bound_ms=bound_ms, bound_by=by,
                       bound_peak=peak)
            # The tensor-core variant against its own arithmetic in plain
            # torch (bf16 operands and P): a reading, not a check.
            emul = ""
            if variant == "wgmma":
                row["err_vs_bf16_products"] = (out.float() - ref.
                    attention_bf16_products(q, k, v, causal=causal,
                                            q_offset=off).float()
                    ).abs().max().item()
                emul = f" (vs bf16 products {row['err_vs_bf16_products']:.3e})"
            rows.append(row)
            print(f"[kernels] {h:3d}/{hkv:<3d} D={d}/{dv} {name:12s} "
                  f"B={b} Sq={sq:4d} Skv={skv:4d} off={off:4d} "
                  f"{'causal' if causal else 'full  '} "
                  f"q={row['q_dtype']:8s} "
                  f"kv={row['kv_dtype']:8s} {variant:5s} err={err:.3e}{emul} "
                  f"(tol {tol:.3e} = {REL_TOL[qdt]:.3g} x max|plain|) "
                  f"kernel={ms:.4f}ms plain={plain_ms:.4f}ms "
                  f"sdpa={lib_ms:.4f}ms "
                  f"bound={bound_ms:.4f}ms ({by}, {peak} peak)")
            if not err <= tol:
                raise AssertionError(f"kernel disagrees with plain: {row}")
            want_variant = ("wgmma" if qdt == torch.bfloat16
                            and (d, dv) in kernel.WGMMA_HEAD_DIMS
                            else "simt")
            if variant != want_variant:
                raise AssertionError(f"q {qdt} at D {d}/{dv} ran the "
                                     f"{variant} kernel")
    # Host time of a launch (the wgmma variant encodes two TMA tensor maps
    # on the host each time), at a size where the device keeps up.
    q = torch.randn(1, 8, 8, 128, generator=gen, device="cuda")
    k = torch.randn(1, 64, 1, 128, generator=gen, device="cuda")
    host = {kernel.launch(qq, k, k)[1]: _host_us(
        lambda: kernel.flash_attention(qq, k, k))
        for qq in (q.to(torch.bfloat16), q)}
    print(f"[kernels] host time of a launch: " + ", ".join(
        f"{name} {us:.1f} us" for name, us in host.items())
        + " (the ctypes call, argument checks and, for wgmma, the tensor "
        "maps)")
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


def _ffn_desc(cfg) -> str:
    dense = ("" if cfg.mlp is None
             else f"ff={cfg.mlp.d_ff} ({cfg.mlp.activation})")
    if cfg.moe is not None:
        m = cfg.moe
        return (f"{dense + ', ' if dense else ''}experts={m.num_experts}x"
                f"{m.d_ff} top-{m.top_k} ({m.scoring}, {m.num_shared} "
                f"shared) capacity_factor={m.capacity_factor}")
    return dense


def _mixer_desc(cfg) -> str:
    parts = []
    if cfg.mla is not None:
        m = cfg.mla
        parts.append(f"MLA heads={m.num_heads} q_lora={m.q_lora} "
                     f"kv_lora={m.kv_lora} dh_qk={m.dh_qk} dh_v={m.dh_v}")
    elif cfg.attn is not None:
        a = cfg.attn
        parts.append(f"heads={a.num_heads}/{a.num_kv_heads} "
                     f"head_dim={a.head_dim}")
    if cfg.mamba is not None:
        m = cfg.mamba
        parts.append(f"Mamba2 heads={m.nheads}x{m.headdim} "
                     f"d_state={m.d_state} chunk={m.chunk}")
    return " + ".join(parts)


def _attn_layers(cfg) -> int:
    """Layers whose mixer is GQA attention: each launches flash once a
    prefill chunk, or once a prompt for a model that prefills one-shot
    (MLA's chunks attend in the absorbed form, in torch; Mamba layers
    launch none)."""
    return sum(st.repeat for st in cfg.stages for spec in st.layers
               if spec.mixer == "attn")


def _prefill_calls(model, lens, page_tokens) -> int:
    """Flash launches a GQA layer makes to prefill prompts of ``lens``
    tokens: one a page-sized chunk, or one a prompt when the model
    prefills one-shot."""
    if model.supports_chunked_prefill:
        return int(sum(-(-int(n) // page_tokens) for n in lens))
    return len(lens)


def serve_workload(arch="qwen2-72b", tag="serve"):
    """The serving workload, on the card: ``arch`` (qwen2-72b for
    [serve], qwen3-moe-30b-a3b for [serve_moe], nemotron-4-340b,
    deepseek-v3-671b, jamba-1.5-large-398b and mamba2-1.3b for their
    serve phases) at its published widths, cut to SERVE_LAYERS layers
    (mamba2-1.3b at its full 48), with random bf16 weights from seed 0,
    the scheduler's config, and SERVE_REQUESTS prompts of 256-3000 tokens
    from ``RandomState(0)``; a model with Mamba layers takes each drawn
    length rounded down to a multiple of its SSD chunk
    (``serve.engine.prompt_len``).  Also serves one short request (300
    tokens, or one chunk) as a warm-up (cuBLAS handles, allocator).
    Returns (model, params, scfg, prompts)."""
    from repro_torch.configs import get_config, with_num_layers
    from repro_torch.models import build_model
    from repro_torch.serve import ServeCfg
    from repro_torch.serve.engine import prompt_len
    from repro_torch.tree import leaves
    cfg = get_config(arch)
    if arch != MAMBA2_ARCH:
        cfg = with_num_layers(cfg, SERVE_LAYERS)
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    print(f"[{tag}] {cfg.name} d_model={cfg.d_model} {_mixer_desc(cfg)} "
          f"{_ffn_desc(cfg)} {cfg.norm} vocab={cfg.vocab_size} "
          f"layers={cfg.num_layers}{' + MTP block' if cfg.mtp else ''}: "
          f"{model.param_count() / 1e9:.3f}B params, "
          f"{_nbytes(leaves(params)) / 1e9:.2f} GB bf16, init "
          f"{time.perf_counter() - t0:.1f}s")
    scfg = ServeCfg(max_len=4096, batch=8, page_tokens=256,
                    cache_dtype=torch.float32)
    rng = np.random.RandomState(0)
    lens = rng.randint(256, 3001, size=SERVE_REQUESTS)
    prompts = [rng.randint(0, cfg.vocab_size,
                           size=int(prompt_len(cfg, n))).tolist()
               for n in lens]
    if [len(p) for p in prompts] != lens.tolist():
        print(f"[{tag}] prompt lengths rounded down to a multiple of the "
              f"SSD chunk {cfg.mamba.chunk}: the reference's ssd_chunked "
              f"takes no other length")
    _serve(model, params, scfg, [prompts[0][:prompt_len(cfg, 300)]], "cuda",
           2)
    return model, params, scfg, prompts


def _checked_serve(model, params, scfg, submit, ref, prompts):
    """Serve once with this script's own hook, which holds the kernel's
    output for every layer of every prefill chunk (or, for a model that
    prefills one-shot, every flash call of its prompt) of CHECK_RIDS
    against the plain version on the same CUDA tensors, right where the
    model calls it.  The plain calls and their host syncs slow the run,
    so it is not the one timed.  Returns ({rid: tokens}, [(max abs error,
    limit) per checked call]); the scheduler and its pool are freed on
    return."""
    from repro_torch.models import layers as L
    from repro_torch.serve import BatchScheduler
    errs = []
    current = {"rid": None}
    kernel_chunk, kernel_flash = L.chunk_attention, L.flash_attention

    def checked_chunk(q, k_cache, v_cache, q_offset, sm_scale=None):
        out = kernel_chunk(q, k_cache, v_cache, q_offset, sm_scale)
        if current["rid"] in CHECK_RIDS:
            errs.append(_error(out, ref.attention(
                q, k_cache, v_cache, causal=True, q_offset=q_offset)))
        return out

    def checked_flash(q, k, v, *, causal=True, q_offset=0, sm_scale=None):
        out = kernel_flash(q, k, v, causal=causal, q_offset=q_offset,
                           sm_scale=sm_scale)
        if current["rid"] in CHECK_RIDS:
            errs.append(_error(out, ref.attention(
                q, k, v, causal=causal, q_offset=q_offset,
                sm_scale=sm_scale)))
        return out

    sched = BatchScheduler(model, params, scfg, device="cuda")
    if model.supports_chunked_prefill:
        chunk_run = sched._chunk

        def tagged_chunk(params_, rid, *args):
            current["rid"] = rid
            return chunk_run(params_, rid, *args)

        sched._chunk = tagged_chunk
        L.chunk_attention = checked_chunk
    else:
        # the one-shot path's prefill sees the prompt, not its rid
        one_shot = model.prefill
        by_prompt = {tuple(prompts[r]): r for r in CHECK_RIDS}

        def tagged_prefill(params_, batch, caches):
            current["rid"] = by_prompt.get(tuple(batch["tokens"][0]
                                                 .tolist()))
            return one_shot(params_, batch, caches)

        model.prefill = tagged_prefill
        L.flash_attention = checked_flash
    try:
        submit(sched)
        checked = {r.rid: r.generated for r in sched.run()}
    finally:
        L.chunk_attention, L.flash_attention = kernel_chunk, kernel_flash
        model.__dict__.pop("prefill", None)
    sched.pool.check_integrity()
    return checked, errs


def phase_serve(ref):
    """[serve]: qwen2-72b served twice (see ``_serve_phase``)."""
    out = _serve_phase(ref, "qwen2-72b", "serve")
    del out["run"]
    _free()
    return out


def _serve_phase(ref, arch, tag):
    """Serve the workload of ``serve_workload(arch)`` twice: the checked
    run and the timed one (see the module doc).  Every GQA attention
    layer launches flash once a prefill chunk, or once a prompt for a
    model that prefills one-shot (``Model.supports_chunked_prefill``
    false: Mamba layers), on the tensor cores; MLA and Mamba layers
    launch none.
    Returns the timed run's numbers, with (model, params, scfg, prompts,
    tokens) under "run"."""
    from repro_torch.kernels import counter
    from repro_torch.serve import BatchScheduler, Request
    from repro_torch.tree import leaves
    model, params, scfg, prompts = serve_workload(arch, tag)
    cfg = model.cfg
    lens = np.array([len(p) for p in prompts])
    weight_bytes = _nbytes(leaves(params))

    def submit(sched):
        for rid, p in enumerate(prompts):
            sched.submit(Request(rid=rid, prompt=p, max_new=SERVE_MAX_NEW))

    checked, errs = _checked_serve(model, params, scfg, submit, ref,
                                   prompts)

    # Timed run of the main path, unhooked, with the counts set to 0 just
    # before it and read just after.
    sched = BatchScheduler(model, params, scfg, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    counter.reset_all()
    t0 = time.perf_counter()
    submit(sched)
    done = sched.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counter.counts()["flash_attention"]
    tc_launches = counter.counts()["flash_attention_tc"]
    peak = torch.cuda.max_memory_allocated()

    n_calls = _prefill_calls(model, lens, scfg.page_tokens)
    calls = ("prefill chunks" if model.supports_chunked_prefill
             else "one-shot prompts")
    attn_layers = _attn_layers(cfg)
    n_tokens = sum(len(r.generated) for r in done)
    ttft = sorted(r.ttft_s for r in done)
    pool = sched.pool
    pool_bytes = _nbytes(pool.pool) + _nbytes(pool.state)
    card = torch.cuda.get_device_properties(0).total_memory
    print(f"[{tag}] prompts {sorted(lens.tolist())}")
    print(f"[{tag}] {len(done)}/{SERVE_REQUESTS} done, {len(sched.shed)} "
          f"shed, {n_tokens} tokens in {wall:.2f}s = "
          f"{n_tokens / wall:.1f} tok/s; {sched.decode_steps} decode steps; "
          f"TTFT p50 {np.percentile(ttft, 50):.3f}s p99 "
          f"{np.percentile(ttft, 99):.3f}s")
    print(f"[{tag}] flash launches {launches} = {attn_layers} attention "
          f"layers x {n_calls} {calls}: "
          f"{launches == attn_layers * n_calls}; on the tensor-core "
          f"variant: {tc_launches}")
    same = {r.rid: r.generated for r in done} == checked
    if errs:
        worst = max(errs, key=lambda e: e[0] / e[1])
        print(f"[{tag}] checked run: {len(errs)} flash outputs of "
              f"rids {CHECK_RIDS} vs plain, max err "
              f"{max(e[0] for e in errs):.3e}; worst {worst[0]:.3e} "
              f"against its tol {worst[1]:.3e} "
              f"({REL_TOL[torch.bfloat16]:.3g} x max|plain|)")
    print(f"[{tag}] token streams of the checked run equal to the timed "
          f"run's: {same}")
    print(f"[{tag}] peak allocated {peak / 2**30:.2f} GiB of "
          f"{card / 2**30:.1f} GiB; {base / 2**30:.2f} GiB before the timed "
          f"run (weights {weight_bytes / 2**30:.2f} GiB, page pool and "
          f"slot state {pool_bytes / 2**30:.2f} GiB)")
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
    if launches != attn_layers * n_calls:
        raise AssertionError(f"{launches} launches for {n_calls} {calls} "
                             f"of {attn_layers} attention layers")
    if tc_launches != launches:
        raise AssertionError(f"{launches - tc_launches} of {launches} "
                             "served chunks missed the tensor-core kernel")
    expect_checks = attn_layers * _prefill_calls(
        model, [lens[r] for r in CHECK_RIDS], scfg.page_tokens)
    if len(errs) != expect_checks or not all(e <= t for e, t in errs):
        raise AssertionError(f"hook: {len(errs)} checks, errs {errs}")
    if not same:
        raise AssertionError("checked and timed runs gave other tokens")
    if not peak < 0.95 * card:
        raise AssertionError(f"peak {peak} exceeds the card")
    return dict(launches=tc_launches,
                max_abs_err=max((e[0] for e in errs), default=None),
                tokens_per_s=n_tokens / wall,
                ttft_p50=float(np.percentile(ttft, 50)),
                ttft_p99=float(np.percentile(ttft, 99)), peak_gib=peak / 2**30,
                run=(model, params, scfg, prompts, checked))


def phase_serve_moe(ref):
    """[serve_moe]: qwen3-moe-30b-a3b at its published widths (4 of 48
    layers) served as [serve] serves qwen2-72b (checked run, timed run),
    then back to back (``chunked_prefill=False``: a prompt's chunks at
    admission, not interleaved with decode), whose streams must equal
    the interleaved run's, and ROWS_PROMPTS requests at batch 8 and 4,
    whose decode rows must be equal bit for bit (a decode block of
    ``DECODE_ROWS`` rows has expert capacity 8, so no token drops and the
    rows stay independent).  Returns the timed run's numbers."""
    out = _serve_phase(ref, MOE_ARCH, "serve_moe")
    model, params, scfg, prompts, checked = out.pop("run")
    _back_to_back_check("serve_moe", model, params, scfg, prompts, checked)
    _decode_rows_check("serve_moe", model, params, scfg)
    del model, params
    _free()
    return out


def _free():
    """After the caller dropped its last references to a phase's
    weights: collect them and hand the cached blocks back, so the next
    phase's weights find room."""
    import gc
    gc.collect()
    torch.cuda.empty_cache()


def _back_to_back_check(tag, model, params, scfg, prompts, checked):
    """The same requests with ``chunked_prefill=False`` (a prompt's
    chunks at admission, not interleaved with decode): the streams must
    equal the interleaved run's."""
    import dataclasses
    _, done = _serve(model, params, dataclasses.replace(
        scfg, chunked_prefill=False), prompts, "cuda", SERVE_MAX_NEW)
    same = {r.rid: r.generated for r in done} == checked
    print(f"[{tag}] back-to-back prefill gives the interleaved run's "
          f"streams: {same}")
    if not same:
        raise AssertionError(f"{tag}: back-to-back and interleaved "
                             "prefill differ")


def _decode_rows_check(tag, model, params, scfg):
    equal, diff, n = _decode_rows_equal(model, params, scfg,
                                        model.cfg.vocab_size)
    print(f"[{tag}] decode rows at batch 8 and 4 through the scheduler: "
          f"{n} rows, bit-identical: {equal} (largest difference "
          f"{diff:.3e})")
    if not equal:
        raise AssertionError(f"{tag}: decode rows depend on the batch")


def phase_serve_nemotron(ref):
    """[serve_nemotron]: nemotron-4-340b at its published widths (4 of 96
    layers: LayerNorm, 96/8 heads at head dim 192, squared-ReLU MLP)
    served as [serve] serves qwen2-72b (checked run, timed run; every
    chunk of every layer on the tensor-core kernel at D 192), then
    ROWS_PROMPTS requests decoded at batch 8 and 4, whose rows must be
    equal bit for bit.  Returns the timed run's numbers."""
    out = _serve_phase(ref, NEMOTRON_ARCH, "serve_nemotron")
    model, params, scfg, _, _ = out.pop("run")
    _decode_rows_check("serve_nemotron", model, params, scfg)
    del model, params
    _free()
    return out


def _mla_one_shot_check(model, params, scfg, prompts, ref):
    """CHECK_RIDS' prompts prefilled one-shot through ``Model.prefill``
    (MLA's materialized form: every layer's attention through the flash
    kernel at head dims (192, 128), each launch held against plain by
    this script's hook) and in page-sized chunks through
    ``Model.prefill_chunk`` (the absorbed form, as the scheduler runs
    it), both at capacity factor CHECK_CAPACITY, the one-shot with the
    chunked path's expert choices replayed (``_moe_routing``; see
    MLA_FORMS_TOL); then the one-shot with its own routing through the
    kernel, through the kernel's arithmetic in plain torch
    (``ref.attention_bf16_products``) and through plain f32 attention
    (``ref.attention``), printed and not held; then each prompt
    one-shot again, unhooked, timed.  Returns (flash launches,
    tensor-core launches, [(max abs error, limit)] of the hooked
    launches, [relative logit difference] a prompt, [(flash launches,
    tensor-core launches, wall seconds)] of each timed prefill)."""
    import dataclasses
    from repro_torch.kernels import counter
    from repro_torch.models import build_model
    from repro_torch.models import layers as L
    cfg = model.cfg
    m8 = build_model(dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=CHECK_CAPACITY)))
    pt = scfg.page_tokens
    errs, diffs = [], []
    launches = tc = 0
    kernel_flash = L.flash_attention

    def checked_flash(q, k, v, *, causal=True, q_offset=0, sm_scale=None):
        out = kernel_flash(q, k, v, causal=causal, q_offset=q_offset,
                           sm_scale=sm_scale)
        errs.append(_error(out, ref.attention(
            q, k, v, causal=causal, q_offset=q_offset, sm_scale=sm_scale)))
        return out

    def one_shot(toks, flash, replay=None):
        caches = m8.init_caches(1, scfg.max_len, dtype=scfg.cache_dtype)
        L.flash_attention = flash
        routing = (contextlib.nullcontext([]) if replay is None
                   else _moe_routing(replay=replay))
        try:
            with routing as differ:
                logits, caches = m8.prefill(params, {"tokens": toks}, caches)
        finally:
            L.flash_attention = kernel_flash
        return logits.float(), caches, sum(differ)

    def rel(got, want):
        return ((got - want).abs().max() / want.abs().max()).item()

    for rid in CHECK_RIDS:
        prompt = prompts[rid]
        n = len(prompt)
        toks = torch.tensor([prompt], device="cuda")
        caches = m8.init_caches(1, scfg.max_len, dtype=scfg.cache_dtype)
        choices = []
        with _moe_routing(record=choices):
            for c in range(-(-n // pt)):
                chunk = torch.zeros(1, pt, dtype=torch.long, device="cuda")
                part = torch.tensor(prompt[c * pt:(c + 1) * pt],
                                    device="cuda")
                chunk[0, :len(part)] = part
                chunked, caches = m8.prefill_chunk(
                    params, {"tokens": chunk}, caches, q_offset=c * pt,
                    valid_len=min((c + 1) * pt, n),
                    last_index=min(n - 1 - c * pt, pt - 1))
        ckv_chunked = [caches[s][l]["ckv"][:, 0, :n].float()
                       for s in caches for l in caches[s]]
        del caches
        # the chunks' calls, one MoE layer after another: each layer's
        # rows in position order (the padded tail of the last chunk last)
        per_chunk = len(choices) // -(-n // pt)
        replay = [torch.cat(choices[l::per_chunk]) for l in range(per_chunk)]
        want = chunked.float()
        counter.reset_all()
        got, caches, flipped = one_shot(toks, checked_flash, replay)
        counts = counter.counts()
        launches += counts["flash_attention"]
        tc += counts["flash_attention_tc"]
        diffs.append(rel(got, want))
        ckv = [caches[s][l]["ckv"][:, 0, :n].float()
               for s in caches for l in caches[s]]
        cache_diffs = [((a - b).abs().amax() / b.abs().amax()).item()
                       for a, b in zip(ckv, ckv_chunked)]
        del caches
        own = [rel(one_shot(toks, flash)[0], want) for flash in (
            kernel_flash, ref.attention_bf16_products, ref.attention)]
        print(f"[serve_deepseek] rid {rid} ({n} tokens): one-shot vs "
              f"chunked last logits {diffs[-1]:.3e} of max|chunked| (tol "
              f"{MLA_FORMS_TOL:.3g}) with the chunked path's expert "
              f"choices replayed ({flipped} of {n} tokens x "
              f"{len(replay)} MoE layers would choose otherwise); with its "
              f"own choices {own[0]:.3e}, through the kernel's arithmetic "
              f"in torch {own[1]:.3e}, through plain f32 attention "
              f"{own[2]:.3e} (not held); latent cache rows per stage: "
              + ", ".join(f"{d:.3e}" for d in cache_diffs))
    timed_runs = []
    for rid in CHECK_RIDS:
        toks = torch.tensor([prompts[rid]], device="cuda")
        caches = m8.init_caches(1, scfg.max_len, dtype=scfg.cache_dtype)
        torch.cuda.synchronize()
        counter.reset_all()
        t0 = time.perf_counter()
        m8.prefill(params, {"tokens": toks}, caches)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        c = counter.counts()
        timed_runs.append((c["flash_attention"], c["flash_attention_tc"],
                           seconds))
        print(f"[serve_deepseek] rid {rid} ({toks.shape[1]} tokens): "
              f"one-shot Model.prefill {seconds * 1e3:.3f} ms wall, "
              f"{c['flash_attention']} flash launches "
              f"({c['flash_attention_tc']} tensor-core)")
        del caches
    return launches, tc, errs, diffs, timed_runs


def phase_serve_deepseek(ref):
    """[serve_deepseek]: deepseek-v3-671b at its published widths (4 of 61
    layers: 3 dense MLA layers and 1 MoE layer of 256 experts, top-8,
    sigmoid scoring, 1 shared expert; and the MTP block the config's
    init builds) served as [serve] serves qwen2-72b (checked and timed
    runs).  Its chunked prefill launches no flash kernel: MLA attends in
    the absorbed form (plain torch, as the reference computes it in
    jnp).  Then the same requests back to back, whose streams must equal
    the interleaved run's; decode rows at batch 8 and 4, bit for bit;
    and CHECK_RIDS' prompts one-shot through ``Model.prefill``, whose
    flash launches at (192, 128) are held against plain and whose last
    logits must agree with the chunked path's, the chunked path's expert
    choices replayed (``_mla_one_shot_check``).  Returns the timed run's
    numbers."""
    out = _serve_phase(ref, DEEPSEEK_ARCH, "serve_deepseek")
    model, params, scfg, prompts, checked = out.pop("run")
    _back_to_back_check("serve_deepseek", model, params, scfg, prompts,
                        checked)
    _decode_rows_check("serve_deepseek", model, params, scfg)
    launches, tc, errs, diffs, timed_runs = _mla_one_shot_check(
        model, params, scfg, prompts, ref)
    worst = max(errs, key=lambda e: e[0] / e[1])
    print(f"[serve_deepseek] one-shot prefill: {launches} flash launches "
          f"({tc} tensor-core) = {SERVE_LAYERS} layers x "
          f"{len(CHECK_RIDS)} prompts; held against plain: max err "
          f"{max(e[0] for e in errs):.3e}, worst {worst[0]:.3e} against "
          f"its tol {worst[1]:.3e}")
    if launches != SERVE_LAYERS * len(CHECK_RIDS) or tc != launches:
        raise AssertionError(f"one-shot MLA prefill: {launches} launches, "
                             f"{tc} tensor-core")
    if any((n, t) != (SERVE_LAYERS, SERVE_LAYERS) for n, t, _ in timed_runs):
        raise AssertionError(f"timed one-shot MLA prefill: {timed_runs}")
    if len(errs) != launches or not all(e <= t for e, t in errs):
        raise AssertionError(f"one-shot flash vs plain: {errs}")
    if not all(d <= MLA_FORMS_TOL for d in diffs):
        raise AssertionError(f"one-shot and chunked MLA prefill differ: "
                             f"{diffs}")
    out.update(one_shot_launches=launches,
               one_shot_max_abs_err=max(e[0] for e in errs),
               one_shot_prefill_s=[t for _, _, t in timed_runs])
    del model, params
    _free()
    return out


@contextlib.contextmanager
def _moe_routing(record=None, replay=None):
    """While the block runs, ``models.moe.route`` either appends each
    call's expert choices (T, k) to ``record`` (MoE layers in call
    order), or takes them from ``replay`` (one tensor a MoE layer, one
    row a position; the calls of each layer consume its rows in order)
    with the weights, positions and keep mask computed from them as
    ``moe.route_logits`` does.  Yields a list that counts, per replayed
    call, the tokens whose own choices differ from the replayed ones."""
    import torch.nn.functional as F
    from repro_torch.models import moe as MOE
    route = MOE.route
    differ, calls, cursor = [], [0], {}

    def recording(x2d, router_w, cfg, capacity):
        out = route(x2d, router_w, cfg, capacity)
        record.append(out[0])
        return out

    def replaying(x2d, router_w, cfg, capacity):
        layer = calls[0] % len(replay)
        calls[0] += 1
        t = x2d.shape[0]
        lo = cursor.get(layer, 0)
        cursor[layer] = lo + t
        idx = replay[layer][lo:lo + t]
        logits = MOE.router_logits(x2d, router_w)
        probs = (torch.sigmoid(logits) if cfg.scoring == "sigmoid"
                 else torch.softmax(logits, dim=-1))
        own = torch.topk(probs, cfg.top_k, dim=-1).indices
        differ.append(int((own.sort(-1).values != idx.sort(-1).values)
                          .any(-1).sum()))
        vals = probs.gather(1, idx)
        if cfg.norm_topk:
            vals = vals / torch.clamp(vals.sum(dim=-1, keepdim=True),
                                      min=1e-9)
        flat = idx.reshape(-1)
        onehot = F.one_hot(flat, cfg.num_experts)
        pos = torch.cumsum(onehot, dim=0).gather(1, flat[:, None])[:, 0] - 1
        keep = (pos < capacity).reshape(t, cfg.top_k)
        return (idx, vals, pos.reshape(t, cfg.top_k), keep,
                torch.zeros((), device=x2d.device))

    MOE.route = recording if replay is None else replaying
    try:
        yield differ
    finally:
        MOE.route = route


def _ssm_forms_check(tag, model, params, scfg, prompts):
    """CHECK_RIDS' prompts (n tokens each) prefilled one-shot through
    ``Model.prefill``, against a one-shot prefill of the first n -
    SSM_FORMS_DECODE tokens (none when that is 0: the fresh cache is the
    state before any token) followed by SSM_FORMS_DECODE decode steps
    through ``Model.decode_step``: the chunked SSD scan against the
    recurrent step.  A MoE layer runs at capacity factor CHECK_CAPACITY
    in both, so no token drops, and the second form replays the
    one-shot's expert choices (``_moe_routing``): a top-2 choice whose
    2nd and 3rd scores lie within the forms' rounding flips between
    them, and a flipped token changes every later state of the Mamba
    layers after it, which is not a difference of the SSD forms.  The
    second form's own routing is run too and its difference printed.
    Returns [relative last-logit difference] a prompt (with the replayed
    routing)."""
    import dataclasses
    from repro_torch.models import build_model
    cfg = model.cfg
    moe = cfg.moe is not None
    if moe:
        model = build_model(dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=CHECK_CAPACITY)))

    def decoded(toks, m, n):
        caches = model.init_caches(1, scfg.max_len, dtype=scfg.cache_dtype)
        if m:
            _, caches = model.prefill(params, {"tokens": toks[:, :m]},
                                      caches)
        for t in range(m, n):
            got, caches = model.decode_step(
                params, {"tokens": toks[:, t:t + 1]}, caches)
        return got.float()

    def rel(got, want):
        return ((got - want).abs().max() / want.abs().max()).item()

    diffs = []
    for rid in CHECK_RIDS:
        toks = torch.tensor([prompts[rid]], device="cuda")
        n, m = toks.shape[1], toks.shape[1] - SSM_FORMS_DECODE
        choices = []
        caches = model.init_caches(1, scfg.max_len, dtype=scfg.cache_dtype)
        with _moe_routing(record=choices):
            want, caches = model.prefill(params, {"tokens": toks}, caches)
        want = want.float()
        del caches
        if moe:
            with _moe_routing(replay=choices) as differ:
                diffs.append(rel(decoded(toks, m, n), want))
            own = rel(decoded(toks, m, n), want)
            note = (f" with the one-shot's expert choices replayed "
                    f"({sum(differ)} of {m + SSM_FORMS_DECODE} tokens x "
                    f"{len(choices)} MoE layers would choose otherwise; "
                    f"with its own choices {own:.3e}, not held)")
        else:
            diffs.append(rel(decoded(toks, m, n), want))
            note = ""
        print(f"[{tag}] rid {rid} ({n} tokens): one-shot vs {m}-token "
              f"prefill + {SSM_FORMS_DECODE} decode steps, last logits "
              f"{diffs[-1]:.3e} of max|one-shot| (tol {SSM_FORMS_TOL:.3g})"
              + note)
    return diffs


def _ssm_serve_phase(ref, arch, tag):
    """[serve_jamba] / [serve_mamba2]: the workload served as [serve]
    serves qwen2-72b (checked run, timed run) through the one-shot
    prefill, then decode rows at batch 8 and 4, bit for bit, and the
    forms check (``_ssm_forms_check``).  Returns the timed run's
    numbers."""
    out = _serve_phase(ref, arch, tag)
    model, params, scfg, prompts, _ = out.pop("run")
    if model.supports_chunked_prefill:
        raise AssertionError(f"{tag}: a Mamba model offers chunked prefill")
    _decode_rows_check(tag, model, params, scfg)
    diffs = _ssm_forms_check(tag, model, params, scfg, prompts)
    if not all(d <= SSM_FORMS_TOL for d in diffs):
        raise AssertionError(f"{tag}: one-shot and decoded logits differ: "
                             f"{diffs}")
    out["forms_diff"] = max(diffs)
    del model, params
    _free()
    return out


def phase_serve_jamba(ref):
    """[serve_jamba]: jamba-1.5-large-398b, 4 of 72 layers (see the module
    doc)."""
    return _ssm_serve_phase(ref, JAMBA_ARCH, "serve_jamba")


def phase_serve_mamba2(ref):
    """[serve_mamba2]: mamba2-1.3b at full depth (see the module doc)."""
    return _ssm_serve_phase(ref, MAMBA2_ARCH, "serve_mamba2")


def _padded_rows(tree, rows: int, block: int, batch_axis):
    """A copy of ``tree`` holding its first ``rows`` rows, followed by
    ``block - rows`` rows of zeros (``block`` = rows: no padding).
    ``batch_axis(path)`` names each leaf's batch axis."""
    from repro_torch.tree import flatten, unflatten
    ls, paths = flatten(tree)
    out = []
    for path, t in zip(paths, ls):
        ax = batch_axis(path)
        part = t.narrow(ax, 0, rows)
        if block > rows:
            shape = list(t.shape)
            shape[ax] = block - rows
            part = torch.cat([part, t.new_zeros(shape)], dim=ax)
        out.append(part.contiguous())
    return unflatten(paths, out)


@contextlib.contextmanager
def _checked_flash(ref, errs, rows: int):
    """While the block runs, every flash launch the model makes is held
    against the plain version on its first ``rows`` batch rows, on the
    same CUDA tensors; appends (max abs error, limit, causal, Sq, Skv)
    to ``errs``."""
    from repro_torch.models import layers as L
    kernel_flash = L.flash_attention

    def checked(q, k, v, *, causal=True, q_offset=0, sm_scale=None):
        out = kernel_flash(q, k, v, causal=causal, q_offset=q_offset,
                           sm_scale=sm_scale)
        errs.append(_error(out[:rows], ref.attention(
            q[:rows], k[:rows], v[:rows], causal=causal, q_offset=q_offset,
            sm_scale=sm_scale)) + (causal, q.shape[1], k.shape[1]))
        return out

    L.flash_attention = checked
    try:
        yield
    finally:
        L.flash_attention = kernel_flash


def _ops_a_call(fn) -> int:
    """The aten ops one call of ``fn`` dispatches (each a kernel launch,
    or a view the host works out): the host's share of a decode step.
    A flash launch goes through ctypes and is not among them."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Count.n += 1
            return func(*args, **(kwargs or {}))

    with Count():
        fn()
    torch.cuda.synchronize()
    return Count.n


def _rel(got, want) -> float:
    want = want.float()
    return ((got.float() - want).abs().max() / want.abs().max()).item()


def _rows_check(tag, decode_rows, timed_logits, rows: int):
    """The first ``rows`` rows decoded alone, from the batch-8 prefill's
    caches: in a block of EMBEDS_BATCH rows with the rest zero padding
    (as the scheduler decodes, ``serve.engine.DECODE_ROWS``), held bit
    for bit to the batch-8 run's logits of the same rows; and at batch
    ``rows`` without padding, a reading.  ``decode_rows(rows, block)``
    runs the steps and returns their logits."""
    padded = decode_rows(rows, EMBEDS_BATCH)
    bare = decode_rows(rows, rows)
    equal = all(_bits_equal(a, b[:rows]) for a, b in zip(padded,
                                                         timed_logits))
    diff = max((a.float() - b[:rows].float()).abs().max().item()
               for a, b in zip(padded, timed_logits))
    bare_equal = all(_bits_equal(a, b[:rows]) for a, b in zip(
        bare, timed_logits))
    print(f"[{tag}] decode rows 0-{rows - 1} at batch {EMBEDS_BATCH} and "
          f"{rows} ({len(padded)} steps, the batch-{rows} block padded to "
          f"{EMBEDS_BATCH} rows as the scheduler pads it): bit-identical: "
          f"{equal} (largest difference {diff:.3e}); unpadded at batch "
          f"{rows}: bit-identical: {bare_equal} (a reading)")
    if not equal:
        raise AssertionError(f"{tag}: decode rows depend on the batch")


def phase_serve_vl(ref):
    """[serve_vl]: qwen2-vl-7b at its published widths and full depth,
    served through ``Model.prefill`` and ``Model.decode_step`` (see the
    module doc).  Returns the timed run's numbers."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import counter
    from repro_torch.models import build_model, frontends
    from repro_torch.models import transformer as T
    from repro_torch.tree import leaves
    tag, b, n, steps = "serve_vl", EMBEDS_BATCH, VL_PROMPT, VL_DECODE
    cfg = get_config(VL_ARCH)
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    print(f"[{tag}] {cfg.name} d_model={cfg.d_model} {_mixer_desc(cfg)} "
          f"M-RoPE sections={cfg.attn.mrope_sections} {_ffn_desc(cfg)} "
          f"vocab={cfg.vocab_size} layers={cfg.num_layers}, no embedding "
          f"table: {model.param_count()} params, "
          f"{_nbytes(leaves(params)) / 1e9:.2f} GB bf16, init "
          f"{time.perf_counter() - t0:.1f}s")
    gen = torch.Generator(device="cuda").manual_seed(1)
    stub = frontends.vision_patch_embeds(gen, b, n, cfg.d_model,
                                         cfg.param_dtype)
    # the stub's next embeddings, at the text positions that follow
    more = frontends.vision_patch_embeds(gen, b, steps, cfg.d_model,
                                         cfg.param_dtype)["inputs_embeds"]
    embeds = torch.cat([stub["inputs_embeds"], more], dim=1)
    last = stub["positions"][:, :, -1:]          # text: t == h == w
    positions = torch.cat([stub["positions"], last + torch.arange(
        1, steps + 1, dtype=torch.int32, device="cuda")], dim=2)
    n_img = n // 4
    print(f"[{tag}] batch {b}: {n} positions a row ({n_img} image patches "
          f"on a {max(int(n_img ** 0.5), 1)}-wide grid, then text from "
          f"{int(stub['positions'][0, 0, n_img])}), f32 cache, then "
          f"{steps} decode steps at text positions "
          f"{int(positions[0, 0, n])}..{int(positions[0, 0, -1])}")

    def prefill(rows=b):
        caches = model.init_caches(rows, n + steps, dtype=torch.float32)
        return model.prefill(params, {
            "inputs_embeds": embeds[:rows, :n],
            "positions": positions[:, :rows, :n]}, caches)

    def decode(caches, rows, block):
        got = []
        for j in range(steps):
            e = embeds[:rows, n + j:n + j + 1]
            p = positions[:, :rows, n + j:n + j + 1]
            if block > rows:
                e = torch.cat([e, e.new_zeros((block - rows,) + e.shape[1:])])
                p = torch.cat([p, p.new_zeros((3, block - rows, 1))], dim=1)
            lg, caches = model.decode_step(
                params, {"inputs_embeds": e, "positions": p}, caches)
            got.append(lg[:rows])
        return got

    errs = []
    with _checked_flash(ref, errs, len(CHECK_RIDS)):
        prefill()                  # the checked run, and the warm-up
    _free()
    counter.reset_all()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    first, caches = prefill()
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    logits = decode(caches, b, b)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    counts = counter.counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    del caches
    launches, tc = counts["flash_attention"], counts["flash_attention_tc"]
    empty = model.init_caches(b, n + steps, dtype=torch.float32)
    ops = _ops_a_call(lambda: model.decode_step(params, {
        "inputs_embeds": embeds[:, n:n + 1],
        "positions": positions[:, :, n:n + 1]}, empty))
    del empty
    worst = max(errs, key=lambda e: e[0] / e[1])
    print(f"[{tag}] prefill {prefill_s:.3f}s; decode "
          f"{decode_s / steps * 1e3:.2f} ms a step, "
          f"{b * steps / decode_s:.1f} rows x steps / s ({ops} aten ops "
          f"a step); peak {peak:.2f} GiB; flash launches {launches} "
          f"({tc} tensor-core) "
          f"= {cfg.num_layers} layers x 1 prefill; the checked prefill's "
          f"{len(errs)} launches against plain (rows "
          f"{list(CHECK_RIDS)}): worst {worst[0]:.3e} against its tol "
          f"{worst[1]:.3e} ({card()})")
    if launches != cfg.num_layers or tc != launches:
        raise AssertionError(f"{tag}: {launches} flash launches, {tc} "
                             "tensor-core")
    if len(errs) != cfg.num_layers or not all(e[0] <= e[1] for e in errs):
        raise AssertionError(f"{tag}: flash vs plain: {errs}")
    # the teacher-forced forward over all n + steps positions
    h, _, _ = T.forward(params, cfg, {"inputs_embeds": embeds,
                                      "positions": positions})
    full = T._unembed(params, cfg, h[:, n - 1:])
    del h
    diffs = [_rel(got, full[:, i]) for i, got in enumerate([first]
                                                            + logits)]
    print(f"[{tag}] prefill and {steps} decode steps against the "
          f"teacher-forced forward over {n + steps} positions: last "
          f"prefill logits {diffs[0]:.3e}, worst decode step "
          f"{max(diffs[1:]):.3e} of max|forward| (tol "
          f"{EMBEDS_FORMS_TOL:.3g})")
    if not all(math.isfinite(d) and d <= EMBEDS_FORMS_TOL for d in diffs):
        raise AssertionError(f"{tag}: decode disagrees with the forward: "
                             f"{diffs}")
    del full
    _, caches = prefill()
    half = b // 2
    _rows_check(tag, lambda rows, block: decode(_padded_rows(
        caches, rows, block, lambda path: 1), rows, block), logits, half)
    del caches, params, model
    _free()
    return {"launches": launches, "max_abs_err": max(e[0] for e in errs),
            "prefill_s": prefill_s, "decode_ms": decode_s / steps * 1e3,
            "peak_gib": peak, "forms_diff": max(diffs), "ops_a_step": ops}


def phase_serve_seamless(ref):
    """[serve_seamless]: seamless-m4t-large-v2 at its published widths and
    full depth, served through ``Model.prefill`` and greedy
    ``Model.decode_step``s (see the module doc).  Returns the timed run's
    numbers."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import counter
    from repro_torch.models import build_model, frontends
    from repro_torch.models import encdec as ED
    from repro_torch.tree import leaves
    tag, b, f = "serve_seamless", EMBEDS_BATCH, SEAMLESS_FRAMES
    n, steps = SEAMLESS_PROMPT, SEAMLESS_DECODE
    cfg = get_config(SEAMLESS_ARCH)
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    a = cfg.attn
    print(f"[{tag}] {cfg.name} d_model={cfg.d_model} encoder "
          f"{cfg.enc_layers} + decoder {cfg.dec_layers} layers, "
          f"heads={a.num_heads}/{a.num_kv_heads} head_dim={a.head_dim}, "
          f"ff={cfg.mlp.d_ff} ({cfg.mlp.activation}) {cfg.norm} "
          f"vocab={cfg.vocab_size}: {model.param_count()} params, "
          f"{_nbytes(leaves(params)) / 1e9:.2f} GB bf16, init "
          f"{time.perf_counter() - t0:.1f}s")
    gen = torch.Generator(device="cuda").manual_seed(1)
    frames = frontends.audio_frame_embeds(gen, b, f, cfg.d_model,
                                          cfg.param_dtype)
    prompt = torch.tensor(np.random.RandomState(0).randint(
        0, cfg.vocab_size, size=(b, n)), device="cuda")
    print(f"[{tag}] batch {b}: {f} frames and a {n}-token prompt a row, "
          f"f32 cache, {steps} greedy decode steps")

    def prefill(rows=b):
        caches = model.init_caches(rows, n + steps, enc_len=f,
                                   dtype=torch.float32)
        return model.prefill(params, {"frame_embeds": frames[:rows],
                                      "tokens": prompt[:rows]}, caches)

    def decode(caches, toks, rows, block):
        got = []
        for j in range(len(toks)):
            t = toks[j][:rows, None]
            if block > rows:
                t = torch.cat([t, t.new_zeros((block - rows, 1))])
            lg, caches = model.decode_step(params, {"tokens": t}, caches)
            got.append(lg[:rows])
        return got

    errs = []
    with _checked_flash(ref, errs, b):
        first, caches = prefill()       # the checked run, and the warm-up
        decode(caches, [torch.argmax(first, dim=-1)], b, b)
    del caches
    _free()
    encode_ms = _ms(lambda: ED.encode(params, cfg, frames), 3)
    counter.reset_all()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    first, caches = prefill()
    toks = [torch.argmax(first, dim=-1)]
    torch.cuda.synchronize()
    ttft = time.perf_counter() - t0
    logits = []
    t0 = time.perf_counter()
    for _ in range(steps):
        lg, caches = model.decode_step(params, {"tokens": toks[-1][:, None]},
                                       caches)
        logits.append(lg)
        toks.append(torch.argmax(lg, dim=-1))
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    counts = counter.counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    # what a decode step spends recomputing the memory's cross K and V
    memory = caches["memory"].to(cfg.param_dtype)
    cross = params["decoder"]["cross"]
    kv_ms = _ms(lambda: [memory @ cross[w][i] for i in range(cfg.dec_layers)
                         for w in ("wk", "wv")], 5)
    del caches, memory
    launches, tc = counts["flash_attention"], counts["flash_attention_tc"]
    want = 3 * cfg.dec_layers + steps * cfg.dec_layers
    empty = model.init_caches(b, n + steps, enc_len=f, dtype=torch.float32)
    ops = _ops_a_call(lambda: model.decode_step(
        params, {"tokens": toks[0][:, None]}, empty))
    del empty
    kinds = {"encoder": [e for e in errs if not e[2] and e[3] == e[4]],
             "cross": [e for e in errs if not e[2] and e[3] != e[4]],
             "self": [e for e in errs if e[2]]}
    print(f"[{tag}] encode {encode_ms:.3f} ms; TTFT {ttft * 1e3:.3f} ms; "
          f"decode {decode_s / steps * 1e3:.3f} ms a step ({ops} aten ops "
          f"and {cfg.dec_layers} flash launches), "
          f"{b * steps / decode_s:.1f} tokens/s; peak {peak:.2f} GiB; "
          f"the memory's cross K/V recomputed a step: {kv_ms:.3f} ms "
          f"({kv_ms / (decode_s / steps * 1e3):.1%} of a step); flash "
          f"launches {launches} ({tc} tensor-core) = {cfg.enc_layers} "
          f"encoder + {cfg.dec_layers} self + {cfg.dec_layers} cross a "
          f"prefill + {cfg.dec_layers} cross x {steps} steps ({card()})")
    for kind, es in kinds.items():
        w = max(es, key=lambda e: e[0] / e[1])
        print(f"[{tag}] checked {kind} launches: {len(es)}, worst "
              f"{w[0]:.3e} against its tol {w[1]:.3e} (Sq {w[3]}, Skv "
              f"{w[4]})")
    if launches != want or tc != launches:
        raise AssertionError(f"{tag}: {launches} flash launches ({tc} "
                             f"tensor-core), expected {want}")
    if (len(errs) != cfg.enc_layers + 3 * cfg.dec_layers
            or not all(e[0] <= e[1] for e in errs)):
        raise AssertionError(f"{tag}: flash vs plain: {errs}")
    full = model.logits(params, {"frame_embeds": frames, "tokens": torch.cat(
        [prompt] + [t[:, None] for t in toks[:-1]], dim=1)})
    diffs = [_rel(got, full[:, n - 1 + i]) for i, got in enumerate(
        [first] + logits)]
    del full
    print(f"[{tag}] prefill and {steps} greedy decode steps against the "
          f"teacher-forced logits over {n + steps} tokens: last prefill "
          f"logits {diffs[0]:.3e}, worst decode step {max(diffs[1:]):.3e} "
          f"of max|forward| (tol {EMBEDS_FORMS_TOL:.3g})")
    if not all(math.isfinite(d) and d <= EMBEDS_FORMS_TOL for d in diffs):
        raise AssertionError(f"{tag}: decode disagrees with the forward: "
                             f"{diffs}")
    _, caches = prefill()
    fed = toks[:-1]
    _rows_check(tag, lambda rows, block: decode(_padded_rows(
        caches, rows, block, lambda path: 0 if path == ("memory",) else 1),
        fed, rows, block), logits, b // 2)
    del caches, params, model
    _free()
    return {"launches": launches, "max_abs_err": max(e[0] for e in errs),
            "encode_ms": encode_ms, "ttft_s": ttft,
            "decode_ms": decode_s / steps * 1e3,
            "tokens_per_s": b * steps / decode_s, "peak_gib": peak,
            "cross_kv_ms": kv_ms, "forms_diff": max(diffs),
            "ops_a_step": ops}


def _serve_tp_run(arch, layers, shape, max_len, n, dtype):
    """One [serve_tp] run: the cut, its weights in ``dtype``, served
    unsplit, then split on a thread mesh of ``shape`` (data, model);
    returns its numbers."""
    from repro_torch.configs import get_config, with_num_layers
    from repro_torch.data.pipeline import shard_batch
    from repro_torch.kernels import counter
    from repro_torch.models import build_model
    from repro_torch.parallel import sharding
    from repro_torch.runtime import substrate
    b, steps = SERVE_TP_BATCH, SERVE_TP_STEPS
    cfg = get_config(arch, param_dtype=dtype)
    cfg = cfg if layers is None else with_num_layers(cfg, layers)
    tag = f"serve_tp] [{arch}"
    whole = build_model(cfg)
    params = whole.init(torch.Generator(device="cuda").manual_seed(0))
    tokens = torch.randint(0, cfg.vocab_size, (b, n + steps),
                           generator=torch.Generator(device="cuda")
                           .manual_seed(1), device="cuda",
                           dtype=torch.int32)
    batches = [{"tokens": tokens[:, :n]}] + [
        {"tokens": tokens[:, n + j:n + j + 1]} for j in range(steps)]

    def timed_run(fn):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    caches = whole.init_caches(b, max_len, dtype=torch.float32)
    (lg, caches), pre_s = timed_run(lambda: whole.prefill(
        params, batches[0], caches))
    want = [lg]

    def decode_whole(caches):
        for bt in batches[1:]:
            lg, caches = whole.decode_step(params, bt, caches)
            want.append(lg)
    _, dec_s = timed_run(lambda: decode_whole(caches))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    del caches
    data, mp = shape
    mesh = substrate.make_host_mesh(data, model_parallel=mp, device="cuda")
    model = build_model(cfg, model_parallel=mp)
    rank_params = [model.rank_params(params, mesh, r)
                   for r in range(mesh.size)]
    del params
    _free()
    axes = sharding.row_axes(mesh.shape, b)
    rows = [shard_batch(bt, mesh, axes) for bt in batches]

    def prefill_rank(p, bt):
        caches = model.init_caches(b, max_len, dtype=torch.float32)
        lg, caches = model.prefill(p, bt, caches)
        return [(lg, model.argmax(lg))], caches

    def decode_rank(p, caches, got, *bts):
        for bt in bts:
            lg, caches = model.decode_step(p, bt, caches)
            got.append((lg, model.argmax(lg)))
        return got

    counter.reset_all()
    pre, split_pre_s = timed_run(lambda: substrate.run_spmd(
        prefill_rank, [(rank_params[r], rows[0][r])
                       for r in range(mesh.size)], mesh))
    prefill_counts = counter.counts()
    got, split_dec_s = timed_run(lambda: substrate.run_spmd(
        decode_rank, [(rank_params[r], pre[r][1], pre[r][0],
                       *[x[r] for x in rows[1:]])
                      for r in range(mesh.size)], mesh))
    split_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    counts = counter.counts()
    split = pre[0][1].split
    specs = {"/".join(p): sp for p, sp in zip(split.paths, split.specs)
             if p[:2] in (("stage0", "layer0"),)}
    n_rows = b // math.prod(mesh.shape[a] for a in axes)
    diffs, agree = [], True
    for step, w in enumerate(want):
        joined = torch.empty_like(w)
        for r in range(mesh.size):
            c = mesh.coords(r)
            d = sharding.block_index(axes, mesh.shape, c)[0]
            lg, top = got[r][step]
            v = lg.shape[-1]
            joined[d * n_rows:(d + 1) * n_rows,
                   c["model"] * v:(c["model"] + 1) * v] = lg
        diffs.append(_rel(joined, w))
        top = joined.float().argmax(-1)
        for r in range(mesh.size):
            d = sharding.block_index(axes, mesh.shape, mesh.coords(r))[0]
            same = top[d * n_rows:(d + 1) * n_rows]
            agree &= bool(torch.equal(got[r][step][1], same))
    print(f"[{tag}] {cfg.name} {cfg.num_layers} layers, "
          f"{str(dtype).split('.')[-1]} weights, on {dict(mesh.shape)}, "
          f"batch {b}, prompt {n}, cache {max_len} positions f32; layer "
          f"0's cache split {specs}")
    print(f"[{tag}] unsplit: prefill {pre_s * 1e3:.1f} ms, decode "
          f"{dec_s / steps * 1e3:.2f} ms a step, peak {peak:.2f} GiB; "
          f"split ({mesh.size} thread ranks on one card): prefill "
          f"{split_pre_s * 1e3:.1f} ms, decode "
          f"{split_dec_s / steps * 1e3:.2f} ms a step, peak "
          f"{split_peak:.2f} GiB ({card()})")
    print(f"[{tag}] split against unsplit over prefill + {steps} decode "
          f"steps: worst {max(diffs):.3e} of max|unsplit| (tol "
          f"{SERVE_TP_TOL:.3g}); each rank's argmax equal to the joined "
          f"rows': {agree}; launches: flash {counts['flash_attention']} "
          f"({counts['flash_attention_tc']} tensor-core, all in the "
          f"prefill: {prefill_counts['flash_attention']}), sum_chunks "
          f"{counts['sum_chunks']}")
    if not all(math.isfinite(d) and d <= SERVE_TP_TOL for d in diffs):
        raise AssertionError(f"[{tag}]: split vs unsplit {diffs}")
    if not agree:
        raise AssertionError(f"[{tag}]: Model.argmax differs from the "
                             "joined logits' argmax")
    attn = _attn_layers(cfg)
    if (counts["flash_attention"] != attn * mesh.size
            or counts["flash_attention_tc"] != counts["flash_attention"]
            or prefill_counts["flash_attention"]
            != counts["flash_attention"]):
        raise AssertionError(f"[{tag}]: flash launches {counts}, want "
                             f"{attn} layers x {mesh.size} ranks on the "
                             "tensor cores, in the prefill")
    if counts["sum_chunks"] <= 0:
        raise AssertionError(f"[{tag}]: no sum_chunks launch")
    del rank_params, pre, got, whole, model
    _free()
    return {"launches": counts["flash_attention"],
            "sum_chunks": counts["sum_chunks"], "worst": max(diffs),
            "prefill_ms": split_pre_s * 1e3,
            "decode_ms": split_dec_s / steps * 1e3,
            "unsplit_prefill_ms": pre_s * 1e3,
            "unsplit_decode_ms": dec_s / steps * 1e3,
            "peak_gib": split_peak, "unsplit_peak_gib": peak}


def phase_serve_tp():
    """[serve_tp]: serving over "data" and "model" (see the module doc).
    Returns {arch: numbers}."""
    return {run[0]: _serve_tp_run(*run) for run in SERVE_TP_RUNS}


def _bits_equal(a, b) -> bool:
    view = {1: torch.int8, 2: torch.int16, 4: torch.int32}[a.element_size()]
    return (a.dtype == b.dtype and a.shape == b.shape
            and torch.equal(a.view(view), b.view(view)))


def _sync_bound(name: str, n: int, in_bytes: int, out_bytes: int):
    """Least time (ms) for ``name`` on ``n`` values: bytes read once and
    written once over HBM bandwidth against its f32 operations over the
    CUDA cores' f32 peak.  Returns (ms, "bytes" | "operations")."""
    t_bytes = (in_bytes + out_bytes) / HBM_BYTES_PER_S
    t_ops = F32_OPS_PER_VALUE[name] * n / PEAK_OPS["f32"]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def _nb(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def phase_collectives():
    """The four gradient-sync kernels against their plain versions, bit
    for bit, at the sync's sizes.  Calls the bindings directly, so no
    launch counter moves.  Returns {(kernel, size name, dtype): row}."""
    from repro_torch.kernels.local_reduce import kernel as lk
    from repro_torch.kernels.local_reduce import ref as lref
    from repro_torch.kernels.quantize import kernel as qk
    from repro_torch.kernels.quantize import ref as qref
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = {}

    def record(name, size, dtype, n, got, want, fn, plain, lib, in_b,
               out_b):
        same = all(_bits_equal(g, w) for g, w in zip(got, want))
        iters = 20 if n > 10 ** 7 else 50
        # In turns, kernel and PyTorch call; each keeps its faster turn.
        ms, lib_ms = float("inf"), None
        for _ in range(2):
            ms = min(ms, _ms(fn, iters))
            if lib is not None:
                lib_ms = min(lib_ms or float("inf"), _ms(lib, iters))
        plain_ms = _ms(plain, 3 if n > 10 ** 7 else 20, warmup=1)
        bound_ms, by = _sync_bound(name, n, in_b, out_b)
        err = max((g.float() - w.float()).abs().max().item()
                  for g, w in zip(got, want))
        rows[(name, size, dtype)] = dict(
            ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound_ms,
            bound_by=by, max_abs_err=err, bit_identical=same)
        lib_s = f"{lib_ms:.4f}ms" if lib_ms is not None else "none"
        print(f"[collectives] {name:11s} {size:16s} n={n:>11,d} {dtype:8s} "
              f"bit-identical={same} kernel={ms:.4f}ms plain={plain_ms:.4f}"
              f"ms library={lib_s} bound={bound_ms:.4f}ms ({by})")
        if not same:
            raise AssertionError(f"{name} at {size} ({dtype}) differs from "
                                 "its plain version")

    for size, n in SYNC_SIZES:
        for dt in (torch.bfloat16, torch.float32):
            x = torch.randn(2, n, generator=gen, device="cuda").to(dt)
            a, b = x[0], x[1]
            got = lk.sum_chunks([a, b])
            record("sum_chunks", size, str(dt).split(".")[-1], n, [got],
                   [lref.sum_chunks([a, b])],
                   lambda: lk.sum_chunks([a, b]),
                   lambda: lref.sum_chunks([a, b]),
                   lambda: torch.add(a, b), _nb(a, b), _nb(got))
            del x, a, b, got
        m = -(-n // qref.QBLOCK) * qref.QBLOCK    # the sync pads to blocks
        x = torch.randn(m, generator=gen, device="cuda")
        x.view(-1, qref.QBLOCK)[0] = 0.0          # an all-zero block
        acc = torch.randn(m, generator=gen, device="cuda")
        q, sc = qk.quantize(x)
        wq, ws = qref.quantize(x)
        record("quantize", size, "float32", m, [q, sc], [wq, ws],
               lambda: qk.quantize(x), lambda: qref.quantize(x), None,
               _nb(x), _nb(q, sc))
        q2d, s2d = q.view(-1, qref.QBLOCK), sc[:, None]
        acc2d = acc.view(-1, qref.QBLOCK)
        d = qk.dequantize(q, sc)
        record("dequantize", size, "float32", m, [d],
               [qref.dequantize(q, sc)], lambda: qk.dequantize(q, sc),
               lambda: qref.dequantize(q, sc),
               lambda: torch.mul(q2d, s2d), _nb(q, sc), _nb(d))
        da = qk.dequant_add(acc, q, sc)
        record("dequant_add", size, "float32", m, [da],
               [qref.dequant_add(acc, q, sc)],
               lambda: qk.dequant_add(acc, q, sc),
               lambda: qref.dequant_add(acc, q, sc),
               lambda: torch.addcmul(acc2d, q2d, s2d), _nb(acc, q, sc),
               _nb(da))
        del x, acc, q, sc, wq, ws, d, da, q2d, s2d, acc2d
    torch.cuda.empty_cache()
    return rows


def tp_psums(model, microbatches: int = 1) -> int:
    """All-reduces over "model" one rank makes in one step of a
    model-parallel run (through the monolithic default session's ring,
    p-1 ``sum_chunks`` launches each).  A microbatch's forward: the
    embedding's *g* (none without an embedding table), each layer's *g*
    after its mixer and its FFN (a Mamba mixer's two more: B and C
    gathered, its gated norm's mean square), the loss's sum of
    exponentials and label logit; its staged backward: each layer's *f*
    (attention's, MLA's and the MLP's; a Mamba mixer's three; a MoE
    layer's two: its input and its routing weights) and the head's.  The
    MTP head adds its embedding's *g*, its block's and its loss's, and
    the encoder-decoder its encoder's and decoder's layers (self- and
    cross-attention, MLP) and the memory's *f*.  With remat the staged
    backward reruns each checkpointed block's forward, its *g*s again
    (the stages' layers, the enc-dec's layers; not the MTP block, the
    embedding or the loss).  Once a step: the partial-sum leaves (MQA's
    K/V, qwen3's q/k norms, MLA's low-rank leaves) and the gradient
    norm.  ``tests/test_torch_tp_families.py`` and
    ``tests/test_torch_remat_tp.py`` hold the plan to a count of the
    sums one step of each reduced family makes on the CPU."""
    from repro_torch.models.encdec import EncDecCfg
    from repro_torch.parallel import sharding
    from repro_torch.tree import flatten
    cfg = model.cfg
    if isinstance(cfg, EncDecCfg):
        layers_g = 2 * cfg.enc_layers + 3 * cfg.dec_layers
        fwd = 1 + layers_g + 2
        bwd = 2 * cfg.enc_layers + 3 * cfg.dec_layers + 2
    else:
        specs = [spec for st in cfg.stages for _ in range(st.repeat)
                 for spec in st.layers]

        def g(spec):
            return (1 + 2 * (spec.mixer == "mamba")
                    + (spec.ffn != "none"))

        def f(spec):
            return (1 + 2 * (spec.mixer == "mamba")
                    + {"dense": 1, "moe": 2, "none": 0}[spec.ffn])

        layers_g = sum(g(s) for s in specs)
        if cfg.mtp:
            specs.append(cfg.stages[-1].layers[-1])
        heads = 1 + cfg.mtp
        fwd = (cfg.embed_inputs * heads + sum(g(s) for s in specs)
               + 2 * heads)
        bwd = sum(f(s) for s in specs) + heads
    rerun = layers_g if cfg.remat else 0
    paths = flatten(model.abstract_params())[1]
    partial = sum(sharding.partial_sum_leaves(paths, model.layout))
    return (fwd + bwd + rerun) * microbatches + partial + 1


def planned_launches(engine, synced, scalars, p: int, compress: bool):
    """Launches of each sync kernel on one rank in one step, as the
    session's plan predicts them, with the formula for each.  ``synced``:
    the tensors the gradient sync reduces (the leaves, or one flat
    tensor a bucket; ``meta`` tensors do); ``scalars``: the other
    all-reduced tensors of the step (the loss, ZeRO's squared norm).  A
    ZeRO reduce-scatter runs the planned all-reduce's own reduce-scatter
    half, so it combines as that all-reduce does; its all-gather adds
    nothing."""
    from repro_torch.core import costmodel, layers, registry
    combine = {costmodel.RING: lambda chunk: p - 1,
               costmodel.BIDIR_RING: lambda chunk: (p - 1) * (
                   1 if chunk % 2 else 2)}
    n_combine, terms, protocols = 0, [], []
    reduced = list(scalars) if compress else list(synced) + list(scalars)
    for t in reduced:
        proto = engine.protocol_for(registry.ALL_REDUCE, layers.nbytes(t),
                                    "data")
        chunk = -(-t.numel() // p)
        k = combine.get(proto, lambda chunk: 0)(chunk)
        n_combine += k
        protocols.append((tuple(t.shape), str(t.dtype).split(".")[-1],
                          proto, k))
    out = {"sum_chunks": (n_combine, "sum over all-reduced tensors of "
                          "(p-1) per ring, 2(p-1) per bidir ring with an "
                          "even chunk, 0 for recursive protocols")}
    if compress:
        n = len(synced)
        out["quantize"] = (n * (p + 1), f"{n} units x (p+1): p-1 ring "
                           "hops + the all-gather payload + the residual")
        out["dequantize"] = (n * p, f"{n} units x p: the own chunk + "
                             "p-1 all-gather hops")
        out["dequant_add"] = (n * p, f"{n} units x p: p-1 receive steps "
                              "+ the residual")
    return out, protocols


def _lib_kwargs(fn: str, p: int) -> dict:
    return {"reduce_scatter": {"dim": 0}, "all_gather": {"dim": 0},
            "all_to_all": {"split_dim": 0, "concat_dim": 1},
            "broadcast": {"root": 1}, "permute": {"shift": 1},
            "send_recv": {"pairs": [(j, j + 1) for j in range(p - 1)]},
            }.get(fn, {})


def _lib_expected(fn: str, xs, r: int, p: int, kw: dict):
    """The plain rearrangement a data-movement call must give rank r."""
    if fn == "all_gather":
        return torch.cat(xs, dim=kw["dim"])
    if fn == "all_to_all":
        return torch.cat([x.chunk(p, kw["split_dim"])[r] for x in xs],
                         dim=kw["concat_dim"])
    if fn == "broadcast":
        return xs[kw["root"]]
    if fn == "permute":
        return xs[(r - kw["shift"]) % p]
    src = [a for a, b in kw["pairs"] if b == r]
    return xs[src[0]] if src else torch.zeros_like(xs[0])


def _lib_combines(fn: str, proto: str, p: int, n: int) -> int:
    """``sum_chunks`` launches one rank makes in one call of ``fn`` on
    ``n`` values: p-1 a ring reduce-scatter (2(p-1) for a bidirectional
    one on an even chunk), the generic path's sums included; none for
    the recursive protocols (their adds are the reference's plain
    ``+``) or data movement."""
    from repro_torch.core import costmodel
    if proto == costmodel.XLA_DEFAULT:
        return p - 1 if fn in ("all_reduce", "reduce_scatter",
                               "broadcast") else 0
    if fn not in ("all_reduce", "reduce_scatter"):
        return 0
    chunk = -(-n // p)
    return {costmodel.RING: p - 1,
            costmodel.BIDIR_RING: (p - 1) * (1 if chunk % 2 else 2)
            }.get(proto, 0)


def _multiaxis_combines(sizes, axes, n: int) -> int:
    """``sum_chunks`` launches one rank makes in one composed all-reduce
    of ``n`` values over several ``axes``: the bidirectional ring reduce-
    scatters' ((p-1) on an odd chunk, 2(p-1) on an even one) of the
    hierarchical schedule's intra axes and of the two-phase schedule's
    two axes, and the padded pod ring's p-1 when the pod axis is not a
    power of two (recursive doubling adds with a plain ``+``)."""
    def bidir(p, chunk):
        return (p - 1) * (1 if chunk % 2 else 2)

    k, m = 0, n
    if "pod" in axes:
        for ax in axes:
            if ax != "pod":
                m = -(-m // sizes[ax])
                k += bidir(sizes[ax], m)
        pp = sizes["pod"]
        return k + (pp - 1 if pp & (pp - 1) else 0)
    c0 = -(-n // sizes[axes[0]])
    return bidir(sizes[axes[0]], c0) + bidir(sizes[axes[1]],
                                            -(-c0 // sizes[axes[1]]))


def _lib_multiaxis(axes, shape, xshape):
    """One composed all-reduce over every axis of a ``shape`` mesh on
    CUDA thread ranks, at bf16 ``xshape`` a rank: the sum bit-equal to
    the same schedule rerun with the plain combine; blocking, start/wait
    and a persistent handle bit-identical; each rank's recorded phase
    bytes equal to the communicator's ``sync_schedule`` unit (the cost
    model's ``phase_wire_bytes``); ``sum_chunks`` launches as the
    schedule counts them.  Prints the transport's wire bytes a rank
    beside the billing and the blocking call's ms.  Returns its row."""
    from repro_torch.comm import Session
    from repro_torch.kernels.local_reduce import ops as lops
    from repro_torch.runtime import substrate
    mesh = substrate.make_mesh(shape, axes, device="cuda")
    n = mesh.size
    gen = torch.Generator(device="cuda").manual_seed(n)
    xs = [torch.randn(xshape, generator=gen, device="cuda").to(
        torch.bfloat16) for _ in range(n)]
    sess = Session(mesh=mesh)
    w = sess.world
    h = w.persistent("all_reduce", xshape, torch.bfloat16)
    (unit,) = w.sync_schedule([("x", xs[0].numel(), torch.bfloat16)]).units
    billed = (unit.start_bytes, unit.wait_bytes)

    def split(x):
        w0 = substrate.sent_bytes()
        y = w.all_reduce_wait(w.all_reduce_start(x))
        return y, substrate.sent_bytes() - w0

    def run(fn):
        out = substrate.run_spmd(fn, [(x,) for x in xs], mesh)
        torch.cuda.synchronize()
        return out

    c0 = lops.counter.value
    out = run(split)
    launches = lops.counter.value - c0
    want_launches = n * _multiaxis_combines(mesh.shape, axes, xs[0].numel())
    recorded = {(ph.get("all_reduce.start", 0), ph.get("all_reduce.wait", 0))
                for ph in (sess.engine.stats.rank_phase_bytes.get(r, {})
                           for r in range(n))}
    sent = sorted({b for _, b in out})
    ys = [y for y, _ in out]
    del out
    same = all(_bits_equal(a, b) for a, b in zip(ys, run(w.all_reduce)))
    same = same and all(_bits_equal(a, b) for a, b in zip(ys, run(h)))
    with plain_sync_ops():
        plain = all(_bits_equal(a, b) for a, b in zip(ys, run(w.all_reduce)))
    del ys
    t0 = time.perf_counter()
    run(w.all_reduce)
    ms = (time.perf_counter() - t0) * 1e3
    label = "x".join(f"{a}={p}" for a, p in zip(axes, shape))
    exact = "" if sent == [sum(billed)] else " (transport != billed)"
    print(f"[collectives_lib] {label} all_reduce {unit.protocol:14s} "
          f"{tuple(xshape)} bf16: {ms:8.3f} ms; wire bytes a rank {sent}"
          f"{exact}; billed (start, wait) {billed}, recorded "
          f"{sorted(recorded)}; sum_chunks {launches} (schedule "
          f"{want_launches}); blocking = start/wait = persistent: {same}; "
          f"= plain-combine rerun: {plain}")
    if recorded != {billed}:
        raise AssertionError(f"{label}: phase bytes {recorded} != {billed}")
    if launches != want_launches:
        raise AssertionError(f"{label}: {launches} sum_chunks launches, "
                             f"schedule {want_launches}")
    if not (same and plain):
        raise AssertionError(f"{label}: arms or plain rerun differ")
    return dict(axes=axes, shape=shape, protocol=unit.protocol, ms=ms,
                sent=sent, billed=billed, launches=launches)


def _lib_call(mesh, fn: str, proto: str, mode: str, xs):
    """One call of ``fn`` on every rank of ``mesh`` through a fresh
    session (``proto`` forced when composed), checked: data movement
    against its plain rearrangement and reductions against the same
    schedule rerun with the plain combine, bit for bit; the recorded
    phase bytes of each rank against ``plan.phase_wire_bytes``; the
    ``sum_chunks`` launches against the schedule's count.  Then timed
    once more.  Returns the call's row."""
    from repro_torch.comm import Session
    from repro_torch.core import layers
    from repro_torch.core import plan as plan_mod
    from repro_torch.core.engine import EngineConfig
    from repro_torch.kernels.local_reduce import ops as lops
    from repro_torch.runtime import substrate
    p = mesh.size
    kw = _lib_kwargs(fn, p)
    sess = Session(mesh=mesh, config=EngineConfig(
        mode=mode, force_protocol={fn: proto} if mode == "composed"
        else {}))
    d = sess.split("data")

    def call(x):
        w0 = substrate.sent_bytes()
        y = (d.all_reduce_wait(d.all_reduce_start(x)) if fn == "all_reduce"
             else getattr(d, fn)(x, **kw))
        return y, substrate.sent_bytes() - w0

    def run():
        out = substrate.run_spmd(call, [(x,) for x in xs], mesh)
        torch.cuda.synchronize()
        return out

    c0 = lops.counter.value
    out = run()
    launches = lops.counter.value - c0
    want_launches = p * _lib_combines(fn, proto, p, xs[0].numel())
    phase = [dict(sess.engine.stats.rank_phase_bytes.get(r, {}))
             for r in range(p)]
    nb = layers.nbytes(xs[0])
    billed = plan_mod.phase_wire_bytes(
        proto, p, nb * p if fn == "all_gather" else nb, fn)
    recorded = {(ph.get(f"{fn}.start", 0), ph.get(f"{fn}.wait", 0))
                for ph in phase}
    sent = [w for _, w in out]
    if fn in ("all_reduce", "reduce_scatter"):
        check = "plain-combine rerun"
        with plain_sync_ops():
            plain = run()
        same = all(_bits_equal(a[0], b[0]) for a, b in zip(out, plain))
        del plain
    else:
        check = "plain rearrangement"
        same = all(_bits_equal(y, _lib_expected(fn, xs, r, p, kw))
                   for r, (y, _) in enumerate(out))
    shape = tuple(out[0][0].shape)
    del out
    t0 = time.perf_counter()
    run()
    ms = (time.perf_counter() - t0) * 1e3
    row = dict(p=p, fn=fn, mode=mode, protocol=proto, ms=ms, shape=shape,
               sent=sent, billed=billed, recorded=sorted(recorded),
               launches=launches, want_launches=want_launches, same=same)
    exact = "" if set(sent) == {sum(billed)} else " (transport != billed)"
    print(f"[collectives_lib] p={p} {fn:14s} {mode:10s} {proto:18s} "
          f"{ms:8.3f} ms; wire bytes a rank {sorted(set(sent))}{exact}; "
          f"billed (start, wait) {billed}, recorded {sorted(recorded)}; "
          f"sum_chunks {launches} (schedule {want_launches}); "
          f"{check}: {same}")
    if recorded != {billed}:
        raise AssertionError(f"{fn} {proto} p={p}: phase bytes {recorded} "
                             f"!= {billed}")
    if launches != want_launches:
        raise AssertionError(f"{fn} {proto} p={p}: {launches} sum_chunks "
                             f"launches, schedule {want_launches}")
    if not same:
        raise AssertionError(f"{fn} {proto} p={p} differs from its {check}")
    return row


def phase_collectives_lib():
    """Every function of the library on every protocol of its menu that
    takes p, and on the generic path (the monolithic engine), on CUDA
    thread ranks: p in {2, 4} at a full-width granite-34b MLP leaf
    (6144 x 24576 bf16, 302 MB a rank), p in {3, 8} at 6144 x 3072; then
    the multi-axis all-reduce (``LIB_MULTI``): two-phase on (data 2,
    model 2) at the MLP leaf and on (4, 2) at 6144 x 3072, hierarchical
    on (pod 2, data 2) and (pod 3, data 2) likewise.
    Returns ({"sum_chunks": launches}, rows)."""
    import gc
    import math
    from repro_torch.comm import Session
    from repro_torch.core import costmodel, layers
    from repro_torch.kernels import counter
    from repro_torch.runtime import substrate
    rows = []
    counter.reset_all()
    for p, shape in LIB_RANKS:
        mesh = substrate.make_mesh((p,), ("data",), device="cuda")
        topo = Session(mesh=mesh).engine.topology
        gen = torch.Generator(device="cuda").manual_seed(p)
        xs = [torch.randn(shape, generator=gen, device="cuda").to(
            torch.bfloat16) for _ in range(p)]
        nb = layers.nbytes(xs[0])
        for fn in LIB_FUNCTIONS:
            plan_nb = nb * p if fn == "all_gather" else nb
            menu = costmodel.protocol_menu(fn)
            variants = [(proto, "composed") for proto, cost in menu.items()
                        if not math.isinf(cost(plan_nb, topo, "data"))]
            for proto, mode in variants + [(costmodel.XLA_DEFAULT,
                                            "monolithic")]:
                rows.append(_lib_call(mesh, fn, proto, mode, xs))
                gc.collect()
        del xs
        gc.collect()
        torch.cuda.empty_cache()
    for axes, shape, xshape in LIB_MULTI:
        rows.append(_lib_multiaxis(axes, shape, xshape))
        gc.collect()
        torch.cuda.empty_cache()
    launches = counter.counts()["sum_chunks"]
    print(f"[collectives_lib] {len(rows)} calls checked; sum_chunks "
          f"launches {launches}")
    return {"sum_chunks": launches}, rows


def _adamw(lr: float, **kw):
    from repro_torch.optim import cosine_schedule, make_optimizer
    return make_optimizer("adamw", lr=cosine_schedule(
        lr, warmup=max(TRAIN_STEPS // 20, 1), total=TRAIN_STEPS), **kw)


def train_workload():
    """The training workload, on the card: granite-34b at its published
    widths cut to TRAIN_LAYERS layers with random bf16 weights from seed
    0, TRAIN_RANKS thread ranks, ``SyntheticLMDataset`` seed 0 (seq
    TRAIN_SEQ, global batch TRAIN_BATCH), AdamW with a cosine schedule
    from TRAIN_LR over TRAIN_STEPS steps.  Returns (model, initial
    params, mesh, dataset, optimizer)."""
    from repro_torch.configs import get_config, with_num_layers
    from repro_torch.data import SyntheticLMDataset
    from repro_torch.models import build_model
    from repro_torch.runtime import substrate
    from repro_torch.tree import leaves
    cfg = with_num_layers(get_config("granite-34b"), TRAIN_LAYERS)
    model = build_model(cfg)
    init = model.init(torch.Generator(device="cuda").manual_seed(0))
    print(f"[train] {cfg.name} d_model={cfg.d_model} heads="
          f"{cfg.attn.num_heads}/{cfg.attn.num_kv_heads} head_dim="
          f"{cfg.attn.head_dim} ff={cfg.mlp.d_ff} ({cfg.mlp.activation}) "
          f"vocab={cfg.vocab_size} layers={cfg.num_layers} block_k="
          f"{cfg.block_k}: {model.param_count() / 1e9:.3f}B params "
          f"({_nbytes(leaves(init)) / 1e9:.2f} GB bf16); {TRAIN_RANKS} "
          f"ranks, seq {TRAIN_SEQ}, global batch {TRAIN_BATCH}")
    mesh = substrate.make_host_mesh(TRAIN_RANKS, device="cuda")
    ds = SyntheticLMDataset(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                            global_batch=TRAIN_BATCH, seed=0)
    return model, init, mesh, ds, _adamw(TRAIN_LR)


def train_run(model, init, mesh, ds, opt, sync: str, **cfg):
    """A fresh session (the §2.2 scan through ``build_session``), fresh
    per-rank states of ``init`` (``trainer.init_states``: replicas, or
    for ``auto`` each rank's data block of the leaves it splits) and the
    step function for one run; ``cfg``: the other ``TrainCfg`` fields
    (buckets, overlap, ZeRO)."""
    from repro_torch.launch.train import build_session
    from repro_torch.train import trainer
    from repro_torch.tree import map_tree
    from repro_torch.comm import Session
    tcfg = trainer.TrainCfg(sync_mode=sync, **cfg)
    # auto: the conventional stack, as the launcher builds it
    session = (Session(mesh=mesh, mode="monolithic") if sync == "auto"
               else build_session(mesh, model, opt, ds, tcfg))
    states = trainer.init_states(model, opt,
                                 map_tree(lambda t: t.clone(), init), tcfg,
                                 mesh)
    return session, states, trainer.make_train_step(model, opt, tcfg,
                                                    comm=session.world)


@contextlib.contextmanager
def plain_sync_ops():
    """Point the gradient sync's ops at their plain versions (``ref``)
    while the block runs, on CUDA tensors too: the other side of the
    whole-step comparison.  The package has no such switch; its ops take
    the kernels for every CUDA tensor."""
    from repro_torch.kernels.local_reduce import ops as lops
    from repro_torch.kernels.local_reduce import ref as lref
    from repro_torch.kernels.quantize import ops as qops
    from repro_torch.kernels.quantize import ref as qref
    saved = (lops.sum_chunks, qops.quantize, qops.dequantize,
             qops.dequant_add)
    lops.sum_chunks = lambda chunks, dtype=None: lref.sum_chunks(
        list(chunks), dtype)
    qops.quantize = lambda x, block=qref.QBLOCK: qref.quantize(x, block)
    qops.dequantize = (lambda q, s, block=qref.QBLOCK, dtype=torch.float32:
                       qref.dequantize(q, s, block, dtype))
    qops.dequant_add = (lambda acc, q, s, block=qref.QBLOCK:
                        qref.dequant_add(acc, q, s, block))
    try:
        yield
    finally:
        (lops.sum_chunks, qops.quantize, qops.dequantize,
         qops.dequant_add) = saved


def _train_steps(step_fn, states, ds):
    """TRAIN_STEPS steps; returns (states, losses, seconds a step,
    last metrics with ``grad_norms``: each step's global gradient
    norm)."""
    losses, times, norms = [], [], []
    for step in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        states, metrics = step_fn(states, ds.host_batch(step))
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(metrics["loss"].item())
        norms.append(metrics["grad_norm"].item())
    return states, losses, times, dict(metrics, grad_norms=norms)


def phase_train_small():
    """Reduced granite-34b: 3 training steps over 2 thread ranks through
    the sync kernels on the card and through the plain path on the CPU,
    from the same f32 weights, composed and compressed."""
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLMDataset
    from repro_torch.models import build_model
    from repro_torch.runtime import substrate
    from repro_torch.tree import map_tree
    cfg = get_config("granite-34b", reduced=True)
    model = build_model(cfg)
    init = model.init(torch.Generator().manual_seed(0))
    ds = SyntheticLMDataset(vocab_size=cfg.vocab_size,
                            seq_len=SMALL_TRAIN_SEQ, global_batch=4, seed=0)
    opt = _adamw(TRAIN_LR)
    for sync in ("composed", "compressed"):
        losses = {}
        for dev in ("cpu", "cuda"):
            mesh = substrate.make_host_mesh(2, device=dev)
            _, states, step_fn = train_run(
                model, map_tree(lambda t: t.to(dev), init), mesh, ds, opt,
                sync)
            losses[dev] = _train_steps(step_fn, states, ds)[1]
        err = max(abs(a - b) / abs(b) for a, b in zip(losses["cuda"],
                                                      losses["cpu"]))
        print(f"[train_small] reduced granite-34b {sync}, seq "
              f"{SMALL_TRAIN_SEQ} ({SMALL_TRAIN_SEQ // cfg.block_k} key "
              f"blocks): card {losses['cuda']} vs CPU {losses['cpu']}; max "
              f"rel err {err:.3e} (tol {SMALL_LOSS_RTOL[sync]})")
        if not err <= SMALL_LOSS_RTOL[sync]:
            raise AssertionError(f"{sync}: card and CPU losses differ")


def phase_train():
    """granite-34b at its published widths (2 of 88 layers) trained over
    TRAIN_RANKS thread ranks on the card: four runs of TRAIN_STEPS steps,
    {composed, compressed} x {sync kernels, plain}, then a composed run
    at LOW_LR whose loss must fall."""
    import gc
    from repro_torch.kernels import counter
    from repro_torch.tree import leaves
    model, init, mesh, ds, opt = train_workload()
    p = TRAIN_RANKS
    results, out = {}, {}
    for sync in ("composed", "compressed"):
        for on in (True, False):
            session, states, step_fn = train_run(model, init, mesh, ds,
                                                 opt, sync)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            counter.reset_all()
            with (contextlib.nullcontext() if on else plain_sync_ops()):
                states, losses, times, metrics = _train_steps(
                    step_fn, states, ds)
            counts = counter.counts()
            peak = torch.cuda.max_memory_allocated()
            same = all(_bits_equal(a, b) for st in states[1:] for a, b in
                       zip(leaves(states[0]["params"]),
                           leaves(st["params"])))
            tag = f"{sync}, {'kernels' if on else 'plain'}"
            step_s = float(np.mean(times[1:]))
            print(f"[train] {tag}: losses {losses}; step {step_s * 1e3:.1f}"
                  f" ms (steps 2-{TRAIN_STEPS}; first "
                  f"{times[0] * 1e3:.1f} ms) = "
                  f"{TRAIN_BATCH * TRAIN_SEQ / step_s:.0f} tokens/s; peak "
                  f"allocated {peak / 2**30:.2f} GiB; replicas identical: "
                  f"{same}")
            if not all(np.isfinite(losses)):
                raise AssertionError(f"{tag}: losses {losses}")
            if not same:
                raise AssertionError(f"{tag}: replicas differ")
            if not peak < 0.95 * torch.cuda.get_device_properties(
                    0).total_memory:
                raise AssertionError(f"{tag}: peak {peak} near the card")
            plan, protocols = planned_launches(
                session.engine, leaves(states[0]["params"]),
                [metrics["loss"]], p, sync == "compressed")
            main = ("sum_chunks",) if sync == "composed" else (
                "quantize", "dequantize", "dequant_add")
            for name in SYNC_KERNELS:
                per, formula = plan.get(name, (0, "not on this path"))
                want = per * p * TRAIN_STEPS if on else 0
                if on and per:
                    print(f"[train]   {name}: {counts[name]} launches; plan "
                          f"{want} = {per} a rank a step x {p} ranks x "
                          f"{TRAIN_STEPS} steps ({formula})")
                if counts[name] != want or (on and name in main
                                            and not want):
                    raise AssertionError(f"{tag}: {name} launched "
                                         f"{counts[name]} times, plan "
                                         f"{want}")
                if on and name in main:
                    out[name] = counts[name]
            if on:
                for shape, dt, proto, k in protocols:
                    print(f"[train]   all_reduce {dt} {shape}: {proto} "
                          f"({k} combine launches a rank a step)")
                out[f"{sync}_step_ms"] = step_s * 1e3
                out[f"{sync}_peak_gib"] = peak / 2**30
                out[f"{sync}_losses"] = losses
                out[f"{sync}_grad_norms"] = metrics["grad_norms"]
                out[f"{sync}_avg_layer"] = session.average_layer_number()
            # rank 0's params, no longer written once its run is over
            results[(sync, on)] = (losses, leaves(states[0]["params"]))
            del states, step_fn, session, metrics
            gc.collect()
            torch.cuda.empty_cache()
        (l_on, p_on), (l_off, p_off) = results.pop((sync, True)), \
            results.pop((sync, False))
        same = l_on == l_off and all(_bits_equal(a, b)
                                     for a, b in zip(p_on, p_off))
        print(f"[train] {sync}: the kernel and plain runs give "
              f"bit-identical losses and parameters: {same}")
        if not same:
            raise AssertionError(f"{sync}: kernel and plain runs differ")
        if sync == "composed":
            out.update(_remat_off_run(model, init, mesh, ds, opt, l_on,
                                      p_on, out))
        del p_on, p_off
    session, states, step_fn = train_run(model, init, mesh, ds,
                                         _adamw(LOW_LR), "composed")
    losses = _train_steps(step_fn, states, ds)[1]
    falls = all(b < a for a, b in zip(losses, losses[1:]))
    print(f"[train] composed, kernels, lr {LOW_LR}: losses {losses}; "
          f"falling: {falls}")
    if not falls:
        raise AssertionError(f"lr {LOW_LR}: losses {losses} do not fall")
    del states, step_fn, session, init
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _remat_off_run(model, init, mesh, ds, opt, losses, params, on):
    """[train]'s composed kernel run once more with ``remat=False``: its
    step time and peak printed beside the remat run's (``on``: [train]'s
    numbers), its losses and parameters held to the remat run's
    (``losses``, rank 0's ``params``) bit for bit.  Returns its
    numbers."""
    import dataclasses
    import gc
    from repro_torch.models import build_model
    from repro_torch.tree import leaves
    off = build_model(dataclasses.replace(model.cfg, remat=False))
    session, states, step_fn = train_run(off, init, mesh, ds, opt,
                                         "composed")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    states, l_off, times, _ = _train_steps(step_fn, states, ds)
    peak = torch.cuda.max_memory_allocated()
    step_s = float(np.mean(times[1:]))
    same = l_off == losses and all(_bits_equal(a, b) for a, b in zip(
        leaves(states[0]["params"]), params))
    print(f"[train] composed, kernels, remat off: losses {l_off}; step "
          f"{step_s * 1e3:.1f} ms, peak allocated {peak / 2**30:.2f} GiB; "
          f"remat on: step {on['composed_step_ms']:.1f} ms, peak "
          f"{on['composed_peak_gib']:.2f} GiB; losses and parameters "
          f"bit-identical: {same}")
    if not same:
        raise AssertionError("remat on and off give other bits")
    del states, step_fn, session
    gc.collect()
    torch.cuda.empty_cache()
    return {"remat_off_step_ms": step_s * 1e3,
            "remat_off_peak_gib": peak / 2**30}


def split_collectives(model, tcfg, mesh) -> tuple:
    """(the reduce-scatters over "data" of a microbatch of the ``auto``
    step split over "data", the leaves it averages whole): one for each
    layer of a split stacked leaf, its gathered weight's gradient in the
    staged backward; one for each use of the embedding, the head and the
    MTP projection; the leaves whole over "data" are all-reduced once a
    step (``trainer._auto_train_step``)."""
    from repro_torch.train import trainer
    from repro_torch.tree import flatten
    ps, paths = flatten(model.abstract_params())
    dims = trainer._data_axis(model, tcfg, mesh, None).dims
    cfg = model.cfg
    mtp = int(bool(getattr(cfg, "mtp", False))
              and getattr(cfg, "embed_inputs", True))
    uses = {"embed": 1 + int(bool(getattr(cfg, "tie_embeddings", False)))
            + mtp, "lm_head": 1 + mtp, "mtp_proj": 1}
    n = whole = 0
    for path, leaf, d in zip(paths, ps, dims):
        if d is None:
            whole += 1
        elif len(path) == 1:
            n += uses[path[0]]
        else:           # a stack's layer at a time; the MTP block once
            n += 1 if path[0] == "mtp_block" else leaf.shape[0]
    return n, whole


def phase_train_auto(train):
    """The train workload as ``sync="auto"`` in the reference's layout
    over "data" (its FSDP): each rank holds its data block of every leaf
    the reference's specs split over "data" (params, gradient
    accumulator, AdamW moments), gathers a layer's whole weights over
    "data" as it runs (forward and remat rerun) and reduce-scatters
    their gradients into its accumulator in the staged backward; the
    other leaves (and the loss) averaged by ``collectives.pmean``, all
    through the monolithic default session.  TRAIN_STEPS steps from the
    same weights and batches as [train]'s composed run (``train``: its
    numbers), losses within AUTO_LOSS_RTOL of them; the ranks' blocks
    join into a finite global tree, each rank holds the bytes of its
    blocks as ``trainer.abstract_state`` plans them, and ``sum_chunks``
    launches as ``split_collectives`` counts.  Returns ({"sum_chunks":
    launches}, numbers)."""
    import gc
    from repro_torch.comm import collectives
    from repro_torch.kernels import counter
    from repro_torch.train import trainer
    from repro_torch.tree import leaves
    model, init, mesh, ds, opt = train_workload()
    p = mesh.size
    tcfg = trainer.TrainCfg(sync_mode="auto")
    session, states, step_fn = train_run(model, init, mesh, ds, opt, "auto")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counter.reset_all()
    states, losses, times, _ = _train_steps(step_fn, states, ds)
    counts = counter.counts()
    peak = torch.cuda.max_memory_allocated()
    plan_bytes = _nbytes(leaves(trainer.abstract_state(model, opt, tcfg,
                                                       mesh)))
    whole_bytes = _nbytes(leaves(trainer.make_train_state(
        model, opt, model.abstract_params(), tcfg)))
    held = [_nbytes(leaves(st)) for st in states]
    tree = trainer.logical_state(trainer.gather_state(states, tcfg, mesh,
                                                      model))
    finite = all(bool(torch.isfinite(t).all()) for t in leaves(tree)
                 if t.is_floating_point())
    step_s = float(np.mean(times[1:]))
    want = train["composed_losses"]
    err = max(abs(a - b) / abs(b) for a, b in zip(losses, want))
    default = collectives.session()
    mono_avg = default.average_layer_number()
    n_rs, n_whole = split_collectives(model, tcfg, mesh)
    per = (n_rs * tcfg.microbatches + n_whole + 2) * (p - 1)
    plan = per * p * TRAIN_STEPS
    print(f"[train_auto] auto (monolithic default session, "
          f"{'composed' if default.engine.composed else 'monolithic'}), "
          f"split over \"data\": losses {losses}; composed {want}; max rel "
          f"err {err:.3e} (tol {AUTO_LOSS_RTOL}); bit-identical "
          f"{losses == want}")
    print(f"[train_auto] state a rank {held} bytes (plan {plan_bytes:,d}; "
          f"whole over \"data\" {whole_bytes:,d}); the ranks' blocks join "
          f"into a global tree of finite leaves: {finite}")
    print(f"[train_auto] step {step_s * 1e3:.1f} ms (steps 2-{TRAIN_STEPS}; "
          f"first {times[0] * 1e3:.1f} ms) = "
          f"{TRAIN_BATCH * TRAIN_SEQ / step_s:.0f} tokens/s, peak allocated "
          f"{peak / 2**30:.2f} GiB; composed {train['composed_step_ms']:.1f}"
          f" ms, {train['composed_peak_gib']:.2f} GiB")
    print(f"[train_auto] average layer number: monolithic {mono_avg:.3f}, "
          f"composed {train['composed_avg_layer']:.6f}")
    print(f"[train_auto]   sum_chunks: {counts['sum_chunks']} launches; "
          f"plan {plan} = ({n_rs} reduce-scatters x "
          f"{tcfg.microbatches} microbatch + {n_whole} whole leaves + the "
          f"loss + the norm) x (p-1) ring combines x {p} ranks x "
          f"{TRAIN_STEPS} steps")
    if not all(np.isfinite(losses)) or not finite or any(
            h != plan_bytes for h in held) or not plan_bytes < whole_bytes:
        raise AssertionError(f"auto: losses {losses}, finite {finite}, "
                             f"held {held} vs {plan_bytes}")
    if not err <= AUTO_LOSS_RTOL:
        raise AssertionError(f"auto losses {losses} vs composed {want}")
    if default.engine.composed or mono_avg != 2.0:
        raise AssertionError(f"default session: {default.describe()}")
    if counts["sum_chunks"] != plan or any(
            counts[k] for k in ("quantize", "dequantize", "dequant_add")):
        raise AssertionError(f"auto launches {counts}, plan {plan}")
    numbers = dict(step_ms=step_s * 1e3, peak_gib=peak / 2**30,
                   losses=losses, mono_avg=mono_avg, state_bytes=held[0],
                   whole_bytes=whole_bytes)
    del states, step_fn, session, init, tree
    gc.collect()
    torch.cuda.empty_cache()
    return {"sum_chunks": counts["sum_chunks"]}, numbers


def _replicas_check(mesh, model, states) -> bool:
    """Data replicas (one model coordinate) hold the same parameters, and
    every leaf the model ranks all hold whole is the same on every
    rank."""
    from repro_torch.parallel import sharding
    from repro_torch.tree import flatten, leaves
    paths = flatten(states[0]["params"])[1]
    coord = [mesh.coords(r).get("model", 0) for r in range(mesh.size)]
    ok = True
    for r, st in enumerate(states):
        first = states[coord.index(coord[r])]
        ok = ok and all(_bits_equal(a, b) for a, b in zip(
            leaves(first["params"]), leaves(st["params"])))
        if model.layout is not None:
            ok = ok and all(
                _bits_equal(a, b) for path, a, b in zip(
                    paths, leaves(states[0]["params"]),
                    leaves(st["params"]))
                if sharding.leaf_split(path, model.layout) is None)
    return ok


def _mesh_run(model, init, mesh, ds, opt, sync, plain=False, **cfg):
    """A fresh session and per-rank states (``trainer.init_states``: each
    rank's shard of ``init``) on ``mesh``, TRAIN_STEPS steps (with the
    plain sync ops when ``plain``); ``cfg``: other ``TrainCfg`` fields.
    ``init`` is the full params, or a function that makes them anew (for
    a model that the card holds once only: they are dropped once the
    states hold them).  Returns (losses, step seconds, first step
    seconds, peak bytes, launches, session, step function, states,
    metrics)."""
    from repro_torch.comm import Session
    from repro_torch.kernels import counter
    from repro_torch.launch.train import build_session
    from repro_torch.train import trainer
    from repro_torch.tree import map_tree
    tcfg = trainer.TrainCfg(sync_mode=sync, **cfg)
    # auto: the conventional stack, as the launcher builds it
    session = (Session(mesh=mesh, mode="monolithic") if sync == "auto"
               else build_session(mesh, model, opt, ds, tcfg))
    # without a model axis rank 0's state holds the tensors it is given,
    # which the optimizer updates in place
    params = init() if callable(init) else (
        init if model.layout is not None
        else map_tree(lambda t: t.clone(), init))
    states = trainer.init_states(model, opt, params, tcfg, mesh)
    del params
    step_fn = trainer.make_train_step(model, opt, tcfg, comm=session.world)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counter.reset_all()
    with (plain_sync_ops() if plain else contextlib.nullcontext()):
        states, losses, times, metrics = _train_steps(step_fn, states, ds)
    return (losses, float(np.mean(times[1:])), times[0],
            torch.cuda.max_memory_allocated(), counter.counts(), session,
            step_fn, states, metrics)


def phase_train_tp(train):
    """granite-34b at its published widths (TRAIN_LAYERS of 88 layers)
    on a (data TRAIN_RANKS, model TP_MODEL) mesh of thread ranks:
    {composed, compressed} x {sync kernels, plain}, TRAIN_STEPS steps a
    run from [train]'s weights and batches.  Returns ({kernel:
    launches}, numbers)."""
    import gc
    from repro_torch.configs import get_config, with_num_layers
    from repro_torch.data import SyntheticLMDataset
    from repro_torch.models import build_model
    from repro_torch.runtime import substrate
    from repro_torch.tree import leaves
    cfg = with_num_layers(get_config("granite-34b"), TRAIN_LAYERS)
    model = build_model(cfg, model_parallel=TP_MODEL)
    init = model.init(torch.Generator(device="cuda").manual_seed(0))
    mesh = substrate.make_host_mesh(TRAIN_RANKS, model_parallel=TP_MODEL,
                                    device="cuda")
    ds = SyntheticLMDataset(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                            global_batch=TRAIN_BATCH, seed=0)
    lay = model.layout
    print(f"[train_tp] {cfg.name} {cfg.num_layers} layers on "
          f"{dict(mesh.shape)}: a rank holds {lay.heads} of "
          f"{cfg.attn.num_heads} query heads, K/V "
          f"{'replicated' if lay.kv_replicated else 'split'} "
          f"({lay.kv_heads} head), {lay.d_ff} of {cfg.mlp.d_ff} FFN "
          f"columns, {lay.vocab} of {cfg.vocab_size} vocabulary rows; "
          f"{TRAIN_BATCH // TRAIN_RANKS} rows a data rank, seq {TRAIN_SEQ}")
    psums = tp_psums(model)
    out, numbers = {}, {}
    for sync in ("composed", "compressed"):
        results = {}
        for on in (True, False):
            (losses, step_s, first_s, peak, counts, session, step_fn,
             states, metrics) = _mesh_run(model, init, mesh, ds,
                                          _adamw(TRAIN_LR), sync,
                                          plain=not on)
            same = _replicas_check(mesh, model, states)
            tag = f"{sync}, {'kernels' if on else 'plain'}"
            print(f"[train_tp] {tag}: losses {losses}; step "
                  f"{step_s * 1e3:.1f} ms (steps 2-{TRAIN_STEPS}; first "
                  f"{first_s * 1e3:.1f} ms) = "
                  f"{TRAIN_BATCH * TRAIN_SEQ / step_s:.0f} tokens/s; peak "
                  f"allocated {peak / 2**30:.2f} GiB; replicas identical: "
                  f"{same}")
            if not all(np.isfinite(losses)) or not same:
                raise AssertionError(f"{tag}: losses {losses}, replicas "
                                     f"{same}")
            plan, _ = planned_launches(
                session.engine, leaves(states[0]["params"]),
                [metrics["loss"]], TRAIN_RANKS, sync == "compressed")
            n_sum, formula = plan["sum_chunks"]
            plan["sum_chunks"] = (
                n_sum + psums * (TP_MODEL - 1),
                f"the data sync's {n_sum} ({formula}) + {psums} all-reduces"
                f" over \"model\" x (p-1)")
            for name in SYNC_KERNELS:
                per, formula = plan.get(name, (0, "not on this path"))
                want = per * mesh.size * TRAIN_STEPS if on else 0
                if on and per:
                    print(f"[train_tp]   {name}: {counts[name]} launches; "
                          f"plan {want} = {per} a rank a step x "
                          f"{mesh.size} ranks x {TRAIN_STEPS} steps "
                          f"({formula})")
                if counts[name] != want:
                    raise AssertionError(f"{tag}: {name} launched "
                                         f"{counts[name]} times, plan "
                                         f"{want}")
                if on and per:
                    out[name] = out.get(name, 0) + counts[name]
            if on:
                numbers[f"{sync}_step_ms"] = step_s * 1e3
                numbers[f"{sync}_peak_gib"] = peak / 2**30
                numbers[f"{sync}_losses"] = losses
                numbers[f"{sync}_grad_norms"] = metrics["grad_norms"]
            results[on] = (losses, [leaves(st["params"])
                                    for st in states[:TP_MODEL]])
            del states, step_fn, session, metrics
            gc.collect()
            torch.cuda.empty_cache()
        (l_on, p_on), (l_off, p_off) = results[True], results[False]
        same = l_on == l_off and all(
            _bits_equal(a, b) for ra, rb in zip(p_on, p_off)
            for a, b in zip(ra, rb))
        print(f"[train_tp] {sync}: the kernel and plain runs give "
              f"bit-identical losses and parameters: {same}")
        if not same:
            raise AssertionError(f"{sync}: kernel and plain runs differ")
        if sync == "composed":
            numbers.update(_tp_remat_off_run(model, init, mesh, ds, l_on,
                                             p_on, numbers))
        del results, p_on, p_off
    want = train["composed_losses"]
    got = numbers["composed_losses"]
    errs = [abs(a - b) / abs(b) for a, b in zip(got, want)]
    print(f"[train_tp] composed against [train]'s composed (no model "
          f"axis): {got} vs {want}; rel err {['%.3e' % e for e in errs]} "
          f"(tol {TP_LOSS_RTOL})")
    if not max(errs) <= TP_LOSS_RTOL:
        raise AssertionError(f"model-parallel losses {got} vs {want}")
    numbers["rel_err"] = errs
    _norms_check("train_tp", "composed against [train]'s composed",
                 numbers["composed_grad_norms"],
                 train["composed_grad_norms"], TP_NORM_RTOL)
    del init
    gc.collect()
    torch.cuda.empty_cache()
    return out, numbers


def _tp_remat_off_run(model, init, mesh, ds, losses, params, on):
    """[train_tp]'s composed kernel run once more with ``remat=False``:
    its step time, peak and model-axis all-reduces printed beside the
    remat run's (``on``: its numbers), its losses and every model rank's
    parameters held to the remat run's (``losses``, ``params``) bit for
    bit, its ``sum_chunks`` launches to the plan without the reruns.
    Returns its numbers."""
    import dataclasses
    import gc
    from repro_torch.models import build_model
    from repro_torch.tree import leaves
    off = build_model(dataclasses.replace(model.cfg, remat=False),
                      model_parallel=TP_MODEL)
    (l_off, step_s, _, peak, counts, session, step_fn, states,
     metrics) = _mesh_run(off, init, mesh, ds, _adamw(TRAIN_LR), "composed")
    _train_check("train_tp", "composed, kernels, remat off", off, mesh,
                 session, states, metrics, counts, l_off, True,
                 extra_psums=tp_psums(off))
    same = l_off == losses and all(
        _bits_equal(a, b) for st, ps in zip(states[:TP_MODEL], params)
        for a, b in zip(leaves(st["params"]), ps))
    print(f"[train_tp] composed, kernels, remat off: losses {l_off}; step "
          f"{step_s * 1e3:.1f} ms, peak allocated {peak / 2**30:.2f} GiB, "
          f"{tp_psums(off)} model-axis all-reduces a rank a step; remat "
          f"on: step {on['composed_step_ms']:.1f} ms, peak "
          f"{on['composed_peak_gib']:.2f} GiB, {tp_psums(model)}; losses "
          f"and every model rank's parameters bit-identical: {same}")
    if not same:
        raise AssertionError("train_tp: remat on and off give other bits")
    del states, step_fn, session, metrics
    gc.collect()
    torch.cuda.empty_cache()
    return {"remat_off_step_ms": step_s * 1e3,
            "remat_off_peak_gib": peak / 2**30,
            "remat_off_sum_chunks": counts["sum_chunks"]}


def _train_check(phase, tag, model, mesh, session, states, metrics, counts,
                 losses, kernels: bool, extra_psums=0, sync="composed",
                 zero=False, synced=None):
    """The checks every [train_moe] and large-arch run makes: finite
    losses, identical replicas (and model-replicated leaves), and each
    sync kernel's launches equal to the plan's count (the data sync's,
    of ``synced`` if given, else of the params' leaves; plus
    ``extra_psums`` model-axis all-reduces of p-1 combines each, a rank
    a step; ZeRO's squared norm is a second all-reduced scalar; 0 for a
    run with the plain sync ops)."""
    from repro_torch.tree import leaves
    same = _replicas_check(mesh, model, states)
    plan, _ = planned_launches(session.engine, synced or leaves(
                                   states[0]["params"]),
                               [metrics["loss"]] * (2 if zero else 1),
                               dict(mesh.shape)["data"], sync == "compressed")
    per = plan["sum_chunks"][0] + extra_psums * (TP_MODEL - 1)
    want = per * mesh.size * TRAIN_STEPS if kernels else 0
    print(f"[{phase}]   {tag}: sum_chunks {counts['sum_chunks']} launches; "
          f"plan {want} = {per} a rank a step ({plan['sum_chunks'][0]} "
          f"data sync + {extra_psums} model-axis all-reduces x "
          f"{TP_MODEL - 1}) x {mesh.size} ranks x {TRAIN_STEPS} steps; "
          f"replicas identical: {same}")
    if not all(np.isfinite(losses)) or not same:
        raise AssertionError(f"{tag}: losses {losses}, replicas {same}")
    if counts["sum_chunks"] != want:
        raise AssertionError(f"{tag}: sum_chunks launched "
                             f"{counts['sum_chunks']} times, plan {want}")
    for name in SYNC_KERNELS[1:]:
        per_q, formula = plan.get(name, (0, "not on this path"))
        want_q = per_q * mesh.size * TRAIN_STEPS if kernels else 0
        if per_q and kernels:
            print(f"[{phase}]   {tag}: {name} {counts[name]} launches; plan "
                  f"{want_q} = {per_q} a rank a step x {mesh.size} ranks x "
                  f"{TRAIN_STEPS} steps ({formula})")
        if counts[name] != want_q or (sync == "compressed" and kernels
                                      and not want_q):
            raise AssertionError(f"{tag}: {name} launched {counts[name]} "
                                 f"times, plan {want_q}")


def _opt_bytes(states):
    """Each rank's optimizer-state bytes."""
    from repro_torch.tree import leaves
    return [sum(t.numel() * t.element_size() for t in leaves(st["opt"]))
            for st in states]


def _adafactor(lr: float, **kw):
    from repro_torch.optim import cosine_schedule, make_optimizer
    return make_optimizer("adafactor", lr=cosine_schedule(
        lr, warmup=max(TRAIN_STEPS // 20, 1), total=TRAIN_STEPS), **kw)


def adafactor_psums(model, opt, zero: bool = False) -> int:
    """Model-axis all-reduces the Adafactor ``opt``'s update adds a rank
    a step (the trainer's ``split_sum`` hook, p-1 ``sum_chunks`` launches
    each), read off ``opt``'s own state of the global params and
    ``sharding.leaf_split``: per leaf split over "model" its RMS clip's
    sum of squares (none where the clip groups are the leaf's leading
    slices and the split is of that dim: an expert stack of one layer,
    each rank clipping its own experts), one for each statistic left
    whole by a mean over the split dim, and the normaliser's mean over a
    ``vr`` split at -1.  With ``zero`` (ZeRO-1: each rank a piece of
    every leaf's chunk, unfactored) one clip sum a leaf."""
    from repro_torch.models import build_model
    from repro_torch.optim.optimizer import clip_groups
    from repro_torch.parallel import sharding
    from repro_torch.tree import flatten
    lay = model.layout
    params = build_model(model.cfg).abstract_params()
    if zero:
        return len(flatten(params)[0])
    shapes = dict(zip(flatten(params)[1],
                      (tuple(t.shape) for t in flatten(params)[0])))
    state = opt.init(params)
    stats = {}
    for path in flatten({"opt": state})[1]:
        if path[1] == "f":
            pp = sharding.opt_leaf(path, lay)[0]
            stats.setdefault(pp, {})[path[-1]] = sharding.leaf_split(path,
                                                                     lay)
    n = 0
    for pp, split in stats.items():
        dim, shape = sharding.leaf_split(pp, lay), shapes[pp]
        if dim is None:
            continue
        n += dim != -len(shape) or clip_groups(shape) == 1  # the RMS clip
        n += sum(split.get(k, 0) is None for k in ("vr", "vc"))  # means
        n += split.get("vr") == -1                      # the normaliser
    return n


class _VLBatches:
    """[train_vl]'s data: ``SyntheticLMDataset``'s embeddings batches with
    M-RoPE positions that differ per section and per row (Qwen2-VL's
    vision positions, row r's text moved on by 5r + step, as in
    ``tests/test_torch_train_embeds.py``; the dataset's own are one
    ``arange`` in every row and section), and text that carries its
    tokens.  The dataset's ``inputs_embeds`` are noise drawn apart from
    its labels, so a model can learn no more than the labels' unigram
    from them, and at LOW_LR the loss of 3 steps on 3 batches did not
    fall (12.348, 12.436, 12.373 on an NVIDIA H100 80GB HBM3, PERF.md).
    The text positions (the last 3/4 of a row) here take their token's
    row of a fixed table (``TEXT_TABLE`` rows, N(0, 0.02^2), seed 0, by
    the token id modulo its size), as an embedding table gives a VLM's
    text; the image quarter keeps the dataset's noise."""

    TEXT_TABLE = 4096

    def __init__(self, ds, d_model: int):
        self.ds = ds
        self.table = np.random.default_rng(0).standard_normal(
            (self.TEXT_TABLE, d_model), dtype=np.float32) * np.float32(0.02)

    def host_batch(self, step):
        from repro_torch.models.frontends import vision_positions
        batch = self.ds.host_batch(step)
        b, s = batch["labels"].shape
        pos = vision_positions(b, s).numpy().copy()
        pos[:, :, s // 4:] += (5 * np.arange(b, dtype=np.int32)
                               + step)[None, :, None]
        batch["positions"] = pos
        text = batch["tokens"][:, s // 4:] % self.TEXT_TABLE
        batch["inputs_embeds"][:, s // 4:] = self.table[text]
        return batch


class _FrameBatches:
    """[train_seamless]'s data: ``SyntheticLMDataset``'s tokens and
    labels beside ``frame_embeds`` (B, S, ``d_model``) f32, N(0, 0.05^2)
    from numpy seeded by (seed, step); the dataset has no frames."""

    def __init__(self, ds, d_model: int):
        self.ds, self.d_model = ds, d_model

    def host_batch(self, step):
        batch = self.ds.host_batch(step)
        rng = np.random.default_rng([self.ds.seed, step])
        batch["frame_embeds"] = rng.standard_normal(
            batch["labels"].shape + (self.d_model,),
            dtype=np.float32) * np.float32(0.05)
        return batch


def _train_data(cfg, batch=TRAIN_BATCH, **kw):
    """[train]'s ``SyntheticLMDataset`` for ``cfg`` (``batch`` rows a
    step; ``kw``: its embeddings options)."""
    from repro_torch.data import SyntheticLMDataset
    return SyntheticLMDataset(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                              global_batch=batch, seed=0, **kw)


def _tokens(ds) -> int:
    """Tokens a step of the dataset ``ds`` (a ``SyntheticLMDataset``, or
    ``_VLBatches`` / ``_FrameBatches`` around one)."""
    base = getattr(ds, "ds", ds)
    return base.global_batch * base.seq_len


def _large_workload(phase, arch, layers=None, data=_train_data, cut=None,
                    ranks=TRAIN_RANKS, lazy=False):
    """``arch`` at its published widths cut to ``layers`` layers (None:
    full depth; ``cut``: a function cutting the config instead), random
    bf16 weights from seed 0 on the card, the data ``data(cfg)``, over
    ``ranks`` data ranks: (model, initial params, mesh, dataset).  With
    ``lazy`` the params are a function that makes them anew (the same
    bits each call), for a model the card holds once only."""
    from repro_torch.configs import get_config, with_num_layers
    from repro_torch.models import build_model
    from repro_torch.models.encdec import EncDecCfg
    from repro_torch.runtime import substrate
    from repro_torch.tree import leaves
    full = get_config(arch)
    cfg = full if layers is None else with_num_layers(full, layers)
    cfg = cfg if cut is None else cut(cfg)
    model = build_model(cfg)

    def make():
        return model.init(torch.Generator(device="cuda").manual_seed(0))

    init = make if lazy else make()
    mesh = substrate.make_host_mesh(ranks, device="cuda")
    ds = data(cfg)
    if isinstance(cfg, EncDecCfg):
        a = cfg.attn
        desc = (f"encoder {cfg.enc_layers} + decoder {cfg.dec_layers} "
                f"layers, heads={a.num_heads}/{a.num_kv_heads} head_dim="
                f"{a.head_dim} ff={cfg.mlp.d_ff} ({cfg.mlp.activation})")
    else:
        desc = f"{_mixer_desc(cfg)} {_ffn_desc(cfg)}"
    print(f"[{phase}] {cfg.name} d_model={cfg.d_model} "
          f"{desc} vocab={cfg.vocab_size} remat={cfg.remat} "
          f"layers={cfg.num_layers} of {full.num_layers}: "
          f"{model.param_count() / 1e9:.3f}B params "
          f"({_nbytes(leaves(model.abstract_params())) / 1e9:.2f} GB bf16 "
          f"a replica); {dict(mesh.shape)}, seq {TRAIN_SEQ}, global batch "
          f"{_tokens(ds) // TRAIN_SEQ}; {card()}")
    return model, init, mesh, ds


def _large_run(phase, tag, model, init, mesh, ds, opt, sync="composed",
               plain=False, extra_psums=0, synced=None, **cfg):
    """One run through ``_mesh_run``, printed and checked as
    ``_train_check`` checks it, its peak held below 95% of the card.
    Returns (losses, grad norms, step ms, peak GiB, launches, rank 0's
    params, states)."""
    (losses, step_s, first_s, peak, counts, session, step_fn, states,
     metrics) = _mesh_run(model, init, mesh, ds, opt, sync, plain=plain,
                          **cfg)
    print(f"[{phase}] {tag}: losses {losses}; step {step_s * 1e3:.1f} ms "
          f"(steps 2-{TRAIN_STEPS}; first {first_s * 1e3:.1f} ms) = "
          f"{_tokens(ds) / step_s:.0f} tokens/s; peak "
          f"allocated {peak / 2**30:.2f} GiB")
    if not peak < 0.95 * torch.cuda.get_device_properties(0).total_memory:
        raise AssertionError(f"{tag}: peak {peak} near the card")
    _train_check(phase, tag, model, mesh, session, states, metrics, counts,
                 losses, not plain, extra_psums, sync=sync,
                 zero=cfg.get("zero", False), synced=synced)
    del session, step_fn
    return (losses, metrics["grad_norms"], step_s * 1e3, peak / 2**30,
            counts, states)


def _kernels_plain_low_lr(phase, model, init, mesh, ds, make_opt,
                          check=None, **cfg):
    """The three runs every large-arch phase makes: data-parallel
    composed with the sync kernels and with the plain sync ops (the same
    bits), then at LOW_LR (the last step's loss below the first's).
    ``check(params)``, given the kernel run's rank-0 params before they
    are dropped, returns more numbers.  Returns (the kernel run's
    numbers, with its LOW_LR run's losses and gradient norms under
    "low_lr", its launches)."""
    import gc
    from repro_torch.tree import leaves
    kept = {}
    for on in (True, False):
        tag = f"data-parallel, {'kernels' if on else 'plain'}"
        losses, norms, step_ms, peak, counts, states = _large_run(
            phase, tag, model, init, mesh, ds, make_opt(TRAIN_LR),
            plain=not on, **cfg)
        kept[on] = (losses, states[0]["params"])
        if on:
            numbers = dict(losses=losses, grad_norms=norms, step_ms=step_ms,
                           peak_gib=peak)
            launches = counts
        del states
        gc.collect()
        torch.cuda.empty_cache()
    (l_on, p_on), (l_off, p_off) = kept[True], kept.pop(False)
    same = l_on == l_off and all(
        _bits_equal(a, b) for a, b in zip(leaves(p_on), leaves(p_off)))
    print(f"[{phase}] the kernel and plain runs give bit-identical losses "
          f"and parameters: {same}")
    if not same:
        raise AssertionError(f"{phase}: kernel and plain runs differ")
    if check is not None:
        numbers.update(check(p_on))
    del kept, p_on, p_off
    gc.collect()
    torch.cuda.empty_cache()
    losses, norms = _large_run(phase, f"data-parallel, kernels, lr {LOW_LR}",
                               model, init, mesh, ds, make_opt(LOW_LR),
                               **cfg)[:2]
    if not losses[-1] < losses[0]:
        raise AssertionError(f"{phase}: lr {LOW_LR}: losses {losses} do not "
                             "fall")
    numbers["low_lr"] = dict(losses=losses, grad_norms=norms)
    gc.collect()
    torch.cuda.empty_cache()
    return numbers, launches


def _layout_desc(model) -> str:
    """What a model rank holds of each split family."""
    from repro_torch.models.encdec import EncDecCfg
    lay, cfg = model.layout, model.cfg
    parts = []
    if isinstance(cfg, EncDecCfg):
        parts.append(f"{lay.heads} of {cfg.attn.num_heads} self- and "
                     f"{cfg.cross.num_heads // lay.model} of "
                     f"{cfg.cross.num_heads} cross-attention heads")
    elif lay.heads:
        parts.append(f"{lay.heads} of {cfg.attn.num_heads} query heads, "
                     f"{lay.kv_heads} of {cfg.attn.num_kv_heads} KV heads")
    if lay.mla_heads:
        parts.append(f"{lay.mla_heads} of {cfg.mla.num_heads} MLA heads "
                     "(the latents whole)")
    if lay.sections:
        parts.append(f"{cfg.mamba.nheads // lay.model} of "
                     f"{cfg.mamba.nheads} Mamba heads, in_proj sectioned "
                     f"{dict(lay.sections)['in_proj']}")
    if lay.d_ff:
        parts.append(f"{lay.d_ff} of {cfg.mlp.d_ff} FFN columns")
    if lay.experts and any(spec.ffn == "moe" for st in cfg.stages
                           for spec in st.layers):
        parts.append(f"{lay.experts} of {cfg.moe.num_experts} experts")
    parts.append(f"{lay.vocab} of {cfg.vocab_size} vocabulary rows")
    return "; ".join(parts)


def _tp_run(phase, model, init, mesh, ds, make_opt, want=None,
            plain=False, lr=LOW_LR, **cfg):
    """``model`` (built for the mesh's "model" axis) on ``mesh`` from
    ``init``, composed, with ``check_model_replicas``, its launches
    checked against the data sync's plan plus the model axis's
    all-reduces (``tp_psums``, Adafactor's ``split_sum`` ones too), and,
    given ``want`` (the unsplit run's numbers at the same ``lr``), its
    losses and gradient norms within ``TP_LOSS_RTOL`` / ``TP_NORM_RTOL``
    of them.  At LOW_LR its last loss must be below its first.  The
    model-axis runs compare at LOW_LR: at TRAIN_LR the first update
    throws the weights far (qwen2-vl's loss rose from 12.54 to 20.37,
    deepseek's from 15.9 to 36.0), and the split's bf16 roundings,
    carried through it, moved the third step's gradient norms 2.8e-3 to
    6.0e-3 from the unsplit run's on the card, where the first step's
    agreed within 2.1e-4 (PERF.md).  Returns (numbers, launches,
    states)."""
    opt = make_opt(lr)
    n_ada = (adafactor_psums(model, opt) if opt.name == "adafactor"
             else 0)
    n_model = tp_psums(model, cfg.get("microbatches", 1))
    tag = f"{dict(mesh.shape)}, {'plain' if plain else 'kernels'}, lr {lr}"
    print(f"[{phase}] on {dict(mesh.shape)}: a rank holds "
          f"{_layout_desc(model)}; {n_model} model-axis all-reduces a rank "
          f"a step (and {n_ada} of Adafactor's)")
    losses, norms, step_ms, peak, counts, states = _large_run(
        phase, tag, model, init, mesh, ds, opt, plain=plain,
        extra_psums=n_model + n_ada, check_model_replicas=True, **cfg)
    numbers = dict(losses=losses, grad_norms=norms, step_ms=step_ms,
                   peak_gib=peak,
                   tokens_per_s=_tokens(ds) / step_ms * 1e3)
    if want is not None:
        errs = [abs(a - b) / abs(b) for a, b in zip(losses, want["losses"])]
        print(f"[{phase}] {tag} against the unsplit run: {losses} vs "
              f"{want['losses']}; rel err {['%.3e' % e for e in errs]} "
              f"(tol {TP_LOSS_RTOL})")
        if not max(errs) <= TP_LOSS_RTOL:
            raise AssertionError(f"{phase}: model-parallel losses {losses} "
                                 f"vs {want['losses']}")
        _norms_check(phase, f"{tag} against the unsplit run", norms,
                     want["grad_norms"], TP_NORM_RTOL)
    if lr == LOW_LR and not losses[-1] < losses[0]:
        raise AssertionError(f"{phase}: {tag}: losses {losses} do not fall")
    return numbers, counts, states


def _tp_twin(phase, cfg, init, ds, make_opt, want, **tcfg):
    """One [phase] run more: ``cfg`` on (data TRAIN_RANKS, model
    TP_MODEL) from ``init`` at LOW_LR (``_tp_run``, against the
    data-parallel kernel run's numbers at LOW_LR ``want``).  Returns
    (numbers, launches)."""
    import gc
    from repro_torch.models import build_model
    from repro_torch.runtime import substrate
    model = build_model(cfg, model_parallel=TP_MODEL)
    mesh = substrate.make_host_mesh(TRAIN_RANKS, model_parallel=TP_MODEL,
                                    device="cuda")
    numbers, counts, states = _tp_run(phase, model, init, mesh, ds,
                                      make_opt, want, **tcfg)
    del states
    gc.collect()
    torch.cuda.empty_cache()
    return numbers, counts


def phase_train_moe():
    """[train_moe]: qwen3-moe-30b-a3b at its published widths cut to
    TRAIN_LAYERS of 48 layers, random bf16 weights from seed 0, [train]'s
    data settings.  Data-parallel over TRAIN_RANKS thread ranks, composed,
    with the sync kernels and plain (bit-identical), and at LOW_LR (the
    last step's loss below the first's); then expert-parallel on (data
    TRAIN_RANKS, model TP_MODEL), composed, with ``check_model_replicas`` (the router's
    gradient bit-equal across "model"), whose losses and gradient norms
    must follow the data-parallel run's within ``TP_LOSS_RTOL`` and
    ``TP_NORM_RTOL``.  Returns ({"sum_chunks": launches}, numbers)."""
    import gc
    from repro_torch.models import build_model
    from repro_torch.runtime import substrate
    model, init, mesh, ds = _large_workload("train_moe", MOE_ARCH,
                                            TRAIN_LAYERS)
    cfg = model.cfg
    dp, dp_counts = _kernels_plain_low_lr("train_moe", model, init, mesh,
                                          ds, _adamw)
    launches = dp_counts["sum_chunks"]
    numbers = dict(dp_step_ms=dp["step_ms"], dp_peak_gib=dp["peak_gib"],
                   dp_losses=dp["losses"], dp_grad_norms=dp["grad_norms"])

    ep_model = build_model(cfg, model_parallel=TP_MODEL)
    ep_mesh = substrate.make_host_mesh(TRAIN_RANKS, model_parallel=TP_MODEL,
                                       device="cuda")
    lay = ep_model.layout
    print(f"[train_moe] expert-parallel on {dict(ep_mesh.shape)}: a rank "
          f"holds {lay.experts} of {cfg.moe.num_experts} experts, "
          f"{lay.heads} of {cfg.attn.num_heads} query heads, "
          f"{lay.kv_heads} of {cfg.attn.num_kv_heads} KV heads, "
          f"{lay.vocab} of {cfg.vocab_size} vocabulary rows; router and "
          f"norms whole")
    (losses, step_s, first_s, peak, counts, session, step_fn, states,
     metrics) = _mesh_run(ep_model, init, ep_mesh, ds, _adamw(TRAIN_LR),
                          "composed", check_model_replicas=True)
    print(f"[train_moe] expert-parallel, kernels: losses {losses}; step "
          f"{step_s * 1e3:.1f} ms (steps 2-{TRAIN_STEPS}; first "
          f"{first_s * 1e3:.1f} ms) = "
          f"{TRAIN_BATCH * TRAIN_SEQ / step_s:.0f} tokens/s; peak "
          f"allocated {peak / 2**30:.2f} GiB; model-replicated gradients "
          f"(router, norms) bit-equal across \"model\" (checked in the "
          f"step)")
    _train_check("train_moe", "expert-parallel", ep_model, ep_mesh, session,
                 states, metrics, counts, losses, True, tp_psums(ep_model))
    launches += counts["sum_chunks"]
    numbers.update(ep_step_ms=step_s * 1e3, ep_peak_gib=peak / 2**30,
                   ep_losses=losses, ep_grad_norms=metrics["grad_norms"])
    errs = [abs(a - b) / abs(b) for a, b in zip(losses,
                                                numbers["dp_losses"])]
    print(f"[train_moe] expert-parallel against data-parallel: {losses} "
          f"vs {numbers['dp_losses']}; rel err "
          f"{['%.3e' % e for e in errs]} (tol {TP_LOSS_RTOL})")
    if not max(errs) <= TP_LOSS_RTOL:
        raise AssertionError(f"expert-parallel losses {losses} vs "
                             f"{numbers['dp_losses']}")
    _norms_check("train_moe", "expert-parallel against data-parallel",
                 metrics["grad_norms"], numbers["dp_grad_norms"],
                 TP_NORM_RTOL)
    del states, step_fn, session, metrics, init
    gc.collect()
    torch.cuda.empty_cache()
    return {"sum_chunks": launches}, numbers


def phase_train_adafactor():
    """[train_adafactor]: mistral-large-123b at its published widths cut
    to TRAIN_LAYERS of 88 layers, random bf16 weights from seed 0,
    [train]'s data, Adafactor (the reference's optimizer for it):
    data-parallel composed with the sync kernels and plain
    (bit-identical) and at LOW_LR (the loss falls); ZeRO-1 (each rank's
    flat chunks unfactored); ZeRO-1 on (data 2, model 2) with
    ``check_model_replicas`` (each rank a piece of its data rank's chunk
    of every whole param, as the reference's chunks are), its losses
    and gradient norms within ``TP_LOSS_RTOL`` / ``TP_NORM_RTOL`` of
    ZeRO-1 on data 2, its model-axis all-reduces a clip sum a leaf
    besides [train_tp]'s; and compressed at ADAFACTOR_COMPRESSED_LAYERS
    layers.  Each ZeRO-1 run prints every rank's optimizer-state
    bytes.  Returns
    ({kernel: launches}, numbers)."""
    import gc
    model, init, mesh, ds = _large_workload(
        "train_adafactor", ADAFACTOR_ARCH, TRAIN_LAYERS)
    dp, dp_counts = _kernels_plain_low_lr(
        "train_adafactor", model, init, mesh, ds, _adafactor)
    launches = {"sum_chunks": dp_counts["sum_chunks"]}
    numbers = {"dp": dp}
    out = _large_run("train_adafactor", "ZeRO-1, kernels", model, init,
                     mesh, ds, _adafactor(TRAIN_LR), zero=True,
                     overlap=True)
    kinds = {k for k in out[5][0]["opt"]["f"]["lm_head"]}
    print(f"[train_adafactor]   ZeRO-1: lm_head's statistics a rank "
          f"{sorted(kinds)} (flat chunks: unfactored); optimizer state a "
          f"rank {_opt_bytes(out[5])}")
    if kinds != {"v"}:
        raise AssertionError(f"ZeRO-1 chunks factored: {kinds}")
    launches["sum_chunks"] += out[4]["sum_chunks"]
    numbers["zero"] = dict(losses=out[0], grad_norms=out[1], step_ms=out[2],
                           peak_gib=out[3], opt_bytes=_opt_bytes(out[5]))
    del out
    gc.collect()
    torch.cuda.empty_cache()

    # ZeRO-1 on (data 2, model 2): each rank a piece of its data rank's
    # chunk of every whole param, the reference's chunk, held to ZeRO-1
    # on data 2
    from repro_torch.models import build_model
    from repro_torch.runtime import substrate
    from repro_torch.train import trainer
    from repro_torch.tree import leaves
    tp_model = build_model(model.cfg, model_parallel=TP_MODEL)
    tp_mesh = substrate.make_host_mesh(TRAIN_RANKS, model_parallel=TP_MODEL,
                                       device="cuda")
    n_ada = adafactor_psums(tp_model, _adafactor(TRAIN_LR), zero=True)
    extra = tp_psums(tp_model) + n_ada
    # what each rank's reduce-scatter over "data" sums: its pieces of
    # every data rank's chunk
    synced = [torch.empty((TRAIN_RANKS * trainer._piece(
        w.numel(), TRAIN_RANKS, TP_MODEL)[1],), dtype=w.dtype,
        device="meta") for w in leaves(model.abstract_params())]
    print(f"[train_adafactor] ZeRO-1 on {dict(tp_mesh.shape)}: {n_ada} of "
          f"Adafactor's model-axis sums a rank a step (a clip a leaf) "
          f"beside the model's {tp_psums(tp_model)}")
    out = _large_run("train_adafactor", "ZeRO-1 on (data 2, model 2), "
                     "kernels", tp_model, init, tp_mesh, ds,
                     _adafactor(TRAIN_LR), extra_psums=extra, synced=synced,
                     check_model_replicas=True, zero=True, overlap=True)
    losses, norms = out[0], out[1]
    launches["sum_chunks"] += out[4]["sum_chunks"]
    numbers["zero_tp"] = dict(losses=losses, grad_norms=norms,
                              step_ms=out[2], peak_gib=out[3],
                              opt_bytes=_opt_bytes(out[5]))
    print(f"[train_adafactor]   ZeRO-1 on (data 2, model 2): optimizer "
          f"state a rank {numbers['zero_tp']['opt_bytes']} (data 2: "
          f"{numbers['zero']['opt_bytes']})")
    del out
    want = numbers["zero"]
    errs = [abs(a - b) / abs(b) for a, b in zip(losses, want["losses"])]
    print(f"[train_adafactor] ZeRO-1 on (data 2, model 2) against ZeRO-1 on "
          f"data 2: {losses} vs {want['losses']}; rel err "
          f"{['%.3e' % e for e in errs]} (tol {TP_LOSS_RTOL})")
    if not max(errs) <= TP_LOSS_RTOL:
        raise AssertionError(f"ZeRO-1 model-parallel losses {losses} vs "
                             f"{want['losses']}")
    _norms_check("train_adafactor", "ZeRO-1 on (data 2, model 2) against "
                 "ZeRO-1 on data 2", norms, want["grad_norms"],
                 TP_NORM_RTOL)
    del init, model, tp_model
    gc.collect()
    torch.cuda.empty_cache()

    model, init, mesh, ds = _large_workload(
        "train_adafactor", ADAFACTOR_ARCH, ADAFACTOR_COMPRESSED_LAYERS)
    out = _large_run("train_adafactor",
                     f"compressed, kernels, {ADAFACTOR_COMPRESSED_LAYERS} "
                     f"layer", model, init, mesh, ds, _adafactor(TRAIN_LR),
                     sync="compressed")
    launches.update({k: out[4][k] for k in SYNC_KERNELS[1:]})
    numbers["compressed"] = dict(losses=out[0], step_ms=out[2],
                                 peak_gib=out[3])
    del out, init, model
    gc.collect()
    torch.cuda.empty_cache()
    return launches, numbers


def phase_train_fsdp_tp(adafactor):
    """[train_fsdp_tp]: [train_adafactor]'s mistral-large-123b cut
    (TRAIN_LAYERS of 88 layers, random bf16 weights from seed 0,
    [train]'s data, Adafactor) as ``auto`` on (data TRAIN_RANKS, model
    TP_MODEL) in the reference's layout: each rank its data block of its
    model block of every leaf the reference's specs split over "data",
    gathered over "data" as each layer runs, its gradients reduce-
    scattered into the rank's accumulator, Adafactor's factored sums and
    the clip's norm spanning the blocks; ``check_model_replicas`` on.
    At LOW_LR, as the model-axis twins compare (``_tp_run``), held to
    [train_adafactor]'s data-parallel run at LOW_LR from the same
    weights and batches (``adafactor``: that phase's numbers): losses
    within AUTO_LOSS_RTOL, gradient norms within TP_NORM_RTOL.  Not to
    its ZeRO-1 run on (2, 2): ZeRO-1 runs Adafactor unfactored on flat
    chunks, as the reference's ZeRO-1 does, which is other arithmetic
    (on an H100 at LOW_LR its second loss rose where the factored runs'
    fell, PERF.md §6).  The ranks' blocks join into a finite global
    tree, each rank holds its state's bytes as ``trainer.abstract_state``
    plans them, and the peak is printed beside ZeRO-1's.  Returns
    ({"sum_chunks": launches}, numbers)."""
    import gc
    from repro_torch.models import build_model
    from repro_torch.runtime import substrate
    from repro_torch.train import trainer
    from repro_torch.tree import leaves
    model, init, _, ds = _large_workload(
        "train_fsdp_tp", ADAFACTOR_ARCH, TRAIN_LAYERS, lazy=True)
    tp_model = build_model(model.cfg, model_parallel=TP_MODEL)
    mesh = substrate.make_host_mesh(TRAIN_RANKS, model_parallel=TP_MODEL,
                                    device="cuda")
    opt = _adafactor(LOW_LR)
    tcfg = trainer.TrainCfg(sync_mode="auto", check_model_replicas=True)
    (losses, step_s, first_s, peak, counts, session, step_fn, states,
     metrics) = _mesh_run(tp_model, init, mesh, ds, opt, "auto",
                          check_model_replicas=True)
    plan_bytes = _nbytes(leaves(trainer.abstract_state(tp_model, opt, tcfg,
                                                       mesh)))
    held = [_nbytes(leaves(st)) for st in states]
    tree = trainer.logical_state(trainer.gather_state(states, tcfg, mesh,
                                                      tp_model))
    finite = all(bool(torch.isfinite(t).all()) for t in leaves(tree)
                 if t.is_floating_point())
    del tree, states, step_fn, session
    want = adafactor["dp"]["low_lr"]
    zero_peak = adafactor["zero_tp"]["peak_gib"]
    errs = [abs(a - b) / abs(b) for a, b in zip(losses, want["losses"])]
    print(f"[train_fsdp_tp] auto on {dict(mesh.shape)}, split over \"data\""
          f" and \"model\", lr {LOW_LR}: losses {losses}; step "
          f"{step_s * 1e3:.1f} ms (steps 2-{TRAIN_STEPS}; first "
          f"{first_s * 1e3:.1f} ms) = {_tokens(ds) / step_s:.0f} tokens/s; "
          f"peak allocated {peak / 2**30:.2f} GiB; sum_chunks "
          f"{counts['sum_chunks']} launches")
    print(f"[train_fsdp_tp] against [train_adafactor]'s data-parallel run "
          f"at lr {LOW_LR}: {losses} vs {want['losses']}; rel err "
          f"{['%.3e' % e for e in errs]} (tol {AUTO_LOSS_RTOL})")
    _norms_check("train_fsdp_tp", "auto on (data 2, model 2) against the "
                 "data-parallel run", metrics["grad_norms"],
                 want["grad_norms"], TP_NORM_RTOL)
    print(f"[train_fsdp_tp] state a rank {held} bytes (plan "
          f"{plan_bytes:,d}); blocks joined finite: {finite}; peak "
          f"{peak / 2**30:.2f} GiB against ZeRO-1 on (2, 2)'s "
          f"{zero_peak:.2f} GiB in [train_adafactor]")
    if not all(np.isfinite(losses)) or not finite or any(
            h != plan_bytes for h in held):
        raise AssertionError(f"fsdp_tp: losses {losses}, finite {finite}, "
                             f"held {held} vs {plan_bytes}")
    if not max(errs) <= AUTO_LOSS_RTOL:
        raise AssertionError(f"fsdp_tp: auto losses {losses} vs "
                             f"{want['losses']}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"fsdp_tp: losses {losses} do not fall")
    numbers = dict(losses=losses, step_ms=step_s * 1e3, peak_gib=peak / 2**30,
                   zero_peak_gib=zero_peak, state_bytes=held[0])
    del init, model, tp_model
    gc.collect()
    torch.cuda.empty_cache()
    return {"sum_chunks": counts["sum_chunks"]}, numbers


def phase_train_deepseek():
    """[train_deepseek]: deepseek-v3-671b at its published widths cut to
    its first TRAIN_LAYERS layers (dense MLA) and the MTP block (MLA and
    a dense FFN), random bf16 weights from seed 0, [train]'s data,
    Adafactor with the reference's settings (gradients accumulated in
    bf16 over 2 microbatches; 8 cut to 2: a rank holds 2 rows):
    data-parallel composed, kernels and plain (bit-identical) and at
    LOW_LR (the loss falls); the MTP metric of the trained params finite;
    then on (data TRAIN_RANKS, model TP_MODEL), MLA and the MTP head
    split by heads, against the data-parallel kernel run (``_tp_twin``).
    Returns ({"sum_chunks": launches}, numbers)."""
    import gc
    model, init, mesh, ds = _large_workload(
        "train_deepseek", DEEPSEEK_ARCH, TRAIN_LAYERS)

    def mtp_finite(params):
        with torch.no_grad():
            batch = {k: torch.from_numpy(v[:1]).cuda()
                     for k, v in ds.host_batch(TRAIN_STEPS).items()}
            _, m = model.loss(params, batch)
        mtp = m["mtp"].item()
        print(f"[train_deepseek] the kernel run's params' metrics on the "
              f"next batch's first row: nll {m['nll'].item():.4f}, mtp "
              f"{mtp:.4f}")
        if not np.isfinite(mtp):
            raise AssertionError(f"mtp {mtp}")
        return {"mtp": mtp}

    tcfg = dict(microbatches=2, grad_dtype=torch.bfloat16)
    dp, counts = _kernels_plain_low_lr(
        "train_deepseek", model, init, mesh, ds, _adafactor,
        check=mtp_finite, **tcfg)
    dp["tp"], tp_counts = _tp_twin("train_deepseek", model.cfg, init, ds,
                                   _adafactor, dp["low_lr"], **tcfg)
    del init, model
    gc.collect()
    torch.cuda.empty_cache()
    return {"sum_chunks": counts["sum_chunks"] + tp_counts["sum_chunks"]}, dp


@contextlib.contextmanager
def _expandable_segments():
    """The caching allocator's expandable segments inside: [train_jamba]'s
    (data 1, model 2) run at 4 rows peaks at 71.09 GiB, and with fixed
    segments the allocator held another 9.8 GiB reserved but unallocated
    there and ran out.  Not for the whole script: mapping their memory
    made the other training phases' first steps and set-ups slower, the
    script 938.9 -> 1083.5 s on an H100 (PERF.md)."""
    torch.cuda.empty_cache()
    torch.cuda.memory._set_allocator_settings("expandable_segments:True")
    try:
        yield
    finally:
        torch.cuda.empty_cache()
        torch.cuda.memory._set_allocator_settings("expandable_segments:False")


def phase_train_jamba():
    """[train_jamba] (``_train_jamba``) with expandable allocator
    segments."""
    with _expandable_segments():
        return _train_jamba()


def _train_jamba():
    """[train_jamba]: jamba-1.5-large-398b at its published widths cut to
    its first JAMBA_TRAIN_LAYERS of 72 layers (``attn+dense``,
    ``mamba+moe``), random bf16 weights from seed 0 made anew for each
    run (the card holds one replica and its gradients), [train]'s data at
    JAMBA_TRAIN_BATCH rows a step, Adafactor with bf16 gradients (the
    reference's settings) over JAMBA_TRAIN_MICRO microbatch, every run at
    LOW_LR (each run's loss falls).  Unsplit on (data 1, model 1), then
    on (data 1, model TP_MODEL) with the experts, the Mamba heads and the
    attention heads split, the block checkpointed over "model", and
    ``check_model_replicas``, with the sync kernels and plain (the same
    bits), their losses and gradient norms within ``TP_LOSS_RTOL`` /
    ``TP_NORM_RTOL`` of the unsplit run's; each run's peak printed.
    Returns
    ({"sum_chunks": launches}, numbers)."""
    import gc
    from repro_torch.models import build_model
    from repro_torch.runtime import substrate
    from repro_torch.tree import leaves
    model, init, mesh, ds = _large_workload(
        "train_jamba", JAMBA_ARCH, JAMBA_TRAIN_LAYERS, ranks=1, lazy=True,
        data=lambda cfg: _train_data(cfg, batch=JAMBA_TRAIN_BATCH))
    tcfg = dict(microbatches=JAMBA_TRAIN_MICRO, grad_dtype=torch.bfloat16)
    losses, norms, step_ms, peak, counts, states = _large_run(
        "train_jamba", f"(data 1, model 1), kernels, lr {LOW_LR}", model,
        init, mesh, ds, _adafactor(LOW_LR), **tcfg)
    del states
    gc.collect()
    torch.cuda.empty_cache()
    if not losses[-1] < losses[0]:
        raise AssertionError(f"train_jamba: unsplit losses {losses} do not "
                             "fall")
    numbers = {"whole": dict(losses=losses, grad_norms=norms,
                             step_ms=step_ms, peak_gib=peak)}
    launches = counts["sum_chunks"]
    tp_model = build_model(model.cfg, model_parallel=TP_MODEL)
    tp_mesh = substrate.make_host_mesh(1, model_parallel=TP_MODEL,
                                       device="cuda")
    for on in (True, False):
        out, counts, states = _tp_run(
            "train_jamba", tp_model, init, tp_mesh, ds, _adafactor,
            numbers["whole"], plain=not on, **tcfg)
        got = [t for st in states for t in leaves(st["params"])]
        if on:
            numbers["tp"] = out
            launches += counts["sum_chunks"]
            # every rank's params, on the host: the card holds one run
            kept = [t.to("cpu") for t in got]
        else:
            same = out["losses"] == numbers["tp"]["losses"] and all(
                _bits_equal(a, b.to("cpu")) for a, b in zip(kept, got))
        del states, got
        gc.collect()
        torch.cuda.empty_cache()
    del kept
    limit = 0.95 * torch.cuda.get_device_properties(0).total_memory / 2**30
    print(f"[train_jamba] {JAMBA_TRAIN_BATCH} rows a step, the block "
          f"checkpointed: peak allocated {numbers['whole']['peak_gib']:.2f} "
          f"GiB on (data 1, model 1), {numbers['tp']['peak_gib']:.2f} GiB "
          f"on {dict(tp_mesh.shape)} (95% of the card: {limit:.2f} GiB; "
          f"4 rows without remat over \"model\" ran out at 67.84 GiB "
          f"allocated, PERF.md)")
    print(f"[train_jamba] the kernel and plain runs on "
          f"{dict(tp_mesh.shape)} give bit-identical losses and every "
          f"rank's parameters: {same}")
    if not same:
        raise AssertionError("train_jamba: kernel and plain runs differ")
    return {"sum_chunks": launches}, numbers


def _dryrun_cell(cfg, ds, mesh_shape, opt, settings=None, sync="composed",
                 **kw):
    """The dry-run of [train]-like training of ``cfg`` on an abstract
    mesh of ``mesh_shape`` ((data,) or (data, model)) over ``ds``'s
    batch (``meta`` tensors of its shapes), ``sync`` (composed, or auto:
    split over "data"), with the optimizer ``opt``, ``settings``
    (``dryrun.train_settings``' keys) and the ``TrainCfg`` fields
    ``kw``: (the cell, its ``ModuleCost``)."""
    from repro_torch.launch import dryrun
    from repro_torch.runtime import substrate
    batch = {k: torch.empty(v.shape, dtype=torch.from_numpy(v).dtype,
                            device="meta")
             for k, v in ds.host_batch(0).items()}
    mesh = substrate.abstract_mesh(mesh_shape,
                                   ("data", "model")[:len(mesh_shape)])
    cell = dryrun.train_cell(cfg, batch, mesh, settings=settings,
                             variant={"sync": sync}, optimizer=opt, **kw)
    return cell, dryrun.trace_cell(cell)


def phase_dryrun(train, train_tp, auto, jamba, t_start):
    """[dryrun]: the launch layer's dry-run (``launch.dryrun.train_cell``,
    one rank traced on ``meta`` tensors) held against one real step on
    the card, counted inside rank 0's thread
    (``stepanalysis.measure_rank``): for [train]'s configuration,
    [train_tp]'s (data 2, model 2) and [train_auto]'s step split over
    "data" (``auto``: that phase's numbers), flops and rank 0's wire
    bytes must be equal.  For those two and [train_jamba]'s (data 1, model 2) run, the
    traced peak a rank times the ranks on the card is printed beside the
    peak that phase measured and the analytic model's figure: readings,
    not gates.  Returns its numbers."""
    import gc
    from repro_torch.comm import Session
    from repro_torch.configs import get_config, with_num_layers
    from repro_torch.launch import dryrun, stepanalysis
    from repro_torch.launch.train import build_session
    from repro_torch.models import build_model
    from repro_torch.runtime import substrate
    from repro_torch.train import trainer
    t0 = time.perf_counter()
    total = torch.cuda.get_device_properties(0).total_memory
    print(f"[dryrun] {card()}: total_memory {total:,d} bytes "
          f"(launch.dryrun.HBM_PER_CHIP {dryrun.HBM_PER_CHIP:,d})")
    cfg = with_num_layers(get_config("granite-34b"), TRAIN_LAYERS)
    ds = _train_data(cfg)
    numbers = {"hbm_per_chip": total}
    for tag, mp, sync, measured in (
            ("train", 1, "composed", train["composed_peak_gib"]),
            ("train_tp", TP_MODEL, "composed",
             train_tp["composed_peak_gib"]),
            ("train_auto", 1, "auto", auto["peak_gib"])):
        shape = (TRAIN_RANKS, mp) if mp > 1 else (TRAIN_RANKS,)
        _, dry = _dryrun_cell(cfg, ds, shape, _adamw(TRAIN_LR), sync=sync)
        model = build_model(cfg, model_parallel=mp)
        mesh = substrate.make_host_mesh(TRAIN_RANKS, model_parallel=mp,
                                        device="cuda")
        opt = _adamw(TRAIN_LR)
        tcfg = trainer.TrainCfg(sync_mode=sync)
        session = (Session(mesh=mesh, mode="monolithic") if sync == "auto"
                   else build_session(mesh, model, opt, ds, tcfg))
        states = trainer.init_states(
            model, opt, model.init(torch.Generator(device="cuda")
                                   .manual_seed(0)), tcfg, mesh)
        step_fn = trainer.make_train_step(model, opt, tcfg,
                                          comm=session.world)
        (states, metrics), real = stepanalysis.measure_rank(
            step_fn, states, ds.host_batch(0))
        torch.cuda.synchronize()
        loss = metrics["loss"].item()
        an = dryrun.analytic_train(cfg, TRAIN_SEQ, TRAIN_BATCH, mesh,
                                   {"optimizer": "adamw"})
        ranks = mesh.size
        print(f"[dryrun] {tag} {dict(mesh.shape)}: flops a rank traced "
              f"{dry.flops:.6e}, real {real.flops:.6e}; wire bytes of rank "
              f"0 traced {dry.wire_bytes:,.0f}, real {real.wire_bytes:,.0f}"
              f"; loss {loss:.4f}")
        print(f"[dryrun] {tag}: peak traced {dry.peak_bytes / 2**30:.2f} "
              f"GiB a rank x {ranks} ranks = "
              f"{dry.peak_bytes * ranks / 2**30:.2f} GiB ({_split(dry)}); "
              f"rank 0 of the real step {real.peak_bytes / 2**30:.2f} GiB; "
              f"[{tag}] measured {measured:.2f} GiB over its {TRAIN_STEPS} "
              f"steps; analytic model {an['total'] * ranks / 2**30:.2f} GiB "
              f"({an['total'] / 2**30:.2f} a rank)")
        if not (dry.flops == real.flops and dry.wire_bytes == real.wire_bytes
                and dry.flops > 0):
            raise AssertionError(f"[dryrun] {tag}: traced flops / wire "
                                 f"bytes {dry.flops} / {dry.wire_bytes} vs "
                                 f"real {real.flops} / {real.wire_bytes}")
        if not math.isfinite(loss):
            raise AssertionError(f"[dryrun] {tag}: loss {loss}")
        numbers[tag] = dict(flops=dry.flops, wire_bytes=dry.wire_bytes,
                            traced_peak_gib=dry.peak_bytes / 2**30,
                            real_rank0_peak_gib=real.peak_bytes / 2**30,
                            measured_peak_gib=measured, ranks=ranks,
                            analytic_gib=an["total"] / 2**30)
        del states, step_fn, session, metrics, model
        gc.collect()
        torch.cuda.empty_cache()
    jcfg = with_num_layers(get_config(JAMBA_ARCH), JAMBA_TRAIN_LAYERS)
    jds = _train_data(jcfg, batch=JAMBA_TRAIN_BATCH)
    settings = dict(optimizer="adafactor", microbatches=JAMBA_TRAIN_MICRO,
                    grad_dtype=torch.bfloat16)
    _, dry = _dryrun_cell(jcfg, jds, (1, TP_MODEL), _adafactor(LOW_LR),
                          settings, check_model_replicas=True)
    an = dryrun.analytic_train(jcfg, TRAIN_SEQ, JAMBA_TRAIN_BATCH,
                               substrate.abstract_mesh((1, TP_MODEL),
                                                       ("data", "model")),
                               settings)
    measured = jamba["tp"]["peak_gib"]
    print(f"[dryrun] train_jamba (1, {TP_MODEL}): peak traced "
          f"{dry.peak_bytes / 2**30:.2f} GiB a rank x {TP_MODEL} ranks = "
          f"{dry.peak_bytes * TP_MODEL / 2**30:.2f} GiB ({_split(dry)}); "
          f"[train_jamba] measured {measured:.2f} GiB; analytic model "
          f"{an['total'] * TP_MODEL / 2**30:.2f} GiB; flops a rank "
          f"{dry.flops:.6e}, wire bytes a rank {dry.wire_bytes:,.0f}")
    numbers["train_jamba"] = dict(
        traced_peak_gib=dry.peak_bytes / 2**30, ranks=TP_MODEL,
        measured_peak_gib=measured, analytic_gib=an["total"] / 2**30)
    numbers["serve_tp"] = _dryrun_serve_tp()
    print(f"[dryrun] {time.perf_counter() - t0:.1f}s; the script so far "
          f"{time.perf_counter() - t_start:.1f}s")
    return numbers


def _dryrun_serve_tp():
    """One decode step of [serve_tp]'s granite-34b run, traced on ``meta``
    (``dryrun.serve_cell``) and run on the card: flops and rank 0's wire
    bytes must be equal."""
    from repro_torch.configs import get_config, with_num_layers
    from repro_torch.launch import dryrun, stepanalysis
    from repro_torch.models import build_model
    from repro_torch.runtime import substrate
    arch, layers, shape, max_len, _, _ = SERVE_TP_RUNS[0]
    cfg = with_num_layers(get_config(arch), layers)
    seq = max_len - 512              # a decode cell's cache: seq + 512
    tokens = torch.randint(0, cfg.vocab_size, (SERVE_TP_BATCH, 1),
                           generator=torch.Generator(device="cuda")
                           .manual_seed(2), device="cuda",
                           dtype=torch.int32)
    dry = dryrun.trace_cell(dryrun.serve_cell(
        cfg, "decode", {"tokens": torch.empty(tokens.shape,
                                              dtype=tokens.dtype,
                                              device="meta")},
        substrate.abstract_mesh(shape, ("data", "model")), seq_len=seq))
    mesh = substrate.make_host_mesh(shape[0], model_parallel=shape[1],
                                    device="cuda")
    params = build_model(cfg).init(torch.Generator(device="cuda")
                                   .manual_seed(0))
    cell = dryrun.serve_cell(cfg, "decode", {"tokens": tokens}, mesh,
                             seq_len=seq, params=params)
    del params
    out, real = stepanalysis.measure_rank(cell.fn, *cell.args)
    torch.cuda.synchronize()
    finite = bool(torch.isfinite(out[0][0]).all())
    print(f"[dryrun] serve_tp {arch} decode {dict(mesh.shape)} (cache "
          f"{max_len} positions, batch {SERVE_TP_BATCH}): flops a rank "
          f"traced {dry.flops:.6e}, real {real.flops:.6e}; wire bytes of "
          f"rank 0 traced {dry.wire_bytes:,.0f}, real "
          f"{real.wire_bytes:,.0f}; peak traced {dry.peak_bytes / 2**30:.3f}"
          f" GiB ({_split(dry)}), rank 0 of the real step "
          f"{real.peak_bytes / 2**30:.3f} GiB ({_split(real)})")
    if not (dry.flops == real.flops and dry.wire_bytes == real.wire_bytes
            and dry.flops > 0 and finite):
        raise AssertionError(f"[dryrun] serve_tp: traced flops / wire "
                             f"bytes {dry.flops} / {dry.wire_bytes} vs "
                             f"real {real.flops} / {real.wire_bytes}, "
                             f"finite logits {finite}")
    del cell, out
    _free()
    return dict(flops=dry.flops, wire_bytes=dry.wire_bytes,
                traced_peak_gib=dry.peak_bytes / 2**30,
                real_rank0_peak_gib=real.peak_bytes / 2**30)


def _split(cost) -> str:
    return ", ".join(f"{k} {v / 2**30:.2f}" for k, v in cost.peak.items())


def phase_train_mamba2():
    """[train_mamba2]: mamba2-1.3b at its published widths and full depth
    (48 layers), random bf16 weights from seed 0, [train]'s data (seq
    2048: a multiple of the SSD chunk), AdamW (the reference's optimizer
    for it): data-parallel composed, kernels and plain (bit-identical)
    and at LOW_LR (the loss falls); then one kernel run cut to
    MAMBA2_REMAT_CUT layers, whose peak with remat is printed.  Returns
    ({"sum_chunks": launches}, numbers)."""
    import gc
    model, init, mesh, ds = _large_workload("train_mamba2", MAMBA2_ARCH)
    dp, counts = _kernels_plain_low_lr(
        "train_mamba2", model, init, mesh, ds, _adamw)
    del init, model
    gc.collect()
    torch.cuda.empty_cache()
    model, init, mesh, ds = _large_workload("train_mamba2", MAMBA2_ARCH,
                                            MAMBA2_REMAT_CUT)
    peak = _large_run("train_mamba2", f"{MAMBA2_REMAT_CUT} layers, kernels",
                      model, init, mesh, ds, _adamw(TRAIN_LR))[3]
    print(f"[train_mamba2] {MAMBA2_REMAT_CUT} layers with remat: peak "
          f"{peak:.2f} GiB (without remat: 64.97 GiB on an NVIDIA H100 "
          "80GB HBM3 at 700 W, PERF.md)")
    dp["peak_gib_cut"] = peak
    del init, model
    gc.collect()
    torch.cuda.empty_cache()
    return {"sum_chunks": counts["sum_chunks"]}, dp


def vl_workload_data(cfg):
    """[train_vl]'s batches for ``cfg`` (``_VLBatches``)."""
    return _VLBatches(_train_data(cfg, embed_dim=cfg.d_model,
                                  with_embeds=True, mrope=True),
                      cfg.d_model)


def vl_workload(phase):
    """[train_vl]'s workload: qwen2-vl-7b cut to VL_TRAIN_LAYERS layers on
    ``_VLBatches`` (``_large_workload``'s tuple)."""
    return _large_workload(phase, VL_ARCH, VL_TRAIN_LAYERS,
                           data=vl_workload_data)


def seamless_workload(phase):
    """[train_seamless]'s workload: seamless-m4t-large-v2 cut to
    SEAMLESS_TRAIN_LAYERS + SEAMLESS_TRAIN_LAYERS layers on
    ``_FrameBatches`` (``_large_workload``'s tuple)."""
    import dataclasses
    return _large_workload(
        phase, SEAMLESS_ARCH, cut=lambda cfg: dataclasses.replace(
            cfg, enc_layers=SEAMLESS_TRAIN_LAYERS,
            dec_layers=SEAMLESS_TRAIN_LAYERS),
        data=lambda cfg: _FrameBatches(_train_data(cfg), cfg.d_model))


def phase_train_vl():
    """[train_vl]: qwen2-vl-7b at its published widths cut to
    VL_TRAIN_LAYERS of 28 layers, random bf16 weights from seed 0,
    [train]'s data as embeddings batches with per-row M-RoPE positions
    (``_VLBatches``), AdamW over VL_TRAIN_MICRO microbatches (the
    reference's settings): each rank splits its rows, positions at dim
    1, into the microbatches.  Data-parallel composed, kernels and plain
    (bit-identical) and at LOW_LR (the loss falls); then on (data
    TRAIN_RANKS, model TP_MODEL), the inputs_embeds and positions whole on
    every model rank, against the data-parallel kernel run
    (``_tp_twin``).  Returns ({"sum_chunks": launches}, numbers)."""
    import gc
    model, init, mesh, ds = vl_workload("train_vl")
    dp, counts = _kernels_plain_low_lr(
        "train_vl", model, init, mesh, ds, _adamw,
        microbatches=VL_TRAIN_MICRO)
    dp["tp"], tp_counts = _tp_twin("train_vl", model.cfg, init, ds, _adamw,
                                   dp["low_lr"], microbatches=VL_TRAIN_MICRO)
    del init, model
    gc.collect()
    torch.cuda.empty_cache()
    return {"sum_chunks": counts["sum_chunks"] + tp_counts["sum_chunks"]}, dp


def phase_train_seamless():
    """[train_seamless]: seamless-m4t-large-v2 at its published widths
    cut to SEAMLESS_TRAIN_LAYERS + SEAMLESS_TRAIN_LAYERS of its 24 + 24
    layers, random bf16 weights from seed 0, [train]'s tokens beside
    numpy frames (``_FrameBatches``), AdamW, 1 microbatch (the
    reference's settings): data-parallel composed, kernels and plain
    (bit-identical) and at LOW_LR (the loss falls); then on (data
    TRAIN_RANKS, model TP_MODEL) against the LOW_LR run (``_tp_twin``).
    Returns ({"sum_chunks": launches}, numbers)."""
    import gc
    model, init, mesh, ds = seamless_workload("train_seamless")
    dp, counts = _kernels_plain_low_lr(
        "train_seamless", model, init, mesh, ds, _adamw)
    dp["tp"], tp_counts = _tp_twin("train_seamless", model.cfg, init, ds,
                                   _adamw, dp["low_lr"])
    print(f"[train_seamless] (data {TRAIN_RANKS}, model {TP_MODEL}), each "
          f"layer checkpointed over \"model\": peak allocated "
          f"{dp['tp']['peak_gib']:.2f} GiB (69.52 GiB without remat over "
          f"\"model\" on an H100, PERF.md); data-parallel "
          f"{dp['peak_gib']:.2f} GiB")
    del init, model
    gc.collect()
    torch.cuda.empty_cache()
    return {"sum_chunks": counts["sum_chunks"] + tp_counts["sum_chunks"]}, dp


def phase_train_pod():
    """granite-34b at its published widths cut to POD_LAYERS layer on a
    (pod 2, data 2) mesh, composed sync (every unit the hierarchical
    all-reduce), against a flat data=4 run from the same weights and
    batches.  Returns ({"sum_chunks": launches}, numbers)."""
    import gc
    from repro_torch.configs import get_config, with_num_layers
    from repro_torch.core import costmodel, layers, registry
    from repro_torch.data import SyntheticLMDataset
    from repro_torch.models import build_model
    from repro_torch.runtime import substrate
    from repro_torch.tree import leaves
    cfg = with_num_layers(get_config("granite-34b"), POD_LAYERS)
    model = build_model(cfg)
    init = model.init(torch.Generator(device="cuda").manual_seed(0))
    ds = SyntheticLMDataset(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                            global_batch=TRAIN_BATCH, seed=0)
    runs = {}
    for name, mesh in (
            ("pod", substrate.make_host_mesh(2, pods=2, device="cuda")),
            ("flat", substrate.make_host_mesh(4, device="cuda"))):
        (losses, step_s, first_s, peak, counts, session, step_fn, states,
         metrics) = _mesh_run(model, init, mesh, ds, _adamw(TRAIN_LR),
                              "composed")
        same = _replicas_check(mesh, model, states)
        units = step_fn.schedule.units
        protos = sorted({u.protocol for u in units})
        print(f"[train_pod] {name} {dict(mesh.shape)}, {cfg.num_layers} "
              f"layer: losses {losses}; step {step_s * 1e3:.1f} ms (steps "
              f"2-{TRAIN_STEPS}; first {first_s * 1e3:.1f} ms) = "
              f"{TRAIN_BATCH * TRAIN_SEQ / step_s:.0f} tokens/s; peak "
              f"allocated {peak / 2**30:.2f} GiB; sync units {protos}; "
              f"replicas identical: {same}")
        if not all(np.isfinite(losses)) or not same:
            raise AssertionError(f"{name}: losses {losses}, replicas {same}")
        if name == "pod":
            if protos != [costmodel.HIERARCHICAL]:
                raise AssertionError(f"pod sync units {protos}")
            per = sum(_multiaxis_combines(mesh.shape, ("pod", "data"),
                                          t.numel())
                      for t in leaves(states[0]["params"]))
            per += sum(
                _lib_combines("all_reduce", session.engine.protocol_for(
                    registry.ALL_REDUCE, layers.nbytes(metrics["loss"]),
                    ax), mesh.shape[ax], 1)
                for ax in ("pod", "data"))
            want = per * mesh.size * TRAIN_STEPS
            print(f"[train_pod]   sum_chunks: {counts['sum_chunks']} "
                  f"launches; plan {want} = {per} a rank a step x "
                  f"{mesh.size} ranks x {TRAIN_STEPS} steps (the "
                  f"hierarchical schedule's bidir ring reduce-scatter over "
                  f"\"data\" a leaf; recursive doubling over \"pod\")")
            if counts["sum_chunks"] != want:
                raise AssertionError(f"pod: sum_chunks {counts}, plan "
                                     f"{want}")
            runs["launches"] = counts["sum_chunks"]
        runs[name] = dict(losses=losses, step_ms=step_s * 1e3,
                          peak_gib=peak / 2**30,
                          grad_norms=metrics["grad_norms"])
        del states, step_fn, session, metrics
        gc.collect()
        torch.cuda.empty_cache()
    got, want = runs["pod"]["losses"], runs["flat"]["losses"]
    errs = [abs(a - b) / abs(b) for a, b in zip(got, want)]
    print(f"[train_pod] pod against flat: rel err "
          f"{['%.3e' % e for e in errs]} (tol {POD_LOSS_RTOL}); "
          f"bit-identical {got == want}")
    if not max(errs) <= POD_LOSS_RTOL:
        raise AssertionError(f"pod losses {got} vs flat {want}")
    _norms_check("train_pod", "pod against flat", runs["pod"]["grad_norms"],
                 runs["flat"]["grad_norms"], POD_NORM_RTOL)
    del init
    gc.collect()
    torch.cuda.empty_cache()
    return {"sum_chunks": runs.pop("launches")}, runs


def _norms_check(phase, what, got, want, rtol):
    """Each step's global gradient norm against ``want``'s within
    ``rtol`` relative: the clip scales the update by the norm, and AdamW
    barely sees a uniform scale, so the losses alone miss a norm that
    counts a model rank's squares twice or not at all."""
    errs = [abs(a - b) / abs(b) for a, b in zip(got, want)]
    print(f"[{phase}] grad norm {what}: {got} vs {want}; rel err "
          f"{['%.3e' % e for e in errs]} (tol {rtol})")
    if not max(errs) <= rtol:
        raise AssertionError(f"{phase}: grad norms {got} vs {want}")


def _sync_run(model, init, mesh, ds, opt, tag, sync, **cfg):
    """One run of the train workload through ``train_run``: TRAIN_STEPS
    steps, the launch counters set to 0 just before and read just after,
    each sync kernel's launches held to the plan's count.  Returns the
    run's record (rank 0's params kept for a bit comparison)."""
    from repro_torch.kernels import counter
    from repro_torch.train import trainer
    from repro_torch.tree import leaves
    p = mesh.size
    session, states, step_fn = train_run(model, init, mesh, ds, opt, sync,
                                         **cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counter.reset_all()
    states, losses, times, metrics = _train_steps(step_fn, states, ds)
    counts = counter.counts()
    peak = torch.cuda.max_memory_allocated()
    same = all(_bits_equal(a, b) for st in states[1:] for a, b in
               zip(leaves(states[0]["params"]), leaves(st["params"])))
    step_s = float(np.mean(times[1:]))
    print(f"[train] {tag}: losses {losses}; step {step_s * 1e3:.1f} ms "
          f"(steps 2-{TRAIN_STEPS}; first {times[0] * 1e3:.1f} ms) = "
          f"{TRAIN_BATCH * TRAIN_SEQ / step_s:.0f} tokens/s; peak allocated "
          f"{peak / 2**30:.2f} GiB; replicas identical: {same}")
    if not all(np.isfinite(losses)) or not same:
        raise AssertionError(f"{tag}: losses {losses}, replicas identical "
                             f"{same}")
    if not peak < 0.95 * torch.cuda.get_device_properties(0).total_memory:
        raise AssertionError(f"{tag}: peak {peak} near the card")
    tcfg = trainer.TrainCfg(sync_mode=sync, **cfg)
    if tcfg.bucket_grads:
        synced = [torch.empty(b.size, dtype=b.wire_dtype, device="meta")
                  for b in trainer.grad_bucket_plan(model.abstract_params(),
                                                    tcfg, model.layout)]
    else:
        synced = leaves(model.abstract_params())
    # ZeRO all-reduces the squared gradient norm, a 0-d f32 like the loss
    scalars = [metrics["loss"]] * (2 if tcfg.zero else 1)
    plan, _ = planned_launches(session.engine, synced, scalars, p,
                               sync == "compressed")
    main = ("sum_chunks",) if sync == "composed" else (
        "quantize", "dequantize", "dequant_add")
    for name in SYNC_KERNELS:
        per, formula = plan.get(name, (0, "not on this path"))
        want = per * p * TRAIN_STEPS
        if per:
            print(f"[train]   {name}: {counts[name]} launches; plan {want} "
                  f"= {per} a rank a step x {p} ranks x {TRAIN_STEPS} steps "
                  f"({formula})")
        if counts[name] != want or (name in main and not want):
            raise AssertionError(f"{tag}: {name} launched {counts[name]} "
                                 f"times, plan {want}")
    st = states[0]
    record = dict(tag=tag, losses=losses, params=leaves(st["params"]),
                  step_ms=step_s * 1e3, peak_gib=peak / 2**30,
                  launches={n: counts[n] for n in main},
                  opt_bytes=_nbytes(leaves(st["opt"])),
                  ef_sizes=[e.numel() for e in st["ef"]]
                  if isinstance(st.get("ef"), tuple) else None,
                  n_units=len(synced))
    del session, states, step_fn, metrics, st
    return record


def _same_run(a, b) -> bool:
    same = a["losses"] == b["losses"] and all(
        _bits_equal(x, y) for x, y in zip(a["params"], b["params"]))
    print(f"[train] {a['tag']} and {b['tag']}: bit-identical losses and "
          f"parameters: {same}")
    if not same:
        raise AssertionError(f"{a['tag']} and {b['tag']} differ")
    return same


def phase_train_sync():
    """The train workload's sync run three more ways, each against the
    run it must equal bit for bit: composed in fused buckets, overlapped
    (depth 2) against blocking; compressed in buckets, overlapped against
    blocking, its EF residual in bucket layout; and ZeRO-1 (composed,
    overlapped) against the per-leaf composed run, both at clip_norm 0,
    with ZeRO's optimizer state half the unsharded state plus padding a
    rank.  Returns {path: {kernel: launches}} and the runs' numbers."""
    import gc
    from repro_torch.train import trainer
    from repro_torch.tree import leaves
    model, init, mesh, ds, opt = train_workload()
    p = mesh.size
    bucket = dict(bucket_grads=True)
    pairs = [
        ("composed, bucketed", "composed", opt, bucket,
         dict(bucket, overlap=True, overlap_depth=2)),
        ("compressed, bucketed", "compressed", opt, bucket,
         dict(bucket, overlap=True, overlap_depth=2)),
        ("composed, clip_norm 0", "composed", _adamw(TRAIN_LR,
                                                     clip_norm=0.0),
         {}, dict(zero=True, overlap=True, overlap_depth=2))]
    launches, numbers = {}, {}
    for name, sync, run_opt, base_cfg, new_cfg in pairs:
        runs = []
        for cfg in (base_cfg, new_cfg):
            kind = ("ZeRO-1, overlapped" if cfg.get("zero") else
                    "overlapped" if cfg.get("overlap") else
                    "blocking" if cfg else "per leaf")
            runs.append(_sync_run(model, init, mesh, ds, run_opt,
                                  f"{name}, {kind}", sync, **cfg))
            gc.collect()
            torch.cuda.empty_cache()
        base, new = runs
        _same_run(base, new)
        key = ("zero" if new_cfg.get("zero") else
               f"{sync}_bucketed")
        launches[key] = new["launches"]
        numbers[key] = dict(step_ms=new["step_ms"], peak_gib=new["peak_gib"],
                            base_step_ms=base["step_ms"],
                            base_peak_gib=base["peak_gib"])
        if sync == "compressed":
            plan = [b.size for b in trainer.grad_bucket_plan(
                model.abstract_params(), trainer.TrainCfg(
                    sync_mode=sync, **new_cfg), model.layout)]
            print(f"[train] {name}: EF residual in bucket layout: "
                  f"{new['ef_sizes'] == plan} ({len(plan)} flat f32 "
                  f"residuals of sizes {plan})")
            if new["ef_sizes"] != plan:
                raise AssertionError(f"EF layout {new['ef_sizes']} is not "
                                     f"the bucket plan {plan}")
        if new_cfg.get("zero"):
            n = [t.numel() for t in leaves(model.abstract_params())]
            want = 8 * sum(trainer._zero_pad_len(k, p) for k in n) // p + 4
            print(f"[train] ZeRO-1 optimizer state a rank: "
                  f"{new['opt_bytes']:,d} B against {base['opt_bytes']:,d} B "
                  f"unsharded (half of it plus padding: {want:,d} B)")
            if new["opt_bytes"] != want or base["opt_bytes"] != 8 * sum(
                    n) + 4:
                raise AssertionError("ZeRO optimizer-state bytes")
            numbers[key].update(opt_bytes=new["opt_bytes"],
                                base_opt_bytes=base["opt_bytes"])
        del runs, base, new
        gc.collect()
        torch.cuda.empty_cache()
    del init
    gc.collect()
    torch.cuda.empty_cache()
    return launches, numbers


def phase_ckpt():
    """The reduced granite-34b as ZeRO-1 over 4 thread ranks on the card
    for 2 steps, an async sharded save of its CUDA tensors, a restore onto
    2 ranks (``allow_resize_1d``) whose gathered logical state must equal
    the saved one bit for bit, one more step with a finite loss, and no
    ``.tmp`` directory left; then the same from (data 2, model 2) onto
    (1, 2)."""
    import shutil
    import tempfile
    from repro_torch.checkpoint import CheckpointManager, load_manifest
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLMDataset
    from repro_torch.launch.train import build_session
    from repro_torch.models import build_model
    from repro_torch.runtime import substrate
    from repro_torch.train import trainer
    from repro_torch.tree import flatten, map_tree
    cfg = get_config("granite-34b", reduced=True)
    model = build_model(cfg)
    init = model.init(torch.Generator(device="cuda").manual_seed(0))
    ds = SyntheticLMDataset(vocab_size=cfg.vocab_size,
                            seq_len=SMALL_TRAIN_SEQ, global_batch=4, seed=0)
    opt = _adamw(TRAIN_LR)
    tcfg = trainer.TrainCfg(zero=True, overlap=True)
    mesh4 = substrate.make_host_mesh(4, device="cuda")
    _, states, step_fn = train_run(model, init, mesh4, ds, opt, "composed",
                                   zero=True, overlap=True)
    for step in range(2):
        states, _ = step_fn(states, ds.host_batch(step))
    saved = trainer.gather_state(states, tcfg, mesh4, model)
    want = map_tree(lambda t: t.clone(), trainer.logical_state(saved))
    os.makedirs(os.path.join(HERE, "build"), exist_ok=True)
    root = tempfile.mkdtemp(prefix="ckpt_", dir=os.path.join(HERE, "build"))
    try:
        mgr = CheckpointManager(root, every=1, async_=True, sharded=True)
        mgr.maybe_save(2, saved)
        mgr.wait()
        names = sorted(os.listdir(root))
        shards = sum(len(e.get("shards", ())) for e in
                     load_manifest(root)["leaves"])
        mesh2 = substrate.make_host_mesh(2, device="cuda")
        tree, step = mgr.restore_latest(
            trainer.global_abstract_state(model, opt, tcfg, mesh2),
            device="cuda", allow_resize_1d=True)
        restored = trainer.scatter_state(tree, tcfg, mesh2, model)
        got = trainer.logical_state(trainer.gather_state(restored, tcfg,
                                                         mesh2, model))
        (gl, gp), (wl, wp) = flatten(got), flatten(want)
        same = gp == wp and all(_bits_equal(a, b) for a, b in zip(gl, wl))
        session = build_session(mesh2, model, opt, ds, tcfg)
        step_fn2 = trainer.make_train_step(model, opt, tcfg,
                                           comm=session.world)
        restored, metrics = step_fn2(restored, ds.host_batch(step))
        loss = metrics["loss"].item()
        print(f"[ckpt] ZeRO-1 reduced granite-34b, 4 ranks, 2 steps: async "
              f"sharded save ({shards} shard files); "
              f"directory holds {names}; restored at step {step} onto 2 "
              f"ranks: logical state bit-identical {same}; step {step + 1} "
              f"loss {loss:.4f}")
        if not same or not np.isfinite(loss) or names != [
                f"step_{2:08d}"] or not shards:
            raise AssertionError("checkpoint round trip onto 2 ranks")
    finally:
        shutil.rmtree(root, ignore_errors=True)

    # the same on a model axis: (data 2, model 2) -> (1, 2), the
    # checkpoint in the reference's global layout
    sess = trainer.TrainSession(build_model(cfg, model_parallel=2), opt,
                                tcfg)
    mesh22 = substrate.make_host_mesh(2, model_parallel=2, device="cuda")
    states = sess.init_state(torch.Generator(device="cuda").manual_seed(0),
                             mesh=mesh22)
    step_fn = sess.step_fn(build_session(mesh22, sess.model, opt, ds,
                                         tcfg).world)
    for step in range(2):
        states, _ = step_fn(states, ds.host_batch(step))
    saved = sess.gather(states, mesh22)
    want = map_tree(lambda t: t.clone(), trainer.logical_state(saved))
    root = tempfile.mkdtemp(prefix="ckpt_tp_", dir=os.path.join(HERE,
                                                                "build"))
    try:
        mgr = CheckpointManager(root, every=1, async_=True, sharded=True)
        mgr.maybe_save(2, saved)
        mgr.wait()
        shards = sum(len(e.get("shards", ())) for e in
                     load_manifest(root)["leaves"])
        mesh12 = substrate.make_mesh((1, 2), ("data", "model"),
                                     device="cuda")
        tree, step = mgr.restore_latest(sess.abstract_state(mesh12),
                                        device="cuda", allow_resize_1d=True)
        restored = sess.scatter(tree, mesh12)
        got = trainer.logical_state(sess.gather(restored, mesh12))
        (gl, gp), (wl, wp) = flatten(got), flatten(want)
        same = gp == wp and all(_bits_equal(a, b) for a, b in zip(gl, wl))
        step_fn = sess.step_fn(build_session(mesh12, sess.model, opt, ds,
                                             tcfg).world)
        restored, metrics = step_fn(restored, ds.host_batch(step))
        loss = metrics["loss"].item()
        print(f"[ckpt] the same on (data 2, model 2): async sharded save "
              f"({shards} shard files: the model ranks' blocks and the "
              f"data ranks' chunks); restored at step {step} onto (1, 2): "
              f"logical state bit-identical {same}; step {step + 1} loss "
              f"{loss:.4f}")
        if not same or not np.isfinite(loss) or not shards:
            raise AssertionError("checkpoint round trip (2, 2) -> (1, 2)")
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _writing(saves, a: float, b: float) -> bool:
    """Was one of ``saves`` (``CheckpointManager.saves``) being written
    between wall times ``a`` and ``b``?"""
    return any(sv["t_called"] < b and sv.get("t_durable", b) > a
               for sv in saves)


def _step_seconds(marks, saves, hooks=()):
    """(seconds, a save was being written meanwhile) of each step between
    two of ``marks`` ((step, mesh size, wall time, ...) at each step's
    end), less the save calls and the (start, end) ``hooks`` of this
    script that fell between them."""
    out = []
    for a, b in zip((m[2] for m in marks), (m[2] for m in marks[1:])):
        held = sum(sv["t_called"] - sv["t0"] for sv in saves
                   if a <= sv["t0"] < b)
        held += sum(t1 - t0 for t0, t1 in hooks if a <= t0 < b)
        out.append((b - a - held, _writing(saves, a, b)))
    return out


def _listed(steps, marks) -> str:
    return ", ".join(f"step {m[0]} {t * 1e3:.1f} ms"
                     + (" (a save being written)" if w else "")
                     for (t, w), m in zip(steps, marks[1:]))


def _dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, fs in os.walk(path) for f in fs)


def phase_elastic_train():
    """The train workload as ZeRO-1 over ELASTIC_TRAIN_RANKS thread ranks
    under ``ElasticController`` with ELASTIC_TRAIN_FAULTS, against a
    fresh 2-rank run restored from the same checkpoint.  Returns
    ({"sum_chunks": launches}, numbers)."""
    import gc
    import shutil
    import tempfile
    from repro_torch.kernels import counter
    from repro_torch.launch.train import build_session
    from repro_torch.runtime import substrate
    from repro_torch.runtime.controller import ElasticController, FaultPlan
    from repro_torch.train import trainer
    from repro_torch.tree import flatten, leaves
    model, init, _, ds, opt = train_workload()
    del init                                  # the controller inits
    tcfg = trainer.TrainCfg(zero=True)
    sess = trainer.TrainSession(model, opt, tcfg)
    mesh = substrate.make_host_mesh(ELASTIC_TRAIN_RANKS, device="cuda")
    comm = build_session(mesh, model, opt, ds, tcfg)
    synced = leaves(model.abstract_params())
    scalars = [torch.empty((), device="meta")] * 2   # loss, squared norm
    plan4, _ = planned_launches(comm.engine, synced, scalars, mesh.size,
                                False)
    state_bytes = _nbytes(leaves(sess.abstract_state(mesh=mesh)))
    os.makedirs(os.path.join(HERE, "build"), exist_ok=True)
    root = tempfile.mkdtemp(prefix="elastic_",
                            dir=os.path.join(HERE, "build"))
    free = shutil.disk_usage(root).free
    print(f"[elastic_train] checkpoint directory {os.path.relpath(root, HERE)}"
          f": {free:,d} bytes free; one save {state_bytes:,d} bytes (params "
          f"bf16 + ZeRO f32 moments + step counters)")
    if free < 2 * state_bytes:
        shutil.rmtree(root, ignore_errors=True)
        raise AssertionError(f"{free} bytes free < two saves")
    try:
        ctl = ElasticController(
            sess, ds, mesh, total_steps=ELASTIC_TRAIN_STEPS, ckpt_dir=root,
            comm=comm, ckpt_every=2, ckpt_keep=1, ckpt_sharded=True,
            rng_seed=0,
            fault_plan=FaultPlan.parse(ELASTIC_TRAIN_FAULTS, seed=0),
            watchdog_timeout=600.0)
        saves = ctl.ckpt.saves
        marks = []          # (step, mesh size, wall time, sum_chunks, loss)
        restored = {}       # step -> the host tree a restore read
        restore_latest = ctl.ckpt.restore_latest

        def keeping_restore(abstract, **kw):
            # this script's hook: the tree the recovery restores, kept
            # (the baseline starts from it; keep=1 collects its files)
            tree, step = restore_latest(abstract, **kw)
            if tree is not None:
                restored[step] = tree
            return tree, step

        def on_step(step, loss):
            torch.cuda.synchronize()
            marks.append((step, ctl.mesh.size, time.perf_counter(),
                          counter.counts()["sum_chunks"], loss))

        ctl.ckpt.restore_latest = keeping_restore
        ctl.on_step = on_step
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        counter.reset_all()
        t_start = time.perf_counter()
        report = ctl.run()
        torch.cuda.synchronize()
        launches = counter.counts()["sum_chunks"]
        peak4 = torch.cuda.max_memory_allocated()
        rec = report.recoveries[0]
        plan2, _ = planned_launches(comm.engine, synced, scalars, 2, False)
        last = saves[-1]
        save_bytes = _dir_bytes(os.path.join(root,
                                             f"step_{last['step']:08d}"))
        final = flatten(trainer.logical_state(sess.gather(ctl.states,
                                                          ctl.mesh)))[0]
        losses = report.losses
        losses4 = {m[0]: m[4] for m in marks if m[1] == ELASTIC_TRAIN_RANKS}
        del ctl, comm
        gc.collect()
        torch.cuda.empty_cache()

        # the 4-rank steps again from the same seed with the plain
        # combine: the same losses, and at the restored step the same
        # state as the checkpoint the recovery read
        states = sess.init_state(torch.Generator(device="cuda").manual_seed(
            0), mesh=mesh)
        step_fn = sess.step_fn(build_session(mesh, model, opt, ds,
                                             tcfg).world)
        plain4, same_ckpt = {}, None
        with plain_sync_ops():
            for s in sorted(losses4):
                states, m = step_fn(states, ds.host_batch(s))
                plain4[s] = m["loss"].item()
                if s + 1 == rec.restored_step:
                    got = flatten(trainer.logical_state(sess.gather(
                        states, mesh)))[0]
                    want = flatten(trainer.logical_state(
                        restored[rec.restored_step]))[0]
                    same_ckpt = len(got) == len(want) and all(
                        _bits_equal(a, b.to(a.device))
                        for a, b in zip(got, want))
                    del got, want
        same_plain = plain4 == losses4
        del states, step_fn
        gc.collect()
        torch.cuda.empty_cache()

        # baseline: a fresh 2-rank run from the same step-2 checkpoint
        mesh2 = substrate.make_mesh((2,), ("data",), device="cuda",
                                    members=rec.healthy_after)
        states = sess.scatter(restored.pop(rec.restored_step), mesh2)
        step_fn = sess.step_fn(build_session(mesh2, model, opt, ds,
                                             tcfg).world)
        base = {}
        for s in range(rec.restored_step, ELASTIC_TRAIN_STEPS):
            states, m = step_fn(states, ds.host_batch(s))
            base[s] = m["loss"].item()
        want = flatten(trainer.logical_state(sess.gather(states,
                                                         mesh2)))[0]
        same_state = len(final) == len(want) and all(
            _bits_equal(a, b) for a, b in zip(final, want))
        del states, step_fn, want, final, restored
        gc.collect()
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(root, ignore_errors=True)

    before = [m for m in marks if m[1] == ELASTIC_TRAIN_RANKS]
    after = [m for m in marks if m[1] == 2]
    n4 = before[-1][3]
    n2 = launches - n4
    want4 = plan4["sum_chunks"][0] * ELASTIC_TRAIN_RANKS * len(before)
    want2 = plan2["sum_chunks"][0] * 2 * len(after)
    steps4, steps2 = _step_seconds(before, saves), _step_seconds(after,
                                                                   saves)
    step4 = float(np.mean([t for t, _ in steps4]))
    step2 = float(np.mean([t for t, _ in steps2]))
    same_losses = {s: losses[s] for s in base} == base
    print(f"[elastic_train] {ELASTIC_TRAIN_FAULTS}: {report.describe()}")
    print(f"[elastic_train] recovery: restore {rec.restore_s:.3f}s, "
          f"re-mesh {rec.remesh_s:.3f}s, re-plan {rec.replan_s:.3f}s "
          f"(total {rec.total_s:.3f}s), restored step {rec.restored_step}, "
          f"survivors {rec.healthy_after}; plan rebuilds "
          f"{report.plan_rebuilds}")
    print(f"[elastic_train] losses {[losses[s] for s in sorted(losses)]}; "
          f"baseline (2 ranks from step 2) {[base[s] for s in sorted(base)]}"
          f": bit-identical {same_losses}; final logical state "
          f"bit-identical {same_state}")
    print(f"[elastic_train] the {ELASTIC_TRAIN_RANKS}-rank steps again "
          f"with the plain combine (ref.sum_chunks): losses "
          f"{[plain4[s] for s in sorted(plain4)]}, bit-identical "
          f"{same_plain}; state at step {rec.restored_step} bit-identical "
          f"to the checkpoint the recovery restored: {same_ckpt}")
    print(f"[elastic_train] step {step4 * 1e3:.1f} ms at 4 ranks "
          f"({_listed(steps4, before)}), {step2 * 1e3:.1f} ms at 2 ranks "
          f"({_listed(steps2, after)}), host clock less the save calls; "
          f"peak allocated {peak4 / 2**30:.2f} GiB; whole run "
          f"{marks[-1][2] - t_start:.1f}s")
    print(f"[elastic_train] sum_chunks launches {n4} at p=4 (plan "
          f"{want4} = {plan4['sum_chunks'][0]} a rank a step x 4 x "
          f"{len(before)}) and {n2} at p=2 (plan {want2} = "
          f"{plan2['sum_chunks'][0]} x 2 x {len(after)})")
    for sv in saves:
        print(f"[elastic_train] save at step {sv['step']}: waited "
              f"{sv['wait_s']:.3f}s for the previous save, call "
              f"{sv['call_s']:.3f}s, durable "
              f"{sv.get('durable_s', float('nan')):.3f}s after the call "
              f"began")
    print(f"[elastic_train] one full-width save: {save_bytes:,d} bytes on "
          f"disk")
    if not (same_losses and same_state):
        raise AssertionError("elastic run differs from its baseline")
    if not (same_plain and same_ckpt):
        raise AssertionError(f"the {ELASTIC_TRAIN_RANKS}-rank steps differ "
                             "from their plain-combine twin")
    if report.plan_rebuilds != 1 or report.mesh_history != [
            (ELASTIC_TRAIN_RANKS,), (2,)] or rec.restored_step != 2:
        raise AssertionError(report.describe())
    if n4 != want4 or n2 != want2 or not (n4 and n2):
        raise AssertionError(f"sum_chunks {n4}/{n2}, plan {want4}/{want2}")
    if not all(np.isfinite(list(losses.values()))):
        raise AssertionError(f"losses {losses}")
    if not all("durable_s" in sv for sv in saves):
        raise AssertionError(f"a save never became durable: {saves}")
    return {"sum_chunks": launches}, dict(
        restore_s=rec.restore_s, remesh_s=rec.remesh_s,
        replan_s=rec.replan_s, step_ms_4=step4 * 1e3, step_ms_2=step2 * 1e3,
        peak_gib=peak4 / 2**30, save_bytes=save_bytes, saves=saves)


def phase_elastic_tp():
    """The train workload as ZeRO-1 on (data, model) ELASTIC_TP_SHAPE
    thread ranks under ``ElasticController`` with ELASTIC_TP_FAULTS
    (which plans (1, 2)), sharded checkpoints in the reference's global
    layout every 2 steps, against a fresh (1, 2) run restored from the
    same checkpoint.  Returns ({"sum_chunks": launches}, numbers)."""
    import gc
    import shutil
    import tempfile
    from repro_torch.kernels import counter
    from repro_torch.launch.train import build_session
    from repro_torch.models import build_model
    from repro_torch.runtime import substrate
    from repro_torch.runtime.controller import ElasticController, FaultPlan
    from repro_torch.train import trainer
    from repro_torch.tree import flatten, leaves, map_tree
    full, init, _, ds, opt = train_workload()
    del init                                  # the controller inits
    data, mp = ELASTIC_TP_SHAPE
    model = build_model(full.cfg, model_parallel=mp)
    tcfg = trainer.TrainCfg(zero=True, check_model_replicas=True)
    sess = trainer.TrainSession(model, opt, tcfg)
    mesh = substrate.make_host_mesh(data, model_parallel=mp, device="cuda")
    comm = build_session(mesh, model, opt, ds, tcfg)
    synced = leaves(model.abstract_params())  # a rank's shard
    # loss, the split and the replicated leaves' squared norms
    scalars = [torch.empty((), device="meta")] * 3
    psums = tp_psums(model)

    def per_rank(p):
        plan, _ = planned_launches(comm.engine, synced, scalars, p, False)
        return plan["sum_chunks"][0] + psums * (mp - 1)
    per4 = per_rank(data)
    state_bytes = _nbytes(leaves(sess.abstract_state(mesh=mesh)))
    os.makedirs(os.path.join(HERE, "build"), exist_ok=True)
    root = tempfile.mkdtemp(prefix="elastic_tp_",
                            dir=os.path.join(HERE, "build"))
    free = shutil.disk_usage(root).free
    print(f"[elastic_tp] {full.cfg.name} {full.cfg.num_layers} layers on "
          f"{dict(mesh.shape)}, ZeRO-1, {ELASTIC_TP_FAULTS}; checkpoint "
          f"directory {os.path.relpath(root, HERE)}: {free:,d} bytes free; "
          f"one save {state_bytes:,d} bytes (the global tree: params bf16 "
          f"+ ZeRO f32 moments + step counters)")
    if free < 2 * state_bytes:
        shutil.rmtree(root, ignore_errors=True)
        raise AssertionError(f"{free} bytes free < two saves")
    try:
        ctl = ElasticController(
            sess, ds, mesh, total_steps=ELASTIC_TRAIN_STEPS, ckpt_dir=root,
            comm=comm, ckpt_every=2, ckpt_keep=1, ckpt_sharded=True,
            rng_seed=0, fault_plan=FaultPlan.parse(ELASTIC_TP_FAULTS, seed=0),
            watchdog_timeout=600.0)
        saves = ctl.ckpt.saves
        marks = []          # (step, mesh size, wall time, sum_chunks, loss)
        restored = {}       # step -> the host tree the recovery read
        held = {}           # step -> the logical state saved, on the host
        hooks = []          # (start, end) of each copy the hook made
        gathers = []        # (start, end) of each gather before a save
        same_saved = []
        maybe_save, restore_latest = ctl.ckpt.maybe_save, \
            ctl.ckpt.restore_latest
        gather = ctl._gathered

        def timed_gather():
            # the global tree's assembly for a save: save work, not a
            # step's
            t0 = time.perf_counter()
            tree = gather()
            gathers.append((t0, time.perf_counter()))
            return tree

        def keeping_save(step, tree, force=False):
            # this script's hook: until the recovery, the last save's
            # logical state, which its restore must give back
            if not restored:
                t0 = time.perf_counter()
                held.clear()
                held[step] = map_tree(lambda t: t.to("cpu", copy=True),
                                      trainer.logical_state(tree))
                hooks.append((t0, time.perf_counter()))
            return maybe_save(step, tree, force=force)

        def keeping_restore(abstract, **kw):
            tree, step = restore_latest(abstract, **kw)
            if tree is not None:
                restored[step] = tree
                (gl, gp), (wl, wp) = (flatten(trainer.logical_state(tree)),
                                      flatten(held.pop(step)))
                same_saved.append(gp == wp and all(
                    _bits_equal(a, b) for a, b in zip(gl, wl)))
            return tree, step

        def on_step(step, loss):
            torch.cuda.synchronize()
            marks.append((step, ctl.mesh.size, time.perf_counter(),
                          counter.counts()["sum_chunks"], loss))

        ctl.ckpt.maybe_save = keeping_save
        ctl.ckpt.restore_latest = keeping_restore
        ctl._gathered = timed_gather
        ctl.on_step = on_step
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        counter.reset_all()
        t_start = time.perf_counter()
        report = ctl.run()
        torch.cuda.synchronize()
        launches = counter.counts()["sum_chunks"]
        peak = torch.cuda.max_memory_allocated()
        rec = report.recoveries[0]
        per2 = per_rank(rec.after_shape[0])
        last = saves[-1]
        save_bytes = _dir_bytes(os.path.join(root,
                                             f"step_{last['step']:08d}"))
        losses = report.losses
        del ctl, comm
        gc.collect()
        torch.cuda.empty_cache()

        # baseline: a fresh run on the survivors' mesh from the same
        # checkpoint
        mesh2 = substrate.make_mesh(rec.after_shape, mesh.axis_names,
                                    device="cuda",
                                    members=rec.healthy_after)
        states = sess.scatter(restored.pop(rec.restored_step), mesh2)
        step_fn = sess.step_fn(build_session(mesh2, model, opt, ds,
                                             tcfg).world)
        base = {}
        for s in range(rec.restored_step, ELASTIC_TRAIN_STEPS):
            states, m = step_fn(states, ds.host_batch(s))
            base[s] = m["loss"].item()
        del states, step_fn, restored
        gc.collect()
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(root, ignore_errors=True)

    before = [m for m in marks if m[1] == mesh.size]
    after = [m for m in marks if m[1] != mesh.size]
    n4 = before[-1][3]
    n2 = launches - n4
    want4 = per4 * mesh.size * len(before)
    want2 = per2 * math.prod(rec.after_shape) * len(after)
    steps4, steps2 = (_step_seconds(before, saves, hooks + gathers),
                      _step_seconds(after, saves, hooks + gathers))
    step4 = float(np.mean([t for t, _ in steps4]))
    step2 = float(np.mean([t for t, _ in steps2]))
    same_losses = {s: losses[s] for s in base} == base
    print(f"[elastic_tp] {ELASTIC_TP_FAULTS}: {report.describe()}")
    print(f"[elastic_tp] recovery: restore {rec.restore_s:.3f}s, re-mesh "
          f"{rec.remesh_s:.3f}s, re-plan {rec.replan_s:.3f}s (total "
          f"{rec.total_s:.3f}s), restored step {rec.restored_step}, "
          f"survivors {rec.healthy_after}; plan rebuilds "
          f"{report.plan_rebuilds}")
    print(f"[elastic_tp] losses {[losses[s] for s in sorted(losses)]}; "
          f"baseline ({rec.after_shape} from step {rec.restored_step}) "
          f"{[base[s] for s in sorted(base)]}: bit-identical "
          f"{same_losses}; restored global tree bit-equal to the saved "
          f"one: {same_saved}; model-replicated gradients bit-equal "
          f"across \"model\" every step (check_model_replicas)")
    print(f"[elastic_tp] step {step4 * 1e3:.1f} ms on {ELASTIC_TP_SHAPE} "
          f"({_listed(steps4, before)}), {step2 * 1e3:.1f} ms on "
          f"{rec.after_shape} ({_listed(steps2, after)}), host clock less "
          f"the save calls, the gathers for them "
          f"({', '.join(f'{t1 - t0:.3f}s' for t0, t1 in gathers)}) and "
          f"this script's copies of the saved state "
          f"({', '.join(f'{t1 - t0:.3f}s' for t0, t1 in hooks)}); peak "
          f"allocated {peak / 2**30:.2f} GiB; whole run "
          f"{marks[-1][2] - t_start:.1f}s")
    print(f"[elastic_tp] sum_chunks launches {n4} on {ELASTIC_TP_SHAPE} "
          f"(plan {want4} = {per4} a rank a step: data sync + {psums} "
          f"model-axis all-reduces x {mp - 1}; x {mesh.size} x "
          f"{len(before)}) and {n2} on {rec.after_shape} (plan {want2} = "
          f"{per2} x {math.prod(rec.after_shape)} x {len(after)})")
    for sv in saves:
        print(f"[elastic_tp] save at step {sv['step']}: waited "
              f"{sv['wait_s']:.3f}s for the previous save, call "
              f"{sv['call_s']:.3f}s, durable "
              f"{sv.get('durable_s', float('nan')):.3f}s after the call "
              f"began")
    print(f"[elastic_tp] one save: {save_bytes:,d} bytes on disk")
    if not same_losses or same_saved != [True]:
        raise AssertionError("elastic TP run differs from its baseline or "
                             "its checkpoint")
    if report.plan_rebuilds != 1 or report.mesh_history != [
            ELASTIC_TP_SHAPE, (1, mp)] or rec.restored_step != 2:
        raise AssertionError(report.describe())
    if n4 != want4 or n2 != want2 or not (n4 and n2):
        raise AssertionError(f"sum_chunks {n4}/{n2}, plan {want4}/{want2}")
    if not all(np.isfinite(list(losses.values()))):
        raise AssertionError(f"losses {losses}")
    if not all("durable_s" in sv for sv in saves):
        raise AssertionError(f"a save never became durable: {saves}")
    return {"sum_chunks": launches}, dict(
        restore_s=rec.restore_s, remesh_s=rec.remesh_s,
        replan_s=rec.replan_s, step_ms_before=step4 * 1e3,
        step_ms_after=step2 * 1e3, peak_gib=peak / 2**30,
        save_bytes=save_bytes, saves=saves,
        gather_s=[t1 - t0 for t0, t1 in gathers])


@contextlib.contextmanager
def _record_logits(into):
    """Record, by (rid, position), each logits row that a request's token
    is picked from while the block runs: a prefill's last row, and the
    rows of the slots each decode step decodes (free slots and slots
    still prefilling are passed over).  This script's hooks on
    ``serve.engine._pick_tokens`` and ``PagePool.bind_decode``."""
    from repro_torch.serve import engine, paging
    pick, bind = engine._pick_tokens, paging.PagePool.bind_decode
    decoding = []       # the decode step under way: its rows' rids or None

    def recording(logits, cfg, rids, pos):
        # a decode step calls the model once a block of rows: each call
        # takes the next rows of its step (padding rows have no slot)
        n = logits.shape[0]
        if decoding:
            rows = decoding[-1][:n]
            del decoding[-1][:n]
        else:
            rows = torch.as_tensor(rids).tolist()
        for i, (rid, p) in enumerate(zip(rows, torch.as_tensor(
                pos).tolist())):
            if rid is not None:
                if (rid, p) in into:
                    raise AssertionError(f"rid {rid} position {p} twice")
                into[(rid, p)] = logits[i].detach().float().cpu()
        return pick(logits, cfg, rids, pos)

    def bind_decode(pool, decode_fn, *args):
        run = bind(pool, decode_fn, *args)

        def recorded(params, tok, rids, pos, slot_rids, active_mask):
            decoding.append([r if a else None
                             for r, a in zip(slot_rids, active_mask)])
            try:
                return run(params, tok, rids, pos, slot_rids, active_mask)
            finally:
                decoding.pop()
        return recorded

    engine._pick_tokens, paging.PagePool.bind_decode = recording, bind_decode
    try:
        yield into
    finally:
        engine._pick_tokens, paging.PagePool.bind_decode = pick, bind


def _decode_rows_equal(model, params, scfg, vocab):
    """ROWS_PROMPTS requests decoded ROWS_MAX_NEW tokens at batch 8 and
    at batch 4 (the first half and the second each in a batch of their
    own), through the scheduler.  Returns (are the logits of each
    (request, position) whose tokens so far agree equal bit for bit, the
    largest |difference| between them, how many such rows).  Prompts are
    64 tokens long, or one SSD chunk for a model with Mamba layers."""
    import dataclasses
    from repro_torch.serve import BatchScheduler, Request
    from repro_torch.serve.engine import prompt_len
    rng = np.random.RandomState(7)
    prompts = [rng.randint(0, vocab, size=prompt_len(model.cfg, 64)).tolist()
               for _ in range(ROWS_PROMPTS)]

    def run(rids, batch):
        got = {}
        reqs = [Request(rid=r, prompt=prompts[r], max_new=ROWS_MAX_NEW)
                for r in rids]
        with _record_logits(got):
            # built under the hook, so its decode binding is the hooked
            # one and only decoding slots' rows are recorded
            sched = BatchScheduler(model, params, dataclasses.replace(
                scfg, batch=batch), device="cuda")
            for r in reqs:
                sched.submit(r)
            sched.run()
        return got, {r.rid: r.generated for r in reqs}

    half = ROWS_PROMPTS // 2
    at8, tok8 = run(range(ROWS_PROMPTS), 8)
    lo, lo_tok = run(range(half), 4)
    hi, hi_tok = run(range(half, ROWS_PROMPTS), 4)
    at4, tok4 = {**lo, **hi}, {**lo_tok, **hi_tok}
    keys = [(r, p) for r in range(ROWS_PROMPTS) for p in range(
        1, ROWS_MAX_NEW) if tok8[r][:p] == tok4[r][:p]]
    equal = all(_bits_equal(at8[k], at4[k]) for k in keys)
    diff = max((at8[k] - at4[k]).abs().max().item() for k in keys)
    return equal, diff, len(keys)


def _batch_dependent_ops(model, params, scfg, vocab):
    """Which op makes a decode row depend on the batch: one decode step of
    ROWS_PROMPTS requests (64-token prompts, prefilled once at batch 8)
    called on the model directly at batch 8, and on the first half of
    the same caches at batch 4, with every GEMM and batched product
    (``mm``, ``addmm``, ``bmm``, ``baddbmm``) recorded in call order.
    Returns [(index, op, shape at 8, shape at 4, largest |difference|)]
    of the ops whose batch-4 rows differ from the batch-8 rows (read
    batch-major, and for a batched product also head-major), and
    whether the logits are equal."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from repro_torch.serve.paging import layout_for
    from repro_torch.tree import flatten, unflatten
    aten = torch.ops.aten
    gemms = {aten.mm.default, aten.addmm.default, aten.bmm.default,
             aten.baddbmm.default}

    class Recorder(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if func in gemms:
                self.ops.append((func.__name__, out.detach().float().cpu()))
            return out

    b, half = ROWS_PROMPTS, ROWS_PROMPTS // 2
    rng = np.random.RandomState(7)
    toks = torch.tensor(rng.randint(0, vocab, size=(b, 64)), device="cuda")
    caches = model.init_caches(b, scfg.max_len, dtype=scfg.cache_dtype,
                               device="cuda")
    with torch.no_grad():
        logits, caches = model.prefill(params, {"tokens": toks}, caches)
        nxt = torch.argmax(logits, dim=-1)[:, None]
        ls, paths = flatten(caches)
        caches4 = unflatten(paths, [
            l.narrow(lay.batch_axis, 0, half).contiguous()
            for l, lay in zip(ls, layout_for(model, scfg).leaves)])
        out = {}
        for n, cs in ((b, caches), (half, caches4)):
            rec = Recorder()
            with rec:
                lg, _ = model.decode_step(params, {"tokens": nxt[:n]}, cs)
            out[n] = (lg.float().cpu(), rec.ops)
    (lg8, ops8), (lg4, ops4) = out[b], out[half]
    differ = []
    for i, ((name, o8), (_, o4)) in enumerate(zip(ops8, ops4)):
        views = [(o8.reshape(b, -1)[:half], o4.reshape(half, -1))]
        if o8.dim() == 3 and o8.shape[0] % b == 0:
            views.append((o8.reshape(-1, b, *o8.shape[1:])[:, :half],
                          o4.reshape(-1, half, *o4.shape[1:])))
        if not any(torch.equal(x, y) for x, y in views):
            differ.append((i, name, tuple(o8.shape), tuple(o4.shape),
                           min((x - y).abs().max().item() for x, y in views)))
    del caches, caches4
    torch.cuda.empty_cache()
    return differ, len(ops8), torch.equal(lg8[:half], lg4)


def _elastic_serve_run(model, params, scfg, prompts, ranks, faults,
                       members=None):
    """Serve ``prompts`` under ``ServeController`` over a session of
    ``ranks`` data thread ranks (``faults`` = None: a plain scheduler on
    that session, the survivor baseline).  Returns (report or scheduler,
    requests, [(wall time, tokens so far) after each step])."""
    from repro_torch.comm import Session
    from repro_torch.runtime import substrate
    from repro_torch.runtime.controller import FaultPlan
    from repro_torch.serve import BatchScheduler, Request, ServeController
    comm = Session(mesh=substrate.make_mesh(
        (ranks,), ("data",), device="cuda", members=members)).world
    reqs = [Request(rid=rid, prompt=p, max_new=SERVE_MAX_NEW)
            for rid, p in enumerate(prompts)]
    log = []
    step = BatchScheduler.step

    def logged(self):
        out = step(self)
        torch.cuda.synchronize()
        log.append((time.perf_counter(),
                    sum(len(r.generated) for r in reqs)))
        return out

    BatchScheduler.step = logged
    try:
        if faults is None:
            runner = BatchScheduler(model, params, scfg, comm=comm)
        else:
            runner = ServeController(
                model, params, scfg, comm=comm,
                fault_plan=FaultPlan.parse(faults, seed=0),
                watchdog_timeout=600.0)
        log.append((time.perf_counter(), 0))
        for r in reqs:
            runner.submit(r)
        runner.run()
    finally:
        BatchScheduler.step = step
    return runner, reqs, log


def _small_elastic_serve():
    """The reduced qwen2-72b (f32, 8-token pages) served over 4 data ranks
    with ``lose@3:2`` on the card and over the 2 survivors uninterrupted:
    are the streams equal?"""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.serve import ServeCfg
    model = build_model(get_config("qwen2-72b", reduced=True))
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, 256, size=rng.randint(3, 50)).tolist()
               for _ in range(12)]
    cfg = ServeCfg(max_len=64 + SERVE_MAX_NEW, batch=8, page_tokens=8,
                   cache_dtype=torch.float32)
    import dataclasses
    ctl, _, _ = _elastic_serve_run(model, params, cfg, prompts, 4,
                                   "lose@3:2")
    rec = ctl.report.recoveries[0]
    base, _, _ = _elastic_serve_run(model, params, dataclasses.replace(
        cfg, batch=4), prompts, 2, None, members=rec.healthy_after)
    return ctl.report.tokens() == {r.rid: r.generated
                                   for r in base.completed}


def phase_elastic_serve():
    """The serve workload over ELASTIC_SERVE_RANKS data thread ranks under
    ``ServeController`` with ELASTIC_SERVE_FAULTS, against an
    uninterrupted run on the survivors.  Returns
    ({"flash_attention": launches}, numbers)."""
    import dataclasses
    import gc
    from repro_torch.kernels import counter
    from repro_torch.serve import plan_serve_batch
    from repro_torch.serve.engine import DECODE_ROWS
    model, params, scfg, prompts = serve_workload()
    cfg = model.cfg
    differ, n_ops, direct_equal = _batch_dependent_ops(model, params, scfg,
                                                       cfg.vocab_size)
    print(f"[elastic_serve] one decode step called on the model directly "
          f"(no row blocks) at batch 8 and 4: logits equal {direct_equal}; "
          f"{len(differ)} of {n_ops} GEMMs / batched products differ"
          + (f", first #{differ[0][0]} {differ[0][1]} {differ[0][2]} vs "
             f"{differ[0][3]} (|diff| {differ[0][4]:.6g}); all: "
             f"{[(i, n, s8) for i, n, s8, _, _ in differ]}" if differ
             else ""))
    rows_equal, row_diff, n_rows = _decode_rows_equal(model, params, scfg,
                                                      cfg.vocab_size)
    print(f"[elastic_serve] decode logits of the same requests at batch 8 "
          f"and batch 4 through the scheduler (blocks of {DECODE_ROWS} "
          f"rows; {n_rows} (request, position) rows): bit-identical "
          f"{rows_equal}, largest |difference| {row_diff:.6g}")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counter.reset_all()
    ctl, reqs, log = _elastic_serve_run(model, params, scfg, prompts,
                                        ELASTIC_SERVE_RANKS,
                                        ELASTIC_SERVE_FAULTS)
    launches = counter.counts()["flash_attention"]
    tc_launches = counter.counts()["flash_attention_tc"]
    peak = torch.cuda.max_memory_allocated()
    report = ctl.report
    rec = report.recoveries[0]
    ctl.sched.pool.check_integrity()
    lens = [len(p) for p in prompts]
    n_chunks = sum(-(-n // scfg.page_tokens) for n in lens)
    want_launches = SERVE_LAYERS * (n_chunks + rec.requeued_chunks)
    # tokens/s before the drain and after the re-admission: the steps
    # before the fault, and those after it (the recovery's own seconds
    # between them are not counted)
    k = rec.step
    t_before = log[k][0] - log[0][0]
    tok_before = log[k][1]
    t_after = log[-1][0] - log[k + 1][0]
    tok_after = log[-1][1] - log[k + 1][1]
    tokens = report.tokens()
    del ctl
    gc.collect()
    torch.cuda.empty_cache()

    base_cfg = dataclasses.replace(scfg, batch=plan_serve_batch(
        scfg.batch, ELASTIC_SERVE_RANKS, 2))
    gaps = {}
    with _record_logits(gaps):
        base, _, _ = _elastic_serve_run(model, params, base_cfg, prompts, 2,
                                        None, members=rec.healthy_after)
    baseline = {r.rid: r.generated for r in base.completed}
    del base
    gc.collect()
    torch.cuda.empty_cache()

    print(f"[elastic_serve] {ELASTIC_SERVE_FAULTS}: {report.describe()}")
    print(f"[elastic_serve] recovery: snapshot {rec.snapshot_s:.3f}s, "
          f"re-mesh {rec.remesh_s:.3f}s, rebuild {rec.rebuild_s:.3f}s "
          f"(total {rec.total_s:.3f}s); resumed {rec.resumed}, parked "
          f"{rec.parked}, back to the queue mid-prefill {rec.requeued} "
          f"({rec.requeued_chunks} chunks run again); snapshot "
          f"{rec.snapshot_bytes:,d} bytes paged against "
          f"{rec.snapshot_bytes_contiguous:,d} contiguous")
    print(f"[elastic_serve] {len(report.completed)}/{SERVE_REQUESTS} done, "
          f"{len(report.shed)} shed; {tok_before} tokens in {t_before:.2f}s "
          f"= {tok_before / t_before:.1f} tok/s before the drain (batch "
          f"{rec.batch_before}), {tok_after} in {t_after:.2f}s = "
          f"{tok_after / t_after:.1f} tok/s after (batch {rec.batch_after}); "
          f"peak allocated {peak / 2**30:.2f} GiB")
    print(f"[elastic_serve] flash launches {launches} = {SERVE_LAYERS} "
          f"layers x ({n_chunks} prompt chunks + {rec.requeued_chunks} "
          f"re-run): {launches == want_launches}; on the tensor-core "
          f"variant: {tc_launches}")
    if rows_equal:
        same = tokens == baseline
        n_same = sum(sum(a == b for a, b in zip(tokens[rid], want))
                     for rid, want in baseline.items())
        print(f"[elastic_serve] streams equal to the survivor run's "
              f"(data 2, batch {base_cfg.batch}) bit for bit: {same}; "
              f"{n_same} of {SERVE_REQUESTS * SERVE_MAX_NEW} tokens equal")
    else:
        small = _small_elastic_serve()
        print(f"[elastic_serve] reduced f32 model on the card: elastic "
              f"streams equal to its survivor run's: {small}")
        # a near-tie: a top-2 gap that the batch-size difference measured
        # above can close (each of the two logits may move by row_diff)
        tie = 2 * row_diff
        held, ok = {}, True
        for rid, want in sorted(baseline.items()):
            got = tokens[rid]
            first_tie = next((p for p in range(len(want))
                              if _top2_gap(gaps[(rid, p)]) <= tie),
                             len(want))
            held[rid] = next((p for p in range(len(want))
                              if got[p] != want[p]), len(want))
            ok &= held[rid] >= first_tie
        n_held = sum(held.values())
        need = MIN_HELD_SHARE * SERVE_REQUESTS * SERVE_MAX_NEW
        same = small and ok and n_held >= need
        print(f"[elastic_serve] full-width streams: tokens equal to the "
              f"survivor run's, by rid: {held}; "
              f"{sum(h < SERVE_MAX_NEW for h in held.values())} of "
              f"{len(baseline)} differ, each only at or after its first "
              f"near-tie (top-2 gap <= {tie:.6g}): {ok}; {n_held} of "
              f"{SERVE_REQUESTS * SERVE_MAX_NEW} tokens held (at least "
              f"{need:.0f})")
    if len(report.completed) != SERVE_REQUESTS or report.shed:
        raise AssertionError("not every request completed")
    for r in report.completed:
        if len(r.generated) != SERVE_MAX_NEW:
            raise AssertionError(f"rid {r.rid}: {r.generated}")
    if report.mesh_history != [(ELASTIC_SERVE_RANKS,), (2,)] or \
            report.batch_history != [scfg.batch, base_cfg.batch]:
        raise AssertionError(report.describe())
    if tc_launches != launches or launches != want_launches:
        raise AssertionError(f"flash launches {launches} (tensor-core "
                             f"{tc_launches}), want {want_launches}")
    if not same:
        raise AssertionError("elastic streams differ from the survivors'")
    return {"flash_attention": launches}, dict(
        snapshot_s=rec.snapshot_s, remesh_s=rec.remesh_s,
        rebuild_s=rec.rebuild_s, tok_s_before=tok_before / t_before,
        tok_s_after=tok_after / t_after, peak_gib=peak / 2**30,
        rows_equal=rows_equal, row_diff=row_diff, ops_differ=differ)


def _top2_gap(row: torch.Tensor) -> float:
    top = torch.topk(row, 2).values
    return (top[0] - top[1]).item()


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


SYNC_SOURCES = {
    "sum_chunks": ("local_reduce/csrc/local_reduce.cu",
                   "src/repro/kernels/local_reduce/kernel.py:37"),
    "quantize": ("quantize/csrc/quantize.cu",
                 "src/repro/kernels/quantize/kernel.py:59"),
    "dequantize": ("quantize/csrc/quantize.cu",
                   "src/repro/kernels/quantize/kernel.py:76"),
    "dequant_add": ("quantize/csrc/quantize.cu",
                    "src/repro/kernels/quantize/kernel.py:90")}


def _sync_entry(name, sync_rows, train, by_path):
    """The kernels-line entry of a sync kernel: times at its largest
    main-path call (the combine chunk in the gradients' bf16, the
    compressed chunk in f32), launches from the per-leaf training run
    and, by path, from the bucketed and ZeRO runs."""
    key = ((name, "combine chunk", "bfloat16") if name == "sum_chunks"
           else (name, "compressed chunk", "float32"))
    row = sync_rows[key]
    source, replaces = SYNC_SOURCES[name]
    return {"name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/" + source,
            "replaces": replaces, "launches": train[name],
            "launches_by_path": {path: counts[name] for path, counts
                                 in by_path.items() if name in counts},
            "max_abs_err": max(r["max_abs_err"] for k, r in
                               sync_rows.items() if k[0] == name),
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"]}


def timed(name, fn, *args):
    """Run one phase and print its seconds on a line of its own."""
    t0 = time.perf_counter()
    out = fn(*args)
    print(f"[phase] {name}: {time.perf_counter() - t0:.1f}s")
    return out


def main() -> int:
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(HERE, "src"))
    from repro_torch.kernels.flash_attention import kernel, ref
    from repro_torch.kernels.local_reduce import kernel as lkernel
    from repro_torch.kernels.quantize import kernel as qkernel
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    timed("build", phase_build, [kernel.LIBRARY, lkernel.LIBRARY,
                                 qkernel.LIBRARY])
    rows = timed("kernels", phase_kernels, kernel, ref)
    timed("small", phase_small)
    serve = timed("serve", phase_serve, ref)
    serve_moe = timed("serve_moe", phase_serve_moe, ref)
    serve_nemotron = timed("serve_nemotron", phase_serve_nemotron, ref)
    serve_deepseek = timed("serve_deepseek", phase_serve_deepseek, ref)
    serve_jamba = timed("serve_jamba", phase_serve_jamba, ref)
    serve_mamba2 = timed("serve_mamba2", phase_serve_mamba2, ref)
    serve_vl = timed("serve_vl", phase_serve_vl, ref)
    serve_seamless = timed("serve_seamless", phase_serve_seamless, ref)
    serve_tp = timed("serve_tp", phase_serve_tp)
    sync_rows = timed("collectives", phase_collectives)
    lib_launches, _ = timed("collectives_lib", phase_collectives_lib)
    timed("train_small", phase_train_small)
    train = timed("train", phase_train)
    by_path, _ = timed("train (sync)", phase_train_sync)
    by_path["train_auto"], auto = timed("train_auto", phase_train_auto,
                                        train)
    by_path["train_tp"], tp_numbers = timed("train_tp", phase_train_tp,
                                            train)
    by_path["train_pod"], _ = timed("train_pod", phase_train_pod)
    by_path["train_moe"], _ = timed("train_moe", phase_train_moe)
    by_path["train_adafactor"], adafactor = timed("train_adafactor",
                                                  phase_train_adafactor)
    by_path["train_fsdp_tp"], _ = timed("train_fsdp_tp",
                                        phase_train_fsdp_tp, adafactor)
    by_path["train_deepseek"], _ = timed("train_deepseek",
                                         phase_train_deepseek)
    by_path["train_jamba"], jamba = timed("train_jamba", phase_train_jamba)
    timed("dryrun", phase_dryrun, train, tp_numbers, auto, jamba, t_start)
    by_path["serve_tp"] = {"sum_chunks": sum(r["sum_chunks"] for r in
                                              serve_tp.values())}
    by_path["train_mamba2"], _ = timed("train_mamba2", phase_train_mamba2)
    by_path["train_vl"], _ = timed("train_vl", phase_train_vl)
    by_path["train_seamless"], _ = timed("train_seamless",
                                         phase_train_seamless)
    timed("ckpt", phase_ckpt)
    by_path["elastic_train"], _ = timed("elastic_train",
                                        phase_elastic_train)
    by_path["elastic_tp"], _ = timed("elastic_tp", phase_elastic_tp)
    by_path["collectives_lib"] = lib_launches
    flash_by_path = {"serve_moe": serve_moe["launches"],
                     "serve_nemotron": serve_nemotron["launches"],
                     "serve_deepseek": serve_deepseek["launches"],
                     "serve_deepseek_one_shot":
                         serve_deepseek["one_shot_launches"],
                     "serve_jamba": serve_jamba["launches"],
                     "serve_mamba2": serve_mamba2["launches"],
                     "serve_vl": serve_vl["launches"],
                     "serve_seamless": serve_seamless["launches"],
                     "serve_tp": sum(r["launches"]
                                     for r in serve_tp.values())}
    flash_by_path["elastic_serve"] = timed(
        "elastic_serve", phase_elastic_serve)[0]["flash_attention"]
    print(f"[done] all phases in {time.perf_counter() - t0:.1f}s; the "
          f"whole script {time.perf_counter() - t_start:.1f}s")

    print(card())
    def reading(family, case, kv_dtype, q_offset=0):
        r = next(r for r in rows if r["family"] == family
                 and r["case"] == case and r["q_offset"] == q_offset
                 and r["q_dtype"] == "bfloat16" and r["kv_dtype"] == kv_dtype)
        return {k: r[k] for k in ("variant", "max_abs_err", "ms",
                                  "plain_ms", "bound_ms", "bound_by",
                                  "library_ms")}

    main_row = reading("qwen2-72b", "chunk", "float32", 3840)
    bf16_row = reading("qwen2-72b", "chunk", "bfloat16", 3840)
    print(json.dumps({"kernels": [{
        "name": "flash_attention", "route": "cuda",
        "variant": main_row["variant"],
        "source": "src/repro_torch/kernels/flash_attention/csrc/"
                  "flash_attention_wgmma.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:93",
        "launches": serve["launches"],
        "launches_by_path": flash_by_path,
        "max_abs_err": max(serve["max_abs_err"], serve_moe["max_abs_err"],
                           serve_nemotron["max_abs_err"],
                           serve_deepseek["one_shot_max_abs_err"],
                           serve_jamba["max_abs_err"],
                           serve_vl["max_abs_err"],
                           serve_seamless["max_abs_err"],
                           max(r["max_abs_err"] for r in rows)),
        "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"],
        "ms_bf16_cache": bf16_row["ms"],
        "plain_ms_bf16_cache": bf16_row["plain_ms"],
        "bound_ms_bf16_cache": bf16_row["bound_ms"],
        "library_ms_bf16_cache": bf16_row["library_ms"],
        # nemotron-4-340b's late chunk (bf16 q on the tensor cores),
        # deepseek-v3's 1000-token MLA one-shot (bf16 q on the tensor
        # cores), and
        # seamless's launches at D 64 (bf16 q on the tensor cores: the
        # encoder and cross-attention over a bf16 memory, the prefill's
        # cross-attention over the f32 one, the causal self-attention)
        "head_dims": {
            "64x64": {
                f"{case.replace(' ', '_')}_{name}_kv": reading(
                    "seamless-m4t-large-v2", case, kv)
                for case in ("encoder", "cross", "cross decode", "self")
                for name, kv in (("bf16", "bfloat16"), ("f32", "float32"))},
            "128x128_vl_prefill": reading("qwen2-vl-7b", "vl prefill",
                                          "bfloat16"),
            "192x192": {"f32_cache": reading("nemotron-4-340b", "chunk",
                                             "float32", 3840),
                        "bf16_cache": reading("nemotron-4-340b", "chunk",
                                              "bfloat16", 3840)},
            "192x128": {"bf16_cache": reading("deepseek-v3-671b",
                                              "one-shot", "bfloat16"),
                        "f32_cache": reading("deepseek-v3-671b",
                                             "one-shot", "float32")}}}] + [
            _sync_entry(name, sync_rows, train, by_path)
            for name in SYNC_KERNELS]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
