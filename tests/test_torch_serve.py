"""The port's ``BatchScheduler`` against the JAX package's, and its own
serving contracts, on the reduced qwen2-72b.

The same seeded requests go through both schedulers over the same
weights (carried by ``params_from_numpy``); greedy token streams must be
identical per request id.  Within the port: chunked-interleaved and
back-to-back prefill give bit-identical streams, LIFO preemption under a
small pool leaves streams intact, and the launcher runs end to end on
the CPU.
"""

import gc
import os
import subprocess
import sys
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import build_model as jax_build
from repro.serve.engine import BatchScheduler as JaxScheduler
from repro.serve.engine import Request as JaxRequest
from repro.serve.engine import ServeCfg as JaxServeCfg
from repro_torch.configs import get_config
from repro_torch.launch import serve as launch_serve
from repro_torch.models import build_model
from repro_torch.models.convert import params_from_numpy
from repro_torch.serve import BatchScheduler, Request, ServeCfg, generate
from repro_torch.tree import leaves

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MAX_LEN, PT = 64, 8


@pytest.fixture(scope="module")
def weights():
    jm = jax_build(jax_config("qwen2-72b", reduced=True))
    jp = jm.init(jax.random.PRNGKey(0))
    tm = build_model(get_config("qwen2-72b", reduced=True))
    return jm, jp, tm, params_from_numpy(jax.device_get(jp), tm.cfg,
                                         device="cpu")


def _prompts(n=6, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 256, size=rng.randint(3, 26)).tolist()
            for _ in range(n)]


def _serve_port(tm, tp, prompts, max_new=5, batch=3, **kw):
    cfg = ServeCfg(max_len=MAX_LEN, batch=batch, cache_dtype=torch.float32,
                   page_tokens=PT, **kw)
    sched = BatchScheduler(tm, tp, cfg, device="cpu")
    for rid, p in enumerate(prompts):
        sched.submit(Request(rid=rid, prompt=list(p), max_new=max_new))
    return sched, {r.rid: r.generated for r in sched.run()}


def test_greedy_streams_match_reference_per_rid(weights):
    jm, jp, tm, tp = weights
    prompts = _prompts()
    jcfg = JaxServeCfg(max_len=MAX_LEN, batch=3, cache_dtype=jnp.float32,
                       page_tokens=PT)
    jsched = JaxScheduler(jm, jp, jcfg)
    for rid, p in enumerate(prompts):
        jsched.submit(JaxRequest(rid=rid, prompt=list(p), max_new=5))
    want = {r.rid: r.generated for r in jsched.run()}
    sched, got = _serve_port(tm, tp, prompts)
    assert got == want
    assert sched.decode_steps == jsched.decode_steps
    assert not sched.shed and sched.pool.pages_allocated == 0


def test_chunked_and_back_to_back_prefill_are_bit_identical(weights):
    _, _, tm, tp = weights
    prompts = _prompts(seed=1)
    _, interleaved = _serve_port(tm, tp, prompts, chunked_prefill=True)
    _, one_shot = _serve_port(tm, tp, prompts, chunked_prefill=False)
    assert interleaved == one_shot
    assert all(len(v) == 5 for v in one_shot.values())


def test_lifo_preemption_keeps_streams_intact(weights):
    """A pool of 6 pages cannot hold two ~40-token requests at once: the
    later one is parked to host mid-decode and resumed, and its stream
    equals the uncontended run's."""
    _, _, tm, tp = weights
    prompts = [[1, 2, 3], [4, 5, 6, 7]]
    _, free = _serve_port(tm, tp, prompts, max_new=36, batch=2)
    cfg = ServeCfg(max_len=MAX_LEN, batch=2, cache_dtype=torch.float32,
                   page_tokens=PT, pool_pages=6)
    sched = BatchScheduler(tm, tp, cfg, device="cpu")
    for rid, p in enumerate(prompts):
        sched.submit(Request(rid=rid, prompt=p, max_new=36))
    parked_seen = 0
    while sched.pending():
        sched.step()
        parked_seen = max(parked_seen, len(sched.parked))
        sched.pool.check_integrity()
    assert parked_seen >= 1
    assert {r.rid: r.generated for r in sched.completed} == free


def test_one_shot_fallback_matches_chunked_streams(weights):
    """A model without chunked prefill is prefilled one-shot (through the
    flash op) and adopted page by page; greedy streams are the same."""
    _, _, tm, tp = weights

    class OneShot(type(tm)):
        supports_chunked_prefill = False

    prompts = _prompts(n=4, seed=2)
    _, chunked = _serve_port(tm, tp, prompts)
    _, one_shot = _serve_port(OneShot(tm.cfg), tp, prompts)
    assert one_shot == chunked


def test_sampling_is_pure_in_seed_rid_position(weights):
    _, _, tm, tp = weights
    prompts = _prompts(n=4, seed=3)
    _, wide = _serve_port(tm, tp, prompts, batch=3, greedy=False, seed=7)
    _, narrow = _serve_port(tm, tp, prompts, batch=1, greedy=False, seed=7)
    _, other = _serve_port(tm, tp, prompts, batch=3, greedy=False, seed=8)
    assert wide == narrow
    assert wide != other


def test_snapshot_mid_prefill_requeues_and_resumes(weights):
    _, _, tm, tp = weights
    prompt = _prompts(n=1, seed=4)[0] + [9] * 20      # several chunks
    _, want = _serve_port(tm, tp, [prompt], batch=1)
    cfg = ServeCfg(max_len=MAX_LEN, batch=1, cache_dtype=torch.float32,
                   page_tokens=PT)
    sched = BatchScheduler(tm, tp, cfg, device="cpu")
    sched.submit(Request(rid=0, prompt=prompt, max_new=5))
    assert 0 in sched._prefills                       # first chunk ran
    snap = sched.snapshot()
    assert not snap.inflight and [r.rid for r in snap.queue] == [0]
    again = BatchScheduler.from_snapshot(tm, tp, cfg, snap, device="cpu")
    assert {r.rid: r.generated for r in again.run()} == want


def test_step_arenas_are_freed_without_the_garbage_collector(weights):
    """The K/V arena a step gathers from the pool dies when the step
    returns.  A reference cycle would keep one arena per step alive (on
    the card: 1 GiB a decode step at full width) until a collection."""
    _, _, tm, tp = weights
    cfg = ServeCfg(max_len=MAX_LEN, batch=3, cache_dtype=torch.float32,
                   page_tokens=PT)
    sched = BatchScheduler(tm, tp, cfg, device="cpu")
    pool, assemble, arenas = sched.pool, sched.pool._assemble, []

    def tracked(state, table):
        caches = assemble(state, table)
        flat = leaves(caches)
        arenas.extend(weakref.ref(flat[i])
                      for i in pool.layout.token_leaf_ids)
        return caches

    pool._assemble = tracked
    gc.disable()
    try:
        for rid, p in enumerate(_prompts()):
            sched.submit(Request(rid=rid, prompt=list(p), max_new=5))
        for _ in range(6):
            sched.step()
        alive = sum(r() is not None for r in arenas)
    finally:
        gc.enable()
    assert sched.decode_steps > 0 and arenas and alive == 0


def test_max_queue_sheds_over_bound(weights):
    _, _, tm, tp = weights
    sched, got = _serve_port(tm, tp, _prompts(n=5), batch=1, max_queue=1)
    assert len(sched.shed) == 3 and len(got) == 2


def test_generate_matches_scheduler(weights):
    _, _, tm, tp = weights
    prompt = _prompts(n=1, seed=5)[0]
    _, want = _serve_port(tm, tp, [prompt], max_new=4)
    out = generate(tm, tp, torch.tensor([prompt]), 4,
                   ServeCfg(max_len=MAX_LEN, batch=1,
                            cache_dtype=torch.float32))
    assert out[0, len(prompt):].tolist() == want[0]


def _launch(*args):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", *args],
        env=env, capture_output=True, text=True, timeout=120, cwd=REPO)


def test_launcher_serves_on_cpu():
    proc = _launch("--device", "cpu", "--requests", "4", "--max-new", "4")
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "served 4 requests (0 shed)" in proc.stderr


@pytest.mark.parametrize("flags", [["--snapshot-dir", "snap"],
                                   ["--ctrl-peers", "a:1,b:2"],
                                   ["--fault-plan", "lose@3:2"]])
def test_launcher_refuses_elastic_flags(flags, capsys):
    """Elastic flags without ``--elastic`` would be ignored: refused."""
    with pytest.raises(SystemExit) as ei:
        launch_serve.parse_args(["--device", "cpu", *flags])
    assert ei.value.code == 2
    assert "needs --elastic" in capsys.readouterr().err
    assert launch_serve.parse_args(["--device", "cpu", "--elastic",
                                    *flags]).elastic


# ---------------------------------------------------------------------------
# Decode at a fixed row count: a row's logits do not depend on the batch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("batch", [1, 3, 4, 8, 12])
def test_every_decode_forward_sees_the_fixed_row_count(weights, batch,
                                                       monkeypatch):
    from repro_torch.serve.engine import DECODE_ROWS
    _, _, tm, tp = weights
    rows = []
    decode = tm.decode_step

    def hooked(params, batch_, caches):
        rows.append(batch_["tokens"].shape[0])
        for leaf in leaves(caches):
            assert DECODE_ROWS in leaf.shape
        return decode(params, batch_, caches)

    monkeypatch.setattr(tm, "decode_step", hooked)
    _, got = _serve_port(tm, tp, _prompts(n=batch + 2, seed=3), max_new=4,
                         batch=batch)
    assert len(got) == batch + 2
    assert rows and set(rows) == {DECODE_ROWS}


def test_padding_rows_write_no_page_and_keep_slot_state(weights):
    """Batch 3 (5 padding rows): a decode step changes only the page each
    active slot writes, never the zero page, and no inactive slot's
    arena state."""
    _, _, tm, tp = weights
    cfg = ServeCfg(max_len=MAX_LEN, batch=3, cache_dtype=torch.float32,
                   page_tokens=PT)
    sched = BatchScheduler(tm, tp, cfg, device="cpu")
    for rid, p in enumerate(_prompts(n=2, seed=4)):
        sched.submit(Request(rid=rid, prompt=list(p), max_new=6))
    while sched._prefills:
        sched.step()
    pool = sched.pool
    active = [i for i, s in enumerate(sched.slots) if s is not None]
    assert active and len(active) < cfg.batch
    touched = {pool.tables[sched.slots[i].rid].page_of(
        pool.tables[sched.slots[i].rid].tokens, PT) for i in active}
    pages = [t.clone() for t in pool.pool]
    state = [t.clone() for t in pool.state]
    sched.step()
    pool.check_integrity()
    for before, after in zip(pages, pool.pool):
        changed = {int(i) for i in torch.nonzero(
            (before != after).flatten(1).any(1)).flatten()}
        assert changed <= touched and 0 not in changed
        assert not after[0].any()                  # the zero page
    inactive = [i for i in range(cfg.batch) if i not in active]
    for before, after, li in zip(state, pool.state,
                                 pool.layout.state_leaf_ids):
        ax = min(pool.layout.leaves[li].batch_axis, before.dim() - 1)
        for i in inactive:
            assert torch.equal(before.narrow(ax, i, 1),
                               after.narrow(ax, i, 1))


def test_decode_rows_equal_at_batch_8_and_4(weights, monkeypatch):
    """The same requests decoded at batch 8 and as two batches of 4 give
    the same greedy streams, and every decode row's logits bit for bit
    (rows of decoding slots only: a free or prefilling slot also runs,
    on stale ids)."""
    from repro_torch.serve import engine
    _, _, tm, tp = weights
    prompts = _prompts(n=8, seed=5)
    pick = engine._pick_tokens

    def run(rids, batch):
        rows, decoding = {}, []

        def recording(lg, cfg, rids_, pos):
            if decoding:                  # a decode call: the next rows
                take = decoding[0][:lg.shape[0]]
                del decoding[0][:lg.shape[0]]
                for j, key in enumerate(take):
                    if key is not None:
                        assert key not in rows
                        rows[key] = lg[j].clone()
            return pick(lg, cfg, rids_, pos)

        monkeypatch.setattr(engine, "_pick_tokens", recording)
        cfg = ServeCfg(max_len=MAX_LEN, batch=batch,
                       cache_dtype=torch.float32, page_tokens=PT)
        sched = BatchScheduler(tm, tp, cfg, device="cpu")
        run_decode = sched._decode

        def decode(params, tok, rids_, pos, slot_rids, active):
            decoding.append([(r, q) if a else None for r, a, q in zip(
                slot_rids, active, pos.tolist())])
            try:
                return run_decode(params, tok, rids_, pos, slot_rids,
                                  active)
            finally:
                decoding.pop()

        sched._decode = decode
        for r in rids:
            sched.submit(Request(rid=r, prompt=prompts[r], max_new=6))
        return {r.rid: r.generated for r in sched.run()}, rows

    s8, rows8 = run(range(8), 8)
    lo, rows_lo = run(range(4), 4)
    hi, rows_hi = run(range(4, 8), 4)
    assert s8 == {**lo, **hi}
    rows4 = {**rows_lo, **rows_hi}
    assert rows8.keys() == rows4.keys() and len(rows8) == 8 * 5
    for k in rows8:
        assert torch.equal(rows8[k], rows4[k]), k
