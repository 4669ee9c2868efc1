"""The port's ``PagePool`` against the JAX package's.

Both pools are built over their package's reduced qwen2-72b (so the leaf
probe sees the same stacked ``(repeat, B, Smax, Hkv, D)`` caches) and
driven through the same seeded sequence of ensure / release / park /
splice / defragment.  After every operation the page tables, token
counts, free lists and pool contents must be identical.
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest

import torch

from repro.configs import get_config as jax_config
from repro.models import build_model as jax_build
from repro.serve.engine import ServeCfg as JaxServeCfg
from repro.serve.paging import PagePool as JaxPagePool
from repro.serve.paging import resolve_page_tokens as jax_resolve
from repro_torch.configs import get_config
from repro_torch.models import build_model
from repro_torch.serve.engine import ServeCfg
from repro_torch.serve.paging import (OutOfPages, PagePool, RequestCache,
                                      resolve_page_tokens)

BATCH, MAX_LEN, PT = 3, 32, 4


def _pools(pool_pages=None):
    jcfg = JaxServeCfg(max_len=MAX_LEN, batch=BATCH, cache_dtype=jnp.float32,
                       page_tokens=PT, pool_pages=pool_pages)
    tcfg = ServeCfg(max_len=MAX_LEN, batch=BATCH, cache_dtype=torch.float32,
                    page_tokens=PT, pool_pages=pool_pages)
    jp = JaxPagePool(jax_build(jax_config("qwen2-72b", reduced=True)), jcfg)
    tp = PagePool(build_model(get_config("qwen2-72b", reduced=True)), tcfg,
                  device="cpu")
    # identical, page-unique contents in both pools
    rng = np.random.RandomState(0)
    for i, leaf in enumerate(tp.pool):
        data = rng.randn(*leaf.shape).astype(np.float32)
        data[0] = 0.0                               # the zero page
        leaf.copy_(torch.from_numpy(data))
        jp.pool[i] = jnp.asarray(data)
    return jp, tp


def _assert_same(jp, tp):
    assert {r: (t.pages, t.tokens) for r, t in jp.tables.items()} == \
        {r: (t.pages, t.tokens) for r, t in tp.tables.items()}
    assert jp._free == tp._free
    for a, b in zip(jp.pool, tp.pool):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    for a, b in zip(jp.state, tp.state):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    tp.check_integrity()


def test_layout_probe_matches_reference():
    jp, tp = _pools()
    assert [(l.shape, l.batch_axis, l.token_axis) for l in jp.layout.leaves] \
        == [(l.shape, l.batch_axis, l.token_axis) for l in tp.layout.leaves]
    assert [tuple(x.shape) for x in jp.pool] == \
        [tuple(x.shape) for x in tp.pool]
    assert [tuple(x.shape) for x in jp.state] == \
        [tuple(x.shape) for x in tp.state]
    assert jp.layout.page_bytes() == tp.layout.page_bytes()
    assert jp.contiguous_bytes() == tp.contiguous_bytes()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_same_ops_give_same_tables_free_lists_and_pages(seed):
    """Random admit / grow / finish / park / resume / defragment churn,
    mirrored op for op on both pools."""
    rnd = random.Random(seed)
    jp, tp = _pools(pool_pages=20)
    live, parked, next_rid = {}, {}, 0        # rid -> slot
    free_slots = list(range(BATCH))
    for _ in range(40):
        op = rnd.choice(["admit", "grow", "finish", "park", "resume",
                         "defrag"])
        if op == "admit" and free_slots:
            rid, n = next_rid, rnd.randint(1, 12)
            next_rid += 1
            try:
                jp.ensure(rid, n)
            except Exception as e:
                assert type(e).__name__ == "OutOfPages"
                with pytest.raises(OutOfPages):
                    tp.ensure(rid, n)
                jp.tables.pop(rid, None)
                tp.tables.pop(rid, None)
            else:
                tp.ensure(rid, n)
                for pool in (jp, tp):
                    pool.tables[rid].tokens = n
                live[rid] = free_slots.pop()
        elif op == "grow" and live:
            rid = rnd.choice(sorted(live))
            n = jp.tables[rid].tokens + rnd.randint(1, 6)
            if jp.pages_for(n) - len(jp.tables[rid].pages) <= jp.pages_free:
                assert jp.ensure(rid, n) == tp.ensure(rid, n)
                for pool in (jp, tp):
                    pool.tables[rid].tokens = n
        elif op == "finish" and live:
            rid = rnd.choice(sorted(live))
            assert jp.release(rid) == tp.release(rid)
            free_slots.append(live.pop(rid))
        elif op == "park" and live:
            rid = rnd.choice(sorted(live))
            slot = live.pop(rid)
            jrc, trc = jp.park(rid, slot), tp.park(rid, slot)
            for a, b in zip(jrc.pages, trc.pages):
                np.testing.assert_array_equal(b.numpy(), np.asarray(a))
            parked[rid] = (jrc, trc)
            free_slots.append(slot)
        elif op == "resume" and parked and free_slots:
            rid = rnd.choice(sorted(parked))
            jrc, trc = parked[rid]
            if jp.has_room(jrc.tokens):
                slot = free_slots.pop()
                jp.splice(rid, slot, jrc)
                tp.splice(rid, slot, trc)
                live[rid] = slot
                del parked[rid]
        elif op == "defrag":
            assert jp.defragment() == tp.defragment()
        _assert_same(jp, tp)


def test_extract_and_splice_invert_each_other():
    _, tp = _pools()
    tp.ensure(7, 10)
    tp.tables[7].tokens = 10
    tp.write_state(1, [torch.full((2, 1), 10, dtype=torch.int32)])
    rc = tp.extract(7, 1)
    assert isinstance(rc, RequestCache) and rc.tokens == 10
    assert rc.nbytes() == sum(p.numel() * 4 for p in rc.pages) + 2 * 4
    before = [leaf[torch.tensor(tp.tables[7].pages)].clone()
              for leaf in tp.pool]
    tp.release(7)
    tp.ensure(8, 20)            # take the freed pages, so 7 moves
    tp.splice(7, 2, rc)
    after = [leaf[torch.tensor(tp.tables[7].pages)] for leaf in tp.pool]
    for a, b in zip(before, after):
        assert torch.equal(a, b)
    assert torch.equal(tp.read_state(2)[0], rc.state[0])
    with pytest.raises(ValueError, match="already holds"):
        tp.splice(7, 2, rc)
    tp.check_integrity()


@pytest.mark.parametrize("max_len,pt", [(64, None), (48, None), (32, 32),
                                        (32, 8), (7, None)])
def test_resolve_page_tokens_matches_reference(max_len, pt):
    assert resolve_page_tokens(max_len, pt) == jax_resolve(max_len, pt)


@pytest.mark.parametrize("max_len,pt", [(32, 6), (32, 64)])
def test_resolve_page_tokens_rejects_like_reference(max_len, pt):
    with pytest.raises(ValueError):
        jax_resolve(max_len, pt)
    with pytest.raises(ValueError):
        resolve_page_tokens(max_len, pt)
