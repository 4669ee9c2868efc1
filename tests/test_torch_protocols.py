"""The port's protocols against the reference's, bit for bit.

The reference runs under ``jax.vmap(axis_name=...)``, as
``tests/test_protocols.py`` does; the port runs the same per-rank inputs
on thread ranks (``substrate.run_spmd``).  Both sum the same operands
in the same order, so every rank's f32 result must be bit-identical,
whether the reference's RS combine kernel is off or on.  The port has
one path: its combine is ``sum_chunks``, whose plain version on the CPU
starts at zero and adds in order, as the reference's kernel does.  bf16 ring reduce-scatters are held to
the same bar: both packages add two bf16 values in f32 and round once.
The tree, Bruck / pairwise and pipeline protocols move data (the
binomial reduce adds in the reference's order), so they are held bit
for bit at p in {2, 3, 4, 8} wherever the protocol takes p.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.comm import Session as JaxSession
from repro.core.engine import EngineConfig as JaxEngineConfig
from repro.core.protocols import bruck as jbruck
from repro.core.protocols import common as jcommon
from repro.core.protocols import pipeline as jpipe
from repro.core.protocols import recursive as jrec
from repro.core.protocols import ring as jring
from repro.core.protocols import tree as jtree
from repro.core.topology import topology_from_mesh_shape as jax_topology
from repro_torch.comm import Session
from repro_torch.core.engine import EngineConfig
from repro_torch.core.protocols import (bruck, common, pipeline, recursive,
                                        ring, tree)
from repro_torch.core.topology import topology_from_mesh_shape
from repro_torch.runtime import substrate as S

AX = "x"


def _bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.int16 if a.dtype.itemsize == 2 else np.int32)


def _ref(fn, x, dtype=jnp.float32):
    return np.asarray(jax.vmap(fn, axis_name=AX)(jnp.asarray(x, dtype)))


def _port(fn, x, dtype=torch.float32):
    p = x.shape[0]
    mesh = S.make_mesh((p,), (AX,), device="cpu")
    xs = torch.from_numpy(np.ascontiguousarray(x)).to(dtype)
    out = S.run_spmd(fn, [(xs[r],) for r in range(p)], mesh, timeout=60)
    out = torch.stack(out)
    if dtype == torch.bfloat16:
        return out.view(torch.int16).numpy()
    return out.numpy()


def _assert_bits(ref, port):
    ref = np.asarray(ref)
    assert ref.shape == port.shape
    np.testing.assert_array_equal(_bits(ref), _bits(port))


def _x(p, *shape, seed=0):
    return np.random.RandomState(seed + p).randn(p, *shape).astype(
        np.float32)


@pytest.mark.parametrize("ref_kernel", [False, True])
@pytest.mark.parametrize("p", [2, 3, 4, 8])
def test_ring_reduce_scatter_bits(p, ref_kernel):
    """The port's one combine path against the reference's both: its
    ``a + b`` and its Pallas ``sum_chunks`` (``ref_kernel``)."""
    x = _x(p, p, 37)
    _assert_bits(
        _ref(lambda v: jring.ring_reduce_scatter_flat(v, AX, ref_kernel), x),
        _port(lambda v: ring.ring_reduce_scatter_flat(v, AX), x))


@pytest.mark.parametrize("ref_kernel", [False, True])
@pytest.mark.parametrize("p", [2, 3, 4])
def test_bf16_ring_reduce_scatter_bits(p, ref_kernel):
    x = _x(p, p, 64, seed=5)
    ref = _ref(lambda v: jring.ring_reduce_scatter_flat(v, AX, ref_kernel),
               x, jnp.bfloat16)
    port = _port(lambda v: ring.ring_reduce_scatter_flat(v, AX),
                 x, torch.bfloat16)
    np.testing.assert_array_equal(_bits(ref), port)


@pytest.mark.parametrize("p", [2, 3, 4, 8])
def test_ring_all_gather_and_all_reduce_bits(p):
    s = _x(p, 11)
    _assert_bits(_ref(lambda v: jring.ring_all_gather_flat(v, AX), s),
                 _port(lambda v: ring.ring_all_gather_flat(v, AX), s))
    x = _x(p, p, 9, seed=1)
    _assert_bits(_ref(lambda v: jring.ring_all_reduce_flat(v, AX), x),
                 _port(lambda v: ring.ring_all_reduce_flat(v, AX), x))


@pytest.mark.parametrize("ref_kernel", [False, True])
@pytest.mark.parametrize("chunk", [10, 7])      # 7: odd -> one-way ring
@pytest.mark.parametrize("p", [2, 3, 4, 8])
def test_bidir_ring_bits(p, chunk, ref_kernel):
    x = _x(p, p, chunk, seed=2)
    _assert_bits(
        _ref(lambda v: jring.bidir_ring_reduce_scatter_flat(v, AX,
                                                            ref_kernel), x),
        _port(lambda v: ring.bidir_ring_reduce_scatter_flat(v, AX), x))
    _assert_bits(
        _ref(lambda v: jring.bidir_ring_all_reduce_flat(v, AX, ref_kernel),
             x),
        _port(lambda v: ring.bidir_ring_all_reduce_flat(v, AX), x))


@pytest.mark.parametrize("p", [2, 4, 8])
def test_recursive_doubling_and_rabenseifner_bits(p):
    x = _x(p, 13, seed=3)
    _assert_bits(
        _ref(lambda v: jrec.recursive_doubling_all_reduce(v, AX), x),
        _port(lambda v: recursive.recursive_doubling_all_reduce(v, AX), x))
    x2 = _x(p, p, 6, seed=4)
    _assert_bits(
        _ref(lambda v: jrec.rabenseifner_all_reduce_flat(v, AX), x2),
        _port(lambda v: recursive.rabenseifner_all_reduce_flat(v, AX), x2))


def test_power_of_two_protocols_refuse_p3():
    x = _x(3, 3, 4)
    for fn in (lambda v: recursive.recursive_doubling_all_reduce(v, AX),
               lambda v: recursive.rabenseifner_all_reduce_flat(v, AX)):
        with pytest.raises(RuntimeError, match="power-of-two"):
            _port(fn, x)


@pytest.mark.parametrize("p", [3, 4, 8])
def test_steppable_all_gathers_match_stage_by_stage(p):
    s = _x(p, 5, seed=6)

    def stepped(run_cls):
        def fn(v):
            run = run_cls(v, AX)
            while run.remaining:
                run.step(1)
            return run.result()
        return fn

    _assert_bits(_ref(stepped(jring.BidirRingAllGatherRun), s),
                 _port(stepped(ring.BidirRingAllGatherRun), s))
    _assert_bits(_ref(stepped(jring.RingAllGatherRun), s),
                 _port(stepped(ring.RingAllGatherRun), s))


@pytest.mark.parametrize("ref_kernel", [False, True])
@pytest.mark.parametrize("proto", ["ring", "bidir_ring",
                                   "recursive_halving",
                                   "recursive_doubling"])
@pytest.mark.parametrize("p", [2, 4, 8])
def test_engine_all_reduce_bits(p, proto, ref_kernel):
    """The planned dispatch path: padding, chunking and unpadding around
    each protocol, through a session's communicator."""
    x = _x(p, 5, 7, seed=7)                     # 35 values: padded to p
    jsess = JaxSession(topology=jax_topology((AX,), (p,)),
                       config=JaxEngineConfig(
                           force_protocol={"all_reduce": proto},
                           use_local_reduce_kernel=ref_kernel))
    sess = Session(topology=topology_from_mesh_shape((AX,), (p,)),
                   config=EngineConfig(force_protocol={"all_reduce": proto}))
    _assert_bits(_ref(lambda v: jsess.world.all_reduce(v, mean=True), x),
                 _port(lambda v: sess.world.all_reduce(v, mean=True), x))
    tok_ref = _ref(lambda v: jsess.world.all_reduce_wait(
        jsess.world.all_reduce_start(v)), x)
    _assert_bits(tok_ref, _port(lambda v: sess.world.all_reduce_wait(
        sess.world.all_reduce_start(v)), x))


# ---------------------------------------------------------------------------
# Tree broadcast / reduce, Bruck / pairwise all-to-all, the GPipe pipeline
# (twins of tests/test_protocols.py's cases): data movement bit for bit,
# and the binomial reduce, which adds in the reference's order.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("root", [0, 1, 2])
@pytest.mark.parametrize("p", [2, 3, 4, 8])
def test_binomial_broadcast_and_reduce_bits(p, root):
    if root >= p:
        root = p - 1
    x = _x(p, 5, seed=8)
    want = _ref(lambda v: jtree.binomial_broadcast(v, AX, root), x)
    _assert_bits(want, _port(lambda v: tree.binomial_broadcast(v, AX, root),
                             x))
    _assert_bits(np.broadcast_to(x[root], x.shape), want)
    _assert_bits(_ref(lambda v: jtree.binomial_reduce_to_root(v, AX, root),
                      x),
                 _port(lambda v: tree.binomial_reduce_to_root(v, AX, root),
                       x))


@pytest.mark.parametrize("root", [0, 1, 3])
@pytest.mark.parametrize("p", [2, 4, 8])
def test_scatter_allgather_broadcast_bits(p, root):
    root %= p
    x = _x(p, p, 6, seed=9)                      # a rank's (p, chunk)
    want = _ref(lambda v: jtree.scatter_allgather_broadcast(v, AX, root), x)
    _assert_bits(want, _port(
        lambda v: tree.scatter_allgather_broadcast(v, AX, root), x))
    _assert_bits(np.broadcast_to(x[root], x.shape), want)
    # the start/finish split the engine's arms use gives the same bits
    _assert_bits(want, _port(lambda v: tree.scatter_allgather_finish(
        tree.scatter_allgather_start(v, AX, root), AX, root), x))


def test_scatter_allgather_broadcast_refuses_p3():
    with pytest.raises(RuntimeError, match="power-of-two"):
        _port(lambda v: tree.scatter_allgather_broadcast(v, AX, 0),
              _x(3, 3, 4))


@pytest.mark.parametrize("impl", ["bruck_all_to_all", "pairwise_all_to_all"])
@pytest.mark.parametrize("p", [2, 3, 4, 8])
def test_all_to_all_bits(p, impl):
    x = _x(p, p, 3, seed=10)                     # block j goes to rank j
    want = _ref(lambda v: getattr(jbruck, impl)(v, AX), x)
    _assert_bits(want, _port(lambda v: getattr(bruck, impl)(v, AX), x))
    _assert_bits(np.swapaxes(x, 0, 1), want)
    assert bruck.bruck_stage_counts(p) == jbruck.bruck_stage_counts(p)
    assert bruck.pairwise_stage_counts(p) == jbruck.pairwise_stage_counts(p)


@pytest.mark.parametrize("p,n_micro", [(2, 3), (3, 2), (4, 4), (4, 8),
                                       (8, 3)])
def test_gpipe_forward_bits(p, n_micro):
    stage_w = np.arange(1, p + 1, dtype=np.float32) * 0.75
    mbs = np.random.RandomState(p + n_micro).randn(n_micro, 6).astype(
        np.float32)
    # a product alone: XLA would contract a multiply-add into one FMA
    want = _ref(lambda w: jpipe.gpipe_forward(
        lambda wi, a: a * wi, w, jnp.asarray(mbs), AX), stage_w)
    got = _port(lambda w: pipeline.gpipe_forward(
        lambda wi, a: a * wi, w, torch.from_numpy(mbs), AX), stage_w)
    _assert_bits(want, got)
    assert not got[:-1].any()                    # zeros off the last stage
    assert pipeline.p2p_stage_counts(p) == jpipe.p2p_stage_counts(p)


@pytest.mark.parametrize("p", [2, 3, 4, 8])
def test_send_next_and_prev_bits(p):
    x = _x(p, 4, seed=11)
    for ours, theirs in ((pipeline.send_next, jpipe.send_next),
                         (pipeline.send_prev, jpipe.send_prev)):
        want = _ref(lambda v: theirs(v, AX), x)
        got = _port(lambda v: ours(v, AX), x)
        # the filler edge's receiver (stage 0 / stage p-1) never reads
        # it; every other stage holds its neighbour's tensor
        live = slice(1, p) if ours is pipeline.send_next else slice(0, p - 1)
        _assert_bits(want[live], got[live])


@pytest.mark.parametrize("p", [2, 3, 4, 8])
def test_complete_perm_matches_reference(p):
    pairs = [(j, j + 1) for j in range(p - 1)]
    assert common.complete_perm(pairs, p) == jcommon.complete_perm(pairs, p)


def test_ppermute_partial_permutation_zeroes_nonreceivers():
    """``send_recv`` needs arbitrary (src, dst) pairs: a rank nobody
    sends to receives zeros, as ``lax.ppermute`` gives."""
    p = 4
    x = _x(p, 3, seed=12)
    got = _port(lambda v: common.ppermute(v, AX, [(0, 2), (3, 1)]), x)
    want = np.zeros_like(x)
    want[2], want[1] = x[0], x[3]
    _assert_bits(want, got)
