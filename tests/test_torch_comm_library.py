"""The port's whole collective library and its monolithic baseline
against the reference, on CPU thread ranks.

The reference runs under ``jax.vmap(axis_name=...)``; the port runs the
same per-rank inputs (seeded numpy) on ``substrate.run_spmd``.

- Composed arms (planned or forced protocols): bit for bit.  Data
  movement has one answer; the reductions add in the reference's order
  (its RS combine is ``a + b``, the port's ``sum_chunks`` adds the same
  two f32 values).
- The generic path (``protocols.xla``, the monolithic engine) against
  ``lax.psum`` and its kin: data movement bit for bit; sums within
  1e-5 relative + 1e-6 absolute in f32 (XLA adds the p values in its own
  order), and bit for bit on integer-valued inputs, whose f32 sums are
  exact in any order.
- Phase bytes: each call's per-rank ``CommStats`` phase bytes equal the
  cost model's ``plan.phase_wire_bytes`` for the protocol that ran; the
  generic all-reduce's transport-measured bytes equal what that bills.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from repro.comm import Session as JaxSession
from repro.comm import collectives as jcollectives
from repro.core import registry as jregistry
from repro.core.engine import EngineConfig as JaxEngineConfig
from repro.core.topology import topology_from_mesh_shape as jax_topology
from repro_torch.comm import Communicator, Session, collectives
from repro_torch.core import costmodel, registry
from repro_torch.core import plan as plan_mod
from repro_torch.core.engine import EngineConfig
from repro_torch.core.protocols import xla
from repro_torch.core.topology import topology_from_mesh_shape
from repro_torch.runtime import substrate as S

AX = "x"
SUM_RTOL, SUM_ATOL = 1e-5, 1e-6
NINE = (registry.ALL_REDUCE, registry.REDUCE_SCATTER, registry.ALL_GATHER,
        registry.ALL_TO_ALL, registry.BROADCAST, registry.PERMUTE,
        registry.SEND_RECV, registry.BARRIER,
        registry.COMPRESSED_ALL_REDUCE)


def _x(p, *shape, seed=0, ints=False):
    rng = np.random.RandomState(seed + 10 * p)
    if ints:
        return rng.randint(-8, 9, size=(p,) + shape).astype(np.float32)
    return rng.randn(p, *shape).astype(np.float32)


def _bits(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a)).view(np.int32)


def _ref(fn, x):
    return np.asarray(jax.vmap(fn, axis_name=AX)(jnp.asarray(x)))


def _mesh(p):
    return S.make_mesh((p,), (AX,), device="cpu")


def _sess(p, mode="composed", force=None):
    return Session(mesh=_mesh(p), config=EngineConfig(
        mode=mode, force_protocol=force or {}))


def _jsess(p, mode="composed", force=None):
    return JaxSession(topology=jax_topology((AX,), (p,)),
                      config=JaxEngineConfig(mode=mode,
                                             force_protocol=force or {}))


def _port(sess, fn, x):
    p = x.shape[0]
    xs = torch.from_numpy(np.ascontiguousarray(x))
    out = S.run_spmd(fn, [(xs[r],) for r in range(p)], sess.mesh, timeout=60)
    return torch.stack(out).numpy()


def _assert_bits(want, got):
    want = np.asarray(want)
    assert want.shape == got.shape, (want.shape, got.shape)
    np.testing.assert_array_equal(_bits(want), _bits(got))


# ---------------------------------------------------------------------------
# Modes and dispatch
# ---------------------------------------------------------------------------

def test_session_mode_monolithic():
    """Twin of tests/test_comm.py::test_session_mode_monolithic."""
    s = Session(topology=topology_from_mesh_shape((AX,), (8,)),
                mode="monolithic")
    assert not s.engine.composed
    # the conventional stack: every function at the conventional tier
    assert s.average_layer_number() == pytest.approx(2.0)
    assert set(s.engine.library.provided) == set(registry.ALL_FUNCTIONS)
    with pytest.raises(ValueError, match="unknown engine mode"):
        EngineConfig(mode="layered")


@pytest.mark.parametrize("mode", ["composed", "monolithic"])
def test_all_nine_functions_dispatch(mode):
    """The reference's nine dispatched functions all have a schedule in
    the port, in both modes, and ``dispatcher`` raises for none."""
    topo = topology_from_mesh_shape((AX,), (4,))
    eng = Session(topology=topo, mode=mode).engine
    jeng = JaxSession(topology=jax_topology((AX,), (4,)), mode=mode).engine
    have = {fn for fn in registry.ALL_FUNCTIONS
            if eng._impl_for(fn) is not None}
    assert have == {fn for fn in jregistry.ALL_FUNCTIONS
                    if jeng._impl_for(fn) is not None} == set(NINE)
    for fn in NINE:
        assert callable(eng.dispatcher(fn))


# ---------------------------------------------------------------------------
# Composed arms against the reference's, bit for bit
# ---------------------------------------------------------------------------

RS_CASES = [(proto, p) for proto in ("ring", "bidir_ring")
            for p in (2, 3, 4, 8)] + [("recursive_halving", p)
                                      for p in (2, 4, 8)]
AG_CASES = [("ring", p) for p in (2, 3, 4, 8)] + [("bruck", p)
                                                  for p in (2, 4, 8)]
A2A_CASES = [(proto, p) for proto in ("pairwise", "bruck")
             for p in (2, 3, 4, 8)]
BCAST_CASES = [(proto, p) for proto in ("binomial_tree", "ring")
               for p in (2, 3, 4, 8)]


def _pair(fn, x, mode="composed", force=None, **kw):
    """(reference, port) of ``Communicator.<fn>(v, **kw)`` on every rank
    of an axis of x.shape[0] ranks."""
    p = x.shape[0]
    jcomm, sess = _jsess(p, mode, force).world, _sess(p, mode, force)
    return (_ref(lambda v: getattr(jcomm, fn)(v, **kw), x),
            _port(sess, lambda v: getattr(sess.world, fn)(v, **kw), x))


@pytest.mark.parametrize("dim", [0, 1])
@pytest.mark.parametrize("proto,p", RS_CASES)
def test_reduce_scatter_bits(proto, p, dim):
    _assert_bits(*_pair("reduce_scatter", _x(p, 3 * p, 2 * p, seed=1),
                        force={"reduce_scatter": proto}, dim=dim))


@pytest.mark.parametrize("dim", [0, 1])
@pytest.mark.parametrize("proto,p", AG_CASES)
def test_all_gather_bits(proto, p, dim):
    x = _x(p, 3, 5, seed=2)
    want, got = _pair("all_gather", x, force={"all_gather": proto}, dim=dim)
    _assert_bits(want, got)
    _assert_bits(np.broadcast_to(np.concatenate(list(x), axis=dim),
                                 got.shape), got)


@pytest.mark.parametrize("dims", [(0, 0), (0, 1), (1, 0)])
@pytest.mark.parametrize("proto,p", A2A_CASES)
def test_all_to_all_bits(proto, p, dims):
    x = _x(p, 2 * p, 2 * p, 3, seed=3)
    want, got = _pair("all_to_all", x, force={"all_to_all": proto},
                      split_dim=dims[0], concat_dim=dims[1])
    _assert_bits(want, got)
    # and lax.all_to_all's tiled semantics
    _assert_bits(_ref(lambda v: lax.all_to_all(
        v, AX, dims[0], dims[1], tiled=True), x), got)


@pytest.mark.parametrize("root", [0, 2])
@pytest.mark.parametrize("proto,p", BCAST_CASES)
def test_broadcast_bits(proto, p, root):
    root %= p
    x = _x(p, 6 * p + 1, seed=4)        # a ragged size: padded to p
    want, got = _pair("broadcast", x, force={"broadcast": proto}, root=root)
    _assert_bits(want, got)
    _assert_bits(np.broadcast_to(x[root], x.shape), got)


@pytest.mark.parametrize("shift", [1, 2])
@pytest.mark.parametrize("p", [2, 3, 4, 8])
def test_permute_and_send_recv_bits(p, shift):
    x = _x(p, 7, seed=5)
    _assert_bits(*_pair("permute", x, shift=shift))
    pairs = [(j, (j + shift) % p) for j in range(p)]
    want, got = _pair("send_recv", x, pairs=pairs)
    _assert_bits(want, got)
    _assert_bits(np.roll(x, shift, axis=0), got)


@pytest.mark.parametrize("p", [2, 3, 4])
def test_send_recv_partial_pairs(p):
    """Arbitrary (src, dst) pairs: a rank nobody sends to receives
    zeros (the reference's vmap-only tests cannot take a partial
    permutation; ``lax.ppermute`` under ``shard_map`` zero-fills)."""
    x = _x(p, 5, seed=6)
    sess = _sess(p)
    got = _port(sess, lambda v: sess.world.send_recv(v, [(p - 1, 0)]), x)
    want = np.zeros_like(x)
    want[0] = x[p - 1]
    _assert_bits(want, got)


@pytest.mark.parametrize("fn,kw", [("reduce_scatter", {}),
                                   ("all_to_all", {})])
def test_indivisible_dimension_is_refused(fn, kw):
    """A dimension that does not split over the axis falls back to the
    generic path, which refuses it as ``lax``'s tiled collectives do."""
    sess = _sess(4)
    with pytest.raises(S.RankFailure) as e:
        _port(sess, lambda v: getattr(sess.world, fn)(v, **kw),
              _x(4, 6, 2))
    assert isinstance(e.value.__cause__, ValueError)


# ---------------------------------------------------------------------------
# The generic path (monolithic) against lax
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ints", [False, True])
@pytest.mark.parametrize("p", [2, 3, 4, 8])
def test_generic_sums_against_lax(p, ints):
    x = _x(p, 4 * p, 3, seed=7, ints=ints)
    cases = [("all_reduce", {}, lambda v: lax.psum(v, AX)),
             ("reduce_scatter", {"dim": 0},
              lambda v: lax.psum_scatter(v, AX, scatter_dimension=0,
                                         tiled=True)),
             ("broadcast", {"root": p - 1},
              lambda v: lax.psum(jnp.where(lax.axis_index(AX) == p - 1, v,
                                           0.0), AX))]
    for fn, kw, lax_fn in cases:
        want, got = _pair(fn, x, mode="monolithic", **kw)
        _assert_bits(_ref(lax_fn, x), want)       # the reference's is lax
        if ints:
            _assert_bits(want, got)
        else:
            np.testing.assert_allclose(got, want, rtol=SUM_RTOL,
                                       atol=SUM_ATOL, err_msg=fn)


@pytest.mark.parametrize("p", [2, 3, 4, 8])
def test_generic_data_movement_against_lax(p):
    x = _x(p, 2 * p, 3, seed=8)
    for fn, kw in (("all_gather", {"dim": 1}),
                   ("all_to_all", {"split_dim": 0, "concat_dim": 1}),
                   ("permute", {"shift": p - 1})):
        _assert_bits(*_pair(fn, x, mode="monolithic", **kw))


def test_engine_monolithic_matches_composed():
    """Twin of tests/test_core.py::test_engine_monolithic_matches_composed
    (p = 8, within the reference's own tolerance), and bit for bit on
    integer-valued inputs."""
    for ints in (False, True):
        x = _x(8, 16, 8, seed=9, ints=ints)
        for fn in ("all_reduce", "reduce_scatter", "all_gather",
                   "all_to_all"):
            comp, mono = _sess(8), _sess(8, "monolithic")
            a = _port(comp, lambda v: getattr(comp.world, fn)(v), x)
            b = _port(mono, lambda v: getattr(mono.world, fn)(v), x)
            if ints:
                _assert_bits(a, b)
            else:
                np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-6,
                                           err_msg=fn)


def test_monolithic_start_wait_bit_identical():
    """Twin of tests/test_overlap.py::test_monolithic_start_wait_bit_
    identical: the generic path runs whole in start, over two axes."""
    mesh = S.make_mesh((2, 4), ("pod", AX), device="cpu")
    mono = Session(mesh=mesh, mode="monolithic").engine
    x = _x(8, 17, seed=10)
    xs = torch.from_numpy(x)

    def run(fn):
        return torch.stack(S.run_spmd(fn, [(xs[r],) for r in range(8)],
                                      mesh, timeout=60)).numpy()

    blocking = run(lambda v: mono.all_reduce(v, ("pod", AX)))
    split = run(lambda v: mono.all_reduce_wait(
        mono.all_reduce_start(v, ("pod", AX))))
    _assert_bits(blocking, split)
    np.testing.assert_allclose(blocking, np.broadcast_to(x.sum(0), x.shape),
                               rtol=SUM_RTOL, atol=SUM_ATOL)


# ---------------------------------------------------------------------------
# Phase bytes: predicted (cost model) equal measured (CommStats), per call
# ---------------------------------------------------------------------------

PHASE_CALLS = [
    ("reduce_scatter", {}, lambda p, nb: nb),
    ("all_gather", {}, lambda p, nb: nb * p),   # planned at the gathered
    ("all_to_all", {}, lambda p, nb: nb),
    ("broadcast", {"root": 1}, lambda p, nb: nb),
    ("permute", {"shift": 1}, lambda p, nb: nb),
    ("send_recv", {"pairs": ((0, 1), (1, 0))}, lambda p, nb: nb),
]


@pytest.mark.parametrize("mode", ["composed", "monolithic"])
@pytest.mark.parametrize("p", [2, 3, 4, 8])
def test_phase_bytes_predicted_equal_measured(p, mode):
    sess = _sess(p, mode)
    eng = sess.engine
    x = _x(p, 4 * p, 6, seed=11)
    nb = x[0].nbytes
    for fn, kw, plan_bytes in PHASE_CALLS:
        before = [dict(eng.stats.rank_phase_bytes.get(r, {}))
                  for r in range(p)]
        _port(sess, lambda v: getattr(sess.world, fn)(v, **kw), x)
        proto = eng.protocol_for(fn, plan_bytes(p, nb), AX)
        if fn == "broadcast" and mode == "composed" and (
                p & (p - 1) or proto != costmodel.RING):
            proto = costmodel.BINOMIAL_TREE
        billed = nb * p if fn == "all_gather" else nb
        sb, wb = plan_mod.phase_wire_bytes(proto, p, billed, fn)
        for r in range(p):
            got = eng.stats.rank_phase_bytes[r]
            assert (got[f"{fn}.start"] - before[r].get(f"{fn}.start", 0),
                    got[f"{fn}.wait"] - before[r].get(f"{fn}.wait", 0))                 == (sb, wb), (fn, proto, r)


@pytest.mark.parametrize("p", [2, 3, 4, 8])
def test_generic_all_reduce_moves_what_the_cost_model_bills(p):
    """The generic all-reduce's wire bytes, as the transport measures
    them, are exactly ``phase_wire_bytes(XLA_DEFAULT)``: 2 (p-1) n / p a
    rank, all in start; the two-phase arms record the same."""
    sess = _sess(p, "monolithic")
    x = _x(p, 12 * p, seed=12)
    nb = x[0].nbytes
    sb, wb = plan_mod.phase_wire_bytes(costmodel.XLA_DEFAULT, p, nb)
    assert (sb, wb) == (2 * (p - 1) * nb // p, 0)

    def fn(v):
        w0 = S.sent_bytes()
        y = sess.world.all_reduce_wait(sess.world.all_reduce_start(v))
        return torch.tensor([S.sent_bytes() - w0])

    sent = _port(sess, fn, x)
    assert (sent == sb).all()
    for r in range(p):
        assert sess.engine.stats.rank_phase_bytes[r][
            "all_reduce.start"] == sb


# ---------------------------------------------------------------------------
# Persistent bindings, barrier, fence, the collectives facade
# ---------------------------------------------------------------------------

BIND_CASES = [("reduce_scatter", {"dim": 1}), ("all_gather", {"dim": 0}),
              ("all_to_all", {"split_dim": 0, "concat_dim": 1}),
              ("broadcast", {"root": 2}), ("permute", {"shift": 3}),
              ("send_recv", {"pairs": [(0, 3), (3, 0)]})]


@pytest.mark.parametrize("mode", ["composed", "monolithic"])
@pytest.mark.parametrize("fn,kw", BIND_CASES)
def test_persistent_bindings_match_dispatch(fn, kw, mode):
    p = 4
    sess = _sess(p, mode)
    x = _x(p, 8, 8, seed=13)
    h = sess.world.persistent(fn, (8, 8), torch.float32, **kw)
    call_kw = dict(kw)
    if fn == "send_recv":
        call_kw = {"pairs": kw["pairs"]}
    want = _port(sess, lambda v: getattr(sess.world, fn)(v, **call_kw), x)
    _assert_bits(want, _port(sess, h, x))
    _assert_bits(want, _port(sess, lambda v: h.wait(h.start(v)), x))
    assert h.protocols[0][0] == AX


def test_barrier_and_checkpoint_fence():
    sess = _sess(4)
    x = _x(4, 3, seed=14)

    def fn(v):
        b = sess.world.barrier()
        tree = sess.world.checkpoint_fence({"a": v, "b": [v * 2]})
        return torch.stack([b.expand(3), tree["a"], tree["b"][0]])

    out = _port(sess, fn, x)
    assert not out[:, 0].any()
    _assert_bits(x, out[:, 1])
    assert sess.engine.stats.events.count("checkpoint_fence") == 4


def test_collectives_facade_default_is_monolithic():
    collectives.install(None)
    p = 4
    mesh = _mesh(p)
    x = _x(p, 8, 4, seed=15, ints=True)
    xs = torch.from_numpy(x)

    def fn(v):
        return (collectives.psum(v, AX), collectives.pmean(v, AX),
                collectives.all_gather(v, AX, dim=1),
                collectives.all_to_all(v, AX, 0, 1),
                collectives.axis_index(AX), collectives.axis_size(AX))

    out = S.run_spmd(fn, [(xs[r],) for r in range(p)], mesh, timeout=60)
    jfn = [lambda v: jcollectives.psum(v, AX),
           lambda v: jcollectives.pmean(v, AX),
           lambda v: jcollectives.all_gather(v, AX, dim=1),
           lambda v: jcollectives.all_to_all(v, AX, 0, 1)]
    for k, jf in enumerate(jfn):
        _assert_bits(_ref(jf, x), torch.stack([o[k] for o in out]).numpy())
    assert [o[4] for o in out] == list(range(p))
    assert all(o[5] == p for o in out)
    default = collectives.session()
    assert not default.engine.composed
    assert default.average_layer_number() == pytest.approx(2.0)
    # an installed session takes the calls; install(None) restores
    comp = _sess(p)
    collectives.install(comp)
    try:
        S.run_spmd(lambda v: collectives.psum(v, AX),
                   [(xs[r],) for r in range(p)], mesh, timeout=60)
        assert registry.ALL_REDUCE in comp.engine.invoked_functions
    finally:
        collectives.install(None)
    assert collectives.session() is default


def test_communicator_strict_false_resolves_the_live_axis():
    sess = Session(topology=topology_from_mesh_shape(("other",), (2,)),
                   mode="monolithic")
    with pytest.raises(ValueError, match="unknown axes"):
        Communicator(sess, (AX,))
    loose = Communicator(sess, (AX,), strict=False)
    x = _x(3, 4, seed=16, ints=True)
    xs = torch.from_numpy(x)
    out = S.run_spmd(lambda v: (loose.size, loose.all_reduce(v, mean=True)),
                     [(xs[r],) for r in range(3)], _mesh(3), timeout=60)
    assert all(o[0] == 3 for o in out)
    np.testing.assert_allclose(out[0][1].numpy(), x.sum(0) / 3, rtol=1e-6)


def test_generic_protocols_module_has_every_function():
    for fn in ("all_reduce", "reduce_scatter", "all_gather", "all_to_all",
               "broadcast", "permute"):
        assert callable(getattr(xla, fn))
