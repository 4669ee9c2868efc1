"""The port's protocols against the reference's, bit for bit.

The reference runs under ``jax.vmap(axis_name=...)``, as
``tests/test_protocols.py`` does; the port runs the same per-rank inputs
on thread ranks (``substrate.run_spmd``).  Both sum the same operands
in the same order, so every rank's f32 result must be bit-identical,
whether the reference's RS combine kernel is off or on.  The port has
one path: its combine is ``sum_chunks``, whose plain version on the CPU
starts at zero and adds in order, as the reference's kernel does.  bf16 ring reduce-scatters are held to
the same bar: both packages add two bf16 values in f32 and round once.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.comm import Session as JaxSession
from repro.core.engine import EngineConfig as JaxEngineConfig
from repro.core.protocols import recursive as jrec
from repro.core.protocols import ring as jring
from repro.core.topology import topology_from_mesh_shape as jax_topology
from repro_torch.comm import Session
from repro_torch.core.engine import EngineConfig
from repro_torch.core.protocols import recursive, ring
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
