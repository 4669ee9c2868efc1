"""The port's int8 error-feedback all-reduce against the reference's,
bit for bit.

The reference runs as it runs in training: compiled (``jax.jit``) over
``jax.vmap(axis_name=...)`` ranks.  XLA then computes the block scale as
``amax`` times the rounded reciprocal of 127, and contracts each
dequantize followed by an add (the ring's receive step) or a subtract
(the error-feedback residual) into one fused multiply-add.  The port's
``dequant_add`` rounds ``acc + q·scale`` once, so every rank's reduced
values and residuals must be bit-identical after every step, whether the
reference's quantize kernels are off or on.  The port has one path: its
ops take the kernels' plain versions on the CPU.
"""

import fractions
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.comm import Session as JaxSession
from repro.core import compression as jcomp
from repro.core.engine import EngineConfig as JaxEngineConfig
from repro.core.topology import topology_from_mesh_shape as jax_topology
from repro_torch.comm import Session
from repro_torch.core import compression
from repro_torch.core.topology import topology_from_mesh_shape
from repro_torch.kernels.quantize import ref as qref
from repro_torch.runtime import substrate as S

AX = "x"
STEPS = 3


def _bits(a) -> np.ndarray:
    return np.asarray(a).view(np.int32)


def _port(fn, *per_rank):
    p = per_rank[0].shape[0]
    mesh = S.make_mesh((p,), (AX,), device="cpu")
    args = [tuple(torch.from_numpy(np.ascontiguousarray(a[r]))
                  for a in per_rank) for r in range(p)]
    return S.run_spmd(fn, args, mesh, timeout=60)


def _grads(p, step, shape=(10, 103)):
    rng = np.random.RandomState(1000 * p + step)
    return (rng.randn(p, *shape) * rng.uniform(0.01, 3.0)).astype(np.float32)


@pytest.mark.parametrize("ref_kernel", [False, True])
@pytest.mark.parametrize("p", [2, 4, 8])
def test_compressed_all_reduce_and_residual_bits_over_steps(p, ref_kernel):
    """1030 values a rank (padded to p * 256 inside), 3 steps with the
    residual carried: reduced values and residuals per rank.  The port's
    one path against the reference with its Pallas kernels off and on
    (``ref_kernel``)."""

    def ref_step(x, r):
        y, st = jcomp.compressed_all_reduce(x, AX, jcomp.EFState(r),
                                            use_kernel=ref_kernel)
        return y, st.residual

    jstep = jax.jit(jax.vmap(ref_step, axis_name=AX))

    def port_step(x, r):
        y, st = compression.compressed_all_reduce(
            x, AX, compression.EFState(r))
        return y, st.residual

    res_ref = np.zeros((p, 10, 103), np.float32)
    res_port = res_ref.copy()
    for step in range(STEPS):
        x = _grads(p, step)
        y_ref, res_ref = map(np.asarray, jstep(jnp.asarray(x),
                                               jnp.asarray(res_ref)))
        out = _port(port_step, x, res_port)
        y_port = np.stack([o[0].numpy() for o in out])
        res_port = np.stack([o[1].numpy() for o in out])
        np.testing.assert_array_equal(_bits(y_ref), _bits(y_port))
        np.testing.assert_array_equal(_bits(res_ref), _bits(res_port))
        assert np.abs(res_port).max() > 0


@pytest.mark.parametrize("ref_kernel", [False, True])
@pytest.mark.parametrize("p", [2, 4])
def test_engine_compressed_sync_and_arms_bits(p, ref_kernel):
    """Through a session's communicator: ``sync_gradients`` with
    compression on a two-leaf tree (mean), and the start/progress/wait
    arms of one leaf."""
    tree_x = {"a": _grads(p, 7, (5, 60)), "b": _grads(p, 8, (257,))}
    jsess = JaxSession(topology=jax_topology((AX,), (p,)),
                       config=JaxEngineConfig(use_quantize_kernel=ref_kernel))
    sess = Session(topology=topology_from_mesh_shape((AX,), (p,)))

    def ref_fn(a, b):
        g, ef = jsess.world.sync_gradients({"a": a, "b": b}, compress=True)
        return g["a"], g["b"], ef["a"].residual, ef["b"].residual

    def port_fn(a, b):
        g, ef = sess.world.sync_gradients({"a": a, "b": b}, compress=True)
        return g["a"], g["b"], ef["a"].residual, ef["b"].residual

    want = jax.jit(jax.vmap(ref_fn, axis_name=AX))(
        jnp.asarray(tree_x["a"]), jnp.asarray(tree_x["b"]))
    got = _port(port_fn, tree_x["a"], tree_x["b"])
    for j, w in enumerate(want):
        np.testing.assert_array_equal(
            _bits(w), _bits(np.stack([o[j].numpy() for o in got])))

    eng = jsess.engine

    def ref_arms(a):
        tok = eng.compressed_all_reduce_start(a, AX,
                                              jcomp.EFState.zeros_like(a))
        eng.compressed_all_reduce_progress(tok, 1)
        y, st = eng.compressed_all_reduce_wait(tok)
        return y, st.residual

    def port_arms(a):
        e = sess.engine
        tok = e.compressed_all_reduce_start(
            a, AX, compression.EFState.zeros_like(a))
        e.compressed_all_reduce_progress(tok, 1)
        y, st = e.compressed_all_reduce_wait(tok)
        return y, st.residual

    want = jax.jit(jax.vmap(ref_arms, axis_name=AX))(
        jnp.asarray(tree_x["a"]))
    got = _port(port_arms, tree_x["a"])
    for j, w in enumerate(want):
        np.testing.assert_array_equal(
            _bits(w), _bits(np.stack([o[j].numpy() for o in got])))


def test_dequant_add_is_the_compiled_dequantize_then_add():
    """The fused receive step and the residual give the bits of the
    reference's dequantize-then-add and dequantize-then-subtract as XLA
    compiles them; rounding the product first (eager) differs."""
    rng = np.random.RandomState(3)
    n = 256 * 64
    acc = rng.randn(n).astype(np.float32)
    x = (rng.randn(n) * 5).astype(np.float32)
    q, s = jax.jit(jcomp.quantize_blockwise)(jnp.asarray(x))
    add = jax.jit(lambda a, q, s: jcomp.dequantize_blockwise(q, s) + a)
    sub = jax.jit(lambda a, q, s: a - jcomp.dequantize_blockwise(q, s))
    tq, ts, tacc = (torch.from_numpy(np.array(v)) for v in (q, s, acc))
    got_add = qref.dequant_add(tacc, tq, ts).numpy()
    np.testing.assert_array_equal(_bits(add(acc, q, s)), _bits(got_add))
    np.testing.assert_array_equal(_bits(sub(acc, q, s)),
                                  _bits(qref.dequant_add(tacc, tq,
                                                         -ts).numpy()))
    twice = (qref.dequantize(tq, ts) + tacc).numpy()
    assert (_bits(twice) != _bits(got_add)).any()


def _f32_nearest(exact: fractions.Fraction) -> float:
    """The f32 nearest to ``exact``, ties to even, by exact comparison."""
    f = np.float32(float(exact))
    cands = {float(f), float(np.nextafter(f, np.float32(np.inf))),
             float(np.nextafter(f, np.float32(-np.inf)))}

    def key(c):
        odd = struct.unpack("<I", struct.pack("<f", c))[0] & 1
        return (abs(fractions.Fraction(c) - exact), odd)

    return min(cands, key=key)


def test_fma_f32_rounds_once():
    """``fma_f32`` against exact rational arithmetic, on random operands
    and on sums that land at or next to a halfway point of f32."""
    rng = np.random.RandomState(0)
    a = rng.randint(-127, 128, 3000).astype(np.float32)
    b = (rng.randn(3000) * 10.0 ** rng.randint(-8, 3, 3000)).astype(
        np.float32)
    c = rng.randn(3000).astype(np.float32)
    # halfway cases: c + a*b with a*b half an ulp of c, give or take a
    # tiny amount
    ulp = np.spacing(np.abs(c[:600])).astype(np.float32)
    a[:600] = 1.0
    b[:200] = ulp[:200] / 2
    b[200:400] = (ulp[200:400] / 2) * np.float32(1 + 2 ** -20)
    b[400:600] = (ulp[400:600] / 2) * np.float32(1 - 2 ** -20)
    got = qref.fma_f32(*(torch.from_numpy(v) for v in (a, b, c))).numpy()
    want = np.array([_f32_nearest(fractions.Fraction(float(x))
                                  * fractions.Fraction(float(y))
                                  + fractions.Fraction(float(z)))
                     for x, y, z in zip(a, b, c)], np.float32)
    np.testing.assert_array_equal(_bits(want), _bits(got))
