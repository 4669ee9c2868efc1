"""The port's multi-axis all-reduce against the reference, on CPU thread
ranks.

- ``protocols.twophase``: the two-phase 2D all-reduce on (2, 2), (2, 4)
  and (4, 2), and the hierarchical all-reduce on (pod 2, data 4) and
  (pod 3, data 2), bit for bit in f32 against the reference's functions
  run as ``tests/test_overlap.py`` runs them (nested ``vmap`` over named
  axes); their start/finish split gives the blocking path's bits.
- With a pod axis that is not a power of two and a shard that does not
  split over it, the port's sum is the plain sum; the reference's keeps
  the pod ring's padding and gathers it in between the values (its
  ``hierarchical_finish`` slices rows, not values), so that case is held
  to numpy only.
- The engine's multi-axis arms: blocking, start/wait and a persistent
  handle give the same bits, and the reference's blocking engine's, for
  two-phase, hierarchical and the per-axis chain of three axes (the
  twin of ``test_overlap.py::test_multiaxis_start_wait_bit_identical``);
  every rank records the phase bytes the communicator's
  ``sync_schedule`` predicts (the twin of ``test_schedule.py``'s
  multi-axis units).
- The compressed gradient sync over two axes (int8 ring on the first,
  the planned all-reduce on the rest) against the reference's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.comm import Session as JaxSession
from repro.core.protocols import twophase as jtwophase
from repro.core.topology import topology_from_mesh_shape as jax_topology
from repro_torch.comm import Session
from repro_torch.core import costmodel, registry
from repro_torch.core.protocols import twophase
from repro_torch.core.topology import topology_from_mesh_shape
from repro_torch.runtime import substrate as S


def _bits(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a)).view(np.int32)


def _x(shape, *per_rank, seed=0):
    return np.random.RandomState(seed + sum(shape)).randn(
        *shape, *per_rank).astype(np.float32)


def _ref(fn, x, axes):
    """``fn`` under one ``vmap`` a mesh axis, outermost first."""
    for ax in reversed(axes):
        fn = jax.vmap(fn, axis_name=ax)
    return np.asarray(fn(jnp.asarray(x)))


def _port(fn, x, axes, shape):
    """``fn`` on thread ranks of a CPU mesh ``shape`` over ``axes``; the
    results stacked back into the mesh's shape."""
    mesh = S.make_mesh(shape, axes, device="cpu")
    xs = torch.from_numpy(np.ascontiguousarray(x)).reshape(
        (mesh.size,) + x.shape[len(shape):])
    out = S.run_spmd(fn, [(xs[r],) for r in range(mesh.size)], mesh,
                     timeout=60)
    if isinstance(out[0], tuple):
        return [torch.stack([o[i] for o in out]).reshape(
            tuple(shape) + tuple(out[0][i].shape)).numpy()
            for i in range(len(out[0]))]
    return torch.stack(out).reshape(tuple(shape) + tuple(out[0].shape)
                                    ).numpy()


def _assert_bits(want, got):
    want = np.asarray(want)
    assert want.shape == got.shape, (want.shape, got.shape)
    np.testing.assert_array_equal(_bits(want), _bits(got))


# ---------------------------------------------------------------------------
# protocols.twophase against the reference's functions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("chunk", [12, 7])     # 7: the odd one-way ring
@pytest.mark.parametrize("shape", [(2, 2), (2, 4), (4, 2)])
def test_two_phase_all_reduce_bits(shape, chunk):
    p0, p1 = shape
    axes = ("a", "b")
    x = _x(shape, p0, chunk)
    ref = _ref(lambda v: jtwophase.two_phase_all_reduce_2d(v, *axes), x,
               axes)
    got = _port(lambda v: twophase.two_phase_all_reduce_2d(v, *axes), x,
                axes, shape)
    _assert_bits(ref, got)
    np.testing.assert_allclose(got[0, 0], x.sum((0, 1)).reshape(-1),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape", [(2, 4), (3, 2), (2, 2)])
def test_hierarchical_all_reduce_bits(shape):
    """(pod 3, data 2) at 48 values: the 24-value shard splits over the
    three pods, the case the reference's padded pod ring gets right."""
    axes = ("pod", "data")
    x = _x(shape, 6, 8, seed=1)
    ref = _ref(lambda v: jtwophase.hierarchical_all_reduce(
        v, ("data",), "pod"), x, axes)
    got = _port(lambda v: twophase.hierarchical_all_reduce(
        v, ("data",), "pod"), x, axes, shape)
    _assert_bits(ref, got)
    np.testing.assert_allclose(got[0, 0], x.sum((0, 1)), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("n", [7, 5, 1])
def test_hierarchical_ragged_pod_ring_gives_the_sum(n):
    """pods = 3 with a shard that does not split over them: the padded
    ring's pad is dropped before the intra-pod gather."""
    shape, axes = (3, 2), ("pod", "data")
    x = _x(shape, n, seed=2)
    got = _port(lambda v: twophase.hierarchical_all_reduce(
        v, ("data",), "pod"), x, axes, shape)
    for c in np.ndindex(*shape):
        np.testing.assert_allclose(got[c], x.sum((0, 1)), rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.parametrize("shape", [(2, 2), (4, 2)])
def test_two_phase_start_finish_is_the_blocking_path(shape):
    axes = ("a", "b")
    x = _x(shape, shape[0], 10, seed=3)

    def split(v):
        shard = twophase.two_phase_start(v, "a")
        return twophase.two_phase_finish(shard, "a", "b", v.shape[0],
                                         v.shape[1])

    _assert_bits(
        _port(lambda v: twophase.two_phase_all_reduce_2d(v, *axes), x, axes,
              shape),
        _port(split, x, axes, shape))


# ---------------------------------------------------------------------------
# The engine's multi-axis arms
# ---------------------------------------------------------------------------

ENGINE_CASES = [
    (("data", "model"), (2, 2), costmodel.TWO_PHASE_2D),
    (("data", "model"), (4, 2), costmodel.TWO_PHASE_2D),
    (("pod", "data"), (2, 4), costmodel.HIERARCHICAL),
    (("pod", "data"), (3, 2), costmodel.HIERARCHICAL),
    (("data", "model", "aux"), (2, 2, 2), None),      # per-axis chain
]


@pytest.mark.parametrize("axes,shape,proto", ENGINE_CASES,
                         ids=lambda v: str(v))
def test_engine_multiaxis_arms_bit_identical(axes, shape, proto):
    """Blocking, start/wait, and a persistent handle's call and
    start/wait: one set of bits, the reference engine's blocking
    all-reduce's (48 values: the pod shard splits over 3 pods)."""
    n = 48
    x = _x(shape, n, seed=4)
    sess = Session(mesh=S.make_mesh(shape, axes, device="cpu"))
    comm = sess.world
    h = comm.persistent("all_reduce", (n,), torch.float32)
    if proto is not None:
        assert h.protocols == (("+".join(axes), proto),)
    else:
        assert tuple(a for a, _ in h.protocols) == axes

    def rank(v):
        return (comm.all_reduce(v),
                comm.all_reduce_wait(comm.all_reduce_start(v)),
                h(v), h.wait(h.start(v)))

    outs = _port(rank, x, axes, shape)
    for o in outs[1:]:
        _assert_bits(outs[0], o)
    jeng = JaxSession(topology=jax_topology(axes, shape)).engine
    _assert_bits(_ref(lambda v: jeng.all_reduce(v, axes), x, axes), outs[0])
    np.testing.assert_allclose(outs[0].reshape(-1, n)[0],
                               x.reshape(-1, n).sum(0), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("axes,shape,proto", ENGINE_CASES[:4],
                         ids=lambda v: str(v))
def test_multiaxis_phase_bytes_are_the_predicted(axes, shape, proto):
    """Every rank records, per phase, the bytes the communicator's
    ``sync_schedule`` unit bills for the same call."""
    n = 4096
    sess = Session(mesh=S.make_mesh(shape, axes, device="cpu"))
    comm = sess.world
    (u,) = comm.sync_schedule([("g", n, torch.float32)]).units
    assert (u.fn, u.protocol, u.axes) == (registry.ALL_REDUCE, proto, axes)
    x = _x(shape, n, seed=5)
    _port(lambda v: comm.all_reduce_wait(comm.all_reduce_start(v)), x, axes,
          shape)
    size = int(np.prod(shape))
    for r in range(size):
        ph = sess.engine.stats.rank_phase_bytes[r]
        assert (ph["all_reduce.start"], ph["all_reduce.wait"]) == (
            u.start_bytes, u.wait_bytes), r


def test_sync_schedule_multiaxis_units():
    """Twin of test_schedule.py::test_sync_schedule_compressed_and_
    multiaxis_units, on (data, model) and (pod, data)."""
    sess = Session(topology=topology_from_mesh_shape(("data", "model"),
                                                     (4, 2)))
    (u,) = sess.split("data").sync_schedule([("b0", 4096, torch.float32)],
                                            compress=True).units
    assert u.fn == registry.COMPRESSED_ALL_REDUCE
    assert u.protocol == costmodel.RING
    (m,) = sess.world.sync_schedule([("b0", 4096, torch.float32)]).units
    assert m.protocol == costmodel.TWO_PHASE_2D
    assert m.axes == ("data", "model")
    podded = Session(topology=topology_from_mesh_shape(("pod", "data"),
                                                       (2, 4)))
    (h,) = podded.world.sync_schedule([("b0", 4096, torch.float32)]).units
    assert h.protocol == costmodel.HIERARCHICAL
    assert h.axes == ("pod", "data")


@pytest.mark.parametrize("axes,shape", [(("data", "model"), (2, 2)),
                                        (("pod", "data"), (2, 2))])
def test_compressed_sync_over_two_axes_matches_reference(axes, shape):
    """``sync_gradients(compress=True)`` over two axes: the int8 ring on
    the first, the planned all-reduce on the second, the mean over both.
    The reference runs compiled, as in training (see
    ``test_torch_compression.py``): values and residuals bit for bit."""
    rng = np.random.RandomState(6)
    g = {"a": rng.randn(*shape, 300).astype(np.float32),
         "b": rng.randn(*shape, 8, 5).astype(np.float32)}
    jeng = JaxSession(topology=jax_topology(axes, shape)).engine

    def jfn(a, b):
        out, ef = jeng.sync_gradients({"a": a, "b": b}, axes, compress=True)
        return out["a"], out["b"], ef["a"].residual, ef["b"].residual

    fn = jfn
    for ax in reversed(axes):
        fn = jax.vmap(fn, axis_name=ax)
    want = [np.asarray(t) for t in jax.jit(fn)(jnp.asarray(g["a"]),
                                               jnp.asarray(g["b"]))]
    sess = Session(mesh=S.make_mesh(shape, axes, device="cpu"))
    mesh = sess.mesh

    def rank(a, b):
        out, ef = sess.engine.sync_gradients({"a": a, "b": b}, axes,
                                             compress=True)
        return out["a"], out["b"], ef["a"].residual, ef["b"].residual

    flat = {k: torch.from_numpy(v).reshape((mesh.size,) + v.shape[2:])
            for k, v in g.items()}
    outs = S.run_spmd(rank, [(flat["a"][r], flat["b"][r])
                             for r in range(mesh.size)], mesh, timeout=60)
    for i, w in enumerate(want):
        _assert_bits(w, torch.stack([o[i] for o in outs]).reshape(
            w.shape).numpy())
