"""The port's step accounting (``repro_torch.launch.stepanalysis``), the
counterpart of ``repro.launch.hloanalysis``, against the reference's
(``tests/test_launch.py``'s analyzer cases, one JAX child):

- the reference's scanned ``tanh(c @ w)`` x 8 and its (32, 128) @ (128,
  16) product give the same flops in both packages (the port runs the
  loop eagerly: every iteration counts, and ``trip_counts`` records 8);
- movement (transpose, reshape, cast) is not charged to ``hbm_bytes``;
  the training attention's blockwise tiles are charged to
  ``hbm_bytes_attn_tiles`` as well;
- ``_wire_factor`` is the reference's for every kind and p = 1-16;
- a hop over "pod" lands in ``wire_bytes_dcn``, one over "data" in
  ``wire_bytes_ici``, each call labelled with its collective, and
  ``stepanalysis.scan_recorded_step`` counts the calls.
"""

import functools
import json

import pytest
import torch

from conftest import run_subprocess_script
from repro_torch.comm import Session
from repro_torch.launch import stepanalysis as SA
from repro_torch.models import layers as L
from repro_torch.runtime import substrate

_CHILD = r"""
import json
import jax
import jax.numpy as jnp
from repro.launch import hloanalysis as H

def scanned(w, x):
    def body(c, wi):
        return jnp.tanh(c @ wi), None
    c, _ = jax.lax.scan(body, x, w)
    return c.sum()

def flops(fn, *shapes):
    compiled = jax.jit(fn).lower(*[jax.ShapeDtypeStruct(s, jnp.float32)
                                   for s in shapes]).compile()
    cost = H.analyze_module(compiled.as_text())
    return cost.flops, cost.trip_counts

out = {"scan": flops(scanned, (8, 64, 64), (16, 64)),
       "dot": flops(lambda a, b: a @ b, (32, 128), (128, 16)),
       "wire": {k: [H._wire_factor(k, p) for p in range(1, 17)]
                for k in H.COLLECTIVES}}
print(json.dumps(out))
"""


@functools.lru_cache(maxsize=None)
def _reference():
    return json.loads(run_subprocess_script(_CHILD, devices=1,
                                            timeout=300).splitlines()[-1])


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def _scanned(w, x):
    c = x
    for i in range(w.shape[0]):
        c = torch.tanh(c @ w[i])
    return c.sum()


def test_scanned_loop_flops_equal_reference():
    ref_flops, ref_trips = _reference()["scan"]
    cost = SA.analyze_step(_scanned, _meta(8, 64, 64), _meta(16, 64),
                           trip_counts=(8,))
    assert cost.flops == ref_flops == 8 * 2 * 16 * 64 * 64
    assert cost.trip_counts == ref_trips == [8]


def test_dot_flops_equal_reference():
    ref_flops, _ = _reference()["dot"]
    cost = SA.analyze_step(lambda a, b: a @ b, _meta(32, 128),
                           _meta(128, 16))
    assert cost.flops == ref_flops == 2 * 32 * 128 * 16
    # a product is charged: its operands and its output
    assert cost.hbm_bytes == 4 * (32 * 128 + 128 * 16 + 32 * 16)


def test_movement_is_not_charged():
    cost = SA.analyze_step(
        lambda a: a.t().reshape(-1).to(torch.bfloat16), _meta(64, 64))
    assert cost.hbm_bytes == 0 <= 4 * 64 * 64 * 3
    assert cost.flops == 0
    # the reshape of the transposed view and the cast allocate
    assert cost.peak_bytes == 4 * 64 * 64 + 2 * 64 * 64


@pytest.mark.parametrize("kind", SA.COLLECTIVES)
def test_wire_factor_equals_reference(kind):
    assert [SA._wire_factor(kind, p) for p in range(1, 17)] \
        == _reference()["wire"][kind]


def test_attention_tiles_are_charged_apart():
    q = _meta(1, 64, 4, 16, dtype=torch.float32).requires_grad_()
    k = _meta(1, 64, 2, 16, dtype=torch.float32).requires_grad_()
    v = _meta(1, 64, 2, 16, dtype=torch.float32).requires_grad_()

    def step(q, k, v):
        L.train_attention(q, k, v, block_k=16).sum().backward()

    cost = SA.analyze_step(step, q, k, v)
    assert 0 < cost.hbm_bytes_attn_tiles < cost.hbm_bytes
    assert cost.hbm_bytes_kernel_adjusted == (cost.hbm_bytes
                                              - cost.hbm_bytes_attn_tiles)
    assert cost.as_dict()["hbm_bytes_kernel_adjusted"] \
        == cost.hbm_bytes_kernel_adjusted


def _sync_step(session, mesh, axis, x):
    def rank(t):
        return session.split(axis).all_reduce(t)
    return substrate.run_spmd(rank, [(x,)] * mesh.size, mesh)


@pytest.mark.parametrize("axis", ["pod", "data"])
def test_hop_over_pod_is_dcn(axis):
    mesh = substrate.abstract_mesh((2, 2), ("pod", "data"))
    session = Session(mesh=mesh, mode="monolithic")
    x = _meta(1024)
    cost = SA.analyze_step(_sync_step, session, mesh, axis, x)
    assert cost.wire_bytes > 0
    if axis == "pod":
        assert cost.wire_bytes_dcn == cost.wire_bytes
        assert cost.wire_bytes_ici == 0
    else:
        assert cost.wire_bytes_ici == cost.wire_bytes
        assert cost.wire_bytes_dcn == 0
    coll = cost.collectives["all_reduce"]
    assert coll["count"] == 1 and coll["tensor_bytes"] == 4 * 1024
    assert coll["wire_bytes"] == cost.wire_bytes
    assert coll["dcn_bytes"] == cost.wire_bytes_dcn
    assert SA.scan_recorded_step(_sync_step, session, mesh, axis, x) \
        == {"all_reduce": {"count": 1, "bytes": 4 * 1024}}
