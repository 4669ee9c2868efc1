"""The plain versions of the port's collective kernels against the
reference's Pallas kernels, bit for bit.

The reference kernels run in interpret mode (``force_kernel=True`` on
the CPU), as ``tests/test_kernels.py`` runs them; the port's ``ops`` on
a CPU tensor take the plain version (``ref``), which is what the CUDA
kernels are held to on the card.  Required: bit-identical, including an
all-zero block, exact .5 ties (round half to even), ragged lengths and
k = 2, 3.  Also: the ``meta`` shape path the application scan uses, and
a CUDA-only binding refusing a CPU tensor.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.local_reduce import ops as jlops
from repro.kernels.quantize import ops as jqops
from repro_torch.kernels.local_reduce import kernel as lkernel
from repro_torch.kernels.local_reduce import ops as lops
from repro_torch.kernels.quantize import kernel as qkernel
from repro_torch.kernels.quantize import ops as qops

QB = 256


def _bits(a):
    a = np.asarray(a)
    return a.view({1: np.int8, 2: np.int16, 4: np.int32}[a.dtype.itemsize])


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("k", [2, 3])
@pytest.mark.parametrize("n", [1024, 1000, 3 * 1024 + 17])
def test_sum_chunks_plain_matches_reference_kernel(k, n):
    x = np.random.RandomState(k * n).randn(k, n).astype(np.float32)
    want = jlops.sum_chunks(jnp.asarray(x), dtype=jnp.float32,
                            force_kernel=True)
    got = lops.sum_chunks(_t(x))
    np.testing.assert_array_equal(_bits(want), _bits(got.numpy()))
    got_list = lops.sum_chunks([_t(r) for r in x])
    assert torch.equal(got, got_list)


def test_sum_chunks_bf16_output_matches_reference_kernel():
    x = np.random.RandomState(1).randn(2, 777).astype(np.float32)
    want = jlops.sum_chunks(jnp.asarray(x, jnp.bfloat16),
                            dtype=jnp.bfloat16, force_kernel=True)
    got = lops.sum_chunks(_t(x).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(_bits(want),
                                  got.view(torch.int16).numpy())


def _quant_input(rows, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(rows, QB).astype(np.float32) * rng.uniform(
        0.01, 10, size=(rows, 1)).astype(np.float32)
    x[1] = 0.0                                       # all-zero block
    # exact ties: amax 127 gives scale 1.0, so k + 0.5 lands on .5
    x[2] = (np.arange(QB) % 9 - 4).astype(np.float32) + 0.5
    x[2, 0] = 127.0
    x[3, :] = -x[3, :]
    return x.reshape(-1)


@pytest.mark.parametrize("rows", [4, 9, 33])
def test_quantize_plain_matches_reference_kernel(rows):
    x = _quant_input(rows, seed=rows)
    wq, ws = jqops.quantize(jnp.asarray(x), force_kernel=True)
    q, s = qops.quantize(_t(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(np.asarray(wq), q.numpy())
    np.testing.assert_array_equal(_bits(ws), _bits(s.numpy()))
    assert s[1].item() == 1.0 and (q[QB:2 * QB] == 0).all()
    # ties go to even: 0.5 -> 0, 1.5 -> 2, -0.5 -> 0, -1.5 -> -2
    tie = q[2 * QB:3 * QB].numpy()
    vals = x[2 * QB:3 * QB]
    np.testing.assert_array_equal(tie[1:], np.rint(vals[1:]).astype(np.int8))


@pytest.mark.parametrize("rows", [4, 9, 33])
def test_dequantize_and_dequant_add_plain_match_reference_kernels(rows):
    x = _quant_input(rows, seed=100 + rows)
    acc = np.random.RandomState(rows).randn(rows * QB).astype(np.float32)
    wq, ws = jqops.quantize(jnp.asarray(x), force_kernel=True)
    q, s = _t(np.asarray(wq)), _t(np.asarray(ws))
    want = jqops.dequantize(wq, ws, force_kernel=True)
    np.testing.assert_array_equal(_bits(want),
                                  _bits(qops.dequantize(q, s).numpy()))
    want = jqops.dequant_add(jnp.asarray(acc), wq, ws, force_kernel=True)
    got = qops.dequant_add(_t(acc), q, s)
    np.testing.assert_array_equal(_bits(want), _bits(got.numpy()))


def test_meta_tensors_take_the_shape_path():
    m = torch.empty(4 * QB, device="meta")
    q, s = qops.quantize(m)
    assert (q.shape, q.dtype, s.shape, s.dtype) == (
        (4 * QB,), torch.int8, (4,), torch.float32)
    assert q.device.type == s.device.type == "meta"
    assert qops.dequantize(q, s).shape == (4 * QB,)
    assert qops.dequant_add(m, q, s).device.type == "meta"
    out = lops.sum_chunks([torch.empty(7, device="meta",
                                       dtype=torch.bfloat16)] * 2)
    assert out.shape == (7,) and out.dtype == torch.bfloat16


def test_ops_refuse_lengths_off_the_block():
    with pytest.raises(ValueError, match="multiple"):
        qops.quantize(torch.zeros(300))


def test_cuda_bindings_refuse_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        lkernel.sum_chunks([torch.zeros(8), torch.zeros(8)])
    with pytest.raises(ValueError, match="CUDA"):
        qkernel.quantize(torch.zeros(QB))
    with pytest.raises(ValueError, match="CUDA"):
        qkernel.dequantize(torch.zeros(QB, dtype=torch.int8),
                           torch.ones(1))


def test_plain_versions_give_the_same_bits_slice_by_slice(monkeypatch):
    """The plain quantize and dequant-add work SLICE values at a time on
    the card; a slice of 2 blocks gives the bits of one pass."""
    from repro_torch.kernels.quantize import ref as qref
    x = _t(_quant_input(9, seed=5))
    acc = torch.randn(9 * QB, generator=torch.Generator().manual_seed(5))
    whole = qref.quantize(x) + (qref.dequant_add(acc, *qref.quantize(x)),)
    monkeypatch.setattr(qref, "SLICE", 2 * QB)
    sliced = qref.quantize(x) + (qref.dequant_add(acc, *qref.quantize(x)),)
    for a, b in zip(whole, sliced):
        assert torch.equal(a, b)
