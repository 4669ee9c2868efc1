"""The port's in-process ranks: ``run_spmd``, ``ppermute`` and the rank
queries on 2/3/4/8 thread ranks, failure propagation without a hang, the
application scan's recording transport, and the thread-safe kernel
launch counters.  Exact equality throughout: a hop copies bytes."""

import sys
import threading
import time

import pytest
import torch

from repro_torch.kernels import counter as kcounter
from repro_torch.kernels.counter import LaunchCounter
from repro_torch.runtime import substrate as S

AX = "x"


def _mesh(p):
    return S.make_mesh((p,), (AX,), device="cpu")


@pytest.mark.parametrize("p", [2, 3, 4, 8])
def test_ppermute_shift_and_rank_queries(p):
    def body(r):
        i = S.axis_index(AX)
        x = torch.full((3,), float(i))
        fwd = S.ppermute(x, AX, [(j, (j + 1) % p) for j in range(p)])
        bwd = S.ppermute(x, AX, [(j, (j - 1) % p) for j in range(p)])
        return i, S.axis_size(AX), fwd, bwd, x

    out = S.run_spmd(body, [(r,) for r in range(p)], _mesh(p))
    for r, (i, size, fwd, bwd, x) in enumerate(out):
        assert (i, size) == (r, p)
        assert torch.equal(fwd, torch.full((3,), float((r - 1) % p)))
        assert torch.equal(bwd, torch.full((3,), float((r + 1) % p)))
        assert fwd.data_ptr() != out[(r - 1) % p][4].data_ptr()


def test_partial_permutation_zero_fills_receivers_without_a_sender():
    def body(r):
        return S.ppermute(torch.full((2,), r + 1.0), AX, [(0, 1)])

    out = S.run_spmd(body, [(r,) for r in range(3)], _mesh(3))
    assert torch.equal(out[1], torch.full((2,), 1.0))
    assert torch.equal(out[0], torch.zeros(2))
    assert torch.equal(out[2], torch.zeros(2))


def test_two_axis_mesh_hops_stay_within_their_axis():
    mesh = S.make_mesh((2, 3), ("a", "b"), device="cpu")

    def body(r):
        x = torch.tensor([float(r)])
        return S.ppermute(x, "b", [(j, (j + 1) % 3) for j in range(3)])

    out = S.run_spmd(body, [(r,) for r in range(6)], mesh)
    for r in range(6):
        c = mesh.coords(r)
        src = mesh.rank_of(dict(c, b=(c["b"] - 1) % 3))
        assert out[r].item() == float(src)


def test_a_failing_rank_fails_the_run_without_a_hang():
    def body(r):
        if r == 2:
            raise ValueError("rank two fails")
        for _ in range(3):
            S.ppermute(torch.zeros(2), AX, [(j, (j + 1) % 4)
                                           for j in range(4)])
        return r

    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 2 of 4 failed: "
                                           "ValueError: rank two fails"):
        S.run_spmd(body, [(r,) for r in range(4)], _mesh(4), timeout=30)
    assert time.monotonic() - t0 < 10


def test_a_rank_that_never_arrives_times_out_the_hop():
    release = threading.Event()

    def body(r):
        if r == 1:
            release.wait(10)
            return r
        return S.ppermute(torch.zeros(1), AX, [(0, 1), (1, 0)])

    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="SpmdAbort"):
        S.run_spmd(body, [(r,) for r in range(2)], _mesh(2), timeout=0.5)
    release.set()
    assert time.monotonic() - t0 < 10


def test_recording_runs_rank_zero_on_meta_and_records_hops():
    mesh = S.abstract_mesh((4,), (AX,))

    def body(x):
        y = S.ppermute(x, AX, [(j, (j + 1) % 4) for j in range(4)])
        return S.axis_index(AX), y

    with S.recording() as rec:
        out = S.run_spmd(body, [(torch.empty(5, 3, device="meta"),)] * 4,
                         mesh)
    assert out[0][0] == 0 and out[0][1].device.type == "meta"
    assert [(s.function, s.nbytes, s.axis) for s in rec.sites] == [
        ("permute", 60, AX), ("axis_index", 0, AX)]
    with pytest.raises(ValueError, match="abstract"):
        S.run_spmd(body, [(torch.zeros(1),)] * 4, mesh)


def test_collectives_outside_a_rank_raise():
    with pytest.raises(RuntimeError, match="not inside a rank"):
        S.axis_index(AX)


def test_launch_counter_loses_no_update_under_contention():
    counter = LaunchCounter()
    n_threads, per = 16, 2000
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(
            target=lambda: [counter.add() for _ in range(per)])
            for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert counter.value == n_threads * per
    assert counter.reset() == n_threads * per and counter.value == 0


def test_every_kernel_family_counts_through_a_launch_counter():
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.local_reduce import ops as lops
    from repro_torch.kernels.quantize import ops as qops
    assert isinstance(fops.counter, LaunchCounter)
    assert isinstance(lops.counter, LaunchCounter)
    assert all(isinstance(c, LaunchCounter) for c in qops.counters.values())
    names = {"flash_attention", "sum_chunks", "quantize", "dequantize",
             "dequant_add"}
    assert names <= set(kcounter.counts())
    assert all(isinstance(n, int) for n in kcounter.counts().values())
