#!/usr/bin/env python3
"""Can a backward node of one rank thread wait for another rank?

    python3 tools/probe_autograd_thread.py [--device cuda|cpu] [--timeout S]

The port's ranks are threads of one process.  A tensor-parallel forward
has operators whose backward all-reduces over the "model" axis, so a
backward node of one rank waits for its peers.  PyTorch's autograd
engine runs every CUDA node of a process on one worker thread per
device, shared by the graph tasks of all threads; a CPU graph task runs
on the thread that called ``backward``.

Two rank threads each build ``y = Wait.apply(x)`` and call
``y.sum().backward()``; ``Wait.backward`` waits at a two-party barrier
with a timeout.  Then the same two ranks run a staged backward: the
barrier runs on the rank thread between two ``backward`` calls, as
``repro_torch.parallel.sharding.StagedBackward`` does.  Prints one line
a variant: ``ok`` with its seconds, or the error a rank raised.  Exits
0 when the staged variant finishes (the answer is the printed lines).
"""

from __future__ import annotations

import argparse
import sys
import threading
import time

import torch


class Wait(torch.autograd.Function):
    """Identity forward; the backward waits at ``barrier``."""

    @staticmethod
    def forward(ctx, x, barrier):
        ctx.barrier = barrier
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        ctx.barrier.wait()
        return g, None


def _ranks(body, n: int = 2):
    """Run ``body(rank)`` on n threads; returns each rank's error or
    None."""
    errors = [None] * n

    def run(r):
        try:
            body(r)
        except BaseException as e:          # reported by the caller
            errors[r] = e

    threads = [threading.Thread(target=run, args=(r,)) for r in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return errors


def probe(device: str, timeout: float) -> bool:
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", 0)
    results = {}

    # 1. the wait inside a backward node
    barrier = threading.Barrier(2, timeout=timeout)

    def in_node(r):
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        x = torch.randn(1024, device=dev, requires_grad=True)
        Wait.apply(x, barrier).sum().backward()
        if dev.type == "cuda":
            torch.cuda.synchronize()

    t0 = time.perf_counter()
    results["wait inside backward"] = (_ranks(in_node),
                                       time.perf_counter() - t0)

    # 2. the staged backward: the wait on the rank thread, between two
    # backward calls over the two halves of the graph
    barrier = threading.Barrier(2, timeout=timeout)

    def staged(r):
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        x = torch.randn(1024, device=dev, requires_grad=True)
        h = x * 2.0
        cut = h.detach().requires_grad_(True)
        (cut * 3.0).sum().backward()
        barrier.wait()
        h.backward(cut.grad)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        assert torch.equal(x.grad, torch.full_like(x, 6.0))

    t0 = time.perf_counter()
    results["staged backward"] = (_ranks(staged), time.perf_counter() - t0)

    for name, (errors, s) in results.items():
        bad = [f"rank {r}: {type(e).__name__}: {e}"
               for r, e in enumerate(errors) if e is not None]
        print(f"[probe] {device} {name}: "
              + ("; ".join(bad) if bad else "ok") + f" ({s:.2f}s, barrier "
              f"timeout {timeout}s)")
    return all(e is None for e in results["staged backward"][0])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--timeout", type=float, default=20.0)
    args = ap.parse_args(argv)
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        print("probe_autograd_thread: CUDA is not available",
              file=sys.stderr)
        return 1
    return 0 if probe(args.device, args.timeout) else 1


if __name__ == "__main__":
    sys.exit(main())
