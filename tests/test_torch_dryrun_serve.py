"""The dry-run's serving cells (``launch.dryrun.serve_cell``), no JAX.

- ``sharding.cache_split`` gives, for every one of the 44 production
  serving cells at (16, 16) and (2, 16, 16), the specs the dry-run's
  ``serve_cache_shardings`` gave before the rule moved into
  ``parallel.sharding`` (``_old_serve_cache_shardings`` below, that
  function as it stood).
- A reduced prefill cell (mamba2-1.3b: its conv and ssm state split
  over "model", its weights over "data") and a reduced decode cell
  (granite-34b: its one K/V head's cache split by sequence over
  "model", the partial softmaxes combined) traced on ``meta`` give the
  flops, wire bytes and peak (params / caches / rest) of rank 0 of the
  same step run for real on the CPU thread mesh, to the byte.  A prefill
  with attention gives the real step's flops and wire bytes; its peak
  is below the real one, whose flash op on the CPU is the plain version
  with its score matrix (on ``meta`` the op holds its output only, as
  the kernel does).
- ``run_cell`` on a production decode cell (jamba-1.5-large-398b's
  ``long_500k`` at (2, 16, 16): its K/V sequence over ("model", "data",
  "pod"), about 5 s) records ``"traced": true``.
"""

import math

import numpy as np
import pytest
import torch

from repro_torch.configs import cells, get_config, get_shape
from repro_torch.launch import dryrun as D
from repro_torch.launch import stepanalysis as SA
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import build_model
from repro_torch.parallel import sharding
from repro_torch.runtime import substrate
from repro_torch.serve import paging
from repro_torch.tree import flatten

SERVE_CELLS = [(a, s, m) for a, s, _ in cells() for m in ("single", "multi")
               if get_shape(s).kind != "train"]


def _old_serve_cache_shardings(model, mesh, batch, max_len, enc_len=0):
    """The dry-run's ``serve_cache_shardings`` before this rule moved
    into ``sharding.cache_split``, kept as it stood (the reference's
    arithmetic)."""
    batch_axes = ("pod", "data")
    kv = {"k": (batch_axes, None, "model", None),
          "v": (batch_axes, None, "model", None), "len": (batch_axes,)}
    mixers = {"attn": kv,
              "mla": {"ckv": (batch_axes, None, None),
                      "krope": (batch_axes, None, None),
                      "len": (batch_axes,)},
              "mamba": {"conv": (batch_axes, None, "model"),
                        "ssm": (batch_axes, "model", None, None)}}

    def stacked(d):
        return [(None,) + d[k] for k in sorted(d)]

    if model.kind == "encdec":
        specs = [(batch_axes, None, None)] + stacked(kv)   # memory, self
    else:                                 # in sorted-path order
        order = sorted((f"stage{i}", f"layer{j}", k)
                       for i, st in enumerate(model.cfg.stages)
                       for j, layer in enumerate(st.layers)
                       for k in mixers[layer.mixer])
        keyed = {(f"stage{i}", f"layer{j}", k): (None,) + mixers[
            layer.mixer][k] for i, st in enumerate(model.cfg.stages)
            for j, layer in enumerate(st.layers) for k in mixers[layer.mixer]}
        specs = [keyed[p] for p in order]
    abstract = paging.abstract_caches(
        model, batch, max_len, dtype=torch.bfloat16,
        enc_len=enc_len if model.kind == "encdec" else 0)
    leaves = flatten(abstract)[0]
    sizes = dict(zip(mesh.axis_names, mesh.axis_sizes))

    def one(spec, leaf):
        fitted = list(D.fit_spec(spec, tuple(leaf.shape), mesh))
        while len(fitted) < leaf.ndim:
            fitted.append(None)
        used = set()
        for e in fitted:
            for a in (e if isinstance(e, tuple) else (e,)):
                if a:
                    used.add(a)
        free = [a for a in ("model", "data", "pod") if a in sizes
                and a not in used]
        if free and leaf.ndim >= 2:
            dims = [(d, i) for i, d in enumerate(leaf.shape)
                    if fitted[i] is None]
            if dims:
                dmax, imax = max(dims)
                axes = []
                for a in free:
                    n = sizes[a]
                    cur = math.prod(sizes[x] for x in axes)
                    if dmax % (cur * n) == 0 and dmax >= 2 * cur * n:
                        axes.append(a)
                if axes and dmax >= 1024:
                    fitted[imax] = tuple(axes) if len(axes) > 1 else axes[0]
        return tuple(fitted)

    return [one(s, l) for s, l in zip(specs, leaves)]


def test_there_are_44_serving_cells():
    assert len(SERVE_CELLS) == 44


@pytest.mark.parametrize("arch,shape,mesh_kind", SERVE_CELLS,
                         ids=[f"{a}-{s}-{m}" for a, s, m in SERVE_CELLS])
def test_cache_split_equals_the_old_rule(arch, shape, mesh_kind):
    mesh = make_production_mesh(multi_pod=mesh_kind == "multi")
    sh = get_shape(shape)
    model = build_model(get_config(arch))
    cache_len = sh.seq_len + 512 if sh.kind == "decode" else sh.seq_len
    want = _old_serve_cache_shardings(model, mesh, sh.global_batch,
                                      cache_len, enc_len=sh.seq_len)
    got, _ = sharding.cache_split(model, mesh.shape, sh.global_batch,
                                  cache_len, sh.seq_len)
    assert got == want
    assert D.serve_cache_shardings(model, mesh, sh.global_batch, cache_len,
                                   enc_len=sh.seq_len)[0] == want


def _batch(arch, cfg, kind, rows, seq):
    rng = np.random.default_rng([5, rows, seq])
    s = 1 if kind == "decode" else seq
    out = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (rows, s)).astype(np.int32))}
    return out


def _traced_and_real(arch, kind, shape, seq):
    """(the dry-run's cost of rank 0 of the cell, the real CPU step's)."""
    cfg = get_config(arch, reduced=True)
    data, model_parallel = shape
    host = _batch(arch, cfg, kind, 4, seq)
    meta = {k: torch.empty(v.shape, dtype=v.dtype, device="meta")
            for k, v in host.items()}
    dry = D.trace_cell(D.serve_cell(
        cfg, kind, meta, substrate.abstract_mesh(shape, ("data", "model")),
        seq_len=seq))
    mesh = substrate.make_host_mesh(data, model_parallel=model_parallel,
                                    device="cpu")
    params = build_model(cfg).init(torch.Generator().manual_seed(0))
    cell = D.serve_cell(cfg, kind, host, mesh, seq_len=seq, params=params)
    out, real = SA.measure_rank(cell.fn, *cell.args)
    logits = out[0][0]
    assert torch.isfinite(logits).all()
    return dry, real


@pytest.mark.parametrize("arch,kind,shape,seq", [
    ("mamba2-1.3b", "prefill", (2, 2), 1024),
    ("granite-34b", "decode", (1, 2), 1024)])
def test_traced_serving_step_equals_a_real_rank(arch, kind, shape, seq):
    dry, real = _traced_and_real(arch, kind, shape, seq)
    assert dry.flops > 0 and dry.wire_bytes > 0
    assert (dry.flops, dry.wire_bytes, dry.peak_bytes, dry.peak) == (
        real.flops, real.wire_bytes, real.peak_bytes, real.peak)
    assert dry.peak["caches"] > 0 and dry.peak["params"] > 0
    if kind == "decode":       # the partial softmaxes' all-gather
        assert dry.collectives["all_gather"]["count"] > 0


def test_traced_attention_prefill_counts_the_real_flops():
    dry, real = _traced_and_real("granite-34b", "prefill", (1, 2), 1024)
    assert (dry.flops, dry.wire_bytes) == (real.flops, real.wire_bytes)
    assert dry.peak_bytes < real.peak_bytes


def test_production_decode_cell_is_traced(tmp_path):
    r = D.run_cell("jamba-1.5-large-398b", "long_500k", "multi",
                   out_dir=str(tmp_path))
    assert r["ok"] and r["traced"] is True, r.get("error")
    an = r["analysis"]
    assert an["flops"] > 0 and an["wire_bytes_dcn"] > 0
    assert r["memory"]["peak_split_traced"]["caches"] > 0
    assert r["meta"]["cache_len"] == get_shape("long_500k").seq_len + 512
