"""Planning and the application scan: the port against the reference.

- From one topology with the same link values, the two packages give
  identical protocol tables, gradient-bucket layouts and tier
  assignments (exact: the cost model is the same arithmetic).
- On the port's H100 link model, a data-axis all-reduce of a 64 MiB f32
  leaf plans to a ring protocol, so the combine kernel is on the path.
- The §2.2 scan of the reduced granite-34b training step, composed and
  compressed, composes the same library as the reference's
  ``build_session``; it runs on ``meta`` tensors and allocates no
  memory of the model's size on the CPU.
"""

import dataclasses
import types

import jax
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import get_config as jget_config
from repro.core import layers as jlayers
from repro.core import plan as jplan
from repro.core import topology as jtopo
from repro.data import SyntheticLMDataset as JDataset
from repro.launch import train as jtrain
from repro.launch.mesh import make_host_mesh as jmake_host_mesh
from repro.models import build_model as jbuild_model
from repro.optim import cosine_schedule as jcosine
from repro.optim import make_optimizer as jmake_optimizer
from repro_torch.configs import get_config
from repro_torch.core import costmodel, layers, plan, registry, topology
from repro_torch.data import SyntheticLMDataset
from repro_torch.launch.train import build_session
from repro_torch.models import build_model
from repro_torch.optim import cosine_schedule, make_optimizer
from repro_torch.runtime import substrate
from repro_torch.train import trainer

MESHES = [(("data",), (4,)), (("data", "model"), (4, 2)),
          (("pod", "data"), (2, 4)), (("data",), (3,))]


def _pair(names, sizes):
    """The same network in both packages: each axis gets the reference's
    link values (ICI inside a pod, DCN across)."""
    jt = jtopo.topology_from_mesh_shape(names, sizes)
    links = {a: topology.Link(bandwidth=l.bandwidth, alpha=l.alpha,
                              wraparound=l.wraparound, duplex=l.duplex)
             for a, l in jt.axis_links.items()}
    return jt, topology.Topology(axis_sizes=dict(jt.axis_sizes),
                                 axis_links=links)


@pytest.mark.parametrize("names,sizes", MESHES)
def test_same_topology_gives_identical_protocol_tables(names, sizes):
    jt, pt = _pair(names, sizes)
    fns = sorted(registry.ALL_FUNCTIONS)
    jp = jplan.CommPlan(jt, composed=True, warm_functions=fns)
    pp = plan.CommPlan(pt, composed=True, warm_functions=fns)
    rows = lambda cp: {k: dataclasses.astuple(e)
                       for k, e in cp._table.items()}
    assert rows(pp) == rows(jp) and len(rows(pp)) > 0
    for axis in names:
        for nb in (4, 3000, 1 << 20, 64 << 20, 1 << 30):
            for fn in (registry.ALL_REDUCE, registry.REDUCE_SCATTER):
                assert pp.protocol_for(fn, nb, axis) == \
                    jp.protocol_for(fn, nb, axis)
                assert plan.phase_wire_bytes(
                    pp.protocol_for(fn, nb, axis), pt.size(axis), nb) == \
                    tuple(jplan.phase_wire_bytes(
                        jp.protocol_for(fn, nb, axis), jt.size(axis), nb))


def test_same_leaves_give_identical_bucket_layouts():
    shapes = [((64, 32), np.float32), ((7,), np.float32),
              ((128, 129), "bfloat16"), ((1000,), np.float32),
              ((3, 5, 7), "bfloat16")]
    jleaves = [jax.ShapeDtypeStruct(s, d) for s, d in shapes]
    tdt = {np.float32: torch.float32, "bfloat16": torch.bfloat16}
    pleaves = [torch.empty(s, dtype=tdt[d], device="meta")
               for s, d in shapes]
    for cap in (None, 4096, 40_000, 1 << 20):
        for aware in (True, False):
            jb = jplan.plan_buckets(jleaves, cap, dtype_aware=aware)
            pb = plan.plan_buckets(pleaves, cap, dtype_aware=aware)
            assert [(str(np.dtype(b.wire_dtype)), b.size, b.nbytes,
                     [(s.index, s.offset, s.size, s.shape)
                      for s in b.slots]) for b in jb] == \
                [(plan.dtype_name(b.wire_dtype), b.size, b.nbytes,
                  [(s.index, s.offset, s.size, s.shape) for s in b.slots])
                 for b in pb]


def test_same_frequencies_give_identical_tiers():
    freqs = {fn: f for fn, f in zip(sorted(registry.ALL_FUNCTIONS),
                                    np.logspace(-2, 6, 40))}
    jtiers = jlayers.assign_tiers(freqs, jlayers.TierPolicy())
    ptiers = layers.assign_tiers(freqs, layers.TierPolicy())
    assert ptiers == jtiers
    assert layers.average_layer_number(ptiers, freqs) == \
        pytest.approx(jlayers.average_layer_number(jtiers, freqs),
                      rel=1e-12)


@pytest.mark.parametrize("p", [2, 4, 8])
def test_h100_link_model_plans_a_large_leaf_to_a_ring(p):
    topo = topology.topology_from_mesh_shape(("data",), (p,))
    assert topo.link("data").wraparound
    pp = plan.CommPlan(topo, composed=True)
    proto = pp.protocol_for(registry.ALL_REDUCE, 64 << 20, "data")
    assert proto in (costmodel.RING, costmodel.BIDIR_RING)


class _CpuBytes(TorchDispatchMode):
    """Counts the bytes of every CPU tensor an operation returns."""

    def __init__(self):
        super().__init__()
        self.cpu_bytes = 0
        self.meta_ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in out if isinstance(out, (tuple, list)) else (out,):
            if isinstance(t, torch.Tensor):
                if t.device.type == "cpu":
                    self.cpu_bytes += t.numel() * t.element_size()
                elif t.device.type == "meta":
                    self.meta_ops += 1
        return out


def _reference_library(sync):
    cfg = jget_config("granite-34b", reduced=True)
    model = jbuild_model(cfg)
    opt = jmake_optimizer("adamw", lr=jcosine(1e-3, warmup=1, total=8))
    ds = JDataset(vocab_size=cfg.vocab_size, seq_len=32, global_batch=8)
    args = types.SimpleNamespace(
        microbatches=1, sync=sync, bucket_grads=False,
        bucket_bytes=32 << 20, overlap=False, overlap_depth=2, zero=False)
    sess = jtrain.build_session(jmake_host_mesh(model_parallel=1), model,
                                opt, ds, args)
    lib = sess.engine.library
    return (sorted(lib.functions), list(lib.blocks), sorted(lib.provided),
            dict(sess.engine.tiers))


@pytest.mark.parametrize("sync", ["composed", "compressed"])
def test_scan_composes_the_reference_library(sync):
    cfg = get_config("granite-34b", reduced=True)
    model = build_model(cfg)
    opt = make_optimizer("adamw", lr=cosine_schedule(1e-3, warmup=1,
                                                     total=8))
    ds = SyntheticLMDataset(vocab_size=cfg.vocab_size, seq_len=32,
                            global_batch=8)
    mesh = substrate.make_host_mesh(4, device="cpu")
    with _CpuBytes() as watch:
        sess = build_session(mesh, model, opt, ds,
                             trainer.TrainCfg(sync_mode=sync))
    assert watch.meta_ops > 100
    # only scalars (the step, the learning rate) are made on the CPU
    assert watch.cpu_bytes < 4096 < model.param_count() * 4
    lib = sess.engine.library
    got = (sorted(lib.functions), list(lib.blocks), sorted(lib.provided),
           dict(sess.engine.tiers))
    assert got == _reference_library(sync)
    if sync == "compressed":
        assert registry.COMPRESSED_ALL_REDUCE in lib.functions
    assert sess.trace_report.count("permute") > 0
