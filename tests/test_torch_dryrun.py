"""The launch layer's dry-run of the port (``repro_torch.launch.dryrun``)
against the reference's (``repro.launch.dryrun``).

- One JAX child with 512 host devices dumps the reference's arithmetic
  for every cell of ``cells()`` at (16, 16) and (2, 16, 16):
  ``input_specs``' shapes and dtypes, ``analytic_memory_train`` /
  ``_serve``, ``model_flops``, and for every arch ``active_param_count``
  and ``train_settings``, plus ``fit_spec`` on a (4, 2) mesh.  The
  port's values must be equal, float for float (the fit verdict is
  held against the port's own ``HBM_PER_CHIP``: the card differs).
  The child runs on a thread from the file's first test on, while the
  traced steps below run in this process.
- On reduced granite-34b at (data 2) and reduced granite-34b and
  jamba-1.5-large-398b at (data 2, model 2), the dry-run's flops, rank
  0's wire bytes, charged bytes and peak of live bytes equal those read
  inside rank 0 of the same step run for real on the CPU thread mesh
  (``stepanalysis.measure_rank``), exactly.
- One production train cell (qwen2-vl-7b at (2, 16, 16), the cheapest
  by its trace time, about 19 s on the CPU; its 28 query heads do not
  split over 16 model ranks, so its attention is whole on every rank)
  is traced whole.
- The refused variants (``puredp``, the ``seqflash`` family), a serving
  cell's analytic model beside its trace, and the train launcher's
  refusal of ``--production-mesh``.
"""

import functools
import json
import threading

import numpy as np
import pytest
import torch

from conftest import run_subprocess_script
from repro_torch.configs import ARCH_IDS, cells, get_config, get_shape
from repro_torch.data import SyntheticLMDataset
from repro_torch.launch import dryrun as D
from repro_torch.launch import stepanalysis as SA
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from repro_torch.runtime import substrate
from repro_torch.train import trainer

MESHES = ("single", "multi")
CELLS = [(a, s, m) for a, s, _ in cells() for m in MESHES]

_CHILD = r"""
import json, types
import numpy as np
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro.launch import dryrun as D
from repro.launch.mesh import make_production_mesh
from repro.configs import ARCH_IDS, cells, get_config, get_shape

def name(dt):
    return jnp.dtype(dt).name

out = {"cells": {}, "arch": {}, "fit_spec": []}
meshes = {"single": make_production_mesh(),
          "multi": make_production_mesh(multi_pod=True)}
for a, s, _ in cells():
    train = get_shape(s).kind == "train"
    inputs = {k: [list(v.shape), name(v.dtype)]
              for k, v in D.input_specs(a, s).items()}
    flops = D.model_flops(a, s)
    for mk, mesh in meshes.items():
        an = (D.analytic_memory_train if train
              else D.analytic_memory_serve)(a, s, mesh)
        out["cells"][f"{a}|{s}|{mk}"] = {
            "inputs": inputs, "analytic": an, "model_flops": flops}
for a in ARCH_IDS:
    st = D.train_settings(a)
    if "grad_dtype" in st:
        st["grad_dtype"] = name(st["grad_dtype"])
    st["opt_kwargs"] = {k: name(v)
                        for k, v in st.get("opt_kwargs", {}).items()}
    out["arch"][a] = {"active": D.active_param_count(get_config(a)),
                      "settings": st}
mesh = types.SimpleNamespace(axis_names=("data", "model"),
                             devices=np.empty((4, 2)))
for spec, shape in json.loads('FIT_CASES'):
    spec = tuple(tuple(e) if isinstance(e, list) else e for e in spec)
    out["fit_spec"].append([D.fit_spec(P(*spec), tuple(shape), mesh)])
print(json.dumps(out, default=list))
"""

#: ``tests/test_launch.py``'s ``fit_spec`` cases and a few more
FIT_CASES = [
    [["data", "model"], [8, 6]], [["data", "model"], [1, 6]],
    [[["data", "model"]], [7]], [["data"], []],
    [[["pod", "data"], None, "model"], [8, 3, 4]],
    [[None, "model", None], [2, 5, 4]], [[["data", "model"]], [16]],
]


_CHILD_RUN = {}


def _start_reference():
    """Run the reference child on a thread, once: the traced steps below
    run in this process meanwhile."""
    if "thread" in _CHILD_RUN:
        return

    def run():
        code = _CHILD.replace("FIT_CASES", json.dumps(FIT_CASES))
        try:
            _CHILD_RUN["out"] = run_subprocess_script(code, devices=512,
                                                      timeout=900)
        except BaseException as e:      # a skip too: raised in the test
            _CHILD_RUN["error"] = e

    _CHILD_RUN["thread"] = threading.Thread(target=run, daemon=True)
    _CHILD_RUN["thread"].start()


@pytest.fixture(scope="module", autouse=True)
def _reference_started():
    _start_reference()


@functools.lru_cache(maxsize=None)
def _reference():
    _start_reference()
    _CHILD_RUN["thread"].join()
    if "error" in _CHILD_RUN:
        raise _CHILD_RUN["error"]
    return json.loads(_CHILD_RUN["out"].splitlines()[-1])


def _dtype(dt) -> str:
    return str(dt).removeprefix("torch.")


def _mesh(kind):
    return make_production_mesh(multi_pod=kind == "multi")


def _without_fit(an):
    return {k: v for k, v in an.items() if not k.startswith("fits")}


# ---------------------------------------------------------------------------
# The traced step against the real one
# ---------------------------------------------------------------------------

#: (arch, (data, model), optimizer): the reduced steps held to the byte
REAL = [("granite-34b", (2, 1), "adamw"), ("granite-34b", (2, 2), "adamw"),
        ("jamba-1.5-large-398b", (2, 2), "adafactor")]


@pytest.mark.parametrize("arch,shape,opt_name", REAL,
                         ids=[f"{a}-{d}x{m}" for a, (d, m), _ in REAL])
def test_traced_step_equals_real_rank(arch, shape, opt_name):
    data, m = shape
    cfg = get_config(arch, reduced=True)
    ds = SyntheticLMDataset(vocab_size=cfg.vocab_size, seq_len=16,
                            global_batch=8, seed=0)
    host = ds.host_batch(0)
    settings = {"optimizer": opt_name, "microbatches": 2}
    names = ("data", "model") if m > 1 else ("data",)
    sizes = (data, m) if m > 1 else (data,)
    meta = {k: torch.empty(v.shape, dtype=torch.from_numpy(v).dtype,
                           device="meta") for k, v in host.items()}
    cell = D.train_cell(cfg, meta, substrate.abstract_mesh(sizes, names),
                        settings=settings, variant={"sync": "composed"})
    dry = D.trace_cell(cell)

    real_cell = D.train_cell(
        cfg, meta, make_host_mesh(data, model_parallel=m, device="cpu"),
        settings=settings, variant={"sync": "composed"})
    model, opt = real_cell.model, real_cell.optimizer
    mesh = make_host_mesh(data, model_parallel=m, device="cpu")
    tcfg = real_cell.train_cfg
    params = trainer.with_model_parallel(model, 1).init(
        torch.Generator().manual_seed(0))
    states = trainer.init_states(model, opt, params, tcfg, mesh)
    (states, metrics), real = SA.measure_rank(
        real_cell.fn, states, {k: torch.from_numpy(v)
                               for k, v in host.items()})
    assert np.isfinite(float(metrics["loss"]))
    assert dry.flops > 0 and dry.wire_bytes > 0
    assert (dry.flops, dry.wire_bytes, dry.hbm_bytes, dry.peak_bytes) == (
        real.flops, real.wire_bytes, real.hbm_bytes, real.peak_bytes)
    assert dry.peak["params"] > 0 and dry.peak["opt_state"] > 0
    assert sum(c["wire_bytes"] for c in dry.collectives.values()) \
        == dry.wire_bytes
    assert dry.wire_bytes_dcn == 0 and dry.wire_bytes_ici == dry.wire_bytes
    assert dry.trip_counts == [st.repeat for st in cfg.stages]


def test_production_cell_traced_whole(tmp_path):
    r = D.run_cell("qwen2-vl-7b", "train_4k", "multi",
                   out_dir=str(tmp_path))
    assert r["ok"] and r["traced"], r.get("error")
    an = r["analysis"]
    assert an["flops"] > 0 and an["wire_bytes"] > 0
    assert an["wire_bytes_dcn"] > 0          # the sync crosses "pod"
    assert an["trip_counts"] == [28]
    assert 0 < r["memory"]["peak_per_device_traced"]
    saved = json.loads((tmp_path / "qwen2-vl-7b__train_4k__multi.json")
                       .read_text())
    assert saved["analysis"]["flops"] == an["flops"]


# ---------------------------------------------------------------------------
# The reference's arithmetic
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,shape,mesh_kind", CELLS,
                         ids=[f"{a}-{s}-{m}" for a, s, m in CELLS])
def test_cell_arithmetic_equals_reference(arch, shape, mesh_kind):
    ref = _reference()["cells"][f"{arch}|{shape}|{mesh_kind}"]
    inputs = {k: [list(v.shape), _dtype(v.dtype)]
              for k, v in D.input_specs(arch, shape).items()}
    assert inputs == ref["inputs"]
    assert all(v.is_meta for v in D.input_specs(arch, shape).values())
    mesh = _mesh(mesh_kind)
    train = get_shape(shape).kind == "train"
    an = (D.analytic_memory_train if train
          else D.analytic_memory_serve)(arch, shape, mesh)
    assert _without_fit(an) == _without_fit(ref["analytic"])
    assert an["fits_hbm"] == (an["total"] < D.HBM_PER_CHIP)
    assert D.model_flops(arch, shape) == ref["model_flops"]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_settings_and_active_params_equal_reference(arch):
    ref = _reference()["arch"][arch]
    assert D.active_param_count(get_config(arch)) == ref["active"]
    st = D.train_settings(arch)
    if "grad_dtype" in st:
        st["grad_dtype"] = _dtype(st["grad_dtype"])
    st["opt_kwargs"] = {k: _dtype(v)
                        for k, v in st.get("opt_kwargs", {}).items()}
    assert st == ref["settings"]


def test_fit_spec_equals_reference():
    mesh = substrate.abstract_mesh((4, 2), ("data", "model"))
    got = []
    for spec, shape in FIT_CASES:
        spec = tuple(tuple(e) if isinstance(e, list) else e for e in spec)
        got.append([json.loads(json.dumps(D.fit_spec(spec, tuple(shape),
                                                      mesh)))])
    assert got == _reference()["fit_spec"]
    assert D.fit_spec(("data", "model"), (1, 6), mesh) == (None, "model")


# ---------------------------------------------------------------------------
# Departures
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("variant", [v for v in D.VARIANTS
                                     if "puredp" in v or "seqflash" in v])
def test_refused_variants(variant, capsys):
    assert D.variant_refusal(variant)
    r = D.run_cell("granite-34b", "train_4k", "single",
                   variant_name=variant)
    assert not r["ok"] and "variant" in r["error"]
    with pytest.raises(SystemExit):
        D.main(["--arch", "granite-34b", "--shape", "train_4k",
                "--variant", variant])
    assert "not ported" in capsys.readouterr().err or "GSPMD" in \
        D.variant_refusal(variant)


def test_ported_variants_not_refused():
    for name in ("baseline", "composed", "bucketed", "compressed", "zero1",
                 "mb1", "mb2", "mb4", "remat_dots", "capacity_1x",
                 "block_k_256", "block_k_1024"):
        assert D.variant_refusal(name) is None, name


def test_serving_cells_are_analytic_with_a_reason(tmp_path):
    """A serving cell keeps the reference's analytic model beside its
    trace: one rank of the split decode step (no reason for leaving it
    untraced any more)."""
    r = D.run_cell("qwen2-72b", "decode_32k", "single",
                   out_dir=str(tmp_path))
    assert r["ok"] and r["traced"] is True, r.get("error")
    assert "reason" not in r
    assert r["memory"]["analytic_h100"]["cache"] > 0
    assert r["memory"]["peak_split_traced"]["caches"] > 0


def test_train_launcher_refuses_production_mesh(capsys):
    from repro_torch.launch import train as launch
    with pytest.raises(SystemExit):
        launch.main(["--production-mesh", "--device", "cpu"])
    assert "repro_torch.launch.dryrun" in capsys.readouterr().err


def test_production_meshes():
    single, multi = make_production_mesh(), make_production_mesh(
        multi_pod=True)
    assert single.abstract and multi.abstract
    assert single.shape == {"data": 16, "model": 16}
    assert multi.shape == {"pod": 2, "data": 16, "model": 16}
    assert make_host_mesh is substrate.make_host_mesh
