"""The ``auto`` step's split over "data" (the reference's FSDP layout:
params, gradient accumulator and optimizer state split over "data" as
its specs say) on the CPU, against the reference.

- ``sharding.data_split`` of every leaf of every reduced arch equals the
  "data" entry of the reference's ``model.param_specs()`` after its
  ``fit_spec``, at data 2 and at data 3 (which divides no width of
  most reduced configs: those leaves stay whole), and so do the AdamW
  moments' and the Adafactor statistics' (``opt_data_leaf``) against
  the reference optimizer's ``state_specs``.
- Rank (d, j)'s param blocks of reduced qwen2-72b (whose model split is
  the reference's leaf for leaf) equal, bit for bit, the reference's
  ``addressable_shards`` on device (d, j) of its ``auto`` state on a
  (2, 2) host mesh; the dry-run's traced params and optimizer bytes of
  rank 0 at (2, 2) are those shards' bytes.
- 3 steps of ``auto`` on (data 2, model 2) for one reduced arch a family
  (dense GQA, MoE, MLA with MTP, Mamba, embeddings input, the enc-dec;
  Adafactor on two, 2 microbatches on two) and on (pod 2, data 2): f32
  losses within ``LOSS_RTOL`` = 1e-4 and gradient norms within
  ``NORM_RTOL`` = 1e-5 of the reference's ``auto`` runs on the same
  meshes, from its weights and batches; each rank holds its blocks, and
  the blocks every model rank holds whole stay equal across "model".
- Remat off gives remat on's loss and gradients, bit for bit.
- ``trainer._accumulate_grads`` adds and scales in place with the old
  list formula's bits (written here as the oracle), in f32 and bf16,
  and holds one gradient copy fewer at its peak.
- The dry-run of the split step at (2, 2) traces the flops, wire bytes,
  charged bytes and peak of a real CPU rank, to the byte.

The reference's runs come from one child interpreter with 4 host
devices (about 95 s on the CPU).
"""

import dataclasses
import json
import threading
import types

import numpy as np
import pytest
import torch

from conftest import run_subprocess_script
from test_torch_train_embeds import host_batch as embeds_batch
from repro_torch.comm import Session
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.data import SyntheticLMDataset
from repro_torch.launch import dryrun as D
from repro_torch.launch import stepanalysis as SA
from repro_torch.models import build_model
from repro_torch.models.convert import params_from_numpy
from repro_torch.optim import cosine_schedule, make_optimizer
from repro_torch.parallel import sharding
from repro_torch.runtime import substrate
from repro_torch.train import trainer
from repro_torch.tree import flatten, leaves, unflatten

STEPS, SEQ, BATCH = 3, 32, 8
LOSS_RTOL, NORM_RTOL = 1e-4, 1e-5
#: Adafactor factors the reduced widths (64) too
ADAFACTOR = {"min_dim_factored": 32}
#: (arch, optimizer, microbatches, mesh): one reduced arch a family on
#: (data 2, model 2), and the pod run
RUNS = [("qwen2-72b", "adamw", 1, "2x2"),
        ("qwen3-moe-30b-a3b", "adamw", 2, "2x2"),
        ("deepseek-v3-671b", "adafactor", 1, "2x2"),
        ("jamba-1.5-large-398b", "adafactor", 1, "2x2"),
        ("qwen2-vl-7b", "adamw", 2, "2x2"),
        ("seamless-m4t-large-v2", "adamw", 1, "2x2"),
        ("granite-34b", "adamw", 1, "pod")]
SHARDS_ARCH = "qwen2-72b"


def _rel_err(got, want) -> float:
    want = np.asarray(want, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - want).max()
                 / max(np.abs(want).max(), 1e-30))


def _host_batch(arch, cfg, step):
    """The numpy batch both packages train ``arch`` on at ``step``."""
    if arch in ("qwen2-vl-7b", "seamless-m4t-large-v2"):
        return embeds_batch(arch, cfg, step, b=BATCH, s=SEQ)
    return SyntheticLMDataset(vocab_size=cfg.vocab_size, seq_len=SEQ,
                              global_batch=BATCH).host_batch(step)


def _optimizer(name):
    return make_optimizer(name, lr=cosine_schedule(1e-3, warmup=1,
                                                   total=STEPS),
                          **(ADAFACTOR if name == "adafactor" else {}))


# ---------------------------------------------------------------------------
# The layout against the reference's specs
# ---------------------------------------------------------------------------

def _ref_data_dims(arch, data, opt_name=None):
    """{state path: the dim (negative) of the leaf the reference's
    ``fit_spec`` keeps "data" on, or None}, for the params (and, given
    ``opt_name``, that optimizer's state) of reduced ``arch``."""
    import jax
    from repro.configs import get_config as ref_config
    from repro.launch.dryrun import fit_spec
    from repro.models import build_model as ref_model
    from repro.optim import make_optimizer as ref_opt
    from jax.sharding import PartitionSpec as P
    mesh = types.SimpleNamespace(axis_names=("data", "model"),
                                 devices=np.empty((data, 2)))
    model = ref_model(ref_config(arch, reduced=True))
    specs, shapes = model.param_specs(), model.abstract_params()
    tree = {"params": (specs, shapes)}
    if opt_name is not None:
        opt = ref_opt(opt_name, **(ADAFACTOR if opt_name == "adafactor"
                                   else {}))
        tree["opt"] = (opt.state_specs(specs, shapes),
                       jax.eval_shape(opt.init, shapes))
    out = {}
    for top, (sp, sh) in tree.items():
        pairs = jax.tree_util.tree_flatten_with_path(
            sp, is_leaf=lambda s: isinstance(s, P))[0]
        shaped = dict((tuple(str(k.key) for k in p), l) for p, l in
                      jax.tree_util.tree_flatten_with_path(sh)[0])
        for p, spec in pairs:
            path = tuple(str(k.key) for k in p)
            fit = fit_spec(spec, shaped[path].shape, mesh)
            dims = [i - len(shaped[path].shape) for i, e in enumerate(fit)
                    if e == "data"]
            out[(top,) + path] = dims[0] if dims else None
    return out


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_data_split_equals_the_references_specs(arch):
    cfg = get_config(arch, reduced=True)
    whole = build_model(cfg)
    opt_name = "adafactor" if arch in ("deepseek-v3-671b",
                                       "mistral-large-123b") else "adamw"
    opt = make_optimizer(opt_name,
                         **(ADAFACTOR if opt_name == "adafactor" else {}))
    state = trainer.make_train_state(whole, opt, whole.abstract_params())
    for data in (2, 3):
        want = {p: d for p, d in _ref_data_dims(arch, data,
                                                opt_name).items()
                if p[-1] != "step"}
        got = dict(zip(flatten(state)[1],
                       trainer._state_data_dims(whole, data, state)))
        got = {p: d for p, d in got.items() if p[-1] != "step"}
        assert set(got) == set(want), set(got) ^ set(want)
        for path, d in want.items():
            assert got[path] == d, (data, path, got[path], d)
        if data == 2:
            assert any(d is not None for d in got.values())
    # the model split's block keeps the data dims of the whole leaf
    lay = sharding.layout(cfg, 2)
    for path, leaf in zip(flatten(whole.abstract_params())[1],
                          leaves(whole.abstract_params())):
        d = sharding.data_split(("params",) + path, None, 2, leaf.shape)
        block = sharding.leaf_block(path, leaf, lay, 0)
        assert sharding.data_split(("params",) + path, lay, 2,
                                   block.shape) == d, path
        assert d is None or d != sharding.leaf_split(path, lay), path


# ---------------------------------------------------------------------------
# Remat and the accumulation (while the reference child runs)
# ---------------------------------------------------------------------------

def _one_step_grads(arch, remat, model_parallel=1, micro=1):
    """Loss and each rank's gradient blocks of one split step of reduced
    ``arch`` on (data 2, ``model_parallel``)."""
    cfg = dataclasses.replace(get_config(arch, reduced=True), remat=remat)
    model = build_model(cfg, model_parallel=model_parallel)
    mesh = substrate.make_host_mesh(2, model_parallel=model_parallel,
                                    device="cpu")
    tcfg = trainer.TrainCfg(sync_mode="auto", microbatches=micro)
    opt = make_optimizer("adamw")
    states = trainer.init_states(
        model, opt, build_model(cfg).init(torch.Generator().manual_seed(0)),
        tcfg, mesh)
    da = trainer._data_axis(model, tcfg, mesh, None)
    rows = trainer.shard_batch(_host_batch(arch, cfg, 0), mesh, ("data",))

    def rank(st, b):
        return trainer._accumulate_grads(model, st["params"], b, micro,
                                         torch.float32, da.dims)

    return substrate.run_spmd(rank, [(states[r], rows[r])
                                     for r in range(mesh.size)], mesh)


@pytest.mark.parametrize("arch,m", [("granite-34b", 1),
                                    ("jamba-1.5-large-398b", 1),
                                    ("deepseek-v3-671b", 2),
                                    ("seamless-m4t-large-v2", 1)])
def test_remat_off_gives_remat_on_bits(arch, m):
    on = _one_step_grads(arch, True, m)
    off = _one_step_grads(arch, False, m)
    for (l1, g1), (l2, g2) in zip(on, off):
        assert torch.equal(l1, l2)
        for path, a, b in zip(flatten(g1)[1], leaves(g1), leaves(g2)):
            assert sharding.bits_equal(a, b), path


def _old_accumulate(model, params, batch, n_micro, grad_dtype):
    """The accumulation as it was written before it ran in place: a new
    list a microbatch, and the scaled sum another."""
    ps, paths = flatten(params)
    acc = [torch.zeros(p.shape, dtype=grad_dtype, device=p.device)
           for p in ps]
    loss_sum = None
    for mb in trainer._split_micro(batch, n_micro):
        loss, grads = model.loss_and_grads(params, mb)
        acc = [a + g.to(grad_dtype) for a, g in zip(acc, leaves(grads))]
        loss_sum = loss if loss_sum is None else loss_sum + loss
    inv = 1.0 / n_micro
    return loss_sum * inv, unflatten(paths, [g * inv for g in acc])


@pytest.mark.parametrize("grad_dtype", [torch.float32, torch.bfloat16])
def test_inplace_accumulation_keeps_the_old_bits(grad_dtype):
    cfg = get_config("granite-34b", reduced=True)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(2))
    batch = {k: torch.from_numpy(v) for k, v in _host_batch(
        "granite-34b", cfg, 1).items()}
    peaks = []
    for fn in (_old_accumulate, trainer._accumulate_grads):
        meter = SA.LiveBytes()
        with meter:
            meter.hold(params, "params")
            loss, grads = fn(model, params, batch, 4, grad_dtype)
        peaks.append((meter.peak, loss, grads))
    (old_peak, old_loss, old), (new_peak, new_loss, new) = peaks
    assert sharding.bits_equal(old_loss, new_loss)
    for a, b in zip(leaves(old), leaves(new)):
        assert sharding.bits_equal(a, b)
    grad_bytes = sum(g.numel() * g.element_size() for g in leaves(new))
    assert new_peak <= old_peak - grad_bytes, (old_peak, new_peak,
                                               grad_bytes)


# ---------------------------------------------------------------------------
# The reference's runs
# ---------------------------------------------------------------------------

REFERENCE_CHILD = """
import json, os
# the child's time is XLA's compiles of the steps: the backend's lower
# optimization level makes them faster
os.environ["XLA_FLAGS"] += (" --xla_backend_optimization_level=0"
                            " --xla_llvm_disable_expensive_passes=true")
import jax, numpy as np
from jax.sharding import NamedSharding
from repro.configs import get_config
from repro.launch.mesh import make_host_mesh
from repro.models import build_model
from repro.optim import cosine_schedule, make_optimizer
from repro.parallel.sharding import filter_spec, fitted_shardings
from repro.runtime import substrate
from repro.train import trainer
STEPS = {steps}
out = {{}}
for arch, opt_name, micro, shape in {runs}:
    cfg = get_config(arch, reduced=True)
    model = build_model(cfg)
    mesh = (make_host_mesh(model_parallel=2) if shape == "2x2"
            else make_host_mesh(model_parallel=1, pods=2))
    opt = make_optimizer(opt_name, lr=cosine_schedule(
        1e-3, warmup=1, total=STEPS),
        **({adafactor!r} if opt_name == "adafactor" else {{}}))
    params = model.init(jax.random.PRNGKey(0))
    np.savez({path!r} + "_" + arch + ".npz", **{{
        "/".join(str(k.key) for k in p): np.asarray(v)
        for p, v in jax.tree_util.tree_flatten_with_path(params)[0]}})
    tcfg = trainer.TrainCfg(microbatches=micro, sync_mode="auto")
    step_fn = jax.jit(trainer.make_train_step(model, opt, tcfg, mesh=mesh))
    sspecs = trainer.state_specs(model, opt, tcfg, mesh=mesh)
    with substrate.set_mesh(mesh):
        state = trainer.make_train_state(model, opt, jax.random.PRNGKey(0),
                                         cfg=tcfg, mesh=mesh)
        state = jax.device_put(state, fitted_shardings(mesh, sspecs, state))
        if arch == {shards_arch!r}:
            devs = mesh.devices
            shards, nbytes = {{}}, {{}}
            for top in ("params", "opt"):
                for p, l in jax.tree_util.tree_flatten_with_path(
                        state[top])[0]:
                    name = "/".join(str(k.key) for k in p)
                    for s in l.addressable_shards:
                        d, j = (int(v) for v in np.argwhere(
                            devs == s.device)[0])
                        key = f"{{d}}/{{j}}"
                        nbytes[top + "@" + key] = nbytes.get(
                            top + "@" + key, 0) + s.data.nbytes
                        if top == "params":
                            shards[key + "/" + name] = np.asarray(s.data)
            np.savez({path!r} + "_shards.npz", **shards)
            out["shard_bytes"] = nbytes
        losses, norms = [], []
        for step in range(STEPS):
            b = dict(np.load({path!r} + f"_{{arch}}_batch{{step}}.npz"))
            specs = trainer.batch_specs(b)
            gb = {{k: jax.make_array_from_callback(
                v.shape, NamedSharding(mesh, filter_spec(
                    specs[k], mesh.axis_names)), lambda idx, v=v: v[idx])
                for k, v in b.items()}}
            state, m = step_fn(state, gb)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
    out[arch] = {{"loss": losses, "grad_norm": norms}}
print("RUNS", json.dumps(out))
"""


_CHILD_RUN = {}


@pytest.fixture(scope="module", autouse=True)
def _reference_started(tmp_path_factory):
    """Start the reference child on a thread, once: the tests that do
    not need it run in this process meanwhile."""
    if "thread" in _CHILD_RUN:
        return
    path = str(tmp_path_factory.mktemp("ref") / "run")
    for arch, *_ in RUNS:
        cfg = get_config(arch, reduced=True)
        for step in range(STEPS):
            np.savez(f"{path}_{arch}_batch{step}.npz",
                     **_host_batch(arch, cfg, step))
    code = REFERENCE_CHILD.format(steps=STEPS, runs=RUNS, path=path,
                                  adafactor=ADAFACTOR,
                                  shards_arch=SHARDS_ARCH)

    def run():
        try:
            _CHILD_RUN["out"] = run_subprocess_script(code, devices=4,
                                                      timeout=600)
        except BaseException as e:      # a skip too: raised in the test
            _CHILD_RUN["error"] = e

    _CHILD_RUN["path"] = path
    _CHILD_RUN["thread"] = threading.Thread(target=run, daemon=True)
    _CHILD_RUN["thread"].start()


@pytest.fixture(scope="module")
def reference_run():
    """({arch: {"loss", "grad_norm"}, "shard_bytes": ...}, {arch:
    initial weights}, the qwen2-72b shards by "d/j/path")."""
    _CHILD_RUN["thread"].join()
    if "error" in _CHILD_RUN:
        raise _CHILD_RUN["error"]
    out, path = _CHILD_RUN["out"], _CHILD_RUN["path"]
    line = next(l for l in out.splitlines() if l.startswith("RUNS "))
    trees = {}
    for arch, *_ in RUNS:
        w = np.load(f"{path}_{arch}.npz")
        trees[arch] = unflatten([tuple(k.split("/")) for k in w.files],
                                [w[k] for k in w.files])
    return (json.loads(line[len("RUNS "):]), trees,
            dict(np.load(f"{path}_shards.npz")))


def _mesh(shape):
    if shape == "pod":
        return substrate.make_host_mesh(2, pods=2, device="cpu")
    return substrate.make_host_mesh(2, model_parallel=2, device="cpu")


def _setup(arch, opt_name, micro, shape, tree, **cfg_kw):
    cfg = get_config(arch, reduced=True)
    if "remat" in cfg_kw:
        cfg = dataclasses.replace(cfg, remat=cfg_kw.pop("remat"))
    mesh = _mesh(shape)
    model = build_model(cfg, model_parallel=dict(mesh.shape).get("model",
                                                                 1))
    opt = _optimizer(opt_name)
    tcfg = trainer.TrainCfg(sync_mode="auto", microbatches=micro, **cfg_kw)
    states = trainer.init_states(model, opt,
                                 params_from_numpy(tree, cfg, device="cpu"),
                                 tcfg, mesh)
    step_fn = trainer.make_train_step(
        model, opt, tcfg, comm=Session(mesh=mesh, mode="monolithic").world)
    return cfg, mesh, model, tcfg, states, step_fn


def test_blocks_equal_the_references_shards_at_init(reference_run):
    _, trees, shards = reference_run
    cfg, mesh, model, tcfg, states, _ = _setup(
        SHARDS_ARCH, "adamw", 1, "2x2", trees[SHARDS_ARCH])
    split = 0
    for r, st in enumerate(states):
        c = mesh.coords(r)
        ps, paths = flatten(st["params"])
        for path, p in zip(paths, ps):
            want = shards[f"{c['data']}/{c['model']}/{'/'.join(path)}"]
            assert tuple(p.shape) == want.shape, path
            assert torch.equal(p, torch.from_numpy(np.array(want))), path
            split += sharding.data_split(("params",) + path, model.layout,
                                         2, want.shape) is not None
    assert split > 0
    # each model coordinate's data blocks join back into its model block
    full = params_from_numpy(trees[SHARDS_ARCH], cfg, device="cpu")
    dims = trainer._state_data_dims(model, 2, {"params": full})
    for j in range(2):
        ranks = [r for r in range(mesh.size) if mesh.coords(r)["model"] == j]
        per = [leaves(states[r]["params"]) for r in ranks]
        for i, (path, whole) in enumerate(zip(*flatten(full)[::-1])):
            got = sharding.join_data([p[i] for p in per], dims[i])
            assert torch.equal(got, sharding.leaf_block(
                path, whole, model.layout, j)), path


@pytest.mark.parametrize("arch,opt_name,micro,shape", RUNS,
                         ids=[f"{a}-{s}" for a, _, _, s in RUNS])
def test_auto_matches_the_references_auto(reference_run, arch, opt_name,
                                          micro, shape):
    ref, trees, _ = reference_run
    cfg, mesh, model, tcfg, states, step_fn = _setup(
        arch, opt_name, micro, shape, trees[arch],
        check_model_replicas=shape == "2x2")
    whole = trainer.make_train_state(model, _optimizer(opt_name),
                                     model.abstract_params(), tcfg)
    held = sum(l.numel() for l in leaves(states[0]))
    assert held < sum(l.numel() for l in leaves(whole))
    losses, norms = [], []
    for step in range(STEPS):
        states, metrics = step_fn(states, _host_batch(arch, cfg, step))
        losses.append(metrics["loss"].item())
        norms.append(metrics["grad_norm"].item())
        _check_blocks(mesh, model, states)
    want = ref[arch]
    assert _rel_err(losses, want["loss"]) <= LOSS_RTOL, (losses, want)
    assert _rel_err(norms, want["grad_norm"]) <= NORM_RTOL, (norms, want)


def _check_blocks(mesh, model, states):
    """Ranks of one (data, model) coordinate (the pods) hold the same
    state, and a leaf every model rank holds whole is the same across
    "model" on each data coordinate."""
    paths = flatten(states[0]["params"])[1]
    for r, st in enumerate(states):
        c = mesh.coords(r)
        for q in range(r):
            cq = mesh.coords(q)
            if all(cq.get(a) == c.get(a) for a in ("data", "model")):
                for a, b in zip(leaves(states[q]), leaves(st)):
                    assert torch.equal(a, b), (q, r)
            elif (cq.get("data") == c.get("data")
                  and model.layout is not None):
                for path, a, b in zip(paths, leaves(states[q]["params"]),
                                      leaves(st["params"])):
                    if sharding.leaf_split(path, model.layout) is None:
                        assert torch.equal(a, b), (q, r, path)


def test_dryrun_traces_the_split_step_of_a_real_rank(reference_run):
    """Flops, wire bytes, charged bytes and the peak of the split step
    at (2, 2) equal a real CPU rank's; its params and optimizer bytes
    are the reference's shards' on device (0, 0)."""
    ref = reference_run[0]
    cfg = get_config(SHARDS_ARCH, reduced=True)
    host = _host_batch(SHARDS_ARCH, cfg, 0)
    meta = {k: torch.empty(v.shape, dtype=torch.from_numpy(v).dtype,
                           device="meta") for k, v in host.items()}
    settings = {"optimizer": "adamw", "microbatches": 2}
    cell = D.train_cell(cfg, meta, substrate.abstract_mesh(
        (2, 2), ("data", "model")), settings=settings)
    assert cell.meta["sync"] == "auto"
    dry = D.trace_cell(cell)
    mesh = substrate.make_host_mesh(2, model_parallel=2, device="cpu")
    real_cell = D.train_cell(cfg, meta, mesh, settings=settings)
    states = trainer.init_states(
        real_cell.model, real_cell.optimizer, build_model(cfg).init(
            torch.Generator().manual_seed(0)), real_cell.train_cfg, mesh)
    (states, metrics), real = SA.measure_rank(
        real_cell.fn, states, {k: torch.from_numpy(v)
                               for k, v in host.items()})
    assert np.isfinite(float(metrics["loss"]))
    assert (dry.flops, dry.wire_bytes, dry.hbm_bytes, dry.peak_bytes) == (
        real.flops, real.wire_bytes, real.hbm_bytes, real.peak_bytes)
    calls = dry.collectives
    assert calls["all_gather"]["count"] > 0
    assert calls["reduce_scatter"]["count"] > 0
    nbytes = ref["shard_bytes"]
    assert dry.peak["params"] == nbytes["params@0/0"]
    assert dry.peak["opt_state"] == nbytes["opt@0/0"]
