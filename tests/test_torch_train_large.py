"""The large archs trained with Adafactor, against the reference, on the
CPU.

- Reduced mistral-large-123b, nemotron-4-340b, jamba-1.5-large-398b and
  deepseek-v3-671b (its MTP loss included), the archs the reference
  trains with Adafactor (``repro.launch.dryrun``): 3 steps of composed
  data-parallel training on 4 thread ranks, each step taken from the
  reference trainer's state before it (its checkpoint-layout tree,
  scattered onto the ranks) on the reference's batch.  Each step's loss
  is within 1e-4 and its gradient norm within 1e-5 relative of the
  reference's (the packages sum in other orders), and the state after
  it, gathered, is the reference's next state leaf by leaf: Adafactor's
  statistics (squares of gradients that agree to 1e-4) within 2e-4 of
  the largest value, each param within 1e-5 of its largest value plus
  1e-3 of the step's largest change of it.  The second term is for the
  update of a zero-initialised leaf (a Mamba ``conv_b``): Adafactor
  divides each gradient by its own RMS (eps 1e-30), so a gradient
  element near zero whose last digits differ moves by a visibly other
  step; a wrong statistic, normaliser or clip moves it by O(1) of the
  step.
  ``min_dim_factored`` is 32 on both sides, so that the reduced widths
  (64 to 296) take both of Adafactor's branches.  The replicas are
  bit-identical after every step.

  Each step starts from the reference's state, not from the port's
  last one, because the trajectories are chaotic where it matters: on
  jamba's reduced model the states after one step agree to 3e-5, yet
  the free-running step-3 losses part by 1.003e-4, since one rank's
  rows sit at a MoE routing near tie (the reference's own model gives
  the port's loss on the port's state).
- ``python -m repro_torch.launch.train --optimizer adafactor`` trains a
  reduced arch, data-parallel and on (data 2, model 2); an unknown
  ``--optimizer`` is refused.

The reference's runs come from one child interpreter with 4 host
devices (``run_reference``, shared with ``test_torch_adafactor.py``).
"""

import json

import numpy as np
import pytest
import torch

from conftest import run_subprocess_script
from repro_torch.configs import get_config
from repro_torch.data import SyntheticLMDataset
from repro_torch.launch import train as launch_train
from repro_torch.launch.train import build_session
from repro_torch.models import build_model
from repro_torch.models.convert import params_from_numpy
from repro_torch.optim import cosine_schedule, make_optimizer
from repro_torch.runtime import substrate
from repro_torch.train import trainer
from repro_torch.tree import flatten, leaves, map_tree, unflatten

STEPS, SEQ, BATCH, RANKS = 3, 32, 8, 4
MIN_DIM_FACTORED = 32
LOSS_RTOL, NORM_RTOL = 1e-4, 1e-5
PARAM_RTOL, UPDATE_RTOL, STAT_RTOL = 1e-5, 1e-3, 2e-4
ARCHS = ("mistral-large-123b", "nemotron-4-340b", "jamba-1.5-large-398b",
         "deepseek-v3-671b")

REFERENCE_CHILD = """
import json, types
import jax, numpy as np
from repro.configs import get_config
from repro.data import SyntheticLMDataset
from repro.launch import train as lt
from repro.launch.mesh import make_host_mesh
from repro.models import build_model
from repro.optim import cosine_schedule, make_optimizer
from repro.parallel.sharding import named_shardings
from repro.runtime import substrate
from repro.train import trainer
STEPS, SEQ, BATCH = {steps}, {seq}, {batch}
out = {{}}
for arch, shape in {runs}:
    cfg = get_config(arch, reduced=True)
    model = build_model(cfg)
    zero = shape in ("zero", "zero2x2")
    mesh = (make_host_mesh(model_parallel=2) if shape.endswith("2x2") else
            substrate.make_mesh(({ranks},), ("data",)) if zero else
            make_host_mesh(model_parallel=1))
    opt = make_optimizer("adafactor", lr=cosine_schedule(
        1e-3, warmup=max(STEPS // 20, 1), total=STEPS),
        min_dim_factored={min_dim})
    ds = SyntheticLMDataset(vocab_size=cfg.vocab_size, seq_len=SEQ,
                            global_batch=BATCH)
    params = model.init(jax.random.PRNGKey(0))
    np.savez({path!r} + "_" + arch + ".npz", **{{
        "/".join(str(k.key) for k in p): np.asarray(v)
        for p, v in jax.tree_util.tree_flatten_with_path(params)[0]}})
    args = types.SimpleNamespace(
        microbatches=1, sync="composed", bucket_grads=False,
        bucket_bytes=32 << 20, overlap=False, overlap_depth=2, zero=zero)
    sess = lt.build_session(mesh, model, opt, ds, args)
    tcfg = trainer.TrainCfg(sync_mode="composed", zero=zero,
                            **({{"data_axes": ("data",)}} if zero else {{}}))
    step_fn = jax.jit(trainer.make_train_step(model, opt, tcfg, mesh=mesh,
                                              comm=sess.world))
    sspecs = trainer.state_specs(model, opt, tcfg, mesh=mesh)
    with substrate.set_mesh(mesh):
        state = trainer.make_train_state(model, opt, jax.random.PRNGKey(0),
                                         cfg=tcfg, mesh=mesh)
        state = jax.device_put(state, named_shardings(mesh, sspecs))
        losses, norms = [], []
        for step in range(STEPS + 1):
            if shape == "dp":
                np.savez({path!r} + f"_{{arch}}_state{{step}}.npz", **{{
                    "/".join(str(getattr(k, "key", k)) for k in p):
                    np.asarray(v) for p, v in
                    jax.tree_util.tree_flatten_with_path(state)[0]}})
            if step == STEPS:
                break
            state, m = step_fn(state, ds.sharded_batch(step, mesh))
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
    out[arch + "/" + shape] = {{"loss": losses, "grad_norm": norms}}
print("RUNS", json.dumps(out))
"""


def run_reference(tmp_path_factory, runs):
    """The reference's Adafactor runs ``runs`` ((arch, shape) with shape
    "dp": composed on 4 data ranks, "zero": ZeRO-1 on 4 data ranks,
    "2x2": composed on (data 2, model 2), "zero2x2": ZeRO-1 on (data 2,
    model 2), its shard_map manual over "data" only), STEPS steps each
    from its
    initial weights: ({"arch/shape": {"loss", "grad_norm"}}, {arch:
    initial weights as a numpy tree}, the path prefix of the "dp" runs'
    states before each step and after the last,
    ``f"{prefix}_{arch}_state{step}.npz"``)."""
    path = str(tmp_path_factory.mktemp("ref") / "weights")
    out = run_subprocess_script(REFERENCE_CHILD.format(
        steps=STEPS, seq=SEQ, batch=BATCH, ranks=RANKS, runs=list(runs),
        min_dim=MIN_DIM_FACTORED, path=path), devices=RANKS, timeout=600)
    line = next(l for l in out.splitlines() if l.startswith("RUNS "))
    trees = {}
    for arch in {a for a, _ in runs}:
        w = np.load(f"{path}_{arch}.npz")
        trees[arch] = unflatten([tuple(k.split("/")) for k in w.files],
                                [w[k] for k in w.files])
    return json.loads(line[len("RUNS "):]), trees, path


def adafactor(**kw):
    return make_optimizer("adafactor", lr=cosine_schedule(
        1e-3, warmup=max(STEPS // 20, 1), total=STEPS),
        min_dim_factored=MIN_DIM_FACTORED, **kw)


def rel_err(got, want) -> float:
    want = np.asarray(want, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - want).max()
                 / max(np.abs(want).max(), 1e-30))


def train(arch, tree, mesh, check=None, **cfg_kw):
    """STEPS steps of ``arch`` from the reference's weights ``tree`` on
    ``mesh``, composed, with Adafactor; ``check(states, step)`` after
    every step.  Returns (losses, gradient norms)."""
    cfg = get_config(arch, reduced=True)
    model = build_model(cfg, model_parallel=dict(mesh.shape).get("model",
                                                                 1))
    opt = adafactor()
    ds = SyntheticLMDataset(vocab_size=cfg.vocab_size, seq_len=SEQ,
                            global_batch=BATCH)
    tcfg = trainer.TrainCfg(**cfg_kw)
    sess = build_session(mesh, model, opt, ds, tcfg)
    states = trainer.init_states(model, opt,
                                 params_from_numpy(tree, cfg, device="cpu"),
                                 tcfg, mesh)
    step_fn = trainer.make_train_step(model, opt, tcfg, comm=sess.world)
    losses, norms = [], []
    for step in range(STEPS):
        states, metrics = step_fn(states, ds.host_batch(step))
        losses.append(metrics["loss"].item())
        norms.append(metrics["grad_norm"].item())
        if check is not None:
            check(states, step)
    return losses, norms


@pytest.fixture(scope="module")
def reference_run(tmp_path_factory):
    return run_reference(tmp_path_factory, [(a, "dp") for a in ARCHS])


def replicas_identical(states, step):
    for st in states[1:]:
        for a, b in zip(leaves([states[0]["params"], states[0]["opt"]]),
                        leaves([st["params"], st["opt"]])):
            assert torch.equal(a, b), f"replicas differ at step {step}"


def _reference_state(prefix, arch, step, cfg):
    """The reference trainer's state before ``step`` as the port's
    checkpoint-layout tree (the same paths and shapes)."""
    z = np.load(f"{prefix}_{arch}_state{step}.npz")
    tree = unflatten([tuple(k.split("/")) for k in z.files],
                     [torch.from_numpy(np.array(z[k])) for k in z.files])
    tree["params"] = params_from_numpy(
        map_tree(lambda t: t.numpy(), tree["params"]), cfg, device="cpu")
    return tree


def _flat(tree):
    ls, paths = flatten(tree)
    return ls, ["/".join(p) for p in paths]


@pytest.mark.parametrize("arch", ARCHS)
def test_adafactor_training_matches_reference(reference_run, arch):
    ref, _, prefix = reference_run
    want = ref[f"{arch}/dp"]
    cfg = get_config(arch, reduced=True)
    model = build_model(cfg)
    opt = adafactor()
    ds = SyntheticLMDataset(vocab_size=cfg.vocab_size, seq_len=SEQ,
                            global_batch=BATCH)
    tcfg = trainer.TrainCfg()
    mesh = substrate.make_host_mesh(RANKS, device="cpu")
    step_fn = trainer.make_train_step(model, opt, tcfg, comm=build_session(
        mesh, model, opt, ds, tcfg).world)
    losses, norms = [], []
    for step in range(STEPS):
        states = trainer.scatter_state(
            _reference_state(prefix, arch, step, cfg), tcfg, mesh, model)
        states, metrics = step_fn(states, ds.host_batch(step))
        replicas_identical(states, step)
        losses.append(metrics["loss"].item())
        norms.append(metrics["grad_norm"].item())
        got = trainer.gather_state(states, tcfg, mesh, model)
        prev = _reference_state(prefix, arch, step, cfg)
        nxt = _reference_state(prefix, arch, step + 1, cfg)
        assert _flat(got)[1] == _flat(nxt)[1]
        for path, a, b, c in zip(_flat(got)[1], leaves(got), leaves(nxt),
                                 leaves(prev)):
            if not a.is_floating_point():
                assert torch.equal(a, b), (step, path)
                continue
            a, b, c = (x.float().numpy() for x in (a, b, c))
            err = np.abs(a - b).max()
            if path.startswith("opt/f/"):
                assert err <= STAT_RTOL * np.abs(b).max(), (step, path, err)
            else:
                assert err <= PARAM_RTOL * np.abs(b).max() + (
                    UPDATE_RTOL * np.abs(b - c).max()), (step, path, err)
    assert rel_err(losses, want["loss"]) <= LOSS_RTOL, (losses, want)
    assert rel_err(norms, want["grad_norm"]) <= NORM_RTOL, (norms, want)


@pytest.mark.parametrize("extra", [[], ["--model-parallel", "2"]],
                         ids=["data", "data_x_model"])
def test_train_cli_runs_adafactor(extra, caplog):
    caplog.set_level("INFO")
    launch_train.main(["--device", "cpu", "--arch", "mistral-large-123b",
                       "--reduced", "--optimizer", "adafactor", "--data",
                       "2", "--steps", "2", "--seq-len", "16",
                       "--global-batch", "4", "--log-every", "1"] + extra)
    assert "step    1  loss" in caplog.text


def test_train_cli_refuses_an_unknown_optimizer(capsys):
    with pytest.raises(SystemExit):
        launch_train.main(["--device", "cpu", "--optimizer", "lion",
                           "--steps", "1"])
    assert "--optimizer" in capsys.readouterr().err
    with pytest.raises(ValueError, match="unknown optimizer 'lion'"):
        make_optimizer("lion")
