"""The port's training slice against the reference, on the CPU.

- AdamW on the same gradients: params and moments within 1e-6
  relative (both update in f32 in the same order; the learning-rate
  schedule and the bias corrections round the same way).
- ``SyntheticLMDataset.host_batch``: byte-identical.
- The training attention (the recompute-backward flash attention) over
  several key blocks with a ragged last block, MQA and GQA: output and
  input gradients within 1e-5 (f32) and 2**-6 (bf16) of the largest
  value of the reference's ``flash_attention_jnp``.
- Reduced granite-34b and qwen2-72b, f32: loss and every gradient leaf
  within 1e-5 of the largest value of the reference's (the packages sum
  in different orders).  Their ``block_k`` is 16, so SEQ 32 runs the
  attention over two key blocks.
- 8 steps of data-parallel training on 4 ranks, ``--sync auto``,
  ``composed`` and ``compressed``, from the reference's own initial
  weights: losses within 1e-4 (auto, composed) and 1e-3 (compressed)
  relative; the int8 ring can round a code the other way after a 1e-7
  difference in a gradient.  ``auto`` is the reference's
  compiler-inserted sync (GSPMD over the global batch) against the
  port's: each rank's data block of every leaf the reference's specs
  split over "data", its gradient reduce-scattered into the block, the
  other leaves averaged by ``pmean`` through the monolithic default
  session: the same mean, summed in another order.
  Replicas (auto: of the leaves every rank holds whole) are
  bit-identical across ranks after every step.
  The reference's losses come from one child interpreter with 4 host
  devices that runs both modes from the same weights.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import run_subprocess_script
from repro.configs import get_config as jget_config
from repro.data import SyntheticLMDataset as JDataset
from repro.models import build_model as jbuild_model
from repro.models.layers import flash_attention_jnp
from repro.optim import cosine_schedule as jcosine
from repro.optim import make_optimizer as jmake_optimizer
from repro_torch.comm import Session
from repro_torch.configs import get_config
from repro_torch.data import SyntheticLMDataset
from repro_torch.launch import train as launch_train
from repro_torch.launch.train import build_session
from repro_torch.models import build_model
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.layers import train_attention
from repro_torch.optim import cosine_schedule, make_optimizer
from repro_torch.runtime import substrate
from repro_torch.train import trainer
from repro_torch.tree import flatten, leaves, unflatten

STEPS, SEQ, BATCH, RANKS = 8, 32, 8, 4
LOSS_RTOL = {"auto": 1e-4, "composed": 1e-4, "compressed": 1e-3}


def _rel_err(got, want) -> float:
    want = np.asarray(want, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - want).max()
                 / max(np.abs(want).max(), 1e-30))


def _np_tree(jtree):
    flat, paths = flatten(jax.device_get(jtree))
    return flat, paths


def test_adamw_matches_reference_on_the_same_gradients():
    rng = np.random.RandomState(0)
    shapes = {"a": (17, 9), "b": (33,), "c": (2, 4, 8)}
    params = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    jopt = jmake_optimizer("adamw", lr=jcosine(1e-2, warmup=1, total=5))
    topt = make_optimizer("adamw", lr=cosine_schedule(1e-2, warmup=1,
                                                      total=5))
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    js, ts = jopt.init(jp), topt.init(tp)
    for step in range(4):
        # large enough that the global-norm clip acts
        g = {k: (rng.randn(*s) * 3).astype(np.float32)
             for k, s in shapes.items()}
        jout = jopt.update({k: jnp.asarray(v) for k, v in g.items()}, js,
                           jp)
        jp, js = jout[0], jout[1]
        tp, ts, tm = topt.update({k: torch.from_numpy(v)
                                  for k, v in g.items()}, ts, tp)
        for k in shapes:
            for jt, tt in ((jp[k], tp[k]), (js["m"][k], ts["m"][k]),
                           (js["v"][k], ts["v"][k])):
                assert _rel_err(tt.numpy(), jt) <= 1e-6, (step, k)
        assert int(ts["step"]) == int(js["step"]) == step + 1
    assert float(tm["grad_norm"]) > 1.0


def test_adamw_slices_give_the_same_bits(monkeypatch):
    """The update runs UPDATE_SLICE values at a time; slices of 7 give
    the bits of one pass (bf16 params, f32 moments, clipping on)."""
    from repro_torch.optim import optimizer as O
    rng = np.random.RandomState(2)
    shapes = {"a": (17, 9), "b": (33,)}

    def run():
        opt = make_optimizer("adamw", lr=cosine_schedule(1e-2, warmup=1,
                                                         total=5))
        p = {k: torch.from_numpy(np.random.RandomState(1).randn(*s)
                                 .astype(np.float32)).to(torch.bfloat16)
             for k, s in shapes.items()}
        st = opt.init(p)
        for g in grads:
            p, st, _ = opt.update(g, st, p)
        return leaves({"p": p, "m": st["m"], "v": st["v"]})

    grads = [{k: torch.from_numpy((rng.randn(*s) * 3).astype(np.float32))
              .to(torch.bfloat16) for k, s in shapes.items()}
             for _ in range(3)]
    whole = run()
    monkeypatch.setattr(O, "UPDATE_SLICE", 7)
    for a, b in zip(whole, run()):
        assert torch.equal(a, b)


@pytest.mark.parametrize("step", [0, 5])
def test_host_batch_is_byte_identical(step):
    jb = JDataset(vocab_size=49152, seq_len=64, global_batch=4,
                  seed=3).host_batch(step)
    tb = SyntheticLMDataset(vocab_size=49152, seq_len=64, global_batch=4,
                            seed=3).host_batch(step)
    assert sorted(jb) == sorted(tb)
    for k in jb:
        assert jb[k].dtype == tb[k].dtype and jb[k].shape == tb[k].shape
        assert jb[k].tobytes() == tb[k].tobytes()


ATTN_TOL = {np.float32: 1e-5, jnp.bfloat16: 2.0 ** -6}


@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16])
@pytest.mark.parametrize("h,hkv", [(4, 1), (4, 2)])
@pytest.mark.parametrize("seq,block_k", [(40, 16), (64, 8)])
def test_train_attention_over_several_blocks_matches_reference(
        seq, block_k, h, hkv, dtype):
    """3 blocks with a ragged last one (40 keys, 16 a block) and 8 full
    blocks: causal output and the gradients of q, k and v."""
    rng = np.random.RandomState(seq + h + hkv)
    q, k, v, do = (rng.randn(2, seq, n, 16).astype(np.float32)
                   for n in (h, hkv, hkv, h))
    jq, jk, jv, jdo = (jnp.asarray(a).astype(dtype) for a in (q, k, v, do))
    jout, vjp = jax.vjp(lambda a, b, c: flash_attention_jnp(
        a, b, c, causal=True, block_k=block_k), jq, jk, jv)
    jgrads = vjp(jdo)
    tdt = torch.float32 if dtype is np.float32 else torch.bfloat16
    tq, tk, tv = (torch.from_numpy(a).to(tdt).requires_grad_(True)
                  for a in (q, k, v))
    tout = train_attention(tq, tk, tv, causal=True, block_k=block_k)
    tgrads = torch.autograd.grad(tout, (tq, tk, tv),
                                 torch.from_numpy(do).to(tdt))
    for name, t, j in zip(("out", "dq", "dk", "dv"), (tout,) + tgrads,
                          (jout,) + tuple(jgrads)):
        want = np.asarray(j.astype(jnp.float32))
        assert t.dtype == tdt, name
        assert _rel_err(t.detach().float().numpy(), want) <= ATTN_TOL[
            dtype], name


@pytest.mark.parametrize("arch", ["granite-34b", "qwen2-72b"])
def test_loss_and_grads_match_reference(arch):
    jm = jbuild_model(jget_config(arch, reduced=True))
    jp = jm.init(jax.random.PRNGKey(1))
    tm = build_model(get_config(arch, reduced=True))
    assert SEQ // tm.cfg.block_k >= 2     # the attention's block loop runs
    tp = params_from_numpy(jax.device_get(jp), tm.cfg, device="cpu")
    batch = SyntheticLMDataset(vocab_size=tm.cfg.vocab_size, seq_len=SEQ,
                               global_batch=2).host_batch(0)
    (jloss, _), jgrads = jax.value_and_grad(jm.loss, has_aux=True)(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    ps, paths = flatten(tp)
    xs = [p.detach().requires_grad_(True) for p in ps]
    tloss, _ = tm.loss(unflatten(paths, xs),
                       {k: torch.from_numpy(v) for k, v in batch.items()})
    tgrads = torch.autograd.grad(tloss, xs)
    assert _rel_err(tloss.item(), float(jloss)) <= 1e-5
    jg, jpaths = _np_tree(jgrads)
    assert jpaths == paths
    for path, a, b in zip(paths, jg, tgrads):
        assert _rel_err(b.numpy(), a) <= 1e-5, "/".join(path)


REFERENCE_CHILD = """
import json, sys, types
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
cfg = get_config("granite-34b", reduced=True)
model = build_model(cfg)
mesh = make_host_mesh(model_parallel=1)
assert mesh.shape["data"] == {ranks} and mesh.size == {ranks}, mesh.shape
opt = make_optimizer("adamw", lr=cosine_schedule(
    1e-3, warmup=max(STEPS // 20, 1), total=STEPS))
ds = SyntheticLMDataset(vocab_size=cfg.vocab_size, seq_len=SEQ,
                        global_batch=BATCH)
params = model.init(jax.random.PRNGKey(0))
np.savez({path!r}, **{{"/".join(str(k.key) for k in p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(params)[0]}})
out = {{}}
for sync in ("auto", "composed", "compressed"):
    args = types.SimpleNamespace(
        microbatches=1, sync=sync, bucket_grads=False, bucket_bytes=32 << 20,
        overlap=False, overlap_depth=2, zero=False)
    sess = (lt.build_session(mesh, model, opt, ds, args)
            if sync != "auto" else None)
    tcfg = trainer.TrainCfg(sync_mode=sync)
    step_fn = jax.jit(trainer.make_train_step(
        model, opt, tcfg, mesh=mesh,
        comm=sess.world if sess is not None else None))
    sspecs = trainer.state_specs(model, opt, tcfg, mesh=mesh)
    with substrate.set_mesh(mesh):
        state = trainer.make_train_state(model, opt, jax.random.PRNGKey(0),
                                         cfg=tcfg, mesh=mesh)
        state = jax.device_put(state, named_shardings(mesh, sspecs))
        losses = []
        for step in range(STEPS):
            state, m = step_fn(state, ds.sharded_batch(step, mesh))
            losses.append(float(m["loss"]))
    out[sync] = losses
print("LOSSES", json.dumps(out))
"""


@pytest.fixture(scope="module")
def reference_run(tmp_path_factory):
    """(reference losses by sync mode, its initial weights as a tree)."""
    path = str(tmp_path_factory.mktemp("ref") / "weights.npz")
    out = run_subprocess_script(REFERENCE_CHILD.format(
        steps=STEPS, seq=SEQ, batch=BATCH, ranks=RANKS, path=path),
        devices=RANKS)
    line = next(l for l in out.splitlines() if l.startswith("LOSSES "))
    w = np.load(path)
    tree = unflatten([tuple(k.split("/")) for k in w.files],
                     [w[k] for k in w.files])
    return json.loads(line[len("LOSSES "):]), tree


@pytest.mark.parametrize("sync", ["auto", "composed", "compressed"])
def test_data_parallel_training_matches_reference(reference_run, sync):
    ref_losses, tree = reference_run
    cfg = get_config("granite-34b", reduced=True)
    model = build_model(cfg)
    opt = make_optimizer("adamw", lr=cosine_schedule(
        1e-3, warmup=max(STEPS // 20, 1), total=STEPS))
    ds = SyntheticLMDataset(vocab_size=cfg.vocab_size, seq_len=SEQ,
                            global_batch=BATCH)
    mesh = substrate.make_host_mesh(RANKS, device="cpu")
    tcfg = trainer.TrainCfg(sync_mode=sync)
    sess = (Session(mesh=mesh, mode="monolithic") if sync == "auto"
            else build_session(mesh, model, opt, ds, tcfg))
    states = trainer.init_states(
        model, opt, params_from_numpy(tree, cfg, device="cpu"), tcfg, mesh)
    step_fn = trainer.make_train_step(model, opt, tcfg, comm=sess.world)
    # auto splits each leaf the reference's specs split over "data": the
    # ranks hold its blocks, and the other leaves whole
    first = {"params": states[0]["params"], "opt": states[0]["opt"]}
    whole = [d is None for d in trainer._state_data_dims(
        model, trainer.data_width(tcfg, mesh), first)]
    assert all(whole) == (sync != "auto")
    losses = []
    for step in range(STEPS):
        states, metrics = step_fn(states, ds.host_batch(step))
        losses.append(metrics["loss"].item())
        first = {"params": states[0]["params"], "opt": states[0]["opt"]}
        for st in states[1:]:     # the EF residual is each rank's own
            mine = {"params": st["params"], "opt": st["opt"]}
            for a, b, w in zip(leaves(first), leaves(mine), whole):
                assert torch.equal(a, b) or not w, (
                    f"replicas differ at {step}")
    assert _rel_err(losses, ref_losses[sync]) <= LOSS_RTOL[sync], (
        losses, ref_losses[sync])
    assert losses[-1] < losses[0]


def test_train_cli_runs_on_the_cpu(capsys):
    launch_train.main(["--device", "cpu", "--arch", "granite-34b",
                       "--reduced", "--sync", "compressed", "--steps", "2",
                       "--seq-len", "16", "--global-batch", "4",
                       "--log-every", "1"])


def test_train_cli_runs_sync_auto_on_the_cpu():
    launch_train.main(["--device", "cpu", "--arch", "granite-34b",
                       "--reduced", "--sync", "auto", "--steps", "2",
                       "--seq-len", "16", "--global-batch", "4",
                       "--log-every", "1"])


@pytest.mark.parametrize("flag", ["--zero", "--overlap", "--bucket-grads"])
def test_train_cli_refuses_sync_auto_with(flag, capsys):
    with pytest.raises(SystemExit):
        launch_train.main(["--device", "cpu", "--sync", "auto", flag,
                           "--steps", "1"])
    assert "--sync" in capsys.readouterr().err


@pytest.mark.parametrize("kw", [{"zero": True}, {"overlap": True},
                                {"bucket_grads": True}])
def test_train_cfg_refuses_auto_with(kw):
    with pytest.raises(ValueError):
        trainer.TrainCfg(sync_mode="auto", **kw)


def test_train_entry_points_raise_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the no-CUDA refusal")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        substrate.make_host_mesh(2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        launch_train.main(["--steps", "1"])
