"""Model-parallel training of the port against the reference, on the CPU.

- ``parallel.sharding``: ``shard_params`` / ``unshard_params`` round
  trip; the shards have ``Model.abstract_params``' shapes; the
  vocab-parallel cross-entropy equals ``cross_entropy`` (value within
  1e-6 relative, each rank's logit gradient the block of the whole one
  within 1e-6 of its largest value).
- Reduced granite-34b (MQA: K/V replicated) and qwen2-72b (GQA 4/2: K/V
  split) on a model axis of 2: the loss equals the unsplit model's
  (1e-5 relative) and the gradient shards (with the partial-sum leaves
  summed over "model") are blocks of its gradients (1e-5 of the largest
  value); the staged backward and the autograd operator *f* agree within
  1e-6 (the engine adds a node's incoming gradients in another order).
- 3 steps on a (data 2, model 2) mesh, ``composed`` (both models) and
  ``compressed`` (granite-34b) against the reference's (2, 2) data x
  model run from the same weights and batches, ``auto`` against its
  composed run: losses within the
  reference's ``LOSS_RTOL`` (1e-4; 1e-3 compressed, where the int8 ring
  can round a code the other way), and each step's global gradient norm
  (which engages the clip) within ``NORM_RTOL`` of the reference's
  (1e-5; 1e-3 compressed; readings 1e-7 and 3.3e-4).  After every step
  the data replicas are identical (``auto``: but for the blocks of the
  leaves it splits over "data", each data rank's own), and so is every
  leaf the model ranks all hold (norms, MQA's K/V; of a data
  coordinate); ``check_model_replicas`` asserts in the
  step that their gradients agree across model ranks without a sum, and
  names a leaf whose gradient one rank changed.
- The pod axis: ``TrainCfg.data_axes`` defaults to ``("pod", "data")``.
  On a (pod 2, data 2) mesh the batch splits over both axes, the
  gradients sync through the hierarchical all-reduce, the port's
  replicas are identical, its losses within 1e-4 and its gradient norms
  within 1e-5 of the reference's.
  With the old default ``("data",)`` the pods computed the same rows
  twice and never synced over "pod".
- Bucketed, overlapped and ZeRO-1 sync run unchanged on the local
  leaves: each gives the per-leaf composed run's bits on (2, 2) (ZeRO
  at ``clip_norm=0``, as ``test_torch_zero.py`` holds it); at
  ``clip_norm`` 1.0 ZeRO's norm, built from chunk-local squares summed
  over "model" too, agrees with the per-leaf run's within 1e-6.
- The launcher's ``--model-parallel 2`` runs; it refuses ``--elastic``
  without ``--ckpt-dir`` and a fault plan without ``--elastic``; a
  session gathers model-split states into global leaves (model-sharded
  checkpoints: ``test_torch_elastic_tp.py``).

The reference's losses come from one child interpreter with 4 host
devices that runs every (2, 2) run and the pod run.
"""

import json

import numpy as np
import pytest
import torch

from conftest import run_subprocess_script
from repro_torch.comm import Session
from repro_torch.configs import get_config
from repro_torch.data import SyntheticLMDataset
from repro_torch.launch import train as launch_train
from repro_torch.launch.train import build_session
from repro_torch.models import build_model
from repro_torch.models import transformer as T
from repro_torch.models.convert import params_from_numpy
from repro_torch.optim import cosine_schedule, make_optimizer
from repro_torch.parallel import sharding
from repro_torch.runtime import substrate
from repro_torch.train import trainer
from repro_torch.tree import flatten, leaves, unflatten

STEPS, SEQ, BATCH = 3, 32, 8
LOSS_RTOL = {"auto": 1e-4, "composed": 1e-4, "compressed": 1e-3}
NORM_RTOL = {"auto": 1e-5, "composed": 1e-5, "compressed": 1e-3}
ARCHS = ("granite-34b", "qwen2-72b")


def _rel_err(got, want) -> float:
    want = np.asarray(want, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - want).max()
                 / max(np.abs(want).max(), 1e-30))


def _model_mesh(m=2):
    return substrate.make_mesh((m,), ("model",), device="cpu")


def _full_params(arch, seed=0):
    cfg = get_config(arch, reduced=True)
    return cfg, build_model(cfg).init(torch.Generator().manual_seed(seed))


# ---------------------------------------------------------------------------
# Meshes and the parameter split
# ---------------------------------------------------------------------------

def test_make_host_mesh_axes():
    m = substrate.make_host_mesh(2, model_parallel=2, device="cpu")
    assert (m.axis_names, m.axis_sizes) == (("data", "model"), (2, 2))
    m = substrate.make_host_mesh(2, model_parallel=2, pods=3, device="cpu")
    assert (m.axis_names, m.axis_sizes) == (("pod", "data", "model"),
                                            (3, 2, 2))
    m = substrate.make_host_mesh(4, pods=2, device="cpu")
    assert (m.axis_names, m.axis_sizes) == (("pod", "data"), (2, 4))
    assert substrate.make_host_mesh(3, device="cpu").axis_names == ("data",)
    with pytest.raises(ValueError):
        substrate.make_host_mesh(2, model_parallel=0, device="cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_shard_unshard_round_trip(arch):
    cfg, full = _full_params(arch)
    model = build_model(cfg, model_parallel=2)
    shards = [model.shard(full, i) for i in range(2)]
    want = flatten(model.abstract_params())
    for sh in shards:
        got = flatten(sh)
        assert got[1] == want[1]
        assert [tuple(t.shape) for t in got[0]] == [tuple(t.shape)
                                                   for t in want[0]]
    back = sharding.unshard_params(shards, model.layout)
    for a, b in zip(leaves(full), leaves(back)):
        assert torch.equal(a, b)
    kv_rep = cfg.attn.num_kv_heads % 2 != 0
    assert model.layout.kv_replicated == kv_rep
    wk = [sh["stage0"]["layer0"]["attn"]["wk"] for sh in shards]
    assert torch.equal(wk[0], wk[1]) == kv_rep


def test_layout_refuses_a_split_that_does_not_divide():
    # a decoder's heads that do not divide are held whole (TPLayout.whole);
    # its FFN columns, and an encoder-decoder's heads, are refused
    cfg = get_config("granite-34b", reduced=True)      # 4 heads, ff 128
    with pytest.raises(ValueError, match="d_ff"):
        sharding.layout(cfg, 3)
    with pytest.raises(ValueError, match="num_heads"):
        sharding.layout(get_config("seamless-m4t-large-v2", reduced=True),
                        3)


def test_vocab_parallel_cross_entropy_matches_cross_entropy():
    rng = np.random.RandomState(0)
    logits = rng.randn(2, 5, 16).astype(np.float32) * 3
    labels = rng.randint(0, 16, size=(2, 5))
    labels[0, 1] = labels[1, 4] = -1                  # ignored positions
    full = torch.from_numpy(logits).requires_grad_(True)
    lab = torch.from_numpy(labels)
    want = T.cross_entropy(full, lab)
    (gwant,) = torch.autograd.grad(want, full)

    def rank(block):
        x = block.clone().requires_grad_(True)
        loss = sharding.vocab_parallel_cross_entropy(
            x, lab, sharding.model_index())
        return loss.detach(), torch.autograd.grad(loss, x)[0]

    blocks = torch.from_numpy(logits).chunk(2, dim=-1)
    out = substrate.run_spmd(rank, [(b,) for b in blocks], _model_mesh(),
                             timeout=60)
    for i, (loss, g) in enumerate(out):
        assert _rel_err(loss.item(), want.item()) <= 1e-6
        assert _rel_err(g.numpy(), gwant.chunk(2, dim=-1)[i].numpy()) <= 1e-6


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_loss_and_grads_match_the_whole_model(arch):
    cfg, full = _full_params(arch, seed=3)
    whole = build_model(cfg)
    tp = build_model(cfg, model_parallel=2)
    batch = {k: torch.from_numpy(v) for k, v in SyntheticLMDataset(
        vocab_size=cfg.vocab_size, seq_len=SEQ, global_batch=2
    ).host_batch(0).items()}
    wloss, wgrads = whole.loss_and_grads(full, batch)

    def rank(params):
        loss, grads = tp.loss_and_grads(params, batch)
        ps, paths = flatten(params)
        xs = [p.detach().requires_grad_(True) for p in ps]
        # without a tape, f is the autograd operator (its all-reduce in
        # the backward node: the CPU runs each thread's own backward)
        floss, _ = tp.loss(unflatten(paths, xs), batch)
        fgrads = torch.autograd.grad(floss, xs)
        return loss, grads, floss.detach(), fgrads

    out = substrate.run_spmd(rank, [(tp.shard(full, i),) for i in range(2)],
                             _model_mesh(), timeout=120)
    paths = flatten(full)[1]
    partial = sharding.partial_sum_leaves(paths, tp.layout)
    for loss, grads, floss, fgrads in out:
        assert _rel_err(loss.item(), wloss.item()) <= 1e-5
        assert torch.equal(loss, floss)
        for a, b in zip(leaves(grads), fgrads):
            assert _rel_err(a.numpy(), b.numpy()) <= 1e-6
    shards = []
    for i in range(2):
        gl = leaves(out[i][1])
        shards.append(unflatten(paths, [
            g + leaves(out[1 - i][1])[j] if partial[j] else g
            for j, g in enumerate(gl)]))
    got = sharding.unshard_params(shards, tp.layout)
    for path, a, b in zip(paths, leaves(got), leaves(wgrads)):
        assert _rel_err(a.numpy(), b.numpy()) <= 1e-5, "/".join(path)


# ---------------------------------------------------------------------------
# Training against the reference's (2, 2) and (pod 2, data 2) runs
# ---------------------------------------------------------------------------

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
RUNS = {runs}
out = {{}}
for arch, shape, sync in RUNS:
    cfg = get_config(arch, reduced=True)
    model = build_model(cfg)
    mesh = (make_host_mesh(model_parallel=2) if shape == "2x2"
            else make_host_mesh(model_parallel=1, pods=2))
    opt = make_optimizer("adamw", lr=cosine_schedule(
        1e-3, warmup=max(STEPS // 20, 1), total=STEPS))
    ds = SyntheticLMDataset(vocab_size=cfg.vocab_size, seq_len=SEQ,
                            global_batch=BATCH)
    params = model.init(jax.random.PRNGKey(0))
    np.savez({path!r} + "_" + arch + ".npz", **{{
        "/".join(str(k.key) for k in p): np.asarray(v)
        for p, v in jax.tree_util.tree_flatten_with_path(params)[0]}})
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
        losses, norms = [], []
        for step in range(STEPS):
            state, m = step_fn(state, ds.sharded_batch(step, mesh))
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
    out["/".join((arch, shape, sync))] = losses
    out["/".join((arch, shape, sync, "grad_norm"))] = norms
print("LOSSES", json.dumps(out))
"""

RUNS = [("granite-34b", "2x2", "composed"),
        ("granite-34b", "2x2", "compressed"),
        ("qwen2-72b", "2x2", "composed"),
        ("granite-34b", "pod", "composed")]


@pytest.fixture(scope="module")
def reference_run(tmp_path_factory):
    """(reference losses by "arch/shape/sync" and gradient norms by
    "arch/shape/sync/grad_norm", its initial weights by arch, as
    trees)."""
    path = str(tmp_path_factory.mktemp("ref") / "weights")
    out = run_subprocess_script(REFERENCE_CHILD.format(
        steps=STEPS, seq=SEQ, batch=BATCH, runs=RUNS, path=path),
        devices=4)
    line = next(l for l in out.splitlines() if l.startswith("LOSSES "))
    trees = {}
    for arch in ARCHS:
        w = np.load(f"{path}_{arch}.npz")
        trees[arch] = unflatten([tuple(k.split("/")) for k in w.files],
                                [w[k] for k in w.files])
    return json.loads(line[len("LOSSES "):]), trees


def _setup(arch, mesh, tree, sync="composed", **cfg_kw):
    cfg = get_config(arch, reduced=True)
    m = dict(mesh.shape).get("model", 1)
    model = build_model(cfg, model_parallel=m)
    opt_kw = cfg_kw.pop("opt_kw", {})
    opt = make_optimizer("adamw", lr=cosine_schedule(
        1e-3, warmup=max(STEPS // 20, 1), total=STEPS), **opt_kw)
    ds = SyntheticLMDataset(vocab_size=cfg.vocab_size, seq_len=SEQ,
                            global_batch=BATCH)
    tcfg = trainer.TrainCfg(sync_mode=sync, **cfg_kw)
    sess = (Session(mesh=mesh, mode="monolithic") if sync == "auto"
            else build_session(mesh, model, opt, ds, tcfg))
    states = trainer.init_states(model, opt,
                                 params_from_numpy(tree, cfg, device="cpu"),
                                 tcfg, mesh)
    return model, ds, states, trainer.make_train_step(model, opt, tcfg,
                                                      comm=sess.world)


def _check_replicas(mesh, model, states, step, data=1):
    """Data replicas (one model coordinate) hold the same state, and the
    leaves every model rank holds whole (norms, MQA's K/V) are the same
    on every rank of a data coordinate: their gradients agree across the
    model ranks.  ``data``: the width ``auto`` splits its state over
    (``trainer.data_width``), whose data ranks hold other blocks of the
    leaves it splits."""
    paths = flatten(states[0]["params"])[1]
    whole = [d is None for d in trainer._state_data_dims(
        model, data, {"params": states[0]["params"]})]
    state_whole = [d is None for d in trainer._state_data_dims(
        model, data, {"params": states[0]["params"],
                      "opt": states[0]["opt"]})]
    for r, st in enumerate(states):
        c = mesh.coords(r)
        first = states[next(q for q in range(mesh.size)
                            if mesh.coords(q)["model"] == c["model"])]
        for a, b, w in zip(leaves({"params": first["params"],
                                   "opt": first["opt"]}),
                           leaves({"params": st["params"],
                                   "opt": st["opt"]}), state_whole):
            assert torch.equal(a, b) or not w, (
                f"data replicas differ at {step}")
        same = states[next(q for q in range(mesh.size)
                           if mesh.coords(q)["data"] == c["data"])]
        for path, a, b in zip(paths, leaves(same["params"]),
                              leaves(st["params"])):
            if sharding.leaf_split(path, model.layout) is None:
                assert torch.equal(a, b), (path, step)
        for path, a, b, w in zip(paths, leaves(first["params"]),
                                 leaves(st["params"]), whole):
            # a block of the leaf: this data rank's own
            assert w or first is st or not torch.equal(a, b), (path, step)


def _train(arch, mesh, tree, sync="composed", **cfg_kw):
    """STEPS steps; returns (losses, gradient norms, states)."""
    model, ds, states, step_fn = _setup(arch, mesh, tree, sync, **cfg_kw)
    losses, norms = [], []
    for step in range(STEPS):
        states, metrics = step_fn(states, ds.host_batch(step))
        losses.append(metrics["loss"].item())
        norms.append(metrics["grad_norm"].item())
    return losses, norms, states


@pytest.mark.parametrize("arch,sync", [(a, s) for a, sh, s in RUNS
                                       if sh == "2x2"]
                         + [("granite-34b", "auto")])
def test_data_x_model_training_matches_reference(reference_run, arch, sync):
    """``auto`` (the monolithic stack) is held to the reference's
    composed run, as ``tests/test_multidev.py`` holds the reference's
    composed run to its auto one (1e-4).  The global gradient norm (the
    split leaves' squares summed over "model") is held to the
    reference's, whose GSPMD norm runs over the whole arrays; it engages
    the clip (AdamW's default ``clip_norm`` 1.0), so a norm counted
    twice or missing a model rank's part would change the update."""
    ref, trees = reference_run
    mesh = substrate.make_host_mesh(2, model_parallel=2, device="cpu")
    model, ds, states, step_fn = _setup(arch, mesh, trees[arch], sync,
                                        check_model_replicas=True)
    losses, norms = [], []
    for step in range(STEPS):
        states, metrics = step_fn(states, ds.host_batch(step))
        losses.append(metrics["loss"].item())
        norms.append(metrics["grad_norm"].item())
        _check_replicas(mesh, model, states, step,
                        data=2 if sync == "auto" else 1)
    key = f"{arch}/2x2/{'composed' if sync == 'auto' else sync}"
    want, want_norms = ref[key], ref[f"{key}/grad_norm"]
    assert _rel_err(losses, want) <= LOSS_RTOL[sync], (losses, want)
    assert min(want_norms) > 1.0, want_norms         # the clip is engaged
    assert _rel_err(norms, want_norms) <= NORM_RTOL[sync], (norms,
                                                             want_norms)
    assert losses[-1] < losses[0]


def _rank_rows(step_fn, states, batch):
    """The rows each rank's step takes from ``batch`` (its split by
    ``data.shard_batch``, found back in the batch's tokens)."""
    seen = []
    real = trainer.shard_batch

    def spy(host, mesh, axes):
        seen.append(real(host, mesh, axes))
        return seen[-1]

    trainer.shard_batch = spy
    try:
        step_fn(states, batch)
    finally:
        trainer.shard_batch = real
    (ranks,) = seen
    tokens = torch.as_tensor(batch["tokens"])
    rows = []
    for got in ranks:
        t = got["tokens"]
        lo = next(i for i in range(len(tokens)) if torch.equal(tokens[i],
                                                               t[0]))
        assert torch.equal(tokens[lo:lo + len(t)], t)
        rows.append((lo, lo + len(t)))
    return rows


def test_pod_axis_syncs_across_pods(reference_run):
    """The repaired default: ``("pod", "data")`` filtered to the mesh.
    With the old ``("data",)`` the step split the batch over "data"
    only: the two pods computed the same rows and the sync never crossed
    "pod"."""
    ref, trees = reference_run
    assert trainer.TrainCfg().data_axes == ("pod", "data")
    mesh = substrate.make_host_mesh(2, pods=2, device="cpu")
    tree = trees["granite-34b"]
    model, ds, states, step_fn = _setup("granite-34b", mesh, tree)
    (u, *_) = step_fn.schedule.units
    assert (u.axes, u.protocol) == (("pod", "data"), "hierarchical")
    losses, norms = [], []
    for step in range(STEPS):
        states, metrics = step_fn(states, ds.host_batch(step))
        losses.append(metrics["loss"].item())
        norms.append(metrics["grad_norm"].item())
        for st in states[1:]:
            for a, b in zip(leaves(states[0]["params"]),
                            leaves(st["params"])):
                assert torch.equal(a, b), f"replicas differ at {step}"
    want = ref["granite-34b/pod/composed"]
    want_norms = ref["granite-34b/pod/composed/grad_norm"]
    assert _rel_err(losses, want) <= LOSS_RTOL["composed"], (losses, want)
    assert _rel_err(norms, want_norms) <= NORM_RTOL["composed"], (
        norms, want_norms)
    per = BATCH // 4
    assert _rank_rows(step_fn, states, ds.host_batch(0)) == [
        (r * per, (r + 1) * per) for r in range(4)]
    _, _, old_states, old_fn = _setup("granite-34b", mesh, tree,
                                      data_axes=("data",))
    assert old_fn.schedule.units[0].axes == ("data",)
    half = BATCH // 2
    assert _rank_rows(old_fn, old_states, ds.host_batch(0)) == [
        (0, half), (half, BATCH)] * 2


@pytest.mark.parametrize("kw", [
    {"bucket_grads": True}, {"overlap": True, "overlap_depth": 3},
    {"zero": True, "overlap": True}], ids=["bucketed", "overlap", "zero"])
def test_sync_flavours_run_on_the_local_leaves(kw):
    """Each flavour on (2, 2) against the per-leaf composed run from the
    same weights: the same losses and parameters, bit for bit (ZeRO at
    ``clip_norm=0``, where its chunked norm is a metric only)."""
    cfg, full = _full_params("granite-34b", seed=4)
    tree = flatten(full)
    tree = unflatten(tree[1], [t.numpy() for t in tree[0]])
    mesh = substrate.make_host_mesh(2, model_parallel=2, device="cpu")
    opt_kw = {"clip_norm": 0.0} if kw.get("zero") else {}
    base_l, _, base = _train("granite-34b", mesh, tree, opt_kw=opt_kw)
    got_l, _, got = _train("granite-34b", mesh, tree, opt_kw=opt_kw, **kw)
    assert got_l == base_l
    for a, b in zip(leaves([s["params"] for s in base]),
                    leaves([s["params"] for s in got])):
        assert torch.equal(a, b)


def test_zero_clipped_norm_agrees_with_per_leaf_on_a_model_axis():
    """ZeRO-1 on (2, 2) at ``clip_norm`` 1.0: its norm from chunk-local
    squares (the split leaves' summed over "model" too) engages the clip
    and agrees with the per-leaf run's to rounding, and so do the
    losses."""
    cfg, full = _full_params("granite-34b", seed=4)
    tree = flatten(full)
    tree = unflatten(tree[1], [t.numpy() for t in tree[0]])
    mesh = substrate.make_host_mesh(2, model_parallel=2, device="cpu")
    opt_kw = {"clip_norm": 1.0}
    lu, nu, _ = _train("granite-34b", mesh, tree, opt_kw=opt_kw)
    lz, nz, _ = _train("granite-34b", mesh, tree, opt_kw=opt_kw,
                       zero=True, overlap=True)
    assert min(nu) > 1.0, nu                 # the clip is engaged
    assert _rel_err(nz, nu) <= 1e-6, (nu, nz)
    assert _rel_err(lz, lu) <= 1e-6, (lu, lz)


def test_check_model_replicas_names_a_gradient_that_differs():
    """``TrainCfg.check_model_replicas``: the gradients of the leaves
    every model rank holds whole must be bit-equal across "model"; a
    norm gradient one model rank changed is named."""
    cfg, full = _full_params("granite-34b")
    model = build_model(cfg, model_parallel=2)
    axis = trainer._model_axis(model, _model_mesh())
    norm = ("stage0", "layer0", "norm_ffn", "scale")
    paths = flatten(full)[1]
    assert norm in paths and not axis.split[paths.index(norm)]

    def rank(params, bump):
        gl, ps = flatten(params)
        if bump:
            gl = [g + 1e-6 if p == norm else g for g, p in zip(gl, ps)]
        axis.check_replicated(unflatten(ps, gl))

    shards = [model.shard(full, i) for i in range(2)]
    substrate.run_spmd(rank, [(sh, False) for sh in shards], _model_mesh(),
                       timeout=60)
    with pytest.raises(substrate.RankFailure, match="norm_ffn/scale"):
        substrate.run_spmd(rank, [(shards[0], False), (shards[1], True)],
                           _model_mesh(), timeout=60)


def test_train_cli_model_parallel_runs_on_the_cpu():
    launch_train.main(["--device", "cpu", "--arch", "granite-34b",
                       "--reduced", "--sync", "composed", "--data", "2",
                       "--model-parallel", "2", "--steps", "2",
                       "--seq-len", "16", "--global-batch", "4",
                       "--log-every", "1"])


@pytest.mark.parametrize("flags", [["--elastic"],
                                   ["--fault-plan", "lose@1:1",
                                    "--ckpt-dir", "/nonexistent"]])
def test_train_cli_refuses_incomplete_elastic_flags_with_model_parallel(
        flags, capsys):
    """Model-sharded checkpoints and ``--elastic`` are accepted with
    ``--model-parallel 2`` (``tests/test_torch_elastic_tp.py``); what the
    launcher still refuses there is an incomplete set of elastic flags:
    ``--elastic`` without a checkpoint store, a fault plan without
    ``--elastic``."""
    with pytest.raises(SystemExit):
        launch_train.main(["--device", "cpu", "--model-parallel", "2",
                           "--steps", "1"] + flags)
    assert "--elastic" in capsys.readouterr().err


def test_train_session_gathers_model_split_states_into_global_leaves():
    """Model-split states gather through their mesh into the checkpoint
    layout: every leaf has the global shape ``abstract_state`` gives."""
    cfg = get_config("granite-34b", reduced=True)
    sess = trainer.TrainSession(build_model(cfg, model_parallel=2),
                                make_optimizer("adamw", lr=1e-3))
    mesh = substrate.make_mesh((1, 2), ("data", "model"), device="cpu")
    states = sess.init_state(torch.Generator().manual_seed(0), mesh=mesh)
    got, want = sess.gather(states, mesh), sess.abstract_state(mesh)
    assert flatten(got)[1] == flatten(want)[1]
    assert [tuple(l.shape) for l in flatten(got)[0]] == \
        [tuple(l.shape) for l in flatten(want)[0]]
    assert got["params"]["lm_head"].shape[-1] == cfg.vocab_size
