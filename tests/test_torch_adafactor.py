"""The port's Adafactor against the reference's, on the CPU.

- ``make_optimizer("adafactor")`` against ``repro.optim.optimizer.
  make_adafactor`` over 3 steps of the same gradients: params and
  state within 1e-6 of the largest value (f32; the sums run in another
  order), leaf kind by leaf kind: a factored 2-D leaf, a 1-D leaf, a
  small unfactored 2-D leaf, a stacked (6, 4, 32, 48) leaf with
  ``min_dim_factored=16`` (the reference's ``_map_leading``: each of
  the 6 layers its own means and RMS clip, which a clip threshold of
  0.5 engages) and a stacked leaf of 3 layers (one clip over the
  leaf).  With the global-norm clip on (``clip_norm`` 1.0) the clip
  scale carries the global norm's summation order into every value:
  1e-5.  bf16 params: each value within 1e-6 of the largest or one bf16
  ulp of its own (the f32 update before rounding agrees to f32
  rounding, which can tip a rounding), at most 1 in 1000 values so.
- The state tree's paths, shapes and dtypes are the reference's, and
  ``min_dim_factored`` decides the factoring as in the reference
  (the twin of ``tests/test_zero.py``'s case).  Slicing the update
  (``UPDATE_SLICE``) changes the sums' order only: within 1e-6.
- The model-axis hook: a column-, row-, expert-split and a replicated
  leaf, each rank of 2 thread ranks holding its block of the params and
  of the state (``sharding.opt_leaf``'s split), updated through
  ``_ModelAxis.split_sum``: the blocks joined equal the whole tree's
  update within 1e-6, factored and unfactored, the stacked expert leaf
  with 6 layers (a clip a layer, summed over "model"); an expert stack
  of one layer (8 or 12 experts) is clipped an expert at a time, each
  rank its own experts (``_ModelAxis.lead_blocks``).
- Reduced mistral-large-123b, ZeRO-1 on 4 data ranks (each rank's flat
  padded chunks unfactored, the RMS clip over the chunk) and composed
  on (data 2, model 2) with ``check_model_replicas``: 3 steps from the
  reference's weights, losses within 1e-4 and gradient norms within
  1e-5 relative of the reference's ZeRO-1 and (2, 2) runs (tighter than
  the card's ``TP_LOSS_RTOL`` / ``TP_NORM_RTOL``).  ZeRO-1 with
  Adafactor on (data 2, model 2), each rank its piece of the whole
  param's chunk of its data rank (``trainer._piece``), is held to the
  reference's ZeRO-1 run on a (2, 2) host mesh the same way, and, with
  the update-RMS clip engaged, to the port's own ZeRO-1 on (2, 1) in
  f32 within 5e-6; its step's sums over "model" are the card plan's.

The reference's runs come from one child interpreter with 4 host
devices (``test_torch_train_large.run_reference``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import cosine_schedule as jcosine
from repro.optim.optimizer import AdafactorCfg as JAdafactorCfg
from repro.optim.optimizer import make_adafactor as jmake_adafactor
from repro_torch.configs import get_config
from repro_torch.data import SyntheticLMDataset
from repro_torch.launch.train import build_session
from repro_torch.models import build_model
from repro_torch.optim import (AdafactorCfg, cosine_schedule,
                               make_adafactor, make_optimizer)
from repro_torch.optim import optimizer as O
from repro_torch.parallel import sharding
from repro_torch.runtime import substrate
from repro_torch.train import trainer
from repro_torch.tree import flatten, leaves, map_tree, unflatten
from test_torch_train_large import (LOSS_RTOL, NORM_RTOL, adafactor,
                                    rel_err, replicas_identical,
                                    run_reference, train)

LEAVES = {"factored": (40, 48), "one_d": (33,), "small": (8, 12),
          "stacked_mapped": (6, 4, 32, 48), "stacked": (3, 20, 24)}
CFG = dict(min_dim_factored=16, weight_decay=0.01, clip_threshold=0.5)


def _opts(**kw):
    kw = {**CFG, **kw}
    return (jmake_adafactor(JAdafactorCfg(lr=jcosine(1e-2, warmup=1,
                                                     total=5), **kw)),
            make_optimizer("adafactor", lr=cosine_schedule(
                1e-2, warmup=1, total=5), **kw))


def _three_steps(shapes, dtype=np.float32, seed=0, **kw):
    """3 updates of both optimizers on the same params and gradients:
    [(reference params, reference state, port params, port state)]."""
    rng = np.random.RandomState(seed)
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == np.float32
                else (jnp.bfloat16, torch.bfloat16))
    params = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    jopt, topt = _opts(**kw)
    jp = {k: jnp.asarray(v).astype(jdt) for k, v in params.items()}
    tp = {k: torch.from_numpy(v.copy()).to(tdt) for k, v in params.items()}
    js, ts = jopt.init(jp), topt.init(tp)
    out = []
    for _ in range(3):
        g = {k: _grad(rng, s) for k, s in shapes.items()}
        jp, js, _ = jopt.update({k: jnp.asarray(v).astype(jdt)
                                 for k, v in g.items()}, js, jp)
        tp, ts, _ = topt.update({k: torch.from_numpy(v).to(tdt)
                                 for k, v in g.items()}, ts, tp)
        # the port updates in place: keep this step's values
        out.append((jax.device_get(jp), jax.device_get(js),
                    map_tree(torch.clone, tp),
                    {"f": map_tree(torch.clone, ts["f"]),
                     "step": ts["step"]}))
    return out


def _grad(rng, shape):
    """Gaussian values of scale 3; the later half of a stacked leaf's
    layers sparse (2% nonzero), whose factored update has a far smaller
    RMS than a dense layer's, so the RMS clip depends on its span."""
    g = rng.randn(*shape) * 3
    if len(shape) >= 3:
        half = shape[0] // 2
        g[half:] *= rng.rand(*g[half:].shape) < 0.02
    return g.astype(np.float32)


def _f32(x):
    return np.asarray(x.float().numpy() if torch.is_tensor(x) else
                      np.asarray(x).astype(np.float32), np.float64)


@pytest.mark.parametrize("kind", list(LEAVES))
def test_update_matches_reference(kind):
    for step, (jp, js, tp, ts) in enumerate(_three_steps(
            {kind: LEAVES[kind]})):
        assert rel_err(_f32(tp[kind]), _f32(jp[kind])) <= 1e-6, step
        assert sorted(ts["f"][kind]) == sorted(js["f"][kind])
        for stat in js["f"][kind]:
            assert rel_err(_f32(ts["f"][kind][stat]),
                           _f32(js["f"][kind][stat])) <= 1e-6, (step, stat)
        assert int(ts["step"]) == int(js["step"]) == step + 1


def test_update_with_the_global_norm_clip_matches_reference():
    for step, (jp, js, tp, ts) in enumerate(_three_steps(
            LEAVES, clip_norm=1.0)):
        for k in LEAVES:
            assert rel_err(_f32(tp[k]), _f32(jp[k])) <= 1e-5, (step, k)
            for stat in js["f"][k]:
                assert rel_err(_f32(ts["f"][k][stat]),
                               _f32(js["f"][k][stat])) <= 1e-5, (step, k)


def test_bf16_params_match_reference():
    for step, (jp, js, tp, ts) in enumerate(_three_steps(
            LEAVES, dtype=jnp.bfloat16, seed=1)):
        for k in LEAVES:
            assert tp[k].dtype == torch.bfloat16
            got, want = _f32(tp[k]), _f32(jp[k])
            err = np.abs(got - want)
            near = err <= 1e-6 * np.abs(want).max()
            ulp = np.ldexp(1.0, np.frexp(want)[1] - 8)     # bf16's
            assert (near | (err <= ulp)).all(), (step, k)
            assert (~near).mean() <= 1e-3, (step, k, (~near).sum())
            for stat in js["f"][k]:
                assert rel_err(_f32(ts["f"][k][stat]),
                               _f32(js["f"][k][stat])) <= 1e-6, (step, k)


def test_the_mapped_leaf_clips_each_layer_on_its_own(monkeypatch):
    """The stacked leaf of 6 layers: its dense and sparse layers' update
    RMS differ, so one clip over the whole leaf gives other params."""
    jp, _, tp, _ = _three_steps({"s": LEAVES["stacked_mapped"]})[0]
    monkeypatch.setattr(O, "MAP_LEADING", 6)   # the leaf is not mapped
    whole = _three_steps({"s": LEAVES["stacked_mapped"]})[0][2]
    assert rel_err(_f32(tp["s"]), _f32(jp["s"])) <= 1e-6
    assert rel_err(_f32(whole["s"]), _f32(jp["s"])) > 1e-4


def test_state_tree_is_the_reference_tree():
    shapes = {"embed": (256, 64), "norm": {"scale": (64,)},
              "stage0": {"w": (2, 64, 128), "e": (2, 4, 64, 32)}}
    tparams = unflatten(*_shape_tree(shapes, lambda s: torch.zeros(s)))
    jparams = unflatten(*_shape_tree(shapes, lambda s: jnp.zeros(s)))
    for md in (16, 128):
        js = jmake_adafactor(JAdafactorCfg(min_dim_factored=md)).init(
            jparams)
        ts = make_adafactor(AdafactorCfg(min_dim_factored=md)).init(tparams)
        jl, jpaths = flatten(jax.device_get(js))
        tl, tpaths = flatten(ts)
        assert tpaths == jpaths
        for a, b in zip(tl, jl):
            assert tuple(a.shape) == tuple(np.shape(b))
            assert str(a.dtype).split(".")[-1] == str(np.asarray(b).dtype)


def _shape_tree(shapes, make):
    paths, ls = [], []

    def walk(node, path):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], path + (k,))
        else:
            paths.append(path)
            ls.append(make(node))
    walk(shapes, ())
    return paths, ls


def test_min_dim_factored_threaded_through():
    """The twin of ``tests/test_zero.py``'s case."""
    params = {"w": torch.ones(8, 8)}
    grads = {"w": torch.full((8, 8), 0.1)}
    small = make_adafactor(AdafactorCfg(min_dim_factored=16))
    st = small.init(params)
    assert set(st["f"]["w"]) == {"v"}, "8x8 < 16 must stay unfactored"
    _, st2, _ = small.update(grads, st, params)
    assert set(st2["f"]["w"]) == {"v"}
    big = make_adafactor(AdafactorCfg(min_dim_factored=4))
    st = big.init(params)
    assert set(st["f"]["w"]) == {"vr", "vc"}, "8x8 >= 4 must factor"
    _, st2, _ = big.update(grads, st, {"w": torch.ones(8, 8)})
    assert set(st2["f"]["w"]) == {"vr", "vc"}
    assert st2["f"]["w"]["vr"].shape == (8,)
    assert st2["f"]["w"]["vc"].shape == (8,)
    # the split of the state follows the factoring, as state_specs does
    lay = sharding.TPLayout(model=2, heads=1, kv_heads=1,
                            kv_replicated=False, d_ff=4, vocab=4, experts=0)
    assert sharding.opt_leaf(("opt", "f", "lm_head", "vr"), lay) == (
        ("lm_head",), None)
    assert sharding.opt_leaf(("opt", "f", "lm_head", "vc"), lay)[1] == -1
    assert sharding.opt_leaf(("opt", "f", "lm_head", "v"), lay)[1] == -1
    assert sharding.opt_leaf(("opt", "m", "lm_head"), lay) == (
        ("lm_head",), -1)


def test_slices_agree_with_one_pass(monkeypatch):
    whole = _three_steps(LEAVES)[-1][2:]
    monkeypatch.setattr(O, "UPDATE_SLICE", 7)
    sliced = _three_steps(LEAVES)[-1][2:]
    for a, b in zip(leaves(whole), leaves(sliced)):
        assert rel_err(_f32(b), _f32(a)) <= 1e-6


def test_unknown_optimizer_is_refused():
    with pytest.raises(ValueError, match="unknown optimizer 'sgd'"):
        make_optimizer("sgd")


# ---------------------------------------------------------------------------
# The model-axis hook
# ---------------------------------------------------------------------------

SPLIT_SHAPES = {"lm_head": (40, 48), "embed": (48, 40),
                "layer": {"moe": {"w_up": (6, 4, 32, 48)}},
                "norm": {"scale": (40, 24)}}


@pytest.mark.parametrize("min_dim", [16, 1000],
                         ids=["factored", "unfactored"])
def test_split_leaves_update_as_the_whole_leaves(min_dim):
    """Columns (-1), rows (-2), experts (-3) and a replicated leaf on 2
    model ranks, each its block of params, gradients and state."""
    _split_update_is_the_whole_update(SPLIT_SHAPES, [-2, -3, -1, None],
                                      min_dim, experts=2)


@pytest.mark.parametrize("min_dim", [16, 1000],
                         ids=["factored", "unfactored"])
@pytest.mark.parametrize("experts", [8, 12])
def test_an_expert_stack_of_one_layer_clips_each_expert(experts, min_dim):
    """An expert stack of one layer (deepseek's MTP block) split at -3
    over 2 model ranks: the reference maps the whole leaf, so each
    expert has its own RMS clip, and each rank clips its own experts
    with no sum over "model" (``_ModelAxis.lead_blocks``), also where
    the rank's 4 experts alone would not be mapped."""
    _split_update_is_the_whole_update(
        {"mtp": {"moe": {"w_up": (experts, 32, 48)}}}, [-3], min_dim,
        experts=experts // 2)


def _split_update_is_the_whole_update(split_shapes, dims, min_dim,
                                      experts):
    """Three Adafactor updates of the leaves ``split_shapes`` (split at
    ``dims``) on 2 model ranks, each its block of params, gradients and
    state, joined: within 1e-6 of the whole leaves' updates."""
    rng = np.random.RandomState(4)
    paths, shapes = _shape_tree(split_shapes, lambda s: s)
    params = unflatten(paths, [torch.from_numpy(
        rng.randn(*s).astype(np.float32)) for s in shapes])
    grads = [unflatten(paths, [torch.from_numpy(
        (rng.randn(*s) * 3).astype(np.float32)) for s in shapes])
        for _ in range(3)]
    lay = sharding.TPLayout(model=2, heads=1, kv_heads=1,
                            kv_replicated=False, d_ff=4, vocab=4,
                            experts=experts)
    assert [sharding.leaf_split(p, lay) for p in paths] == dims
    opt = make_optimizer("adafactor", lr=1e-2, min_dim_factored=min_dim,
                         clip_threshold=0.5)
    whole_p = map_tree(lambda t: t.clone(), params)
    whole_s = opt.init(whole_p)
    for g in grads:
        whole_p, whole_s, _ = opt.update(g, whole_s, whole_p)
    axis = trainer._ModelAxis(partial=(False,) * len(paths),
                              dims=tuple(dims), model=2)
    state0 = {"params": params, "opt": opt.init(params)}

    def block(tree, idx):
        ls, ps = flatten(tree)
        return unflatten(ps, [sharding.leaf_block(p, l, lay, idx).clone()
                              for p, l in zip(ps, ls)])

    def rank(idx):
        st = block(state0, idx)
        p, s = st["params"], st["opt"]
        for g in grads:
            gb = block({"params": g}, idx)["params"]
            p, s, _ = opt.update(gb, s, p, split_sum=axis.split_sum,
                                 lead_blocks=axis.lead_blocks)
        return {"params": p, "opt": s}

    out = substrate.run_spmd(rank, [(0,), (1,)], substrate.make_mesh(
        (2,), ("model",), device="cpu"), timeout=60)
    got = sharding.unshard_params(out, lay)
    want = {"params": whole_p, "opt": whole_s}
    gl, gpaths = flatten(got)
    assert gpaths == flatten(want)[1]
    for path, a, b in zip(gpaths, gl, leaves(want)):
        assert a.shape == b.shape, path
        assert rel_err(_f32(a), _f32(b)) <= 1e-6, path


# ---------------------------------------------------------------------------
# ZeRO-1 and (data 2, model 2) against the reference's runs
# ---------------------------------------------------------------------------

ARCH = "mistral-large-123b"


@pytest.fixture(scope="module")
def reference_run(tmp_path_factory):
    return run_reference(tmp_path_factory, [(ARCH, "zero"), (ARCH, "2x2"),
                                            (ARCH, "zero2x2")])


def test_zero_training_matches_reference_zero(reference_run):
    ref, trees, _ = reference_run
    mesh = substrate.make_host_mesh(4, device="cpu")
    chunks = []

    def check(states, step):
        replicas_identical([{"params": s["params"], "opt": {}}
                            for s in states], step)
        chunks.append([set(s["opt"]["f"]["lm_head"]) for s in states])

    losses, norms = train(ARCH, trees[ARCH], mesh, check, zero=True,
                          overlap=True)
    want = ref[f"{ARCH}/zero"]
    assert chunks[0] == [{"v"}] * 4        # 1-D chunks: unfactored
    assert rel_err(losses, want["loss"]) <= LOSS_RTOL, (losses, want)
    assert rel_err(norms, want["grad_norm"]) <= NORM_RTOL, (norms, want)


def test_data_x_model_training_matches_reference(reference_run):
    ref, trees, _ = reference_run
    mesh = substrate.make_host_mesh(2, model_parallel=2, device="cpu")

    def check(states, step):
        for r, st in enumerate(states):
            twin = states[r % 2]          # the same model coordinate
            for a, b in zip(leaves([twin["params"], twin["opt"]]),
                            leaves([st["params"], st["opt"]])):
                assert torch.equal(a, b), (r, step)

    losses, norms = train(ARCH, trees[ARCH], mesh, check,
                          check_model_replicas=True)
    want = ref[f"{ARCH}/2x2"]
    assert rel_err(losses, want["loss"]) <= LOSS_RTOL, (losses, want)
    assert rel_err(norms, want["grad_norm"]) <= NORM_RTOL, (norms, want)
    assert losses[-1] < losses[0]


def test_zero_with_a_model_axis_is_refused(reference_run):
    """Nothing refuses ZeRO-1 with Adafactor on (data 2, model 2): each
    rank holds 1/2 of its data rank's chunk of every whole param (flat,
    unfactored), the data replicas of a model coordinate the same
    params, and the run is the reference's ZeRO-1 run on its (2, 2) host
    mesh within ``LOSS_RTOL`` / ``NORM_RTOL``."""
    ref, trees, _ = reference_run
    mesh = substrate.make_host_mesh(2, model_parallel=2, device="cpu")
    lengths = []

    def check(states, step):
        for r, st in enumerate(states):
            twin = states[mesh.coords(r)["model"]]
            for a, b in zip(leaves(twin["params"]), leaves(st["params"])):
                assert torch.equal(a, b), (r, step)
        lengths.append([{k: tuple(v.shape) for k, v in
                         s["opt"]["f"]["lm_head"].items()} for s in states])

    losses, norms = train(ARCH, trees[ARCH], mesh, check, zero=True,
                          overlap=True)
    cfg = get_config(ARCH, reduced=True)
    c = -(-cfg.d_model * cfg.vocab_size // 2)       # a data rank's chunk
    assert lengths[0] == [{"v": (-(-c // 2),)}] * 4
    want = ref[f"{ARCH}/zero2x2"]
    assert rel_err(losses, want["loss"]) <= LOSS_RTOL, (losses, want)
    assert rel_err(norms, want["grad_norm"]) <= NORM_RTOL, (norms, want)
    assert losses[-1] < losses[0]


def test_zero_over_a_model_axis_sums_as_the_smoke_plans():
    """One ZeRO-1 + Adafactor step of reduced mistral-large-123b on (data
    2, model 2): each rank sums over "model" (``sharding.psum``) as often
    as ``chip_smoke.py`` plans it for [train_adafactor]: ``tp_psums``
    plus ``adafactor_psums(zero=True)``, one clip sum a leaf."""
    from test_torch_tp_families import _smoke
    cfg = get_config(ARCH, reduced=True)
    model = build_model(cfg, model_parallel=2)
    opt = adafactor()
    tcfg = trainer.TrainCfg(zero=True)
    mesh = substrate.make_host_mesh(2, model_parallel=2, device="cpu")
    ds = SyntheticLMDataset(vocab_size=cfg.vocab_size, seq_len=16,
                            global_batch=4)
    step = trainer.make_train_step(model, opt, tcfg, comm=build_session(
        mesh, model, opt, ds, tcfg).world)
    states = trainer.init_states(
        model, opt, build_model(cfg).init(torch.Generator().manual_seed(0)),
        tcfg, mesh)
    calls = [0]
    psum = sharding.psum

    def counted(x):
        calls[0] += 1
        return psum(x)

    sharding.psum = counted
    try:
        step(states, ds.host_batch(0))
    finally:
        sharding.psum = psum
    smoke = _smoke()
    want = smoke.tp_psums(model) + smoke.adafactor_psums(model, opt,
                                                         zero=True)
    assert want > smoke.tp_psums(model)
    assert calls[0] == 4 * want


@pytest.mark.parametrize("m", [2, 4])
def test_zero_over_a_model_axis_clips_the_references_chunk(m):
    """ZeRO-1 + Adafactor with its update-RMS clip engaged (threshold
    0.1): reduced mistral-large-123b on (data 2, model ``m``), each rank
    a piece of its data rank's chunk, follows (data 2, model 1), whose
    ranks hold the reference's chunks whole, over 3 steps: losses and
    gradient norms within 5e-6 relative (f32, the sums in another
    order; largest readings 7.8e-8 and 1.2e-7), and the gathered states
    within 1e-5 of each leaf's largest value (1.6e-6).  A clip over each
    rank's piece alone, not summed over "model", fails it."""
    cfg = get_config(ARCH, reduced=True)
    params = build_model(cfg).init(torch.Generator().manual_seed(3))
    ds = SyntheticLMDataset(vocab_size=cfg.vocab_size, seq_len=16,
                            global_batch=4, seed=2)
    runs = {}
    for model_parallel in (1, m):
        sess = trainer.TrainSession(
            build_model(cfg, model_parallel=model_parallel),
            adafactor(clip_threshold=0.1), trainer.TrainCfg(zero=True))
        mesh = substrate.make_host_mesh(2, model_parallel=model_parallel,
                                        device="cpu")
        states = trainer.init_states(sess.model, sess.optimizer,
                                     map_tree(torch.clone, params),
                                     sess.cfg, mesh)
        step = sess.step_fn(build_session(mesh, sess.model, sess.optimizer,
                                          ds, sess.cfg).world)
        losses, norms = [], []
        for i in range(3):
            states, metrics = step(states, ds.host_batch(i))
            losses.append(metrics["loss"].item())
            norms.append(metrics["grad_norm"].item())
        runs[model_parallel] = (losses, norms, trainer.logical_state(
            sess.gather(states, mesh)))
    (l1, n1, s1), (lm, nm, sm) = runs[1], runs[m]
    assert rel_err(lm, l1) <= 5e-6, (lm, l1)
    assert rel_err(nm, n1) <= 5e-6, (nm, n1)
    gl, paths = flatten(sm)
    for path, a, b in zip(paths, gl, leaves(s1)):
        if a.is_floating_point():
            assert rel_err(a.numpy(), b.numpy()) <= 1e-5, path
