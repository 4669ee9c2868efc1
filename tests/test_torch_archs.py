"""Every architecture the port registers against the JAX package: the
twin of ``tests/test_archs.py``, on the CPU.

For each of the reference's ten archs the reference's reduced config is
initialised by JAX and carried into the port with ``params_from_numpy``,
and both packages take the same numpy batch (``_batch``, the twin of
``tests/test_archs.py``'s ``make_batch``: tokens; qwen2-vl-7b's
``inputs_embeds`` and the stub's 3-D positions; seamless's
``frame_embeds`` beside the decoder's tokens):

- logits of the same batch within 1e-5 of the largest reference logit
  (f32; the packages sum in different orders);
- the loss (NLL + the MoE aux loss + the MTP term where the config has
  it) and each metric within 1e-5 relative;
- every gradient within 1e-4 of its leaf's largest reference value (a
  leaf whose reference gradient is 0 everywhere within 1e-10);
- 5 AdamW steps on one batch lower the loss (the reference's
  ``test_smoke_train_step_improves``);
- prefill of half the tokens plus 3 decode steps give the teacher-forced
  forward's logits within 8e-3, as the reference's test holds its own
  (qwen2-vl-7b with explicit (3, B, 1) positions, which the reference's
  test skips; its decode logits are also held within 1e-5 of the
  reference's ``Model.decode_step`` on the same inputs);
- the full published config's parameter count, from ``meta`` tensors,
  equal to the reference's ``param_count()``;
- both launchers run mistral-large-123b, nemotron-4-340b,
  deepseek-v3-671b and the two state-space archs reduced on the CPU, and
  refuse qwen2-vl-7b and seamless-m4t-large-v2 (as the scheduler does);
- the registry's metadata: each ``ArchInfo``'s family, skipped shapes
  and embeddings flag, ``SHAPES`` and the cells equal the reference's
  for the port's archs; only the state-space archs run ``long_500k``;
  ``with_num_layers`` cuts inside a stage pattern (jamba at 4 layers)
  and leaves deepseek's 4-layer cut as it was.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.configs import SHAPES as JSHAPES
from repro.configs import cells as jcells
from repro.configs import get_config as jget_config
from repro.models import build_model as jbuild_model
from repro_torch.configs import (ARCH_IDS, ARCHS, SHAPES, cells, get_arch,
                                 get_config, with_num_layers)
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train as launch_train
from repro_torch.models import build_model, frontends
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.encdec import EncDecCfg
from repro_torch.optim import make_optimizer
from repro_torch.serve import BatchScheduler, ServeCfg
from repro_torch.tree import flatten, unflatten

B, S = 2, 32
LOGIT_TOL = 1e-5
LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
DECODE_TOL = 8e-3


@functools.lru_cache(maxsize=None)
def _pair(arch):
    jm = jbuild_model(jget_config(arch, reduced=True))
    jp = jm.init(jax.random.PRNGKey(0))
    tm = build_model(get_config(arch, reduced=True))
    tp = params_from_numpy(jax.device_get(jp), tm.cfg, device="cpu")
    return jm, jp, tm, tp


def _batch(seed=0, arch=None):
    """A numpy batch for ``arch``'s reduced config (tokens when None)."""
    rng = np.random.RandomState(seed)
    out = {"tokens": rng.randint(0, 256, (B, S)),
           "labels": rng.randint(0, 256, (B, S))}
    cfg = None if arch is None else get_config(arch, reduced=True)
    if isinstance(cfg, EncDecCfg):
        out["frame_embeds"] = (rng.randn(B, S, cfg.d_model) * 0.05
                               ).astype(np.float32)
    elif cfg is not None and not cfg.embed_inputs:
        out = {"inputs_embeds": (rng.randn(B, S, cfg.d_model) * 0.02
                                 ).astype(np.float32),
               "positions": frontends.vision_positions(B, S).numpy(),
               "labels": out["labels"]}
    return out


@functools.lru_cache(maxsize=None)
def _reference(arch):
    """The reference's logits, (loss, metrics) and gradients on
    ``_batch()``, from one jitted function."""
    jm, jp, _, _ = _pair(arch)

    def run(p, b):
        return jm.logits(p, b), jax.value_and_grad(jm.loss, has_aux=True)(
            p, b)

    return jax.device_get(jax.jit(run)(jp, _jax(_batch(arch=arch))))


def _jax(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _torch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _rel(got, want):
    want = np.asarray(want, np.float64)
    got = np.asarray(got, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def test_port_registers_the_six_archs():
    """The six archs of the earlier slices, the two state-space ones and
    the two embeddings ones: all ten of the reference's."""
    assert set(ARCH_IDS) == {"granite-34b", "qwen2-72b", "qwen3-moe-30b-a3b",
                             "mistral-large-123b", "nemotron-4-340b",
                             "deepseek-v3-671b", "mamba2-1.3b",
                             "jamba-1.5-large-398b", "qwen2-vl-7b",
                             "seamless-m4t-large-v2"}
    assert set(ARCH_IDS) == set(JARCHS)


def test_long_500k_applicability_flags():
    """The twin of ``tests/test_archs.py``'s, over the port's archs:
    SSM and hybrid archs run long_500k, pure-attention archs skip it."""
    runs = {a for a in ARCH_IDS if "long_500k" not in ARCHS[a].skip_shapes}
    assert runs == {"jamba-1.5-large-398b", "mamba2-1.3b"}
    for a in ARCH_IDS:
        if ARCHS[a].family in ("ssm", "hybrid"):
            assert a in runs


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_arch_info_and_shapes_equal_the_reference(arch):
    got, want = get_arch(arch), JARCHS[arch]
    assert (got.arch_id, got.family, got.skip_shapes, got.uses_embeds) == (
        want.arch_id, want.family, want.skip_shapes, want.uses_embeds)
    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in JSHAPES.items()}
    assert [c for c in cells(include_skipped=True) if c[0] == arch] == [
        c for c in jcells(include_skipped=True) if c[0] == arch]


def test_with_num_layers_cuts_inside_a_stage_pattern():
    jamba = with_num_layers(get_config("jamba-1.5-large-398b"), 4)
    assert [(st.repeat, [(l.mixer, l.ffn) for l in st.layers])
            for st in jamba.stages] == [(1, [("attn", "dense"),
                                             ("mamba", "moe"),
                                             ("mamba", "dense"),
                                             ("mamba", "moe")])]
    assert [(l.mixer, l.ffn) for l in jamba.stages[0].layers] == [
        (l.mixer, l.ffn) for l in jget_config(
            "jamba-1.5-large-398b", reduced=True).stages[0].layers]
    assert jamba.d_model == 8192 and jamba.num_layers == 4
    deepseek = with_num_layers(get_config("deepseek-v3-671b"), 4)
    assert [(st.repeat, [(l.mixer, l.ffn) for l in st.layers])
            for st in deepseek.stages] == [(3, [("mla", "dense")]),
                                           (1, [("mla", "moe")])]
    nine = with_num_layers(get_config("jamba-1.5-large-398b"), 9)
    assert [(st.repeat, len(st.layers)) for st in nine.stages] == [(1, 8),
                                                                   (1, 1)]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_reduced_logits_match_reference(arch):
    _, _, tm, tp = _pair(arch)
    want = _reference(arch)[0]
    got = tm.logits(tp, _torch(_batch(arch=arch)))
    assert got.shape == (B, S, tm.cfg.vocab_size)
    assert _rel(got.numpy(), want) <= LOGIT_TOL


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_reduced_loss_and_grads_match_reference(arch):
    _, _, tm, tp = _pair(arch)
    (jloss, jmet), jgrads = _reference(arch)[1]
    ps, paths = flatten(tp)
    xs = [t.detach().requires_grad_(True) for t in ps]
    tloss, tmet = tm.loss(unflatten(paths, xs), _torch(_batch(arch=arch)))
    tgrads = torch.autograd.grad(tloss, xs)
    assert set(tmet) == set(jmet)
    assert ("mtp" in tmet) == (getattr(tm.cfg, "mtp", False)
                               and getattr(tm.cfg, "embed_inputs", True))
    assert abs(tloss.item() - float(jloss)) <= LOSS_TOL * abs(float(jloss))
    for k in jmet:
        assert abs(tmet[k].item() - float(jmet[k])) <= LOSS_TOL * max(
            abs(float(jmet[k])), 1e-30), k
    jg, jpaths = flatten(jgrads)
    assert jpaths == paths
    for path, want, got in zip(paths, jg, tgrads):
        if not np.abs(want).max():
            assert got.abs().max().item() <= 1e-10, "/".join(path)
        else:
            assert _rel(got.numpy(), want) <= GRAD_TOL, "/".join(path)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_train_steps_on_one_batch_lower_the_loss(arch):
    _, _, tm, tp = _pair(arch)
    leaves, paths = flatten(tp)
    params = unflatten(paths, [t.clone() for t in leaves])
    opt = make_optimizer("adamw", lr=5e-3)
    state = opt.init(params)
    b = _torch(_batch(2, arch))
    losses = []
    for _ in range(5):
        loss, grads = tm.loss_and_grads(params, b)
        params, state, _ = opt.update(grads, state, params)
        losses.append(loss.item())
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0], losses


def _steps(batch, half):
    """(the prefill batch of the first ``half`` positions, the decode
    batches of the next 3): tokens, or embeddings with their (3, B, 1)
    positions; an enc-dec's frames go whole into the prefill."""
    def cut(a, b):
        out = {}
        for k, v in batch.items():
            if k == "positions":
                out[k] = v[:, :, a:b]
            elif k in ("tokens", "inputs_embeds"):
                out[k] = v[:, a:b]
        return out
    pre = cut(0, half)
    if "frame_embeds" in batch:
        pre["frame_embeds"] = batch["frame_embeds"]
    return pre, [cut(t, t + 1) for t in range(half, half + 3)]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_prefill_and_decode_match_the_teacher_forced_forward(arch):
    cfg = get_config(arch, reduced=True)
    if getattr(cfg, "moe", None) is not None:   # capacity drops depend on
        cfg = dataclasses.replace(                 # the token count
            cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=8.0))
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    batch = _torch(_batch(3, arch))
    batch.pop("labels")
    full = model.logits(params, batch)
    caches = model.init_caches(B, S + 8, enc_len=S, dtype=torch.float32,
                               device="cpu")
    half = S // 2
    pre, steps = _steps(batch, half)
    logits, caches = model.prefill(params, pre, caches)
    torch.testing.assert_close(logits, full[:, half - 1], rtol=DECODE_TOL,
                               atol=DECODE_TOL)
    for t, step in zip(range(half, half + 3), steps):
        logits, caches = model.decode_step(params, step, caches)
        torch.testing.assert_close(logits, full[:, t], rtol=DECODE_TOL,
                                   atol=DECODE_TOL)


def test_vl_decode_with_positions_matches_reference_decode_step():
    """qwen2-vl-7b: prefill of the first half, then 3 decode steps with
    explicit (3, B, 1) positions, in both packages from the same weights:
    logits within 1e-5 (the reference's own test skips the VLM, since its
    default decode positions are text positions)."""
    arch = "qwen2-vl-7b"
    jm, jp, tm, tp = _pair(arch)
    batch = _batch(4, arch)
    batch.pop("labels")
    half = S // 2
    pre, steps = _steps(batch, half)
    jc = jm.init_caches(B, S, dtype=jnp.float32)
    tc = tm.init_caches(B, S, dtype=torch.float32, device="cpu")
    for i, b in enumerate([pre] + steps):
        if i == 0:
            want, jc = jm.prefill(jp, _jax(b), jc)
            got, tc = tm.prefill(tp, _torch(b), tc)
        else:
            want, jc = jm.decode_step(jp, _jax(b), jc)
            got, tc = tm.decode_step(tp, _torch(b), tc)
        assert _rel(got.numpy(), want) <= LOGIT_TOL, i
    # the default (text) positions are not the stub's: they give others
    got_text, _ = tm.decode_step(tp, {"inputs_embeds": _torch(steps[0])[
        "inputs_embeds"]}, tm.init_caches(B, S, dtype=torch.float32,
                                          device="cpu"))
    want_text, _ = jm.decode_step(jp, {"inputs_embeds": jnp.asarray(
        steps[0]["inputs_embeds"])}, jm.init_caches(B, S, dtype=jnp.float32))
    assert _rel(got_text.numpy(), want_text) <= LOGIT_TOL


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_full_param_count_equals_reference(arch):
    assert (build_model(get_config(arch)).param_count()
            == jbuild_model(jget_config(arch)).param_count())


@pytest.mark.parametrize("arch", ["mistral-large-123b", "nemotron-4-340b",
                                  "deepseek-v3-671b", "mamba2-1.3b",
                                  "jamba-1.5-large-398b"])
def test_launchers_run_the_arch_on_the_cpu(arch, caplog):
    caplog.set_level("INFO")
    launch_serve.main(["--device", "cpu", "--arch", arch, "--reduced",
                       "--requests", "3", "--max-new", "3"])
    assert "served 3 requests (0 shed)" in caplog.text
    launch_train.main(["--device", "cpu", "--arch", arch, "--reduced",
                       "--data", "2", "--steps", "2", "--seq-len", "16",
                       "--global-batch", "4", "--log-every", "1"])
    assert "step    1  loss" in caplog.text


@pytest.mark.parametrize("arch", ["qwen2-vl-7b", "seamless-m4t-large-v2"])
def test_embeddings_archs_are_refused_by_the_token_entry_points(arch):
    """The scheduler and the serve launcher feed token ids only (the
    reference's scheduler does too, and its serve launcher refuses the
    enc-dec); the train launcher's batches carry no embeddings."""
    model = build_model(get_config(arch, reduced=True))
    params = model.init(torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="token ids only"):
        BatchScheduler(model, params, ServeCfg(max_len=32, batch=2),
                       device="cpu")
    with pytest.raises(SystemExit, match="token ids only"):
        launch_serve.main(["--device", "cpu", "--arch", arch, "--reduced",
                           "--requests", "1", "--max-new", "1"])
    needs = ("frame_embeds" if model.kind == "encdec"
             else "inputs_embeds, positions")
    with pytest.raises(SystemExit, match=needs):
        launch_train.main(["--device", "cpu", "--arch", arch, "--reduced",
                           "--steps", "1"])
