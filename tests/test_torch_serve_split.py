"""Serving split over "data" and "model" on the CPU, against the
reference.

The reference's dry-run places a prefill or decode cell's params by its
``param_specs``, its caches by ``serve_cache_shardings`` (heads over
"model", or the sequence where the K/V heads do not divide) and its
logits over (("pod", "data"), "model").  Here the port's ranks
(``Model.rank_params``, ``Model.init_caches`` inside the rank,
``Model.prefill`` and three ``Model.decode_step``s on the rank's rows)
are held to the reference's reduced model run so on a host mesh of the
same shape (jitted under the mesh with those shardings, so that its MoE
layers route each data shard's tokens as the port's data ranks do):

- the logits, each rank's vocabulary block of its rows joined, within
  ``LOGITS_TOL`` = 1e-5 of the reference's at the prefill and at every
  decode step, and every rank's ``Model.argmax`` equal to the joined
  rows' argmax;
- every rank's cache blocks after the last step within ``CACHE_TOL`` =
  1e-5 of the reference's addressable shard on the device at the rank's
  coordinates, the ``len`` counters bit-equal.

Both tolerances are the repo's relative measure (``_rel``): the largest
difference over the largest magnitude of the reference's values.

Caches hold ``MAX_LEN`` = 1024 positions, so that the fit's sequence
rule (a dim of at least 1024) applies.  Where it splits the sequence
(granite-34b's one K/V head, qwen2-72b's two over four model ranks,
deepseek-v3's latents) the prompt ends 2 positions short of a block
boundary, so that the third decode step writes the next block's first
position; Mamba prompts are a multiple of the SSD chunk (8).  The
reference's runs come from one child interpreter with 4 host devices.
"""

import json
import threading

import numpy as np
import pytest
import torch

from conftest import run_subprocess_script
from repro_torch.configs import get_config
from repro_torch.data.pipeline import shard_batch
from repro_torch.models import build_model
from repro_torch.models.convert import params_from_numpy
from repro_torch.parallel import sharding
from repro_torch.runtime import substrate
from repro_torch.tree import flatten, unflatten

LOGITS_TOL = CACHE_TOL = 1e-5
MAX_LEN, BATCH, STEPS = 1024, 4, 3
#: (case id, arch, (pods, data, model), prompt length)
CASES = [
    ("granite-1x2", "granite-34b", (1, 1, 2), 510),
    ("granite-2x2", "granite-34b", (1, 2, 2), 510),
    ("qwen2-1x4", "qwen2-72b", (1, 1, 4), 254),
    ("qwen2-2x2", "qwen2-72b", (1, 2, 2), 510),
    ("qwen2-pod", "qwen2-72b", (2, 1, 2), 510),
    ("deepseek-2x2", "deepseek-v3-671b", (1, 2, 2), 510),
    ("mamba2-2x2", "mamba2-1.3b", (1, 2, 2), 504),
    ("jamba-2x2", "jamba-1.5-large-398b", (1, 2, 2), 504),
    ("qwen2vl-2x2", "qwen2-vl-7b", (1, 2, 2), 510),
    ("seamless-2x2", "seamless-m4t-large-v2", (1, 2, 2), 6),
]
#: seamless's memory: enough frames for the fit to split them
ENC_LEN = 1024


def _rel(got: torch.Tensor, want) -> float:
    want = torch.as_tensor(want, dtype=torch.float64)
    return float((got.double() - want).abs().max()
                 / max(float(want.abs().max()), 1e-30))


def _inputs(arch, cfg, prompt):
    """(the prompt batch, the decode steps' batches), numpy, global."""
    rng = np.random.default_rng([11, len(arch), prompt])
    b = BATCH
    if arch == "seamless-m4t-large-v2":
        pre = {"frame_embeds": rng.standard_normal(
            (b, ENC_LEN, cfg.d_model)).astype(np.float32) * np.float32(0.05),
            "tokens": rng.integers(0, cfg.vocab_size,
                                   (b, prompt)).astype(np.int32)}
    elif arch == "qwen2-vl-7b":
        pos = np.broadcast_to(np.arange(prompt, dtype=np.int32),
                              (3, b, prompt)).copy()
        pos[1, :, :prompt // 2] //= 4            # a patch grid's rows,
        pos[2, :, :prompt // 2] %= 4             # and its columns
        pos[:, :, prompt // 2:] += 3 * np.arange(b, dtype=np.int32)[
            None, :, None]
        pre = {"inputs_embeds": rng.standard_normal(
            (b, prompt, cfg.d_model)).astype(np.float32) * np.float32(0.02),
            "positions": pos}
    else:
        pre = {"tokens": rng.integers(0, cfg.vocab_size,
                                      (b, prompt)).astype(np.int32)}
    steps = []
    for i in range(STEPS):
        if arch == "qwen2-vl-7b":
            nxt = pre["positions"][:, :, -1:] + 1 + i
            steps.append({"inputs_embeds": rng.standard_normal(
                (b, 1, cfg.d_model)).astype(np.float32) * np.float32(0.02),
                "positions": nxt.astype(np.int32)})
        else:
            steps.append({"tokens": rng.integers(
                0, cfg.vocab_size, (b, 1)).astype(np.int32)})
    return pre, steps


REFERENCE_CHILD = """
import json, os
os.environ["XLA_FLAGS"] += (" --xla_backend_optimization_level=0"
                            " --xla_llvm_disable_expensive_passes=true")
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from repro.configs import get_config
from repro.launch.dryrun import fit_shardings, fit_spec, serve_cache_shardings
from repro.models import build_model
from repro.runtime import substrate
from repro.serve import paging
from repro.train import trainer
path, max_len, batch, enc_len = {path!r}, {max_len}, {batch}, {enc_len}
out, shards, done = {{}}, {{}}, set()
for case, arch, shape, prompt in {cases}:
    cfg = get_config(arch, reduced=True)
    model = build_model(cfg)
    params = model.init(jax.random.PRNGKey(0))
    if arch not in done:
        done.add(arch)
        np.savez(path + "_" + arch + ".npz", **{{
            "/".join(str(k.key) for k in p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(params)[0]}})
    names = (("pod",) if shape[0] > 1 else ()) + ("data", "model")
    dims = shape if shape[0] > 1 else shape[1:]
    n = int(np.prod(dims))
    mesh = Mesh(np.array(jax.devices()[:n]).reshape(dims), names)
    el = enc_len if model.kind == "encdec" else 0
    cache_sh, _ = serve_cache_shardings(model, mesh, batch, max_len,
                                        enc_len=el)
    logits_sh = NamedSharding(mesh, fit_spec(
        P(("pod", "data"), "model"), (batch, cfg.vocab_size), mesh))
    params_sh = fit_shardings(model.param_specs(), params, mesh)

    def put(b):
        return jax.device_put(b, fit_shardings(trainer.batch_specs(b), b,
                                               mesh))

    logits = []
    with substrate.set_mesh(mesh):
        params = jax.device_put(params, params_sh)
        caches = jax.device_put(paging.contiguous_caches(
            model, batch, max_len, dtype=jnp.float32, enc_len=el), cache_sh)
        pre = dict(np.load(path + "_" + case + "_in0.npz"))
        run = jax.jit(model.prefill, out_shardings=(logits_sh, cache_sh))
        lg, caches = run(params, put(pre), caches)
        logits.append(np.asarray(lg))
        step = jax.jit(model.decode_step, out_shardings=(logits_sh, cache_sh),
                       donate_argnums=(2,))
        for i in range({steps}):
            b = dict(np.load(path + "_" + case + f"_in{{i + 1}}.npz"))
            lg, caches = step(params, put(b), caches)
            logits.append(np.asarray(lg))
    out[case] = [l.tolist() for l in logits]
    devs = mesh.devices
    for p, leaf in jax.tree_util.tree_flatten_with_path(caches)[0]:
        name = "/".join(str(k.key) for k in p)
        for s in leaf.addressable_shards:
            c = [int(v) for v in np.argwhere(devs == s.device)[0]]
            key = case + "@" + ",".join(map(str, c)) + "@" + name
            shards[key] = np.asarray(s.data)
np.savez(path + "_shards.npz", **shards)
print("LOGITS", json.dumps(out))
"""

_CHILD = {}


@pytest.fixture(scope="module", autouse=True)
def _reference_started(tmp_path_factory):
    """Start the reference child on a thread, once."""
    if "thread" in _CHILD:
        return
    path = str(tmp_path_factory.mktemp("ref") / "run")
    for case, arch, _, prompt in CASES:
        pre, steps = _inputs(arch, get_config(arch, reduced=True), prompt)
        for i, b in enumerate([pre] + steps):
            np.savez(f"{path}_{case}_in{i}.npz", **b)
    code = REFERENCE_CHILD.format(path=path, max_len=MAX_LEN, batch=BATCH,
                                  enc_len=ENC_LEN, cases=CASES, steps=STEPS)

    def run():
        try:
            _CHILD["out"] = run_subprocess_script(code, devices=4,
                                                  timeout=600)
        except BaseException as e:      # a skip too: raised in the test
            _CHILD["error"] = e

    _CHILD["path"] = path
    _CHILD["thread"] = threading.Thread(target=run, daemon=True)
    _CHILD["thread"].start()


@pytest.fixture(scope="module")
def reference():
    """({case: [logits a step]}, {arch: weights}, {"case@coords@path":
    cache shard})."""
    _CHILD["thread"].join()
    if "error" in _CHILD:
        raise _CHILD["error"]
    path = _CHILD["path"]
    line = next(l for l in _CHILD["out"].splitlines()
                if l.startswith("LOGITS "))
    trees = {}
    for _, arch, _, _ in CASES:
        w = np.load(f"{path}_{arch}.npz")
        trees[arch] = unflatten([tuple(k.split("/")) for k in w.files],
                                [w[k] for k in w.files])
    return (json.loads(line[len("LOGITS "):]), trees,
            dict(np.load(f"{path}_shards.npz")))


def _serve(arch, shape, prompt, tree):
    """Each rank's (logits, argmax) a step and its caches after the last
    step, on a thread mesh of ``shape``."""
    cfg = get_config(arch, reduced=True)
    pods, data, model_parallel = shape
    mesh = substrate.make_host_mesh(data, model_parallel=model_parallel,
                                    pods=pods, device="cpu")
    model = build_model(cfg, model_parallel=model_parallel)
    full = params_from_numpy(tree, cfg, device="cpu")
    pre, steps = _inputs(arch, cfg, prompt)
    axes = sharding.row_axes(mesh.shape, BATCH)
    batches = [shard_batch(b, mesh, axes) for b in [pre] + steps]
    enc_len = ENC_LEN if model.kind == "encdec" else 0

    def rank(params, *bs):
        caches = model.init_caches(BATCH, MAX_LEN, enc_len=enc_len,
                                   dtype=torch.float32, device="cpu")
        outs = []
        logits, caches = model.prefill(params, bs[0], caches)
        outs.append((logits, model.argmax(logits)))
        for b in bs[1:]:
            logits, caches = model.decode_step(params, b, caches)
            outs.append((logits, model.argmax(logits)))
        return outs, caches

    args = [(model.rank_params(full, mesh, r), *[b[r] for b in batches])
            for r in range(mesh.size)]
    return mesh, axes, substrate.run_spmd(rank, args, mesh)


@pytest.mark.parametrize("case,arch,shape,prompt", CASES,
                         ids=[c[0] for c in CASES])
def test_split_serving_matches_the_reference(reference, case, arch, shape,
                                             prompt):
    ref_logits, trees, shards = reference
    mesh, axes, out = _serve(arch, shape, prompt, trees[arch])
    rows = int(np.prod([mesh.shape[a] for a in axes]))
    for step, want in enumerate(ref_logits[case]):
        want = torch.tensor(want)
        got = torch.full_like(want, float("nan"))
        for r, (steps, _) in enumerate(out):
            c = mesh.coords(r)
            d = sharding.block_index(axes, mesh.shape, c)[0]
            logits, top = steps[step]
            lo, v = d * (BATCH // rows), logits.shape[-1]
            cols = slice(c["model"] * v, (c["model"] + 1) * v)
            got[lo:lo + logits.shape[0], cols] = logits
            assert torch.equal(top, want[lo:lo + logits.shape[0]]
                               .argmax(-1)), (case, step, r)
        err = _rel(got, want)
        assert err <= LOGITS_TOL, (case, step, err)
    split_seq = False
    for r, (_, caches) in enumerate(out):
        coords = ",".join(str(mesh.coords(r)[a]) for a in mesh.axis_names)
        for path, leaf in zip(*flatten(caches)[::-1]):
            want = shards[f"{case}@{coords}@{'/'.join(path)}"]
            assert tuple(leaf.shape) == want.shape, (case, r, path)
            if path[-1] == "len":
                assert torch.equal(leaf, torch.from_numpy(want)), path
            else:
                err = _rel(leaf, want)
                assert err <= CACHE_TOL, (case, r, path, err)
        split_seq |= any("model" in sharding.entry_axes(s[2])
                         for p, s in zip(caches.split.paths,
                                         caches.split.specs)
                         if p[-1] in ("k", "ckv"))
    # where the sequence splits, the third decode step crosses a block
    if split_seq:
        block = MAX_LEN // mesh.shape["model"]
        assert prompt % block == block - 2 and STEPS >= 3, case


def test_init_caches_are_the_splits_blocks():
    """A model split over "model" gives the rank its blocks of the
    caches (no longer a refusal), each the shape ``cache_split`` says."""
    cfg = get_config("granite-34b", reduced=True)
    model = build_model(cfg, model_parallel=2)
    mesh = substrate.abstract_mesh((2, 2), ("data", "model"))
    specs, whole = sharding.cache_split(model, mesh.shape, BATCH, MAX_LEN)
    for r in range(mesh.size):
        caches = model.init_caches(BATCH, MAX_LEN, device="meta",
                                   mesh=mesh, rank=r)
        assert isinstance(caches, sharding.CacheBlocks)
        for leaf, w, spec in zip(flatten(caches)[0], flatten(whole)[0],
                                 specs):
            n = [int(np.prod([mesh.shape[a] for a in
                              sharding.entry_axes(e)])) for e in spec]
            assert tuple(leaf.shape) == tuple(d // k for d, k in
                                              zip(w.shape, n))
    with pytest.raises(ValueError, match="serves from the blocks"):
        model.prefill({}, {}, {})
