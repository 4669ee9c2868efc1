"""The port stands alone: nothing under ``src/repro_torch`` nor
``chip_smoke.py`` imports JAX or the JAX package, and importing the
serving and training entry points, the schedule IR, the checkpoint
store, the elastic runtime, the collective library's protocol
modules, the multi-axis modules (two-phase protocols, the model split),
the state-space block and configs, and the embeddings families'
frontends, encoder-decoder and configs leaves ``jax`` out of ``sys.modules``.
The elastic launchers, like the others, run on ``cuda`` unless asked for
the CPU, and raise without CUDA."""

import ast
import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "repro")


def _port_files():
    root = os.path.join(REPO, "src", "repro_torch")
    files = [os.path.join(d, f) for d, _, fs in os.walk(root)
             for f in fs if f.endswith(".py")]
    return sorted(files) + [os.path.join(REPO, "chip_smoke.py")]


def _imported_roots(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_port_file_imports_no_jax_or_reference(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{os.path.relpath(path, REPO)} imports {bad}"


def _imports_without_jax(modules):
    code = (f"import sys, {', '.join(modules)}; "
            "bad = sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'jaxlib', 'repro')); "
            "assert not bad, bad")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]


def test_serving_entry_points_import_without_jax():
    _imports_without_jax(["repro_torch.serve", "repro_torch.launch.serve",
                          "repro_torch.kernels.flash_attention.kernel"])


def test_state_space_modules_import_without_jax():
    _imports_without_jax(["repro_torch.models.mamba",
                          "repro_torch.configs.mamba2_1_3b",
                          "repro_torch.configs.jamba_1_5_large_398b",
                          "repro_torch.configs.shapes"])


def test_embeddings_families_import_without_jax():
    _imports_without_jax(["repro_torch.models.frontends",
                          "repro_torch.models.encdec",
                          "repro_torch.configs.qwen2_vl_7b",
                          "repro_torch.configs.seamless_m4t_large_v2",
                          "repro_torch.data.pipeline"])


def test_training_entry_points_import_without_jax():
    _imports_without_jax(["repro_torch.launch.train", "repro_torch.comm",
                          "repro_torch.kernels.local_reduce.ops",
                          "repro_torch.kernels.quantize.ops"])


def test_schedule_and_checkpoint_modules_import_without_jax():
    _imports_without_jax(["repro_torch.core.schedule",
                          "repro_torch.core.plan",
                          "repro_torch.checkpoint",
                          "repro_torch.train.trainer"])


def test_elastic_entry_points_import_without_jax():
    _imports_without_jax(["repro_torch.runtime.controller",
                          "repro_torch.runtime.ctrlplane",
                          "repro_torch.runtime.health",
                          "repro_torch.runtime.elastic",
                          "repro_torch.runtime.watchdog",
                          "repro_torch.serve.controller",
                          "repro_torch.serve.state"])


@pytest.mark.parametrize("launcher,argv", [
    ("train", ["--elastic", "--fault-plan", "lose@1:1", "--ckpt-dir",
               "unused", "--steps", "1"]),
    ("serve", ["--elastic", "--data", "2", "--fault-plan", "lose@1:1"])])
def test_elastic_launchers_run_on_cuda_unless_asked(launcher, argv):
    if torch.cuda.is_available():
        pytest.skip("checks the no-CUDA refusal")
    import importlib
    mod = importlib.import_module(f"repro_torch.launch.{launcher}")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mod.main(argv)


def test_collective_library_modules_import_without_jax():
    _imports_without_jax(["repro_torch.core.protocols.xla",
                          "repro_torch.core.protocols.tree",
                          "repro_torch.core.protocols.bruck",
                          "repro_torch.core.protocols.pipeline",
                          "repro_torch.comm.collectives"])


def test_multi_axis_modules_import_without_jax():
    _imports_without_jax(["repro_torch.core.protocols.twophase",
                          "repro_torch.parallel.sharding",
                          "repro_torch.models.model",
                          "repro_torch.models.convert"])
