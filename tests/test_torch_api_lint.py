"""``tools/check_api_torch.py`` wired into tier-1, the twin of
``tests/test_api_lint.py``: the port's own training, serving and
elastic paths route distributed work through ``repro_torch.comm``, and
each of the six rules catches a violation planted in a temporary file.
No JAX here."""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools"))

import check_api_torch as lint  # noqa: E402


def _planted(tmp_path, src: str):
    path = tmp_path / "planted.py"
    path.write_text(src)
    return lint.check_paths([str(path)])


def test_repo_is_clean():
    violations = lint.check_paths(lint.DEFAULT_ROOTS)
    assert not violations, "\n".join(violations)


def test_lint_catches_engine_construction(tmp_path):
    out = _planted(tmp_path, "from repro_torch.core.engine import "
                             "CollectiveEngine\ne = CollectiveEngine(topo)\n")
    assert len(out) == 1 and "CollectiveEngine" in out[0]
    assert _planted(tmp_path, "import repro_torch.core.engine as E\n"
                              "e = E.CollectiveEngine(topo)\n")
    out = _planted(tmp_path, "e = CollectiveEngine.monolithic(topo)\n")
    assert out and "monolithic" in out[0]


def test_lint_catches_direct_hops_and_transports(tmp_path):
    for snippet in ("from repro_torch.runtime import substrate\n"
                    "y = substrate.ppermute(x, 'data', [(0, 1)])\n",
                    "from repro_torch.runtime.substrate import ppermute\n",
                    "t = substrate.ThreadTransport(mesh)\n",
                    "import torch.distributed as dist\n"
                    "dist.all_reduce(x)\n",
                    "import torch.distributed\n"
                    "torch.distributed.all_gather(out, x)\n",
                    "from torch import distributed as d\nd.send(x, 1)\n",
                    "from torch.distributed import all_reduce\n"):
        out = _planted(tmp_path, snippet)
        assert out and "repro_torch.comm" in out[0], snippet
    # the facade, and the substrate's own module, stay allowed
    ok = ("from repro_torch.comm import collectives\n"
          "y = collectives.psum(x, 'model')\n"
          "out = substrate.run_spmd(fn, args, mesh)\n"
          "n = substrate.sent_bytes()\n")
    assert not _planted(tmp_path, ok)
    assert not lint.check_source("y = ppermute(x, 'data', p)\n",
                                 "src/repro_torch/runtime/substrate.py")


def test_lint_catches_private_phase_arms(tmp_path):
    for snippet in ("y = eng._allreduce_1d_start(x, 'data')\n",
                    "tok = self._compressed_start(x, 'data')\n",
                    "y = eng._wait_inflight(tok)\n"):
        out = _planted(tmp_path, snippet)
        assert out and "two-phase arm" in out[0], snippet
    ok = ("tok = handle.start(x)\ny = handle.wait(tok)\n"
          "t2 = comm.all_reduce_start(x)\ny2 = comm.all_reduce_wait(t2)\n"
          "wd.start()\nckpt.wait()\nsrv._startup()\n")
    assert not _planted(tmp_path, ok)


def test_lint_catches_schedule_ir_construction(tmp_path):
    for node in ("CommUnit", "CommOp", "ComputeOp", "Schedule"):
        out = _planted(tmp_path, f"u = {node}(name='x')\n")
        assert out and "schedule-IR" in out[0], node
        assert _planted(tmp_path, f"u = schedule_mod.{node}(name='x')\n")
    ok = "s = comm.sync_schedule(specs)\np = session.schedule_for(f, a)\n"
    assert not _planted(tmp_path, ok)


def test_lint_catches_cache_creation_outside_pool(tmp_path):
    for snippet in ("c = model.init_caches(4, 512, dtype=dt)\n",
                    "c = init_caches(4, 512)\n",
                    "row = extract_cache(c, 2, specs)\n",
                    "c2 = engine.splice_cache(c, one, 2, specs)\n"):
        out = _planted(tmp_path, snippet)
        assert out and "paging" in out[0], snippet
    ok = "c = model.init_caches(4, 512, dtype=dt)\n"
    assert not lint.check_source(ok, "src/repro_torch/serve/paging.py")
    assert not lint.check_source(ok, "src/repro_torch/models/model.py")
    blessed = ("c = paging.contiguous_caches(model, 4, 512, dtype=dt, "
               "device=d)\na = paging.abstract_caches(model, 1, 512, "
               "dtype=dt)\n")
    assert not _planted(tmp_path, blessed)


def test_lint_catches_transports_and_sockets_outside_ctrlplane(tmp_path):
    for snippet in ("t = TcpTransport(port=9001)\n",
                    "t = ctrlplane.TcpTransport(port=9001)\n",
                    "t = LocalTransport(fab, 'a')\n",
                    "fab = LocalFabric()\n",
                    "import socket\n",
                    "from socket import create_server\n",
                    "import socket\ns = socket.create_connection(a)\n"):
        out = _planted(tmp_path, snippet)
        assert out and "ctrlplane" in out[0], snippet
    ok = ("import socket\nt = TcpTransport(port=9001)\n"
          "s = socket.create_server(('127.0.0.1', 0))\n")
    assert not lint.check_source(ok, "src/repro_torch/runtime/ctrlplane.py")
    blessed = "m = ctrlplane.connect(port=9001, peers=peers)\n"
    assert not _planted(tmp_path, blessed)


def test_lint_exempts_core_and_comm():
    assert lint.check_paths(["src/repro_torch/core"]) == []
    assert lint.check_paths(["src/repro_torch/comm"]) == []
    # the runtime builds transports and hops, and only there
    assert lint.check_paths(["src/repro_torch/runtime"]) == []
