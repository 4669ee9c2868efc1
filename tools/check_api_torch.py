#!/usr/bin/env python
"""API-boundary lint of the PyTorch port: the Sessions-style facade is
the only public way to do distributed work (``tools/check_api.py``'s six
rules in the port's terms).

Enforced, for every Python file under ``src/repro_torch`` EXCEPT the
implementation layers ``src/repro_torch/core`` and
``src/repro_torch/comm``:

  1. no construction of a ``CollectiveEngine`` (the constructor or the
     ``for_mesh`` / ``from_application`` / ``monolithic`` spellings);
     sessions own engines;
  2. no direct hop or transport call outside ``runtime/`` as well:
     ``substrate.ppermute``, ``ThreadTransport`` / ``RecordingTransport``
     construction, and ``torch.distributed`` collectives.  Model-internal
     collectives go through ``repro_torch.comm.collectives``, application
     collectives through a ``Communicator``;
  3. no calls to ``_start`` / ``_progress`` / ``_wait``-suffixed engine
     internals; the nonblocking surface is ``PersistentHandle.start /
     progress / wait`` and the Communicator's ``*_start`` / ``*_wait``;
  4. no construction of schedule-IR nodes (``CommUnit``, ``CommOp``,
     ``ComputeOp``, ``Schedule``): sync programs come from
     ``Communicator.sync_schedule`` / ``Session.schedule_for`` and the
     ``core.plan`` passes;
  5. no ``init_caches`` / ``splice_cache`` / ``extract_cache`` calls
     outside ``serve/paging.py`` and ``models/``: serving cache memory
     comes from ``paging.contiguous_caches`` / ``paging.abstract_caches``
     and the ``PagePool``;
  6. no control-plane transport construction (``TcpTransport``,
     ``LocalTransport``, ``LocalFabric``) and no raw socket use outside
     ``runtime/ctrlplane.py``.

Exemptions, each with its reason, are in ``EXEMPT``, ``HOP_EXEMPT``,
``CACHE_EXEMPT`` and ``CTRL_EXEMPT``.  A pure AST walk: nothing of the
checked code is imported.

    python tools/check_api_torch.py [paths...]
"""

from __future__ import annotations

import ast
import os
import sys
from typing import Iterable, List

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: deprecated CollectiveEngine constructors (classmethod spellings)
ENGINE_CTORS = frozenset({"for_mesh", "from_application", "monolithic"})

#: the substrate's hop and its transports (rule 2)
HOP_CALLS = frozenset({"ppermute"})
TRANSPORTS = frozenset({"ThreadTransport", "RecordingTransport"})
#: ``torch.distributed`` collectives and point-to-point calls (rule 2)
DIST_CALLS = frozenset({
    "all_reduce", "all_gather", "all_gather_into_tensor", "reduce_scatter",
    "reduce_scatter_tensor", "all_to_all", "all_to_all_single", "broadcast",
    "reduce", "gather", "scatter", "send", "recv", "isend", "irecv",
    "batch_isend_irecv", "barrier", "init_process_group",
})

#: schedule-IR node constructors (rule 4)
IR_NODES = frozenset({"CommUnit", "CommOp", "ComputeOp", "Schedule"})

#: cache-memory chokepoints (rule 5)
CACHE_CALLS = frozenset({"init_caches", "splice_cache", "extract_cache"})
#: the pool module itself, and the model definitions that implement
#: ``init_caches``
CACHE_EXEMPT = ("src/repro_torch/serve/paging.py", "src/repro_torch/models/")

#: control-plane chokepoints (rule 6)
TRANSPORT_CTORS = frozenset({"TcpTransport", "LocalTransport",
                             "LocalFabric"})
SOCKET_CALLS = frozenset({"socket", "create_connection", "create_server"})
#: the control plane's own module speaks the wire
CTRL_EXEMPT = ("src/repro_torch/runtime/ctrlplane.py",)

#: the implementation layers: they build engines, schedules and hops
EXEMPT = ("src/repro_torch/core/", "src/repro_torch/comm/")
#: the substrate defines the hop and its transports, and the runtime's
#: controllers sit beside it (rule 2 only)
HOP_EXEMPT = ("src/repro_torch/runtime/",)

DEFAULT_ROOTS = ("src/repro_torch",)


def _dist_aliases(tree: ast.Module) -> frozenset:
    """Names bound to ``torch.distributed`` itself in this module."""
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                if alias.name == "torch.distributed":
                    names.add(alias.asname or "torch.distributed")
        elif (isinstance(node, ast.ImportFrom) and node.module == "torch"):
            for alias in node.names:
                if alias.name == "distributed":
                    names.add(alias.asname or "distributed")
    return frozenset(names)


def _dotted(node: ast.AST) -> str:
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        return f"{_dotted(node.value)}.{node.attr}"
    return ""


def _is_private_phase_arm(attr: str) -> bool:
    """Underscore-prefixed attribute with ``start``/``progress``/``wait``
    as a whole name word (rule 3): ``_allreduce_1d_start`` counts,
    ``_startup`` does not."""
    if not attr.startswith("_") or attr.startswith("__"):
        return False
    return bool({"start", "progress", "wait"}
                & set(attr.strip("_").split("_")))


def check_source(src: str, relpath: str) -> List[str]:
    """Lint one file's source; returns violation strings."""
    try:
        tree = ast.parse(src, filename=relpath)
    except SyntaxError as e:
        return [f"{relpath}:{e.lineno}: syntax error: {e.msg}"]
    out: List[str] = []
    dist = _dist_aliases(tree)
    hop_exempt = any(relpath.startswith(p) for p in HOP_EXEMPT)
    cache_exempt = any(relpath.startswith(p) for p in CACHE_EXEMPT)
    ctrl_exempt = any(relpath.startswith(p) for p in CTRL_EXEMPT)
    facade = "route through repro_torch.comm (a Communicator, or " \
             "repro_torch.comm.collectives)"
    for node in ast.walk(tree):
        # import socket / from socket import ... (rule 6)
        if not ctrl_exempt:
            if isinstance(node, ast.Import):
                for alias in node.names:
                    if alias.name.split(".")[0] == "socket":
                        out.append(f"{relpath}:{node.lineno}: imports "
                                   f"socket — the control-plane wire lives "
                                   f"in repro_torch.runtime.ctrlplane only "
                                   f"(use ctrlplane.connect)")
            elif (isinstance(node, ast.ImportFrom)
                  and (node.module or "").split(".")[0] == "socket"):
                out.append(f"{relpath}:{node.lineno}: imports from socket "
                           f"— the control-plane wire lives in "
                           f"repro_torch.runtime.ctrlplane only (use "
                           f"ctrlplane.connect)")
        # from torch.distributed import all_reduce (rule 2)
        if (not hop_exempt and isinstance(node, ast.ImportFrom)
                and node.module == "torch.distributed"):
            for alias in node.names:
                if alias.name in DIST_CALLS:
                    out.append(f"{relpath}:{node.lineno}: imports "
                               f"{alias.name} from torch.distributed — "
                               f"{facade}")
            continue
        # from repro_torch.runtime.substrate import ppermute (rule 2)
        if (not hop_exempt and isinstance(node, ast.ImportFrom)
                and (node.module or "").endswith("substrate")):
            for alias in node.names:
                if alias.name in HOP_CALLS | TRANSPORTS:
                    out.append(f"{relpath}:{node.lineno}: imports "
                               f"{alias.name} from the substrate — "
                               f"{facade}")
            continue
        if not isinstance(node, ast.Call):
            continue
        fn = node.func
        name = fn.id if isinstance(fn, ast.Name) else (
            fn.attr if isinstance(fn, ast.Attribute) else "")
        owner = _dotted(fn.value) if isinstance(fn, ast.Attribute) else ""
        if name == "CollectiveEngine":
            out.append(f"{relpath}:{node.lineno}: constructs a "
                       f"CollectiveEngine — use repro_torch.comm.Session")
        elif name in ENGINE_CTORS and owner.endswith("CollectiveEngine"):
            out.append(f"{relpath}:{node.lineno}: calls CollectiveEngine."
                       f"{name} — use repro_torch.comm.Session")
        elif name in IR_NODES:
            out.append(f"{relpath}:{node.lineno}: constructs schedule-IR "
                       f"node {name} — build programs with "
                       f"Communicator.sync_schedule / Session.schedule_for")
        elif name in CACHE_CALLS and not cache_exempt:
            out.append(f"{relpath}:{node.lineno}: calls {name} outside "
                       f"repro_torch.serve.paging — cache memory is owned "
                       f"by the PagePool (use paging.contiguous_caches / "
                       f"paging.abstract_caches)")
        elif name in TRANSPORT_CTORS and not ctrl_exempt:
            out.append(f"{relpath}:{node.lineno}: constructs {name} — "
                       f"control-plane transports are built only inside "
                       f"repro_torch.runtime.ctrlplane (use "
                       f"ctrlplane.connect and pass the Membership around)")
        elif (name in SOCKET_CALLS and not ctrl_exempt
              and owner == "socket"):
            out.append(f"{relpath}:{node.lineno}: calls socket.{name} — "
                       f"the control-plane wire lives in "
                       f"repro_torch.runtime.ctrlplane only (use "
                       f"ctrlplane.connect)")
        elif hop_exempt:
            if isinstance(fn, ast.Attribute) and _is_private_phase_arm(name):
                out.append(_arm(relpath, node, name))
        elif name in TRANSPORTS:
            out.append(f"{relpath}:{node.lineno}: constructs {name} — "
                       f"ranks run through substrate.run_spmd; {facade}")
        elif name in HOP_CALLS and (isinstance(fn, ast.Name)
                                    or owner.endswith("substrate")):
            out.append(f"{relpath}:{node.lineno}: calls the substrate's "
                       f"hop {name} directly — {facade}")
        elif name in DIST_CALLS and (owner in dist or owner.endswith(
                "torch.distributed")):
            out.append(f"{relpath}:{node.lineno}: calls torch.distributed."
                       f"{name} — {facade}")
        elif isinstance(fn, ast.Attribute) and _is_private_phase_arm(name):
            out.append(_arm(relpath, node, name))
    return out


def _arm(relpath: str, node: ast.AST, name: str) -> str:
    return (f"{relpath}:{node.lineno}: calls private two-phase arm {name} "
            f"— use PersistentHandle.start/wait or the Communicator's "
            f"*_start/*_wait methods")


def iter_files(roots: Iterable[str]) -> Iterable[str]:
    for root in roots:
        absroot = root if os.path.isabs(root) else os.path.join(REPO, root)
        if os.path.isfile(absroot):
            yield absroot
            continue
        for dirpath, _, names in os.walk(absroot):
            for name in sorted(names):
                if name.endswith(".py"):
                    yield os.path.join(dirpath, name)


def check_paths(roots: Iterable[str]) -> List[str]:
    violations: List[str] = []
    for path in iter_files(roots):
        rel = os.path.relpath(path, REPO).replace(os.sep, "/")
        if any(rel.startswith(p) for p in EXEMPT):
            continue
        with open(path, encoding="utf-8") as f:
            violations.extend(check_source(f.read(), rel))
    return violations


def main(argv: List[str]) -> int:
    roots = argv or list(DEFAULT_ROOTS)
    violations = check_paths(roots)
    for v in violations:
        print(v)
    if violations:
        print(f"\ncheck_api_torch: {len(violations)} violation(s) — "
              f"distributed work outside repro_torch/core + repro_torch/"
              f"comm must go through the repro_torch.comm facade",
              file=sys.stderr)
        return 1
    print("check_api_torch: OK — all paths route through repro_torch.comm")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
