#!/usr/bin/env python3
"""Flash attention's [kernels] rows from several checkouts, in turns, on one card.

    python3 tools/flash_kernels_ab.py TREE [TREE ...] [--family NAME ...]
                                     [--one-shot-len N] [--out FILE]

Each TREE is the root of a checkout of this repository (``.`` for this
one).  For each TREE in the order given, a child process builds that
tree's flash-attention library with ``nvcc`` into the tree's own
``build/``, prints ptxas's registers and spills of every kernel in it
(``chip_smoke.phase_build``), and runs that tree's ``chip_smoke.
phase_kernels`` (each case against plain, with kernel, plain, SDPA and
bound times), limited to the families named by ``--family`` if any,
with each family's one-shot case at ``--one-shot-len`` tokens if given.  A
tree named twice runs twice.  Then one table: each row's kernel ms in
every run, and each tree's mean against the first tree's; and, for
every kernel of the library, whether its machine code (``cuobjdump
-sass``) is the first tree's.  Give ``PARENT . . PARENT`` to compare a
change with its parent within one call (the two in turns, so that
drift of the card's clocks shows).

Needs a CUDA card; exits non-zero if any child fails.  ``--out`` writes
every run's rows as JSON.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

CHILD = r"""
import hashlib, json, os, re, subprocess, sys
tree, out = sys.argv[1], sys.argv[2]
families, one_shot_len = json.loads(sys.argv[3]), int(sys.argv[4])
sys.path[:0] = [tree, os.path.join(tree, "src")]
import chip_smoke as C
from repro_torch.kernels.flash_attention import kernel, ref
from torch.utils.cpp_extension import CUDA_HOME
if families:
    C.KERNEL_HEADS = [h for h in C.KERNEL_HEADS if h[0] in families]
if one_shot_len:
    C.KERNEL_HEADS = [h[:5] + ([(n, b, one_shot_len, one_shot_len, o, c)
                                if n == "one-shot" else (n, b, sq, skv, o, c)
                                for n, b, sq, skv, o, c in h[5]],)
                      for h in C.KERNEL_HEADS]
C.phase_build([kernel.LIBRARY])
dump = subprocess.run(
    [os.path.join(CUDA_HOME or "/usr/local/cuda", "bin", "cuobjdump"),
     "-sass", str(kernel.LIBRARY.built.path)],
    capture_output=True, text=True, check=True).stdout
sass = {}
for part in dump.split("Function : ")[1:]:
    name, _, code = part.partition("\n")
    # an anonymous namespace's name carries a hash of its file's text
    name = re.sub(r"_GLOBAL__N__[0-9a-f]+_", "_GLOBAL__N_", name.strip())
    sass[name] = hashlib.sha256(code.encode()).hexdigest()[:16]
rows = C.phase_kernels(kernel, ref)
with open(out, "w") as f:
    json.dump({"rows": rows, "sass": sass}, f)
"""

KEY = ("family", "case", "q_offset", "q_dtype", "kv_dtype")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trees", nargs="+")
    ap.add_argument("--family", action="append", default=[])
    ap.add_argument("--one-shot-len", type=int, default=0)
    ap.add_argument("--out")
    args = ap.parse_args()
    runs, failed = [], []
    with tempfile.TemporaryDirectory() as tmp:
        for i, tree in enumerate(args.trees):
            tree = os.path.abspath(tree)
            out = os.path.join(tmp, f"{i}.json")
            print(f"=== run {i}: {tree}", flush=True)
            proc = subprocess.run(
                [sys.executable, "-c", CHILD, tree, out,
                 json.dumps(args.family), str(args.one_shot_len)], cwd=tree)
            if proc.returncode != 0:
                failed.append((i, tree, proc.returncode))
                continue
            with open(out) as f:
                runs.append((i, tree, json.load(f)))
    if args.out:
        with open(args.out, "w") as f:
            json.dump([{"run": i, "tree": t, **r} for i, t, r in runs], f)
    if runs:
        first = runs[0][1]
        name = {t: os.path.relpath(t) for t in args.trees}
        name.update({os.path.abspath(t): os.path.relpath(t)
                     for t in args.trees})
        trees = list(dict.fromkeys(t for _, t, _ in runs))
        table = {}
        for i, tree, run in runs:
            for r in run["rows"]:
                table.setdefault(tuple(r[k] for k in KEY), []).append(
                    (tree, r["ms"], r["variant"]))
        print("=== kernel ms by run (" + ", ".join(
            f"run {i}: {name[t]}" for i, t, _ in runs) + "), and each "
            f"tree's mean over the mean of {name[first]}")
        for key, cells in table.items():
            means = {t: [ms for tt, ms, _ in cells if tt == t]
                     for t in trees}
            means = {t: sum(v) / len(v) for t, v in means.items() if v}
            ratios = " ".join(
                f"{name[t]} {means[t] / means[first]:.4f}"
                for t in trees[1:] if t in means and first in means)
            print(" ".join(map(str, key)) + ": "
                  + " ".join(f"{ms:.4f}({v})" for _, ms, v in cells)
                  + (f"  [{ratios}]" if ratios else ""))
        print(f"=== machine code against {name[first]}'s")
        base = runs[0][2]["sass"]
        for fn in sorted(set().union(*(r["sass"] for _, _, r in runs))):
            print(fn + ": " + " ".join(
                f"{name[t]} " + ("absent" if fn not in r["sass"] else
                                 "same" if r["sass"][fn] == base.get(fn)
                                 else "differs")
                for _, t, r in runs[1:]))
    for i, tree, rc in failed:
        print(f"run {i} ({tree}) failed: exit {rc}", file=sys.stderr)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
