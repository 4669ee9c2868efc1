#!/usr/bin/env python3
"""ptxas's view of the tensor-core flash kernel, as built and with edits.

    python3 tools/flash_ptxas.py [--variant NAME ...] [--out DIR]

Compiles ``src/repro_torch/kernels/flash_attention/csrc/
flash_attention_wgmma.cu`` with the library's nvcc flags into a cubin,
once as it stands and once for each variant named (a textual edit of the
source, listed in ``VARIANTS``), all at once, and prints for every
``flash_wgmma_kernel`` instantiation: ptxas's registers, stack frame and
spill bytes; its C75xx performance notes; and, from ``cuobjdump -sass``,
the highest register the code names and its local-memory stores and
loads (STL / LDL).  ``--out`` keeps each variant's source, cubin and
SASS there.

Variants:
  trap           the barrier wait's timeout traps (``__trap()``) in place
                 of the faulting store: ptxas then holds the consumers to
                 the launch's registers whatever ``setmaxnreg`` gives them
  no_setmaxnreg  no register split between producer and consumers

Needs the CUDA toolkit (the card's machine); exits non-zero if a build
fails or a variant's edit no longer applies.
"""

from __future__ import annotations

import argparse
import os
import re
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
SRC = os.path.join(ROOT, "src", "repro_torch", "kernels", "flash_attention",
                   "csrc", "flash_attention_wgmma.cu")

VARIANTS = {
    "trap": [("if (spins > (1u << 24)) fault();",
              "if (spins > (1u << 24)) __trap();")],
    "no_setmaxnreg": [
        ('    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\\n"\n'
         '                 :: "n"(P::PRODUCER_REGS));\n', ""),
        ('    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\\n"\n'
         '                 :: "n"(P::CONSUMER_REGS));\n', "")],
}


def _toolkit() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    return CUDA_HOME or "/usr/local/cuda"


def build(name: str, edits, out: str):
    """(name, ptxas log, SASS) of the source with ``edits`` applied."""
    text = open(SRC).read()
    for old, new in edits:
        if old not in text:
            raise SystemExit(f"variant {name}: edit no longer applies")
        text = text.replace(old, new)
    src = os.path.join(out, f"{name}.cu")
    cubin = os.path.join(out, f"{name}.cubin")
    with open(src, "w") as f:
        f.write(text)
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels.build import NVCC_FLAGS
    flags = [f for f in NVCC_FLAGS if f not in ("-shared", "-Xcompiler",
                                                "-fPIC")]
    tk = _toolkit()
    proc = subprocess.run([os.path.join(tk, "bin", "nvcc"), *flags,
                           "-cubin", "-o", cubin, src],
                          capture_output=True, text=True)
    if proc.returncode:
        raise SystemExit(f"variant {name}: nvcc failed\n{proc.stderr}")
    sass = subprocess.run([os.path.join(tk, "bin", "cuobjdump"), "-sass",
                           cubin], capture_output=True, text=True,
                          check=True).stdout
    with open(os.path.join(out, f"{name}.sass"), "w") as f:
        f.write(sass)
    return name, proc.stdout + proc.stderr, sass


def report(name: str, log: str, sass: str) -> None:
    sys.path.insert(0, ROOT)
    import chip_smoke
    print(f"=== {name}")
    for fn, regs, spills in chip_smoke._ptxas_usage(log):
        if "flash_wgmma_kernel" in fn:
            print(f"  {fn}: {regs} registers; {spills}")
    for line in log.splitlines():
        if re.search(r"C75\d\d", line) and "flash_wgmma_kernel" in line:
            print("  " + line.strip())
    for part in sass.split("Function : ")[1:]:
        fn, _, code = part.partition("\n")
        m = re.search(r"flash_wgmma_kernelILi(\d+)ELi(\d+)ELb(\d)", fn)
        if not m:
            continue
        regs = [int(r) for r in re.findall(r"\bR(\d+)\b", code)]
        stl = len(re.findall(r"\bSTL\b", code))
        ldl = len(re.findall(r"\bLDL\b", code))
        kv = "true" if m[3] == "1" else "false"
        print(f"  SASS <{m[1]}, {m[2]}, {kv}>: highest register "
              f"R{max(regs) if regs else 0}, STL {stl}, LDL {ldl}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variant", action="append", default=[],
                    choices=sorted(VARIANTS))
    ap.add_argument("--out")
    args = ap.parse_args()
    jobs = [("as built", [])] + [(v, VARIANTS[v]) for v in args.variant]
    with tempfile.TemporaryDirectory() as tmp:
        out = args.out or tmp
        os.makedirs(out, exist_ok=True)
        with ThreadPoolExecutor(len(jobs)) as pool:
            built = list(pool.map(
                lambda job: build(job[0].replace(" ", "_"), job[1], out),
                jobs))
    for name, log, sass in built:
        report(name, log, sass)
    return 0


if __name__ == "__main__":
    sys.exit(main())
