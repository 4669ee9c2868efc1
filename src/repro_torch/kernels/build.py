"""Build the port's CUDA sources into shared libraries at first use.

Each library is compiled by ``nvcc`` from the package's own ``csrc/``
into ``<repo>/build/`` (git-ignored), named by a hash of its sources and
flags, so an edited source or flag rebuilds and an unchanged one loads
the cached library.  The sources have a plain C interface and are loaded
with ``ctypes``; nothing links against PyTorch.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Callable, Optional, Sequence

BUILD_DIR = Path(__file__).resolve().parents[3] / "build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


@dataclasses.dataclass(frozen=True)
class Built:
    path: Path
    seconds: float          # 0.0 when the cached library was reused
    log: str                # nvcc's output (ptxas registers/spills)


def nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin/nvcc`` as PyTorch finds it, else
    the one on ``PATH``."""
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to "
                           "build the port's kernels")
    return found


def build(name: str, sources: Sequence[Path]) -> Built:
    """Compile ``sources`` into ``build/lib<name>-<hash>.so`` unless that
    file exists.  Concurrent builds write to their own temporary file
    and rename it into place."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        digest.update(Path(src).read_bytes())
    out = BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"
    if out.exists():
        return Built(out, 0.0, "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name} "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)
    return Built(out, seconds, log)


class Library:
    """One kernel library, built and loaded at its first use.

    Ranks run as threads, so two of them may ask for the library at
    once: a lock makes the first build it and the others wait for it.
    ``declare`` sets each C function's ``argtypes`` and ``restype``."""

    def __init__(self, name: str, sources: Sequence[Path],
                 declare: Callable[[ctypes.CDLL], None]) -> None:
        self.name = name
        self.sources = tuple(sources)
        self._declare = declare
        self._lock = threading.Lock()
        self._lib: Optional[ctypes.CDLL] = None
        self.built: Optional[Built] = None

    def load(self) -> Built:
        """Build (or reuse) and load the library; returns its build
        record (seconds, nvcc log)."""
        with self._lock:
            if self._lib is None:
                built = build(self.name, self.sources)
                lib = ctypes.CDLL(str(built.path))
                self._declare(lib)
                self._lib, self.built = lib, built
            return self.built

    @property
    def lib(self) -> ctypes.CDLL:
        self.load()
        return self._lib
