#!/usr/bin/env python
"""Environment probe of the PyTorch port: the torch version, whether CUDA
is present (the card's name and power limit), ``nvcc`` and ``triton``
where present, and the substrate's transport.

    python tools/check_env_torch.py

Exit status is 0 when the substrate imports, 1 otherwise: a preflight
before a test run or a card run.
"""

import os
import shutil
import subprocess
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))


def _card() -> str:
    """``nvidia-smi``'s name and power limit of each card, or why not."""
    smi = shutil.which("nvidia-smi")
    if smi is None:
        return "nvidia-smi not found"
    try:
        out = subprocess.run(
            [smi, "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi failed: {e}"
    return out.stdout.strip() or out.stderr.strip()


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or (
        "/usr/local/cuda/bin/nvcc"
        if os.path.exists("/usr/local/cuda/bin/nvcc") else None)
    if nvcc is None:
        return "absent"
    try:
        out = subprocess.run([nvcc, "--version"], capture_output=True,
                             text=True, timeout=30).stdout
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"{nvcc} failed: {e}"
    last = [l for l in out.splitlines() if l.strip()]
    return f"{nvcc}: {last[-1] if last else '?'}"


def main() -> int:
    try:
        import torch
    except Exception as e:  # pragma: no cover - catastrophic env
        print(f"FATAL: torch failed to import: {e}")
        return 1
    print(f"torch:      {torch.__version__} (CUDA build "
          f"{torch.version.cuda})")
    if torch.cuda.is_available():
        n = torch.cuda.device_count()
        print(f"cuda:       {n} device(s): "
              f"{torch.cuda.get_device_name(0)}; {_card()}")
    else:
        print("cuda:       not available (the port's tests run on the CPU)")
    print(f"nvcc:       {_nvcc()}")
    try:
        import triton
        print(f"triton:     {triton.__version__}")
    except ImportError:
        print("triton:     absent")
    try:
        from repro_torch.runtime import substrate
    except Exception as e:
        print(f"the substrate did not import: {type(e).__name__}: {e}")
        return 1
    print(f"substrate:  {substrate.ThreadTransport.__name__} (ranks are "
          f"threads of one process; hops through substrate.ppermute)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
