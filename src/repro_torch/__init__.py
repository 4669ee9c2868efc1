"""PyTorch/CUDA port of ``repro``: the same subpackages (configs, models,
kernels, serve, launch), written for an NVIDIA H100.

The JAX package ``repro`` is the reference each module here is held
against.  This package imports ``torch``, ``numpy`` and the standard
library only.  Entry points run on ``cuda`` unless the caller passes
``device="cpu"``; asking for CUDA where there is none raises, it never
falls back to the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """The ``torch.device`` an entry point runs on.  Raises when CUDA is
    asked for and missing (no silent CPU fallback)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but CUDA is not available; "
            "pass device='cpu' to run on the CPU")
    return dev


__all__ = ["resolve_device"]
