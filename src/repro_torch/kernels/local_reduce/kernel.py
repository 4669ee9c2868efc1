"""CUDA k-way chunk reduction: the binding of ``csrc/local_reduce.cu``.

Counterpart of the Pallas kernel ``repro.kernels.local_reduce.kernel.
sum_chunks_3d``, on flat ragged chunks (no padding to TPU tiles).  The
shared library is built by ``nvcc`` at first use
(``repro_torch.kernels.build``) and loaded with ``ctypes``; importing this
module builds nothing.  The kernel launches on the current CUDA stream
and allocates nothing; the wrapper checks the arguments, allocates the
output, and raises if the launch returns an error.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Sequence

import torch

from repro_torch.kernels import build as B

SOURCE = Path(__file__).resolve().parent / "csrc" / "local_reduce.cu"
MAX_CHUNKS = 8
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _declare(lib: ctypes.CDLL) -> None:
    fn = lib.local_reduce_sum_chunks
    fn.argtypes = [ctypes.POINTER(ctypes.c_void_p), ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.local_reduce_error_string.argtypes = [ctypes.c_int]
    lib.local_reduce_error_string.restype = ctypes.c_char_p


LIBRARY = B.Library("local_reduce", [SOURCE], _declare)


def load() -> B.Built:
    return LIBRARY.load()


def sum_chunks(chunks: Sequence[torch.Tensor], dtype=None) -> torch.Tensor:
    """k same-shape contiguous CUDA tensors (f32 or bf16, one dtype) ->
    their sum accumulated in f32, in ``dtype`` (f32 or bf16; default:
    the inputs' dtype)."""
    chunks = list(chunks)
    if not 1 <= len(chunks) <= MAX_CHUNKS:
        raise ValueError(f"{len(chunks)} chunks: the kernel takes 1 to "
                         f"{MAX_CHUNKS}")
    first = chunks[0]
    dtype = dtype or first.dtype
    if first.device.type != "cuda":
        raise ValueError(f"the CUDA kernel needs CUDA tensors, got "
                         f"{first.device}")
    for x in chunks:
        if x.device != first.device or x.dtype != first.dtype \
                or x.shape != first.shape:
            raise ValueError(f"chunks differ: {x.dtype}{tuple(x.shape)} on "
                             f"{x.device} vs {first.dtype}"
                             f"{tuple(first.shape)} on {first.device}")
        if not x.is_contiguous():
            raise ValueError("chunks must be contiguous")
    if first.dtype not in _DTYPE_CODE or dtype not in _DTYPE_CODE:
        raise TypeError(f"dtypes {first.dtype} -> {dtype}: the kernel takes "
                        "float32 or bfloat16")
    out = torch.empty(first.shape, dtype=dtype, device=first.device)
    n = first.numel()
    if n == 0:
        return out
    lib = LIBRARY.lib
    ptrs = (ctypes.c_void_p * len(chunks))(*[x.data_ptr() for x in chunks])
    args = (ptrs, len(chunks), out.data_ptr(), n, _DTYPE_CODE[first.dtype],
            _DTYPE_CODE[dtype],
            torch.cuda.current_stream(first.device).cuda_stream)
    # The kernel launches on the current device: switch only if the
    # chunks lie elsewhere, since the switch is host time on every call.
    if first.device.index == torch.cuda.current_device():
        err = lib.local_reduce_sum_chunks(*args)
    else:
        with torch.cuda.device(first.device):
            err = lib.local_reduce_sum_chunks(*args)
    if err != 0:
        msg = lib.local_reduce_error_string(err).decode()
        raise RuntimeError(f"local_reduce_sum_chunks failed ({err}): {msg}")
    return out
