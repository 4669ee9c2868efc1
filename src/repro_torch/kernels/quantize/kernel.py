"""CUDA int8 quantize / dequantize / dequant-add: the binding of
``csrc/quantize.cu``.

Counterparts of the Pallas kernels ``quantize_2d``, ``dequantize_2d`` and
``dequant_add_2d`` in ``repro.kernels.quantize.kernel``, on flat buffers
whose length is a multiple of the 256-value block (no padding to the
TPU's 8-block tiles).  The shared library is built by ``nvcc`` at first
use (``repro_torch.kernels.build``) and loaded with ``ctypes``; importing
this module builds nothing.  The kernels launch on the current CUDA
stream and allocate nothing; the wrappers check the arguments, allocate
the outputs, and raise if a launch returns an error.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Tuple

import torch

from repro_torch.kernels import build as B

SOURCE = Path(__file__).resolve().parent / "csrc" / "quantize.cu"
QBLOCK = 256


def _declare(lib: ctypes.CDLL) -> None:
    vp, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.quantize_int8.argtypes = [vp, vp, vp, i64, vp]
    lib.dequantize_int8.argtypes = [vp, vp, vp, i64, vp]
    lib.dequant_add_int8.argtypes = [vp, vp, vp, vp, i64, vp]
    for fn in (lib.quantize_int8, lib.dequantize_int8, lib.dequant_add_int8):
        fn.restype = ctypes.c_int
    lib.quantize_error_string.argtypes = [ctypes.c_int]
    lib.quantize_error_string.restype = ctypes.c_char_p


LIBRARY = B.Library("quantize", [SOURCE], _declare)


def load() -> B.Built:
    return LIBRARY.load()


def _operand(name: str, x: torch.Tensor, dtype, n: int,
             device) -> torch.Tensor:
    """Checked flat operand: CUDA, ``dtype``, ``n`` values, contiguous and
    16-byte aligned (a misaligned view is copied to a fresh buffer, which
    the allocator aligns)."""
    if x.device.type != "cuda" or (device is not None and x.device != device):
        raise ValueError(f"{name} on {x.device}: the kernel needs CUDA "
                         "tensors on one device")
    if x.dtype != dtype:
        raise TypeError(f"{name} dtype {x.dtype}, expected {dtype}")
    if x.numel() != n:
        raise ValueError(f"{name} has {x.numel()} values, expected {n}")
    x = x.reshape(-1)
    if not x.is_contiguous() or x.data_ptr() % 16:
        x = x.clone(memory_format=torch.contiguous_format)
    return x


def _raise_on(lib, err: int, what: str) -> None:
    if err != 0:
        msg = lib.quantize_error_string(err).decode()
        raise RuntimeError(f"{what} failed ({err}): {msg}")


def _stream(device):
    return torch.cuda.current_stream(device).cuda_stream


def quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (n,) f32 CUDA, n a positive multiple of 256 -> (q int8 (n,),
    scales f32 (n/256,))."""
    n = x.numel()
    if n == 0 or n % QBLOCK:
        raise ValueError(f"{n} values: need a positive multiple of {QBLOCK}")
    x = _operand("x", x, torch.float32, n, None)
    q = torch.empty(n, dtype=torch.int8, device=x.device)
    scale = torch.empty(n // QBLOCK, dtype=torch.float32, device=x.device)
    lib = LIBRARY.lib
    with torch.cuda.device(x.device):
        err = lib.quantize_int8(x.data_ptr(), q.data_ptr(), scale.data_ptr(),
                                n // QBLOCK, _stream(x.device))
    _raise_on(lib, err, "quantize_int8")
    return q, scale


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """q: (n,) int8, scale: (n/256,) f32 CUDA -> (n,) f32."""
    n = q.numel()
    if n == 0 or n % QBLOCK:
        raise ValueError(f"{n} codes: need a positive multiple of {QBLOCK}")
    q = _operand("q", q, torch.int8, n, None)
    scale = _operand("scale", scale, torch.float32, n // QBLOCK, q.device)
    out = torch.empty(n, dtype=torch.float32, device=q.device)
    lib = LIBRARY.lib
    with torch.cuda.device(q.device):
        err = lib.dequantize_int8(q.data_ptr(), scale.data_ptr(),
                                  out.data_ptr(), n, _stream(q.device))
    _raise_on(lib, err, "dequantize_int8")
    return out


def dequant_add(acc: torch.Tensor, q: torch.Tensor,
                scale: torch.Tensor) -> torch.Tensor:
    """acc: f32 CUDA (any shape, n values), q: (n,) int8, scale: (n/256,)
    f32 -> acc + q * scale in f32, of acc's shape."""
    n = q.numel()
    if n == 0 or n % QBLOCK:
        raise ValueError(f"{n} codes: need a positive multiple of {QBLOCK}")
    shape = acc.shape
    acc = _operand("acc", acc, torch.float32, n, None)
    q = _operand("q", q, torch.int8, n, acc.device)
    scale = _operand("scale", scale, torch.float32, n // QBLOCK, acc.device)
    out = torch.empty(n, dtype=torch.float32, device=acc.device)
    lib = LIBRARY.lib
    with torch.cuda.device(acc.device):
        err = lib.dequant_add_int8(acc.data_ptr(), q.data_ptr(),
                                   scale.data_ptr(), out.data_ptr(), n,
                                   _stream(acc.device))
    _raise_on(lib, err, "dequant_add_int8")
    return out.reshape(shape)
