"""CUDA flash-attention forward: the binding of ``csrc/flash_attention.cu``.

Counterpart of the Pallas kernel ``repro.kernels.flash_attention.kernel.
flash_attention_bhsd``, on the model's ``(B, S, H, D)`` layout instead of
the flattened ``(B*H, S, D)`` one (the kernel takes strides, so no
transpose is copied).  The shared library is built by ``nvcc`` at first
use (``repro_torch.kernels.build``) and loaded with ``ctypes``; importing
this module builds nothing.

The kernel launches on the current CUDA stream and allocates nothing;
the wrapper checks every argument, allocates the output, and raises if
the launch returns an error.

Two kernels share the library, chosen by type and head dims in the C
entry: a bf16 query at head dims (q/k, v) in ``WGMMA_HEAD_DIMS`` ((64,
64), (128, 128), (192, 192) and MLA's (192, 128): every full-width serve
path) runs on the tensor cores (``csrc/flash_attention_wgmma.cu``,
variant ``"wgmma"``); any other query (f32, or the reduced configs' head
dim 16) runs on the CUDA cores in f32 (``csrc/flash_attention.cu``,
variant ``"simt"``).  ``launch`` returns the variant the C entry reports.
The tensor-core kernel's plan is fixed per head dims and cache type when
it is compiled (``Plan`` in the source): three consumer warpgroups of 64
query rows at D 64, where a query of at most 64 rows (a cross-attention
decode step or prompt) has them take the key tiles in turn and merge at
the end, and at (192, 192) over a bf16 cache, where a block takes 64
rows of three query heads of one KV group when the group divides by
three; two elsewhere; Q in shared memory at (192, 128) and at D 192 over
a bf16 cache; each tile's softmax overlapped with the last tile's
products over a bf16 cache but at (192, 192).
Both take ``causal=False`` (every query sees every key: the
encoder-decoder's encoder and cross-attention).
"""

from __future__ import annotations

import ctypes
import math
from pathlib import Path

import torch

from repro_torch.kernels import build as B

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = (CSRC / "flash_attention.cu", CSRC / "flash_attention_wgmma.cu")
#: the (q/k, v) head dims the library is built for
HEAD_DIMS = ((16, 16), (64, 64), (128, 128), (192, 192), (192, 128))
#: the head dims at which a bf16 query runs on the tensor cores
WGMMA_HEAD_DIMS = ((64, 64), (128, 128), (192, 192), (192, 128))
VARIANTS = ("simt", "wgmma")   # as the C entry reports them: 0, 1
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _declare(lib: ctypes.CDLL) -> None:
    fn = lib.flash_attention_fwd
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 9
                   + [ctypes.c_int64] * 12
                   + [ctypes.c_int, ctypes.c_int, ctypes.c_float,
                      ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)])
    fn.restype = ctypes.c_int
    lib.flash_attention_error_string.argtypes = [ctypes.c_int]
    lib.flash_attention_error_string.restype = ctypes.c_char_p


LIBRARY = B.Library("flash_attention", SOURCES, _declare)


def load() -> B.Built:
    """Build (or reuse) and load the kernel library; returns its build
    record (seconds, nvcc log)."""
    return LIBRARY.load()


def _check(name: str, x: torch.Tensor, device: torch.device) -> None:
    if x.device != device:
        raise ValueError(f"{name} on {x.device}, q on {device}")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"{name} dtype {x.dtype}: the kernel takes "
                        "float32 or bfloat16")
    if x.dim() != 4:
        raise ValueError(f"{name} shape {tuple(x.shape)}: the kernel takes "
                         "(B, S, H, D)")
    if x.stride(-1) != 1:
        raise ValueError(f"{name}: head dim must be contiguous")
    # 16-byte vector loads: aligned base, row strides in whole vectors.
    if x.data_ptr() % 16 or any(s % 8 for s in _strides(x)):
        raise ValueError(f"{name}: base must be 16-byte aligned and "
                         f"strides multiples of 8 elements ({x.stride()})")


def _strides(x: torch.Tensor):
    """(batch, seq, head) element strides; 0 for an axis of size 1, whose
    stride is never used and may be anything."""
    return [0 if x.shape[i] == 1 else x.stride(i) for i in range(3)]


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, sm_scale: float | None = None,
                    q_offset: int = 0) -> torch.Tensor:
    """q: (B, Sq, H, D); k: (B, Skv, Hkv, D); v: (B, Skv, Hkv, Dv) CUDA
    tensors, (D, Dv) in ``HEAD_DIMS`` -> (B, Sq, H, Dv) in q's dtype.
    ``q_offset`` is a runtime int: one compiled kernel serves every chunk
    position."""
    return launch(q, k, v, causal=causal, sm_scale=sm_scale,
                  q_offset=q_offset)[0]


def launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
           causal: bool = True, sm_scale: float | None = None,
           q_offset: int = 0) -> tuple[torch.Tensor, str]:
    """``flash_attention``, and the variant that ran (``VARIANTS``)."""
    if q.device.type != "cuda":
        raise ValueError(f"the CUDA kernel needs CUDA tensors, got {q.device}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        _check(name, x, q.device)
    dims = (q.shape[-1], v.shape[-1])
    if dims not in HEAD_DIMS:
        raise ValueError(f"head dims (D, Dv) = {dims}: the kernel takes "
                         f"D in {sorted({d for d, _ in HEAD_DIMS})}, "
                         f"paired with Dv as in {HEAD_DIMS}")
    if (k.dtype != v.dtype or k.shape[:-1] != v.shape[:-1]
            or k.shape[-1] != q.shape[-1]):
        raise ValueError(f"q {tuple(q.shape)}, k {k.dtype}{tuple(k.shape)} "
                         f"and v {v.dtype}{tuple(v.shape)} must match")
    b, sq, h, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    if k.shape[0] != b or hkv == 0 or h % hkv:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)}: "
                         "batch must match and H be a multiple of Hkv")
    if b * h == 0 or sq == 0:
        raise ValueError(f"empty query {tuple(q.shape)}")
    q_offset = int(q_offset)
    if q_offset < 0:
        raise ValueError(f"q_offset={q_offset} must be >= 0")
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)
    lib = LIBRARY.lib
    o = q.new_empty((b, sq, h, v.shape[-1]))
    variant = ctypes.c_int(-1)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            _DTYPE_CODE[q.dtype], _DTYPE_CODE[k.dtype], b, sq, skv, h, hkv,
            d, v.shape[-1], *_strides(q), *_strides(k), *_strides(v), *_strides(o),
            int(causal), q_offset, scale, stream, ctypes.byref(variant))
    if err != 0:
        msg = lib.flash_attention_error_string(err).decode()
        raise RuntimeError(f"flash_attention_fwd failed ({err}): {msg}")
    return o, VARIANTS[variant.value]
