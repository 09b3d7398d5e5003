"""ctypes binding of ``csrc/flash_attention.cu`` (the hand-written Hopper
kernel that replaces the Pallas kernel ``flash_attention_kernel`` of
``repro/kernels/flash_attention/kernel.py``).

The library is built with ``nvcc`` at the first launch (``kernels.build``);
importing this module compiles nothing.  Callers pass tensors that the
wrapper in ``ops.py`` has already checked.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import check_error, stream

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 128)       # the instances the CUDA source builds


def _lib() -> ctypes.CDLL:
    lib = build.load(SOURCE)
    if not getattr(lib, "_repro_bound", False):
        vp, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        lib.fa_flash_attention.argtypes = [vp, vp, vp, vp, vp, i32, i64, i64,
                                           i64, i64, i64, i64, vp]
        lib.fa_flash_attention.restype = i32
        lib._repro_bound = True
    return lib


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    window: int) -> torch.Tensor:
    """Launch B4 on checked CUDA tensors q (B, H, L, D), k and v
    (B, K, L, D) of one dtype, with any strides.  The output has q's
    dtype and q's memory layout (``empty_like``), so the transpose view
    of a (B, L, H, D) projection gives a (B, L, H, D)-contiguous output."""
    B, H, L, D = q.shape
    out = torch.empty_like(q)
    strides = (ctypes.c_int64 * 16)(*q.stride(), *k.stride(), *v.stride(),
                                     *out.stride())
    err = _lib().fa_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        ctypes.addressof(strides), _DTYPE_CODE[q.dtype], B, H, k.shape[1], L,
        D, window, stream(q.device))
    check_error(err, "fa_flash_attention")
    return out
