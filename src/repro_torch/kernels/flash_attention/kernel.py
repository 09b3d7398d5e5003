"""ctypes bindings of the two hand-written Hopper kernels that replace the
Pallas kernel ``flash_attention_kernel`` of
``repro/kernels/flash_attention/kernel.py``:

  * ``csrc/flash_attention_tc.cu`` — bfloat16 q, k and v on the tensor
    cores (wgmma, K/V brought by TMA);
  * ``csrc/flash_attention.cu`` — float32 q, k and v in IEEE float32 FMAs
    on the CUDA cores (TF32 tensor cores would break the float32
    tolerance).

Each library is built with ``nvcc`` at its first launch
(``kernels.build``); importing this module compiles nothing.  Callers
pass tensors that the wrapper in ``ops.py`` has already checked.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import check_error, stream

_CSRC = Path(__file__).resolve().parent / "csrc"
SOURCE = _CSRC / "flash_attention.cu"
SOURCE_TC = _CSRC / "flash_attention_tc.cu"
SOURCES = (SOURCE_TC, SOURCE)

HEAD_DIMS = (16, 32, 64, 128)       # the instances each CUDA source builds


def _bind(source: Path, name: str) -> ctypes.CDLL:
    lib = build.load(source)
    if not getattr(lib, "_repro_bound", False):
        vp, i64 = ctypes.c_void_p, ctypes.c_int64
        fn = getattr(lib, name)
        fn.argtypes = [vp, vp, vp, vp, vp, i64, i64, i64, i64, i64, i64, vp]
        fn.restype = ctypes.c_int
        lib._repro_bound = True
    return lib


def _lib() -> ctypes.CDLL:
    return _bind(SOURCE, "fa_flash_attention")


def _lib_tc() -> ctypes.CDLL:
    return _bind(SOURCE_TC, "fa_flash_attention_tc")


def _launch(fn, name: str, q: torch.Tensor, k: torch.Tensor,
            v: torch.Tensor, window: int, strides) -> torch.Tensor:
    B, H, L, D = q.shape
    out = torch.empty_like(q)
    st = (ctypes.c_int64 * 16)(*strides, *out.stride())
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             ctypes.addressof(st), B, H, k.shape[1], L, D, window,
             stream(q.device))
    check_error(err, name)
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    window: int) -> torch.Tensor:
    """Launch the float32 kernel on checked float32 CUDA tensors
    q (B, H, L, D), k and v (B, K, L, D), with any strides.  The output
    has q's memory layout (``empty_like``), so the transpose view of a
    (B, L, H, D) projection gives a (B, L, H, D)-contiguous output."""
    return _launch(_lib().fa_flash_attention, "fa_flash_attention", q, k, v,
                   window, (*q.stride(), *k.stride(), *v.stride()))


def flash_attention_tc(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       *, window: int, strides) -> torch.Tensor:
    """Launch the tensor-core kernel on checked bfloat16 CUDA tensors, as
    ``flash_attention`` does; ``strides`` are the 12 element strides that
    its tensor maps take (``ops.tma_strides`` of q, k and v)."""
    return _launch(_lib_tc().fa_flash_attention_tc, "fa_flash_attention_tc",
                   q, k, v, window, strides)
