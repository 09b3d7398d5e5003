"""ctypes binding of ``csrc/robust_agg.cu`` (the hand-written Hopper
kernel that replaces the Pallas kernel ``sorted_reduce_kernel`` of
``repro/kernels/robust_agg/kernel.py``).

The library is built with ``nvcc`` at the first launch (``kernels.build``);
importing this module compiles nothing.  Callers pass tensors that the
wrappers in ``ops.py`` have already checked.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import check_error, stream

SOURCE = Path(__file__).resolve().parent / "csrc" / "robust_agg.cu"

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
MAX_M = 64              # must equal MAX_M in the CUDA source


def _lib() -> ctypes.CDLL:
    lib = build.load(SOURCE)
    if not getattr(lib, "_repro_bound", False):
        vp, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        lib.ra_sorted_reduce.argtypes = [vp, i32, i64, i64, i32, i32, vp, vp]
        lib.ra_sorted_reduce.restype = i32
        lib._repro_bound = True
    return lib


def sorted_reduce(g: torch.Tensor, *, trim: int, median: bool
                  ) -> torch.Tensor:
    """Launch B3 on a checked contiguous (m, n) f32/bf16 CUDA tensor:
    the (n,) float32 median (``median``) or ``trim``-trimmed mean."""
    m, n = g.shape
    out = torch.empty((n,), dtype=torch.float32, device=g.device)
    err = _lib().ra_sorted_reduce(g.data_ptr(), _DTYPE_CODE[g.dtype], m, n,
                                  trim, int(median), out.data_ptr(),
                                  stream(g.device))
    check_error(err, "ra_sorted_reduce")
    return out
