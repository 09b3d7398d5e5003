"""ctypes binding of ``csrc/safeguard_filter.cu`` (the hand-written Hopper
kernels that replace the Pallas kernels of
``repro/kernels/safeguard_filter/kernel.py``).

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

SOURCE = Path(__file__).resolve().parent / "csrc" / "safeguard_filter.cu"

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# blocks of the split-K first stage per SM: enough tiles in flight to keep
# the card's memory busy (the kernel is bound by device memory)
_BLOCKS_PER_SM = 8
_TILE_D = 128           # must equal TILE_D in the CUDA source
MAX_M = 64


def _lib() -> ctypes.CDLL:
    lib = build.load(SOURCE)
    if not getattr(lib, "_repro_bound", False):
        vp, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        lib.sf_pairwise_sqdist.argtypes = [vp, i32, i64, i64, vp, i32, vp, vp]
        lib.sf_pairwise_sqdist.restype = i32
        lib.sf_fused_accumulate_sqdist.argtypes = [vp, vp, vp, vp, i64, i64,
                                                   vp, i32, vp, vp]
        lib.sf_fused_accumulate_sqdist.restype = i32
        lib._repro_bound = True
    return lib


def n_blocks(d: int, device: torch.device) -> int:
    """Blocks of the first stage: a fixed count per card (so the order of
    the partial sums, and the result, is the same on every run), never more
    than there are tiles."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, min(sms * _BLOCKS_PER_SM, -(-d // _TILE_D)))


def pairwise_sqdist(a: torch.Tensor) -> torch.Tensor:
    """Launch B1 on a checked contiguous (m, d) f32/bf16 CUDA tensor."""
    m, d = a.shape
    nb = n_blocks(d, a.device)
    partial = torch.empty((nb, m, m), dtype=torch.float32, device=a.device)
    out = torch.empty((m, m), dtype=torch.float32, device=a.device)
    err = _lib().sf_pairwise_sqdist(
        a.data_ptr(), _DTYPE_CODE[a.dtype], m, d, partial.data_ptr(), nb,
        out.data_ptr(), stream(a.device))
    check_error(err, "sf_pairwise_sqdist")
    return out


def fused_accumulate_sqdist(acc: torch.Tensor, g: torch.Tensor,
                            reset: torch.Tensor, scale: torch.Tensor
                            ) -> torch.Tensor:
    """Launch B2: updates ``acc`` in place, returns the (m, m) sqdist."""
    m, d = acc.shape
    nb = n_blocks(d, acc.device)
    partial = torch.empty((nb, m, m), dtype=torch.float32, device=acc.device)
    out = torch.empty((m, m), dtype=torch.float32, device=acc.device)
    err = _lib().sf_fused_accumulate_sqdist(
        acc.data_ptr(), g.data_ptr(), reset.data_ptr(), scale.data_ptr(),
        m, d, partial.data_ptr(), nb, out.data_ptr(), stream(acc.device))
    check_error(err, "sf_fused_accumulate_sqdist")
    return out
