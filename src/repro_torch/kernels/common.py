"""Helpers shared by the kernel packages: the checks a wrapper makes
before a CUDA tensor reaches a kernel, and the plumbing of a ctypes
launch (the current stream, the error code a launch returns)."""

from __future__ import annotations

import torch


def check_dtype(name: str, x: torch.Tensor, dtypes) -> None:
    """Raise unless ``x`` is of one of ``dtypes``."""
    if x.dtype not in dtypes:
        raise TypeError(f"{name}: dtype {x.dtype} not in {dtypes}")


def check_matrix(name: str, x: torch.Tensor, dtypes, max_m: int) -> None:
    """Raise unless ``x`` is a contiguous ``(m, d)`` matrix of one of
    ``dtypes`` with ``1 <= m <= max_m`` and ``d >= 1``."""
    if x.ndim != 2:
        raise ValueError(f"{name}: expected an (m, d) matrix, got "
                         f"shape {tuple(x.shape)}")
    check_dtype(name, x, dtypes)
    if not x.is_contiguous():
        raise ValueError(f"{name}: tensor must be contiguous")
    m, d = x.shape
    if not 1 <= m <= max_m or d < 1:
        raise ValueError(f"{name}: need 1 <= m <= {max_m} and d >= 1, "
                         f"got {(m, d)}")


def check_error(err: int, name: str) -> None:
    """Raise when a library entry point returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} "
                           f"({torch.cuda.get_device_name()})")


def stream(device: torch.device) -> int:
    """The handle of PyTorch's current stream on ``device``."""
    return torch.cuda.current_stream(device).cuda_stream
