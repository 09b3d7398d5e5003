"""Wrapper of the flash-attention kernel (port of
``repro.kernels.flash_attention.ops``): causal attention with GQA and an
optional sliding window over q (B, H, L, D) and k, v (B, K, L, D).

Dispatch is on the tensors' device and nothing else:

  * CPU tensors go to the plain PyTorch version in ``ref.py``;
  * CUDA tensors go to the hand-written CUDA kernel (``kernel.py``), after
    checks of dtype, shape and head counts that raise on what the kernel
    does not take.  There is no fallback.

The kernel masks the ragged edge of L itself, so unlike the reference's
wrapper this one pads nothing.  ``LAUNCHES`` counts kernel launches, one
per wrapper call that reached the kernel.
"""

from __future__ import annotations

from typing import Dict

import torch

from repro_torch.kernels.common import check_dtype
from repro_torch.kernels.flash_attention import kernel as _k
from repro_torch.kernels.flash_attention import ref

LAUNCHES: Dict[str, int] = {"flash_attention": 0}
DTYPES = (torch.float32, torch.bfloat16)


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           window: int) -> None:
    """Raise unless q (B, H, L, D) and k, v (B, K, L, D) fit each other:
    K divides H, one D, L >= 1, a window >= 0."""
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention: expected q (B, H, L, D) and k, v "
                         f"(B, K, L, D), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    (B, H, L, D), (Bk, K, Lk, Dk) = q.shape, k.shape
    if (Bk, Lk) != (B, L) or L < 1:
        raise ValueError(f"flash_attention: batch and length of q {(B, L)} "
                         f"and k/v {(Bk, Lk)} differ or are empty")
    if Dk != D:
        raise ValueError(f"flash_attention: head dims differ, q {D} vs k/v "
                         f"{Dk}")
    if K < 1 or H % K:
        raise ValueError(f"flash_attention: {K} kv heads do not divide "
                         f"{H} query heads")
    if window < 0:
        raise ValueError(f"flash_attention: window {window} < 0")


def check_kernel_inputs(q: torch.Tensor, k: torch.Tensor,
                        v: torch.Tensor) -> None:
    """Raise unless the kernel takes q, k and v: one dtype of ``DTYPES``
    and a head dim it was built for."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        check_dtype(f"flash_attention({name})", t, DTYPES)
    if len({q.dtype, k.dtype, v.dtype}) != 1:
        raise TypeError(f"flash_attention: q, k and v dtypes differ: "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if q.shape[-1] not in _k.HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {q.shape[-1]} not in "
                         f"{_k.HEAD_DIMS}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    window: int = 0) -> torch.Tensor:
    """Causal (``window`` > 0: sliding-window) attention, GQA head map
    ``h // (H / K)``.  q: (B, H, L, D); k, v: (B, K, L, D).  Returns
    (B, H, L, D) in q's dtype."""
    _check(q, k, v, window)
    devices = {t.device for t in (q, k, v)}
    if devices == {torch.device("cpu")}:
        return ref.attention(q, k, v, window=window)
    if len(devices) != 1 or q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported devices "
                         f"{sorted(str(d) for d in devices)}")
    check_kernel_inputs(q, k, v)
    out = _k.flash_attention(q, k, v, window=window)
    LAUNCHES["flash_attention"] += 1
    return out
