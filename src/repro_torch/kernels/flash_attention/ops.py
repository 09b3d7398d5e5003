"""Wrapper of the flash-attention kernel (port of
``repro.kernels.flash_attention.ops``): causal attention with GQA and an
optional sliding window over q (B, H, L, D) and k, v (B, K, L, D).

Dispatch is on the tensors' device, then on their dtype:

  * CPU tensors go to the plain PyTorch version in ``ref.py``;
  * bfloat16 CUDA tensors go to the tensor-core kernel
    (``csrc/flash_attention_tc.cu``), which reads them through TMA and so
    raises ``ValueError`` on a layout TMA cannot address;
  * float32 CUDA tensors go to the CUDA-core kernel
    (``csrc/flash_attention.cu``);
  * anything else raises.  There is no fallback from one kernel to the
    other, or to the plain version.

The kernels mask the ragged edge of L themselves, so unlike the
reference's wrapper this one pads nothing.  ``LAUNCHES`` counts kernel
launches, one per wrapper call that reached a kernel: ``flash_attention``
in all, and each kernel apart.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.kernels.common import check_dtype
from repro_torch.kernels.flash_attention import kernel as _k
from repro_torch.kernels.flash_attention import ref

LAUNCHES: Dict[str, int] = {"flash_attention": 0, "flash_attention_tc": 0,
                            "flash_attention_f32": 0}
DTYPES = (torch.float32, torch.bfloat16)
TMA_ALIGN = 16      # bytes: TMA's alignment of the start and of each stride


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


def tma_strides(q: torch.Tensor, k: torch.Tensor,
                v: torch.Tensor) -> Tuple[int, ...]:
    """The 12 element strides (b, h, l, d of q, k, v) that the
    tensor-core kernel's tensor maps take.  Raise ``ValueError`` unless TMA
    can address each tensor: last-dim stride 1, every other stride a
    multiple of 16 bytes, the start on 16 bytes.  The stride of a dim of
    size 1 is never followed, so it is given as 16 bytes."""
    out = []
    for name, t in (("q", q), ("k", k), ("v", v)):
        size = t.element_size()
        if t.stride(3) != 1 or t.data_ptr() % TMA_ALIGN:
            raise ValueError(f"flash_attention({name}): the tensor-core kernel "
                             f"needs a last-dim stride of 1 and a 16-byte "
                             f"aligned start, got strides {t.stride()}")
        st = [s if n > 1 else TMA_ALIGN // size
              for n, s in zip(t.shape[:3], t.stride()[:3])]
        if any(s <= 0 or s * size % TMA_ALIGN for s in st):
            raise ValueError(f"flash_attention({name}): strides {t.stride()} "
                             f"are not multiples of {TMA_ALIGN} bytes, which "
                             f"the tensor-core kernel's TMA loads need")
        out += [*st, 1]
    return tuple(out)


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
    if q.dtype == torch.bfloat16:
        out = _k.flash_attention_tc(q, k, v, window=window,
                                    strides=tma_strides(q, k, v))
        LAUNCHES["flash_attention_tc"] += 1
    else:
        out = _k.flash_attention(q, k, v, window=window)
        LAUNCHES["flash_attention_f32"] += 1
    LAUNCHES["flash_attention"] += 1
    return out
