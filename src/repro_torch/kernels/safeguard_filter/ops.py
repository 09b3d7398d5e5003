"""Wrappers of the safeguard-filter kernels (port of
``repro.kernels.safeguard_filter.ops``).

Dispatch is on the tensor's device and nothing else:

  * a CPU tensor goes to the plain PyTorch version in ``ref.py``;
  * a CUDA tensor goes to the hand-written CUDA kernel (``kernel.py``),
    after checks of dtype, shape and contiguity that raise on what the
    kernel does not take.  There is no fallback.

``LAUNCHES`` counts kernel launches, one per wrapper call that reached a
kernel, so that a run can show its main path went through the kernels.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.kernels.common import check_matrix
from repro_torch.kernels.safeguard_filter import kernel as _k
from repro_torch.kernels.safeguard_filter import ref

LAUNCHES: Dict[str, int] = {"pairwise_sqdist": 0,
                            "fused_accumulate_sqdist": 0}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _device_scalar(x, dtype, device) -> torch.Tensor:
    """A one-element tensor of ``dtype`` on ``device`` (no host sync for a
    tensor that already lives there)."""
    t = torch.as_tensor(x, device=device)
    if t.numel() != 1:
        raise ValueError(f"expected a scalar, got shape {tuple(t.shape)}")
    return t.reshape(1).to(dtype).contiguous()


def pairwise_sqdist(a: torch.Tensor) -> torch.Tensor:
    """(m, d) float32/bfloat16 -> (m, m) float32 squared distances."""
    if a.device.type == "cpu":
        return ref.pairwise_sqdist(a)
    if a.device.type != "cuda":
        raise ValueError(f"pairwise_sqdist: unsupported device {a.device}")
    check_matrix("pairwise_sqdist", a, (torch.float32, torch.bfloat16),
                 _k.MAX_M)
    out = _k.pairwise_sqdist(a)
    LAUNCHES["pairwise_sqdist"] += 1
    return out


def fused_accumulate_sqdist(acc: torch.Tensor, g: torch.Tensor, reset,
                            scale) -> Tuple[torch.Tensor, torch.Tensor]:
    """``acc <- (reset ? 0 : acc) + g * scale`` IN PLACE, and the (m, m)
    squared distances of the updated ``acc``.  acc, g: (m, d) float32;
    reset: bool/int scalar; scale: float scalar (tensors stay on the
    device, so a step needs no host sync).  Returns ``(acc, sqdist)``."""
    if acc.device.type == "cpu":
        new, sq = ref.fused_accumulate_sqdist(acc, g, reset, scale)
        acc.copy_(new)
        return acc, sq
    if acc.device.type != "cuda":
        raise ValueError(f"fused_accumulate_sqdist: unsupported device "
                         f"{acc.device}")
    check_matrix("fused_accumulate_sqdist(acc)", acc, (torch.float32,),
                 _k.MAX_M)
    check_matrix("fused_accumulate_sqdist(g)", g, (torch.float32,),
                 _k.MAX_M)
    if g.shape != acc.shape or g.device != acc.device:
        raise ValueError(f"fused_accumulate_sqdist: g {tuple(g.shape)} on "
                         f"{g.device} vs acc {tuple(acc.shape)} on "
                         f"{acc.device}")
    reset1 = _device_scalar(reset, torch.int32, acc.device)
    scale1 = _device_scalar(scale, torch.float32, acc.device)
    sq = _k.fused_accumulate_sqdist(acc, g, reset1, scale1)
    LAUNCHES["fused_accumulate_sqdist"] += 1
    return acc, sq
