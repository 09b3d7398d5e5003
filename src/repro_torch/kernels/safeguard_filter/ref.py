"""Plain PyTorch versions of the safeguard-filter kernels (port of
``repro.kernels.safeguard_filter.ref``).

The CPU wrappers run these; on the card ``chip_smoke.py`` holds each CUDA
kernel against them.  The filter thresholds these distances, so every
float32 product here is full IEEE float32: TF32 is switched off for
matmuls and for cuDNN before any product is taken.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def gram(a: torch.Tensor) -> torch.Tensor:
    """(m, d) -> (m, m) float32 Gram matrix."""
    af = a.float()
    return af @ af.T


def pairwise_sqdist(a: torch.Tensor) -> torch.Tensor:
    """(m, d) -> (m, m) float32 squared L2 distances, clipped at 0."""
    g = gram(a)
    diag = torch.diagonal(g)
    return torch.clamp(diag[:, None] + diag[None, :] - 2.0 * g, min=0.0)


def fused_accumulate_sqdist(acc: torch.Tensor, g: torch.Tensor, reset,
                            scale):
    """``new = (reset ? 0 : acc) + g * scale`` (a select, so an inf/NaN
    accumulator is cleared by the reset) and the (m, m) sqdist of ``new``.
    ``reset`` and ``scale`` are python scalars or 0-d/1-element tensors.
    Returns ``(new, sqdist)``; ``acc`` is not modified."""
    reset = torch.as_tensor(reset, device=acc.device).reshape(()) != 0
    scale = torch.as_tensor(scale, dtype=torch.float32,
                            device=acc.device).reshape(())
    kept = torch.where(reset, torch.zeros_like(acc), acc).float()
    new = kept + g.float() * scale
    return new, pairwise_sqdist(new)
