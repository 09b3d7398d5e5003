"""Plain PyTorch versions of the robust-aggregation kernel (port of
``repro.kernels.robust_agg.ref``).

The CPU wrappers run these; on the card ``chip_smoke.py`` holds the CUDA
kernel against them.  Both follow the arithmetic of the JAX defense
(``repro.core.aggregators``) to the bit:

  * the median is ``jnp.median``'s midpoint ``(s[(m-1)//2] + s[m//2]) *
    0.5`` of the float32 values sorted over dim 0 (so an odd m gives the
    middle value, save where ``2 * s`` overflows), and a column that holds
    a NaN gives NaN.  ``torch.median`` would return the lower middle value
    for even m, and ``torch.quantile`` refuses more than 2**24 elements;
  * the trimmed mean sorts with NaN last, adds the kept ranks in rank
    order and multiplies by the float32 reciprocal of their count, which
    is what XLA makes of ``jnp.mean`` over the kept rows.
"""

import torch

f32 = torch.float32


def _sorted(g: torch.Tensor) -> torch.Tensor:
    """(m, n) -> its float32 values sorted over dim 0, NaN last."""
    return torch.sort(g.to(f32), dim=0).values


def coord_median(g: torch.Tensor) -> torch.Tensor:
    """(m, n) -> (n,) float32 per-coordinate median."""
    s = _sorted(g)
    m = s.shape[0]
    med = (s[(m - 1) // 2] + s[m // 2]) * 0.5
    return torch.where(torch.isnan(g).any(dim=0), float("nan"), med)


def trimmed_mean(g: torch.Tensor, trim: int) -> torch.Tensor:
    """(m, n) -> (n,) float32: drop ``trim`` smallest and largest values
    per coordinate, mean of the rest."""
    m = g.shape[0]
    s = _sorted(g)
    total = torch.zeros_like(s[0])
    for rank in range(trim, m - trim):
        total = total + s[rank]
    inv = torch.ones((), dtype=f32, device=g.device) / (m - 2 * trim)
    return total * inv
