"""Wrappers of the robust-aggregation kernel (port of
``repro.kernels.robust_agg.ops``): the coordinate-wise median and
trimmed mean over the worker axis of an ``(m, n)`` matrix.

Dispatch is on the tensor's device and nothing else:

  * a CPU tensor goes to the plain PyTorch version in ``ref.py``;
  * a CUDA tensor goes to the hand-written CUDA kernel (``kernel.py``),
    after checks of dtype, shape and contiguity that raise on what the
    kernel does not take.  There is no fallback.

``LAUNCHES`` counts kernel launches, one per wrapper call that reached
the kernel.
"""

from __future__ import annotations

from typing import Dict

import torch

from repro_torch.kernels.common import check_matrix
from repro_torch.kernels.robust_agg import kernel as _k
from repro_torch.kernels.robust_agg import ref

LAUNCHES: Dict[str, int] = {"coord_median": 0, "trimmed_mean": 0}
DTYPES = (torch.float32, torch.bfloat16)


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _on_card(name: str, g: torch.Tensor) -> bool:
    """False for a CPU tensor; True for a CUDA tensor the kernel takes;
    raises for anything else."""
    if g.device.type == "cpu":
        return False
    if g.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {g.device}")
    check_matrix(name, g, DTYPES, _k.MAX_M)
    return True


def coord_median(g: torch.Tensor) -> torch.Tensor:
    """(m, n) float32/bfloat16 -> (n,) float32 coordinate-wise median
    (``jnp.median``: the midpoint of the middle pair; NaN propagates)."""
    if not _on_card("coord_median", g):
        return ref.coord_median(g)
    out = _k.sorted_reduce(g, trim=0, median=True)
    LAUNCHES["coord_median"] += 1
    return out


def trimmed_mean(g: torch.Tensor, trim: int) -> torch.Tensor:
    """(m, n) -> (n,) float32 trimmed mean: drop the ``trim`` lowest and
    highest values of each coordinate, then average."""
    m = g.shape[0]
    if trim < 0 or 2 * trim >= m:
        raise ValueError(f"trim {trim} out of range for m={m}: need 0 <= "
                         "trim and 2 * trim < m")
    if not _on_card("trimmed_mean", g):
        return ref.trimmed_mean(g, trim)
    out = _k.sorted_reduce(g, trim=trim, median=False)
    LAUNCHES["trimmed_mean"] += 1
    return out
