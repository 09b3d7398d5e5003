"""Non-IID worker measurements (port of ``repro.data.hetero``; only the
``zeta_sq`` trace is ported — the Dirichlet and concept-shift worker
models are not yet)."""

from __future__ import annotations

import torch

from repro_torch.core import tree_utils as tu


def zeta_sq(grads, mask: torch.Tensor) -> torch.Tensor:
    """Measured inter-worker dissimilarity ``E_{i in mask} ||g_i -
    g_bar_mask||^2`` of this step's stacked gradients."""
    return tu.tree_dissimilarity(grads, mask)
