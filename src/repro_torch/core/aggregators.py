"""Historyless aggregators (port of ``repro.core.aggregators``): stacked
tree (leaves ``(m, ...)``) -> parameter tree.  Only ``mean`` is ported;
the robust baselines come with the rest of the defense zoo."""

from __future__ import annotations

from repro_torch.core import tree_utils as tu


def mean(grads):
    """Naive mean — no Byzantine tolerance at all."""
    return tu.tree_map(lambda g: g.mean(dim=0), grads)
