"""Helpers for stacked per-worker gradients (port of
``repro.core.tree_utils``).

A tree here is a nested dict (or list) of tensors.  Leaves are visited in
JAX's ``tree_flatten`` order — dict keys sorted — so that flat layouts,
and the A/B buffers built on them, line up column for column with the
JAX package's.  A stacked tree carries a leading worker axis ``m`` on
every leaf.
"""

from __future__ import annotations

from typing import Any, Callable, List, Tuple

import torch

f32 = torch.float32


def tree_leaves(tree) -> List[torch.Tensor]:
    """Leaves in ``jax.tree_util.tree_leaves`` order (sorted dict keys)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for sub in tree for leaf in tree_leaves(sub)]
    if tree is None:
        return []
    return [tree]


def tree_paths(tree, prefix: str = "") -> List[str]:
    """Dotted key paths of the leaves, in :func:`tree_leaves` order."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree)
                for p in tree_paths(tree[k], f"{prefix}{k}.")]
    if isinstance(tree, (list, tuple)):
        return [p for i, sub in enumerate(tree)
                for p in tree_paths(sub, f"{prefix}{i}.")]
    return [prefix[:-1]]


def tree_map(fn: Callable, tree, *rest):
    """``jax.tree.map`` over nested dicts/lists of tensors."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, t, *(r[i] for r in rest))
                          for i, t in enumerate(tree))
    return fn(tree, *rest)


def _build(node, it):
    if isinstance(node, dict):
        return {k: _build(node[k], it) for k in sorted(node)}
    if isinstance(node, (list, tuple)):
        return type(node)(_build(s, it) for s in node)
    return next(it)


def tree_unflatten(like, leaves: List[Any]):
    """Rebuild ``like``'s structure from leaves in :func:`tree_leaves`
    order.  Module-level recursion on purpose: a nested recursive closure
    is a reference cycle that would keep ``leaves`` (a step's stacked
    gradients) alive until the cycle collector runs."""
    return _build(like, iter(leaves))


def tree_structure(tree) -> Tuple:
    """Hashable description of a tree's structure (the treedef)."""
    if isinstance(tree, dict):
        return ("dict", tuple((k, tree_structure(tree[k]))
                              for k in sorted(tree)))
    if isinstance(tree, (list, tuple)):
        return ("seq", tuple(tree_structure(s) for s in tree))
    return ("leaf",)


def tree_worker_count(tree) -> int:
    """Leading-axis size shared by every leaf of a stacked tree."""
    leaves = tree_leaves(tree)
    if not leaves:
        raise ValueError("empty tree")
    m = leaves[0].shape[0]
    for leaf in leaves:
        if leaf.shape[0] != m:
            raise ValueError(
                f"inconsistent worker axis: {leaf.shape[0]} vs {m}")
    return m


def tree_sq_norm(tree) -> torch.Tensor:
    """Scalar squared L2 norm over a (non-stacked) tree, in f32."""
    return sum(leaf.to(f32).square().sum() for leaf in tree_leaves(tree))


def tree_row_sq_norms(tree) -> torch.Tensor:
    """``(m,)`` squared L2 norm of every worker row of a stacked tree."""
    leaves = tree_leaves(tree)
    m = leaves[0].shape[0]
    tot = torch.zeros((m,), dtype=f32, device=leaves[0].device)
    for leaf in leaves:
        tot = tot + leaf.to(f32).square().reshape(m, -1).sum(dim=1)
    return tot


def gram_to_sqdist(gram: torch.Tensor) -> torch.Tensor:
    """Pairwise squared distances from a Gram matrix, clipped at 0."""
    diag = torch.diagonal(gram)
    return torch.clamp(diag[:, None] + diag[None, :] - 2.0 * gram, min=0.0)


def tree_gram(tree) -> torch.Tensor:
    """``(m, m)`` Gram matrix of a stacked tree, leaf by leaf, in f32."""
    leaves = tree_leaves(tree)
    m = leaves[0].shape[0]
    gram = torch.zeros((m, m), dtype=f32, device=leaves[0].device)
    for leaf in leaves:
        lf = leaf.to(f32).reshape(m, -1)
        gram = gram + lf @ lf.T
    return gram


def tree_pairwise_sqdist(tree) -> torch.Tensor:
    """``(m, m)`` pairwise squared L2 distances between workers."""
    return gram_to_sqdist(tree_gram(tree))


def tree_masked_mean(tree, mask: torch.Tensor):
    """Mean over workers ``i`` with ``mask[i]``; mask is float/bool (m,)."""
    w = mask.to(f32)
    denom = torch.clamp(w.sum(), min=1.0)

    def one(leaf):
        wshape = (-1,) + (1,) * (leaf.ndim - 1)
        s = (leaf.to(f32) * w.reshape(wshape)).sum(dim=0)
        return (s / denom).to(leaf.dtype)
    return tree_map(one, tree)


def tree_dissimilarity(tree, mask: torch.Tensor) -> torch.Tensor:
    """``E_{i in mask} ||g_i - g_bar_mask||^2`` over the masked rows."""
    w = mask.to(f32)
    m = w.shape[0]
    sq = torch.zeros((m,), dtype=f32, device=w.device)
    # leaf by leaf, so only one leaf's f32 deviations are alive at a time
    for leaf in tree_leaves(tree):
        center = tree_masked_mean(leaf, mask)
        diff = leaf.to(f32) - center[None].to(f32)
        sq = sq + diff.square().reshape(m, -1).sum(dim=1)
    return (sq * w).sum() / torch.clamp(w.sum(), min=1.0)


def tree_select_worker(tree, idx):
    """Row ``idx`` (an int or a 0-d/1-element tensor, read on the device
    without a host sync) of every leaf of a stacked tree."""
    def one(leaf):
        i = torch.as_tensor(idx, device=leaf.device).reshape(1)
        return torch.index_select(leaf, 0, i)[0]
    return tree_map(one, tree)
