"""Historyless aggregators (port of ``repro.core.aggregators``): the
baselines the paper compares against — naive mean, coordinate-wise
median, trimmed mean, the geometric medoid and Weiszfeld's geometric
median, Krum and Zeno.  Stacked tree (leaves ``(m, ...)``) -> parameter
tree.

The coordinate-wise statistics go leaf by leaf through
``kernels.robust_agg`` (kernel B3 on the card): each stacked leaf is
viewed as ``(m, n)``, reduced to float32 and cast back to the leaf's
dtype.  The selection rules keep the reference's tie-break (``argmin``
picks the first index) and the reference's float32 distances.
"""

from __future__ import annotations

import torch

from repro_torch.core import tree_utils as tu
from repro_torch.kernels import robust_agg

f32 = torch.float32


def mean(grads):
    """Naive mean — no Byzantine tolerance at all."""
    return tu.tree_map(lambda g: g.mean(dim=0), grads)


def _per_leaf(reduce):
    """Apply ``reduce((m, n)) -> (n,) float32`` to every stacked leaf."""
    def one(g):
        out = reduce(g.reshape(g.shape[0], -1))
        return out.reshape(g.shape[1:]).to(g.dtype)
    return one


def coordinate_median(grads):
    """Definition C.2 — per-coordinate median over workers."""
    return tu.tree_map(_per_leaf(robust_agg.coord_median), grads)


def trimmed_mean(grads, trim: int):
    """Drop the ``trim`` lowest and highest values per coordinate, then mean
    (Yin et al. 2018)."""
    return tu.tree_map(
        _per_leaf(lambda g: robust_agg.trimmed_mean(g, trim)), grads)


def medoid_index(grads) -> torch.Tensor:
    """The worker minimizing its summed distance to all others."""
    sqdist = tu.tree_pairwise_sqdist(grads)
    return torch.argmin(torch.sqrt(sqdist).sum(dim=1))


def geometric_medoid(grads):
    """Paper Definition C.1 as implemented in their experiments: the set
    element minimizing the summed distance to all others."""
    return tu.tree_select_worker(grads, medoid_index(grads))


def geometric_median(grads, iters: int = 8, eps: float = 1e-8):
    """True geometric median via Weiszfeld iterations (smoothed).

    The iterate stays float32 across all iterations and is cast to the
    gradient dtype once at the end; the weights guard against ``w.sum()
    == 0`` (every distance overflowing to inf)."""
    m = tu.tree_worker_count(grads)
    grads32 = tu.tree_map(lambda g: g.to(f32), grads)
    y = tu.tree_map(lambda g: g.mean(dim=0), grads32)
    for _ in range(iters):
        parts = tu.tree_map(
            lambda g, c: (g - c[None]).square().reshape(m, -1).sum(dim=1),
            grads32, y)
        dist = torch.sqrt(sum(tu.tree_leaves(parts)) + eps)
        w = 1.0 / dist
        w = w / torch.clamp(w.sum(), min=1e-30)
        y = tu.tree_map(lambda g: torch.tensordot(w, g, dims=1), grads32)
    return tu.tree_map(lambda yl, g: yl.to(g.dtype), y, grads)


def krum_index(grads, n_byz: int) -> torch.Tensor:
    """The worker whose ``m - b - 2`` nearest neighbours are closest in
    squared distance."""
    m = tu.tree_worker_count(grads)
    k = m - n_byz - 2
    if k < 1:
        raise ValueError(f"Krum needs m > b + 2 (m={m}, b={n_byz})")
    sqdist = tu.tree_pairwise_sqdist(grads)
    eye = torch.eye(m, dtype=torch.bool, device=sqdist.device)
    sqdist = torch.where(eye, float("inf"), sqdist)
    nearest = torch.sort(sqdist, dim=1).values[:, :k]
    return torch.argmin(nearest.sum(dim=1))


def krum(grads, n_byz: int):
    """Definition C.3 — select the Krum worker."""
    return tu.tree_select_worker(grads, krum_index(grads, n_byz))


def zeno_keep(scores: torch.Tensor, n_byz: int) -> torch.Tensor:
    """(m,) bool: the ``m - b`` workers with the highest scores (ties go
    to the lower index, as the reference's stable argsort)."""
    m = scores.shape[0]
    order = torch.argsort(-scores, stable=True)
    keep = torch.zeros((m,), dtype=torch.bool, device=scores.device)
    keep[order[:m - n_byz]] = True
    return keep


def zeno(grads, scores: torch.Tensor, n_byz: int):
    """Definition C.4 — mean of the ``m - b`` gradients with the highest
    *stochastic descendant scores* (computed by the caller: Zeno needs a
    master-side loss oracle, see ``train.trainer.zeno_scores``)."""
    return tu.tree_masked_mean(grads, zeno_keep(scores, n_byz))


def zeno_score(loss_before: torch.Tensor, loss_after: torch.Tensor,
               grad_sq_norm: torch.Tensor, rho: float = 5e-4
               ) -> torch.Tensor:
    """Score(u) = f_r(x) - f_r(x - eta u) - rho ||u||^2 (eta folded in by
    the caller evaluating ``loss_after`` at ``x - eta u``)."""
    return loss_before - loss_after - rho * grad_sq_norm
