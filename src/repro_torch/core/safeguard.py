"""SafeguardSGD (Allen-Zhu, Ebrahimian, Li, Alistarh — ICLR 2021), port of
``repro.core.safeguard``: Algorithm 1 (double safe guard) and Algorithm 2
(single safe guard) as an aggregation layer over stacked per-worker
gradients.

Two state representations:

  * **flat** (default): the A/B accumulators are ``(m, d_pad)`` float32
    matrices in the JAX package's ``tree_flatten`` column order
    (:class:`FlatLayout`), so they compare column for column with the
    reference.  The accumulate-and-reset updates the buffer IN PLACE (the
    reference is functional; the old buffer is never read again, and in
    place saves one ``(m, d_pad)`` copy per step).  ``backend`` picks the
    distance pass:

    ======================  ===============  ===============================
    JAX backend             port backend     what it runs
    ======================  ===============  ===============================
    ``"pallas"`` (default)  ``"kernel"``     plain accumulate + CUDA Gram
                                             kernel (B1)
    ``"pallas_fused"``      ``"kernel_fused"`` CUDA fused accumulate+Gram
                                             kernel (B2) on the flattened
                                             gradients
    ``"xla"``               ``"plain"``      plain accumulate + plain Gram
    ======================  ===============  ===============================

    On CPU tensors the kernel wrappers run their plain versions.
  * **stacked**: stacked-tree accumulators and a leaf-by-leaf Gram, kept
    as the in-package oracle.

The sketched mode of the reference is not ported yet.  Accumulators are
always float32 (the reference's default ``acc_dtype``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Tuple

import torch

from repro_torch.core import tree_utils as tu
from repro_torch.kernels.safeguard_filter import ops as sf_ops
from repro_torch.kernels.safeguard_filter import ref as sf_ref

f32 = torch.float32

# --------------------------------------------------------------------------
# Flat buffer layout
# --------------------------------------------------------------------------

_LANE = 128           # the reference's lane multiple
_BLOCK_D = 512        # the reference's preferred d-tile


@dataclasses.dataclass(frozen=True)
class FlatLayout:
    """The one-time flattening of a parameter tree into ``(m, d_pad)``
    rows.  ``offsets[i]:offsets[i]+sizes[i]`` is leaf ``i``'s column
    slice; ``paths`` names the leaves in column order."""
    structure: Any                    # tu.tree_structure of the param tree
    paths: Tuple[str, ...]
    shapes: Tuple[Tuple[int, ...], ...]
    dtypes: Tuple[torch.dtype, ...]
    offsets: Tuple[int, ...]
    sizes: Tuple[int, ...]
    d: int                            # true model dimension
    d_padded: int                     # the reference's padded width


def make_layout(params_like) -> FlatLayout:
    """``params_like``: a parameter tree (NOT worker-stacked).  Same
    ``d_padded`` rule as the reference, so state tensors compare one to
    one."""
    leaves = tu.tree_leaves(params_like)
    if not leaves:
        raise ValueError("empty gradient tree")
    shapes, dtypes, offsets, sizes = [], [], [], []
    off = 0
    for leaf in leaves:
        size = math.prod(int(s) for s in leaf.shape)
        shapes.append(tuple(int(s) for s in leaf.shape))
        dtypes.append(leaf.dtype)
        offsets.append(off)
        sizes.append(size)
        off += size
    d = off
    pad_to = _BLOCK_D if d >= _BLOCK_D else _LANE
    return FlatLayout(structure=tu.tree_structure(params_like),
                      paths=tuple(tu.tree_paths(params_like)),
                      shapes=tuple(shapes), dtypes=tuple(dtypes),
                      offsets=tuple(offsets), sizes=tuple(sizes), d=d,
                      d_padded=d + (-d) % pad_to)


def flatten_stacked(grads, layout: FlatLayout) -> torch.Tensor:
    """Worker-stacked tree (leaves ``(m, ...)``) -> ``(m, d_pad)`` float32
    matrix in the layout's column order, zero padding columns."""
    leaves = tu.tree_leaves(grads)
    m = leaves[0].shape[0]
    if sum(leaf[0].numel() for leaf in leaves) != layout.d:
        raise ValueError("gradient tree does not match the layout")
    flat = torch.zeros((m, layout.d_padded), dtype=f32,
                       device=leaves[0].device)
    for leaf, off, size in zip(leaves, layout.offsets, layout.sizes):
        flat[:, off:off + size] = leaf.reshape(m, size)
    return flat


def unflatten_row(row: torch.Tensor, layout: FlatLayout):
    """One worker row ``(d_pad,)`` -> parameter-tree view (diagnostics)."""
    like = _skeleton(layout.structure)
    leaves = [row[off:off + size].reshape(shape).to(dt)
              for shape, dt, off, size in zip(layout.shapes, layout.dtypes,
                                               layout.offsets, layout.sizes)]
    return tu.tree_unflatten(like, leaves)


def _skeleton(structure):
    """An empty tree of the given ``tu.tree_structure``."""
    if structure[0] == "dict":
        return {k: _skeleton(s) for k, s in structure[1]}
    if structure[0] == "seq":
        return [_skeleton(s) for s in structure[1]]
    return None


# --------------------------------------------------------------------------
# Config
# --------------------------------------------------------------------------

# empirical-filter eviction multiplier (paper Appendix C.1), single source
THRESHOLD_SCALE = 1.5

BACKENDS = ("kernel", "kernel_fused", "plain")


@dataclasses.dataclass(frozen=True)
class SafeguardConfig:
    """Hyper-parameters of the safeguard filter (see the reference's
    ``SafeguardConfig`` for the meaning of each field)."""
    m: int
    T0: int = 100
    T1: int = 600
    mode: str = "double"        # "double" | "single"
    rule: str = "empirical"     # "empirical" | "theoretical"
    thresh0: float = 0.0
    thresh1: float = 0.0
    threshold_scale: float = THRESHOLD_SCALE
    threshold_floor: float = 5.0
    nu: float = 0.0
    reset_period: int = 0
    aggregate_prefilter: bool = True
    engine: str = "flat"        # "flat" | "stacked"
    backend: str = "kernel"     # see BACKENDS and the module docstring

    def __post_init__(self):
        if self.mode not in ("double", "single"):
            raise ValueError(f"bad mode {self.mode!r}")
        if self.rule not in ("empirical", "theoretical"):
            raise ValueError(f"bad rule {self.rule!r}")
        if self.engine not in ("flat", "stacked"):
            raise ValueError(f"bad engine {self.engine!r}")
        if self.backend not in BACKENDS:
            raise ValueError(f"bad backend {self.backend!r}")
        if self.T0 > self.T1:
            raise ValueError("need T0 <= T1")
        if self.rule == "theoretical" and self.thresh0 <= 0:
            raise ValueError("theoretical rule needs explicit thresholds")

    @staticmethod
    def theoretical_thresholds(T0: int, T1: int, m: int, p: float = 0.01,
                               V: float = 1.0):
        """Paper Lemma 3.2 / B.2 thresholds ``8 sqrt(T log(16 m T / p))``."""
        t0 = 8.0 * V * math.sqrt(T0 * math.log(16 * m * T1 / p)) / m
        t1 = 8.0 * V * math.sqrt(T1 * math.log(16 * m * T1 / p)) / m
        return t0, t1


# --------------------------------------------------------------------------
# State
# --------------------------------------------------------------------------

@dataclasses.dataclass
class SafeguardState:
    """Carried across steps.  ``A``/``B`` are ``(m, d_pad)`` buffers under
    the flat engine and stacked trees under the stacked engine; ``layout``
    is ``None`` unless the flat engine is active.  ``step`` is a 0-d
    int32 tensor on the device, so the window resets need no host sync."""
    good: torch.Tensor          # (m,) bool
    step: torch.Tensor          # () int32
    A: Any                      # long window (None in single mode)
    B: Any                      # short window
    evicted_at: torch.Tensor    # (m,) int32, -1 if never evicted
    layout: Optional[FlatLayout] = None


def init_state(cfg: SafeguardConfig, params_like) -> SafeguardState:
    """``params_like``: a parameter tree (NOT stacked) giving shapes and
    the device."""
    device = tu.tree_leaves(params_like)[0].device
    layout = None
    if cfg.engine == "flat":
        layout = make_layout(params_like)

        def buf():
            return torch.zeros((cfg.m, layout.d_padded), dtype=f32,
                               device=device)
        A = buf() if cfg.mode == "double" else None
        B = buf()
    else:
        def buf():
            return tu.tree_map(lambda p: torch.zeros(
                (cfg.m,) + tuple(p.shape), dtype=f32, device=device),
                params_like)
        A = buf() if cfg.mode == "double" else None
        B = buf()
    return SafeguardState(
        good=torch.ones((cfg.m,), dtype=torch.bool, device=device),
        step=torch.zeros((), dtype=torch.int32, device=device),
        A=A, B=B,
        evicted_at=torch.full((cfg.m,), -1, dtype=torch.int32,
                              device=device),
        layout=layout)


# --------------------------------------------------------------------------
# Filter internals
# --------------------------------------------------------------------------

_BIG = 1e30


def _masked_dist(sqdist: torch.Tensor, good: torch.Tensor) -> torch.Tensor:
    # decision-site clamp: a negative sqdist from f32 cancellation would
    # turn sqrt into NaN, and a NaN distance compares False against the
    # threshold — silently evicting honest workers
    dist = torch.sqrt(torch.clamp(sqdist, min=0.0))
    big = torch.full_like(dist, _BIG)
    dist = torch.where(good[None, :], dist, big)
    return torch.where(good[:, None], dist, big)


def _empirical_filter(sqdist: torch.Tensor, good: torch.Tensor, m: int,
                      scale: float, floor: float):
    """Appendix C.1: score_i = (ceil(m/2)+1)-th smallest distance over good
    j; med = argmin score (first index on ties); evict j with
    d(j, med) >= scale * max(S, floor).  Returns (pass mask, med index,
    threshold, scores)."""
    dist = _masked_dist(sqdist, good)
    k = min(int(-(-m // 2)) + 1, m)
    sorted_d = torch.sort(dist, dim=1).values
    scores = sorted_d[:, k - 1]
    scores = torch.where(good, scores, torch.full_like(scores, _BIG))
    med = torch.argmin(scores)
    S = scores[med]
    thresh = scale * torch.clamp(S, min=floor)
    ok = dist[:, med] < thresh
    ok = ok | (torch.arange(m, device=good.device) == med)
    return ok & good, med, thresh, scores


def _theoretical_filter(sqdist: torch.Tensor, good: torch.Tensor, m: int,
                        thresh: float):
    """Paper Algorithm 1 lines 9-11: med = first good i with a strict
    majority within ``thresh`` (else the good worker with the highest
    count); evict at ``2 * thresh``."""
    dist = _masked_dist(sqdist, good)
    within = (dist <= thresh) & good[None, :] & good[:, None]
    counts = within.sum(dim=1)
    valid = good & (counts > m // 2)
    counts_masked = torch.where(good, counts, torch.full_like(counts, -1))
    # argmax over a bool needs an int cast in torch; first index on ties
    med = torch.where(valid.any(), torch.argmax(valid.to(torch.int32)),
                      torch.argmax(counts_masked))
    ok = dist[:, med] <= 2.0 * thresh
    ok = ok | (torch.arange(m, device=good.device) == med)
    thr = torch.tensor(2.0 * thresh, dtype=f32, device=good.device)
    return ok & good, med, thr, counts.to(f32)


def _accumulate_exact(acc, grads, reset, inv_ngood):
    """Stacked engine: acc <- [reset ? 0 : acc] + grads / n_good."""
    def one(a, g):
        a = torch.where(reset, torch.zeros_like(a), a)
        return a + g.to(f32) * inv_ngood
    return tu.tree_map(one, acc, grads)


def _accumulate_flat(acc, grads, reset, scale, layout: FlatLayout):
    """acc <- [reset ? 0 : acc] + flatten(grads) * scale, IN PLACE.  The
    reset is a fill (a select), so an inf/NaN row is cleared; each leaf is
    added into its column slice, so no (m, d) flattened matrix is built."""
    acc.masked_fill_(reset, 0.0)
    leaves = tu.tree_leaves(grads)
    m = leaves[0].shape[0]
    for leaf, off, size in zip(leaves, layout.offsets, layout.sizes):
        acc[:, off:off + size].add_(leaf.reshape(m, size).to(f32) * scale)
    return acc


def _flat_sqdist(buf, cfg: SafeguardConfig):
    if cfg.backend == "kernel":
        return sf_ops.pairwise_sqdist(buf)
    return sf_ref.pairwise_sqdist(buf)


def _flat_update(acc, grads, gflat, reset, scale, cfg: SafeguardConfig,
                 layout: FlatLayout):
    """One accumulator's flat-engine update -> (new_acc, sqdist).
    ``gflat`` is the flattened gradient matrix, built by the caller only
    for the ``kernel_fused`` backend (``None`` otherwise)."""
    if gflat is not None:
        return sf_ops.fused_accumulate_sqdist(acc, gflat, reset, scale)
    new = _accumulate_flat(acc, grads, reset, scale, layout)
    return new, _flat_sqdist(new, cfg)


# --------------------------------------------------------------------------
# The step
# --------------------------------------------------------------------------

def safeguard_step(state: SafeguardState, grads, cfg: SafeguardConfig,
                   generator: Optional[torch.Generator] = None):
    """One master-side safeguard step.

    ``grads``: stacked per-worker gradient tree, leaves ``(m, ...)``, after
    the Byzantine rewrite.  ``generator`` draws the Gaussian perturbation
    (required if ``cfg.nu > 0``).  The flat accumulators of ``state`` are
    updated in place.  Returns ``(new_state, aggregated tree, info)``.
    """
    m = cfg.m
    t = state.step
    good = state.good

    # Section 5: periodically restore every worker (and clear its
    # eviction time)
    restored = torch.zeros_like(good)
    evicted_at = state.evicted_at
    if cfg.reset_period > 0:
        restore = (t % cfg.reset_period) == 0
        restored = restore & ~good
        good = torch.where(restore, torch.ones_like(good), good)
        evicted_at = torch.where(restored, torch.full_like(evicted_at, -1),
                                 evicted_at)

    n_good = torch.clamp(good.sum(), min=1).to(f32)
    inv_ngood = 1.0 / n_good

    reset_B = (t % cfg.T0) == 0
    reset_A = (t % cfg.T1) == 0

    if cfg.engine == "flat":
        layout = state.layout
        gflat = (flatten_stacked(grads, layout)
                 if cfg.backend == "kernel_fused" else None)
        B, sqdist_B = _flat_update(state.B, grads, gflat, reset_B,
                                   inv_ngood, cfg, layout)
        A, sqdist_A = None, None
        if cfg.mode == "double":
            A, sqdist_A = _flat_update(state.A, grads, gflat, reset_A,
                                       inv_ngood, cfg, layout)
    else:
        B = _accumulate_exact(state.B, grads, reset_B, inv_ngood)
        sqdist_B = tu.tree_pairwise_sqdist(B)
        A, sqdist_A = None, None
        if cfg.mode == "double":
            A = _accumulate_exact(state.A, grads, reset_A, inv_ngood)
            sqdist_A = tu.tree_pairwise_sqdist(A)

    if cfg.rule == "empirical":
        okB, medB, thB, scoresB = _empirical_filter(
            sqdist_B, good, m, cfg.threshold_scale, cfg.threshold_floor)
        if cfg.mode == "double":
            okA, medA, thA, _ = _empirical_filter(
                sqdist_A, good, m, cfg.threshold_scale, cfg.threshold_floor)
        else:
            okA, medA, thA = torch.ones_like(okB), medB, thB
    else:
        okB, medB, thB, scoresB = _theoretical_filter(
            sqdist_B, good, m, cfg.thresh0)
        if cfg.mode == "double":
            okA, medA, thA, _ = _theoretical_filter(
                sqdist_A, good, m, cfg.thresh1)
        else:
            okA, medA, thA = torch.ones_like(okB), medB, thB

    new_good = good & okA & okB
    newly_evicted = good & ~new_good
    evicted_at = torch.where(newly_evicted, t.to(torch.int32), evicted_at)

    # SGD direction over good_t (pre-filter, paper line 12) or good_{t+1}
    agg_mask = good if cfg.aggregate_prefilter else new_good
    agg = tu.tree_masked_mean(grads, agg_mask)

    if cfg.nu > 0.0:
        if generator is None:
            raise ValueError("nu > 0 requires a generator")
        agg = tu.tree_map(
            lambda leaf: leaf + cfg.nu * torch.randn(
                leaf.shape, generator=generator, dtype=leaf.dtype,
                device=leaf.device), agg)

    new_state = SafeguardState(
        good=new_good, step=t + 1,
        A=A if cfg.mode == "double" else state.A, B=B,
        evicted_at=evicted_at, layout=state.layout)
    dist_B = torch.sqrt(torch.clamp(sqdist_B, min=0.0))[:, medB]
    dist_A = (torch.sqrt(torch.clamp(sqdist_A, min=0.0))[:, medA]
              if sqdist_A is not None else dist_B)
    info = {
        "n_good": n_good,
        "med_B": medB,
        "med_A": medA,
        "threshold_B": thB,
        "threshold_A": thA,
        "dist_to_med_B": dist_B,
        "dist_to_med_A": dist_A,
        "scores_B": scoresB,
        "newly_evicted": newly_evicted,
        "restored": restored,
        "good": new_good,
    }
    return new_state, agg, info
