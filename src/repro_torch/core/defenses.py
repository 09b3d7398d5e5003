"""The Defense protocol (port of ``repro.core.defenses``):

    init_state(params_like)       -> state        [None = stateless]
    aggregate(state, grads, ctx)  -> (agg, state', info)

``grads`` is the worker-stacked gradient tree after the Byzantine
rewrite; ``ctx`` carries step-scoped resources (``generator``, and
``scores`` from Zeno's held-batch oracle).  ``info`` always has ``good``
and ``n_good``.  The registry holds the seven historyless baselines of
``core.aggregators`` (``mean``, ``coord_median``, ``trimmed_mean``,
``geo_median``, ``weiszfeld``, ``krum``, ``zeno``) and
``safeguard_single``/``safeguard_double``; the history-aware zoo is not
ported yet.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Dict, Optional

import torch

from repro_torch.core import aggregators as agg_lib
from repro_torch.core import safeguard as sg
from repro_torch.core import tree_utils as tu

# Knob defaults shared by the factories below — single source.
DEFENSE_DEFAULTS = {
    "threshold_scale": sg.SafeguardConfig.threshold_scale,
}


def derive_trim(n_byz: int, m: int) -> int:
    """Per-coordinate trim count for trimmed-mean at ``b = alpha * m``:
    ``n_byz``, capped so that at least one value is kept."""
    return min(int(n_byz), (m - 1) // 2)


@dataclasses.dataclass(frozen=True)
class Defense:
    """One defense under the protocol; see the module docstring.

    ``static_nbyz``: the defense consumes ``n_byz`` as a python value
    (slice and selection bounds)."""
    name: str
    aggregate: Callable
    init_state: Optional[Callable] = None
    needs_held_batch: bool = False    # Zeno's master-side score oracle
    static_nbyz: bool = False

    @property
    def stateful(self) -> bool:
        return self.init_state is not None

    @property
    def historyless(self) -> bool:
        """The paper's dividing line: a defense with no carried state sees
        one step of gradients only."""
        return not self.stateful


def final_good(state) -> Optional[torch.Tensor]:
    """The last good mask recorded in a defense state, or ``None``."""
    if state is None:
        return None
    if hasattr(state, "good"):
        return state.good
    if isinstance(state, dict) and "good" in state:
        return state["good"]
    return None


def _all_good_info(m: int, device) -> Dict[str, torch.Tensor]:
    return {"good": torch.ones((m,), dtype=torch.bool, device=device),
            "n_good": torch.tensor(float(m), device=device)}


def _stateless(name: str, fn: Callable, *, needs_scores: bool = False,
               static_nbyz: bool = False) -> Defense:
    def aggregate(state, grads, ctx):
        m = tu.tree_worker_count(grads)
        device = tu.tree_leaves(grads)[0].device
        if needs_scores:
            scores = (ctx or {}).get("scores")
            if scores is None:
                raise ValueError(f"{name} needs ctx['scores'] (a held-out "
                                 "batch at the trainer level)")
            agg = fn(grads, scores=scores)
        else:
            agg = fn(grads)
        return agg, state, _all_good_info(m, device)

    return Defense(name, aggregate, needs_held_batch=needs_scores,
                   static_nbyz=static_nbyz)


def make_safeguard_defense(cfg: sg.SafeguardConfig,
                           name: Optional[str] = None) -> Defense:
    """The paper's defense under the protocol; its state is the plain
    :class:`core.safeguard.SafeguardState`."""
    def init_state(params_like):
        return sg.init_state(cfg, params_like)

    def aggregate(state, grads, ctx):
        gen = (ctx or {}).get("generator") if cfg.nu > 0 else None
        new_state, agg, info = sg.safeguard_step(state, grads, cfg, gen)
        return agg, new_state, info

    return Defense(name or f"safeguard_{cfg.mode}", aggregate,
                   init_state=init_state)


def make_registry(m: int, n_byz: int, *, T0: int = 20, T1: int = 120,
                  threshold_floor: float = 0.1, reset_period: int = 0,
                  threshold_scale=DEFENSE_DEFAULTS["threshold_scale"],
                  backend: str = "kernel") -> Dict[str, Defense]:
    """The ported defenses, parameterized as the reference's registry
    (``b = alpha * m``; safeguard windows and thresholds as given)."""
    trim = derive_trim(n_byz, m)

    def sg_cfg(mode):
        return sg.SafeguardConfig(m=m, T0=T0, T1=T1, mode=mode,
                                  threshold_floor=threshold_floor,
                                  threshold_scale=threshold_scale,
                                  reset_period=reset_period,
                                  backend=backend)

    return {
        "mean": _stateless("mean", agg_lib.mean),
        "coord_median": _stateless("coord_median",
                                   agg_lib.coordinate_median),
        "trimmed_mean": _stateless(
            "trimmed_mean",
            functools.partial(agg_lib.trimmed_mean, trim=trim),
            static_nbyz=True),
        "geo_median": _stateless("geo_median", agg_lib.geometric_medoid),
        "weiszfeld": _stateless("weiszfeld", agg_lib.geometric_median),
        "krum": _stateless(
            "krum", functools.partial(agg_lib.krum, n_byz=n_byz),
            static_nbyz=True),
        "zeno": _stateless(
            "zeno", functools.partial(agg_lib.zeno, n_byz=n_byz),
            needs_scores=True, static_nbyz=True),
        "safeguard_single": make_safeguard_defense(sg_cfg("single"),
                                                   "safeguard_single"),
        "safeguard_double": make_safeguard_defense(sg_cfg("double"),
                                                   "safeguard_double"),
    }
