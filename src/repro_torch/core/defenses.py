"""The Defense protocol (port of ``repro.core.defenses``):

    init_state(params_like)       -> state        [None = stateless]
    aggregate(state, grads, ctx)  -> (agg, state', info)

``grads`` is the worker-stacked gradient tree after the Byzantine
rewrite; ``ctx`` carries step-scoped resources (``generator``).  ``info``
always has ``good`` and ``n_good``.  The registry holds ``mean``,
``safeguard_single`` and ``safeguard_double``; the rest of the zoo is not
ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import torch

from repro_torch.core import aggregators as agg_lib
from repro_torch.core import safeguard as sg
from repro_torch.core import tree_utils as tu

# Knob defaults shared by the factories below — single source.
DEFENSE_DEFAULTS = {
    "threshold_scale": sg.SafeguardConfig.threshold_scale,
}


@dataclasses.dataclass(frozen=True)
class Defense:
    """One defense under the protocol; see the module docstring."""
    name: str
    aggregate: Callable
    init_state: Optional[Callable] = None
    needs_held_batch: bool = False

    @property
    def stateful(self) -> bool:
        return self.init_state is not None


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


def _stateless(name: str, fn: Callable) -> Defense:
    def aggregate(state, grads, ctx):
        m = tu.tree_worker_count(grads)
        device = tu.tree_leaves(grads)[0].device
        return fn(grads), state, _all_good_info(m, device)

    return Defense(name, aggregate)


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
    (``n_byz`` is taken for signature parity; no ported defense reads
    it)."""
    def sg_cfg(mode):
        return sg.SafeguardConfig(m=m, T0=T0, T1=T1, mode=mode,
                                  threshold_floor=threshold_floor,
                                  threshold_scale=threshold_scale,
                                  reset_period=reset_period,
                                  backend=backend)

    return {
        "mean": _stateless("mean", agg_lib.mean),
        "safeguard_single": make_safeguard_defense(sg_cfg("single"),
                                                   "safeguard_single"),
        "safeguard_double": make_safeguard_defense(sg_cfg("double"),
                                                   "safeguard_double"),
    }
