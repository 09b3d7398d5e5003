"""Byzantine attacks (port of ``repro.core.attacks``).

An attack rewrites the rows of the stacked honest gradients that
``byz_mask`` marks as Byzantine:

    act(grads, byz_mask, state, step, generator) -> (grads', state')

Ported: ``none``, ``sign_flip``, the safeguard attacks
``safeguard_x0.6`` / ``safeguard_x0.7`` (``-scale * g``), the
historyless-breaking ``variance`` [Baruch et al. 2019] and ``ipm``
[Xie et al. 2020], and the ``label_flip`` data attack (the pipeline flips
the Byzantine workers' tokens).  ``delayed``, ``burst``,
``random_noise`` and the adaptive (observe/act) attacks are not ported
yet.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import torch

from repro_torch.core import tree_utils as tu

f32 = torch.float32

# Collusion strength of the static variance attack: ``mu - z * sigma``
# per coordinate (the reference's single source, repro.core.attacks).
VARIANCE_Z = 1.5


def _mix_leaf(h: torch.Tensor, a: torch.Tensor, byz_mask: torch.Tensor):
    """Per-worker select on one leaf: Byzantine rows from ``a`` (which may
    broadcast over the worker axis)."""
    mshape = (-1,) + (1,) * (h.ndim - 1)
    return torch.where(byz_mask.reshape(mshape), a.to(h.dtype), h)


def _mix(honest, adversarial, byz_mask: torch.Tensor):
    """Per-worker select: Byzantine rows from ``adversarial``."""
    return tu.tree_map(lambda h, a: _mix_leaf(h, a, byz_mask), honest,
                       adversarial)


def _honest_stats(g: torch.Tensor, byz_mask: torch.Tensor):
    """Mean and std over honest workers only, per coordinate of one
    stacked leaf, in float32."""
    w = (~byz_mask).to(f32)
    n = torch.clamp(w.sum(), min=1.0)
    gw = g.to(f32)
    wr = w.reshape((-1,) + (1,) * (g.ndim - 1))
    mu = (gw * wr).sum(dim=0) / n
    var = ((gw - mu[None]).square() * wr).sum(dim=0) / n
    return mu, torch.sqrt(var + 1e-12)


def attack_none(grads, byz_mask, state, step, generator):
    return grads, state


def attack_sign_flip(grads, byz_mask, state, step, generator):
    return _mix(grads, tu.tree_map(torch.neg, grads), byz_mask), state


def make_scaled_flip(scale: float):
    """Safeguard attack: ``-scale * g``.  The factor is rounded to the
    gradient's dtype first, as the reference's weakly-typed scalar is."""
    def attack(grads, byz_mask, state, step, generator):
        neg = tu.tree_map(
            lambda g: torch.as_tensor(-scale, dtype=g.dtype,
                                      device=g.device) * g, grads)
        return _mix(grads, neg, byz_mask), state
    return attack


def make_variance_attack(z_max: float = VARIANCE_Z, direction: float = -1.0):
    """[Baruch et al.] all Byzantine workers collude on ``mu + dir*z*sigma``.
    Leaf by leaf, so only one leaf's float32 statistics are alive."""
    def attack(grads, byz_mask, state, step, generator):
        def one(g):
            mu, sd = _honest_stats(g, byz_mask)
            return _mix_leaf(g, (mu + direction * z_max * sd)[None],
                             byz_mask)
        return tu.tree_map(one, grads), state
    return attack


def make_ipm(eps: float = 1.0):
    """Inner-product manipulation: report ``-eps * honest mean``."""
    def attack(grads, byz_mask, state, step, generator):
        def one(g):
            mu, _ = _honest_stats(g, byz_mask)
            return _mix_leaf(g, (-eps * mu)[None], byz_mask)
        return tu.tree_map(one, grads), state
    return attack


@dataclasses.dataclass(frozen=True)
class Attack:
    """``act`` rewrites the Byzantine rows; ``init`` builds its state from
    a parameter tree (``None``: stateless)."""
    name: str
    act: Callable
    init: Optional[Callable] = None
    data_attack: bool = False         # label flipping lives in the pipeline


def make_registry() -> Dict[str, Attack]:
    return {
        "none": Attack("none", attack_none),
        "sign_flip": Attack("sign_flip", attack_sign_flip),
        "safeguard_x0.6": Attack("safeguard_x0.6", make_scaled_flip(0.6)),
        "safeguard_x0.7": Attack("safeguard_x0.7", make_scaled_flip(0.7)),
        "variance": Attack("variance", make_variance_attack(VARIANCE_Z)),
        "ipm": Attack("ipm", make_ipm(1.0)),
        "label_flip": Attack("label_flip", attack_none, data_attack=True),
    }
