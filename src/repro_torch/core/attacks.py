"""Byzantine attacks (port of ``repro.core.attacks``).

An attack rewrites the rows of the stacked honest gradients that
``byz_mask`` marks as Byzantine:

    act(grads, byz_mask, state, step, generator) -> (grads', state')

Ported: ``none``, ``sign_flip`` and the safeguard attacks
``safeguard_x0.6`` / ``safeguard_x0.7`` (``-scale * g``).  The adaptive
(observe/act) attacks and the rest of the open-loop zoo are not ported
yet.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import torch

from repro_torch.core import tree_utils as tu


def _mix(honest, adversarial, byz_mask: torch.Tensor):
    """Per-worker select: Byzantine rows from ``adversarial``."""
    def one(h, a):
        mshape = (-1,) + (1,) * (h.ndim - 1)
        return torch.where(byz_mask.reshape(mshape), a.to(h.dtype), h)
    return tu.tree_map(one, honest, adversarial)


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
    }
