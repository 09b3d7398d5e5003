"""Optimizers (port of ``repro.optim.optimizers``): SGD with momentum and
Adam as (init, update) pairs over parameter trees, plus global-norm
clipping.  ``update`` consumes the aggregated gradient and returns new
parameter tensors (the old ones are left untouched)."""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.configs.base import TrainConfig
from repro_torch.core import tree_utils as tu
from repro_torch.optim.schedules import make_schedule

f32 = torch.float32


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(leaf.to(f32).square().sum()
                          for leaf in tu.tree_leaves(tree)))


def clip_by_global_norm(tree, max_norm: float):
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    return tu.tree_map(lambda g: (g.to(f32) * scale).to(g.dtype),
                       tree), norm


@dataclasses.dataclass(frozen=True)
class OptimizerBundle:
    init: Callable[[Any], Any]
    update: Callable[..., tuple]
    """update(grads, opt_state, params, step) -> (new_params, new_state)"""


def make_optimizer(cfg: TrainConfig) -> OptimizerBundle:
    lr_fn = make_schedule(cfg)

    def decayed(p, upd, lr):
        if cfg.weight_decay > 0.0:
            upd = upd + lr * cfg.weight_decay * p.to(f32)
        return (p.to(f32) - upd).to(p.dtype)

    if cfg.optimizer == "sgd":
        def init(params):
            if cfg.momentum > 0.0:
                return {"mu": tu.tree_map(
                    lambda p: torch.zeros(p.shape, dtype=f32,
                                          device=p.device), params)}
            return {}

        def update(grads, state, params, step):
            if cfg.grad_clip > 0.0:
                grads, _ = clip_by_global_norm(grads, cfg.grad_clip)
            lr = lr_fn(step)
            if cfg.momentum > 0.0:
                mu = tu.tree_map(lambda m, g: cfg.momentum * m + g.to(f32),
                                 state["mu"], grads)
                direction, new_state = mu, {"mu": mu}
            else:
                direction = tu.tree_map(lambda g: g.to(f32), grads)
                new_state = state
            return (tu.tree_map(lambda p, d: decayed(p, lr * d, lr),
                                params, direction), new_state)

        return OptimizerBundle(init, update)

    if cfg.optimizer == "adam":
        b1, b2, eps = 0.9, 0.999, 1e-8

        def init(params):
            def z(p):
                return torch.zeros(p.shape, dtype=f32, device=p.device)
            device = tu.tree_leaves(params)[0].device
            return {"m": tu.tree_map(z, params), "v": tu.tree_map(z, params),
                    "count": torch.zeros((), dtype=torch.int32,
                                         device=device)}

        def update(grads, state, params, step):
            if cfg.grad_clip > 0.0:
                grads, _ = clip_by_global_norm(grads, cfg.grad_clip)
            count = state["count"] + 1
            lr = lr_fn(step)
            m = tu.tree_map(lambda m_, g: b1 * m_ + (1 - b1) * g.to(f32),
                            state["m"], grads)
            v = tu.tree_map(
                lambda v_, g: b2 * v_ + (1 - b2) * g.to(f32).square(),
                state["v"], grads)
            c1 = 1 - b1 ** count.to(f32)
            c2 = 1 - b2 ** count.to(f32)

            def step_leaf(p, m_, v_):
                return decayed(p, lr * (m_ / c1) / (torch.sqrt(v_ / c2) + eps),
                               lr)
            return (tu.tree_map(step_leaf, params, m, v),
                    {"m": m, "v": v, "count": count})

        return OptimizerBundle(init, update)

    raise ValueError(f"unknown optimizer {cfg.optimizer!r}")
