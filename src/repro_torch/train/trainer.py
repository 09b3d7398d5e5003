"""Byzantine-resilient training loop (port of ``repro.train.trainer``).

``make_train_step`` builds one step of the paper's master/worker
protocol:

  1. per-worker gradients — a loop over the m workers, each a
     ``torch.autograd.grad`` of its own batch slice, stacked into
     ``(m, ...)`` leaves;
  2. the Byzantine simulation — the attack rewrites the rows marked by
     ``byz_mask``;
  3. aggregation through one ``core.defenses.Defense`` (the safeguard's
     flat A/B accumulators live in ``TrainState.defense_state``; Zeno
     gets its scores from a held-out batch, ``zeno_scores``);
  4. the optimizer update.

The step emits the reference's metric keys for the ported defenses and
attacks.  Metric values stay tensors on the device: the step itself never
waits for the card.  ``Trainer`` runs the step in a plain Python loop and
prints log lines with the same scalar keys (the reference's live
collector is a later port).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.core import aggregators as agg_lib
from repro_torch.core import attacks as atk_lib
from repro_torch.core import defenses as dfn_lib
from repro_torch.core import tree_utils as tu
from repro_torch.data import hetero as het_lib
from repro_torch.optim import OptimizerBundle

f32 = torch.float32


@dataclasses.dataclass
class TrainState:
    params: Any
    opt_state: Any
    defense_state: Any
    attack_state: Any
    step: torch.Tensor              # () int32 on the device
    generator: torch.Generator      # attack and defense noise


def init_train_state(params, opt: OptimizerBundle, *,
                     defense: Optional[dfn_lib.Defense] = None,
                     attack: Optional[atk_lib.Attack] = None,
                     seed: int = 0) -> TrainState:
    device = tu.tree_leaves(params)[0].device
    defense_state = None
    if defense is not None and defense.init_state is not None:
        defense_state = defense.init_state(params)
    attack_state = (attack.init(params)
                    if attack is not None and attack.init is not None
                    else None)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return TrainState(params=params, opt_state=opt.init(params),
                      defense_state=defense_state, attack_state=attack_state,
                      step=torch.zeros((), dtype=torch.int32, device=device),
                      generator=gen)


def per_worker_grads(loss_fn: Callable, params, batch, m: int):
    """``(losses (m,), stacked grads)``: worker i's loss and gradient on
    its slice ``batch[..][i]``, one ``autograd.grad`` per worker, written
    into preallocated ``(m, ...)`` leaves."""
    leaves = tu.tree_leaves(params)
    live = [leaf.detach().requires_grad_(True) for leaf in leaves]
    p = tu.tree_unflatten(params, live)
    stacked = [torch.empty((m,) + tuple(leaf.shape), dtype=leaf.dtype,
                           device=leaf.device) for leaf in leaves]
    losses = []
    for i in range(m):
        loss = loss_fn(p, tu.tree_map(lambda x: x[i], batch))
        for dst, g in zip(stacked, torch.autograd.grad(loss, live)):
            dst[i].copy_(g)
        losses.append(loss.detach())
    return torch.stack(losses), tu.tree_unflatten(params, stacked)


def zeno_scores(loss_fn: Callable, params, grads, held_batch, *,
                eta: float, rho: float) -> torch.Tensor:
    """Zeno's stochastic descendant score per worker (Definition C.4):
    Score(g_i) = f_r(x) - f_r(x - eta g_i) - rho ||g_i||^2 evaluated on a
    held-out minibatch (the master-side oracle).  One forward pass per
    worker, one stepped copy of the parameters alive at a time."""
    m = tu.tree_worker_count(grads)
    with torch.no_grad():
        loss_before = loss_fn(params, held_batch)
        loss_after = []
        for i in range(m):
            stepped = tu.tree_map(
                lambda p, g: (p.to(f32) - eta * g[i].to(f32)).to(p.dtype),
                params, grads)
            loss_after.append(loss_fn(stepped, held_batch))
            del stepped
    return agg_lib.zeno_score(loss_before, torch.stack(loss_after),
                              tu.tree_row_sq_norms(grads), rho)


def make_train_step(loss_fn: Callable, opt: OptimizerBundle, *,
                    byz_mask: torch.Tensor,
                    defense: dfn_lib.Defense,
                    attack: Optional[atk_lib.Attack] = None,
                    zeno_eta: float = 0.1, zeno_rho: float = 5e-4):
    """Build the training step ``step_fn(state, batch, held_batch=None) ->
    (state, metrics)``.  ``loss_fn(params, worker_batch) -> scalar``;
    ``batch`` leaves are ``(m, B/m, ...)``; ``held_batch`` (a
    ``loss_fn`` batch) feeds the score oracle of a defense that
    ``needs_held_batch``."""
    attack = attack or atk_lib.Attack("none", atk_lib.attack_none)
    m = int(byz_mask.shape[0])
    honest = ~byz_mask

    def step_fn(state: TrainState, batch, held_batch=None):
        # (1) per-worker gradients
        losses, grads = per_worker_grads(loss_fn, state.params, batch, m)

        # (2) Byzantine simulation
        grads, attack_state = attack.act(grads, byz_mask, state.attack_state,
                                         state.step, state.generator)

        # (3) aggregation through the Defense protocol
        metrics: Dict[str, torch.Tensor] = {
            "loss": losses.mean(),
            "honest_loss": (losses * honest).sum()
            / torch.clamp(honest.sum(), min=1),
        }
        ctx = {"generator": state.generator}
        if defense.needs_held_batch:
            if held_batch is None:
                raise ValueError(f"{defense.name} needs a held-out batch")
            ctx["scores"] = zeno_scores(loss_fn, state.params, grads,
                                        held_batch, eta=zeno_eta,
                                        rho=zeno_rho)
        agg, defense_state, info = defense.aggregate(state.defense_state,
                                                     grads, ctx)
        metrics["zeta_sq"] = het_lib.zeta_sq(grads, honest)
        metrics["zeta_good_sq"] = het_lib.zeta_sq(grads, info["good"])
        if defense.stateful:
            metrics["n_good"] = info["n_good"]
            metrics["caught_byz"] = (byz_mask & ~info["good"]).sum()
            metrics["evicted_honest"] = (honest & ~info["good"]).sum()
            metrics["good"] = info["good"]
            if "restored" in info:
                metrics["restored"] = info["restored"].sum()
        for k in ("dist_to_med_B", "dist_to_med_A",
                  "threshold_B", "threshold_A"):
            if k in info:
                metrics[k] = info[k].to(f32)
        del grads

        # (4) optimizer
        params, opt_state = opt.update(agg, state.opt_state, state.params,
                                       state.step)
        metrics["grad_norm"] = torch.sqrt(tu.tree_sq_norm(agg))
        new_state = TrainState(params=params, opt_state=opt_state,
                               defense_state=defense_state,
                               attack_state=attack_state,
                               step=state.step + 1,
                               generator=state.generator)
        return new_state, metrics

    return step_fn


class Trainer:
    """Python-loop wrapper: data iterators, scalar history, vector traces.

    ``held_iter`` yields the held-out batches of a score-oracle defense
    (Zeno), one per step.  Every ``log_every`` steps (and at the last) the
    scalar metrics become one history record and, when ``verbose``, one
    printed log line."""

    def __init__(self, state: TrainState, step_fn, data_iter, *,
                 held_iter=None, log_every: int = 50, name: str = "run"):
        self.state = state
        self.step_fn = step_fn
        self.data_iter = data_iter
        self.held_iter = held_iter
        self.log_every = log_every
        self.name = name
        self.history: list = []
        # non-scalar metrics accumulate here every step (on the device)
        self.traces: Dict[str, list] = {}

    def run(self, steps: int, verbose: bool = True):
        t0 = time.time()
        for i in range(steps):
            batch = next(self.data_iter)
            if self.held_iter is not None:
                self.state, metrics = self.step_fn(self.state, batch,
                                                   next(self.held_iter))
            else:
                self.state, metrics = self.step_fn(self.state, batch)
            for k, v in metrics.items():
                if v.ndim != 0:
                    self.traces.setdefault(k, []).append(v)
            if (i + 1) % self.log_every == 0 or i == steps - 1:
                rec = {k: float(v) for k, v in metrics.items()
                       if v.ndim == 0}
                rec["step"] = int(self.state.step)
                rec["wall_s"] = time.time() - t0
                self.history.append(rec)
                if verbose:
                    print(f"[{self.name}] " + " ".join(
                        f"{k}={v:.6g}" if isinstance(v, float) else
                        f"{k}={v}" for k, v in rec.items()), flush=True)
        return self.history
