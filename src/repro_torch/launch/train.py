"""Training CLI of the port (the flags of ``repro.launch.train``, plus
``--device``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b \
        --steps 200 --attack sign_flip --defense safeguard \
        --workers 10 --byz 4
    PYTHONPATH=src python -m repro_torch.launch.train --defense krum \
        --attack variance

It runs on the CUDA card unless ``--device cpu`` is given, and refuses to
start when the card is asked for and missing.
"""

from __future__ import annotations

import argparse
import json
import os

import torch

from repro_torch import configs as C
from repro_torch.configs.base import TrainConfig
from repro_torch.core import attacks as atk_lib
from repro_torch.core import defenses as dfn_lib
from repro_torch.data import pipeline as data_lib
from repro_torch.models import transformer as T
from repro_torch.optim import make_optimizer
from repro_torch.train import Trainer, init_train_state, make_train_step


def build_defense(name: str, m: int, n_byz: int, args) -> dfn_lib.Defense:
    """A defense of the port's registry; ``safeguard`` is an alias for
    ``safeguard_double``."""
    if name == "safeguard":
        name = "safeguard_double"
    reg = dfn_lib.make_registry(m, n_byz, T0=args.t0, T1=args.t1,
                                threshold_floor=args.floor,
                                reset_period=args.reset_period)
    if name not in reg:
        raise SystemExit(f"unknown or not yet ported defense {name}; "
                         f"choose safeguard|{sorted(reg)}")
    return reg[name]


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--full", action="store_true",
                    help="full config (default: reduced smoke config)")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=80)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--workers", type=int, default=10)
    ap.add_argument("--byz", type=int, default=4)
    ap.add_argument("--attack", default="sign_flip",
                    choices=sorted(atk_lib.make_registry()))
    ap.add_argument("--defense", default="safeguard")
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--momentum", type=float, default=0.0)
    ap.add_argument("--optimizer", default="sgd", choices=["sgd", "adam"])
    ap.add_argument("--t0", type=int, default=50)
    ap.add_argument("--t1", type=int, default=200)
    ap.add_argument("--floor", type=float, default=1.0)
    ap.add_argument("--reset-period", type=int, default=0)
    ap.add_argument("--hetero-alpha", type=float, default=0.0,
                    help="Dirichlet worker heterogeneity (not ported yet)")
    ap.add_argument("--sketch", action="store_true",
                    help="sketched safeguard (not ported yet)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=25)
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory (not ported yet)")
    ap.add_argument("--out", default=None, help="write history JSON here")
    ap.add_argument("--device", default="cuda",
                    help="torch device; the CPU only when asked for")
    return ap.parse_args(argv)


def resolve_device(name: str) -> torch.device:
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device available; pass --device cpu to "
                         "run on the CPU")
    return device


def main(argv=None):
    args = parse_args(argv)
    device = resolve_device(args.device)
    for flag, on in (("--sketch", args.sketch),
                     ("--hetero-alpha", args.hetero_alpha > 0),
                     ("--ckpt-dir", args.ckpt_dir is not None)):
        if on:
            raise SystemExit(f"{flag} is not ported yet")

    cfg = C.get(args.arch) if args.full else C.get_smoke(args.arch)
    m, n_byz = args.workers, args.byz
    if args.batch % m:
        raise SystemExit("--batch must be divisible by --workers")
    byz_mask = torch.arange(m, device=device) < n_byz

    attack = atk_lib.make_registry()[args.attack]
    defense = build_defense(args.defense, m, n_byz, args)

    params = T.init_params(cfg, args.seed, device=device)
    opt = make_optimizer(TrainConfig(lr=args.lr, momentum=args.momentum,
                                     optimizer=args.optimizer))

    def loss(p, b):
        return T.loss_fn(p, cfg, b)

    state = init_train_state(params, opt, defense=defense, attack=attack,
                             seed=args.seed)
    step = make_train_step(loss, opt, byz_mask=byz_mask, defense=defense,
                           attack=attack)
    flip = byz_mask if attack.data_attack else None
    it = data_lib.lm_batches(cfg.vocab_size, args.batch, args.seq,
                             seed=args.seed, m=m, flip_mask=flip,
                             device=device)
    held = None
    if defense.needs_held_batch:
        held = data_lib.lm_batches(cfg.vocab_size, 8, args.seq,
                                   seed=args.seed + 1, device=device)
    name = f"{cfg.name}/{args.attack}/{args.defense}"
    trainer = Trainer(state, step, it, held_iter=held,
                      log_every=args.log_every, name=name)
    hist = trainer.run(args.steps)

    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"config": vars(args), "history": hist}, f, indent=1)
        print(f"history written to {args.out}")
    return hist


if __name__ == "__main__":
    main()
