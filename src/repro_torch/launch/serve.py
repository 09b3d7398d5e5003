"""Serving CLI of the port (the flags of ``repro.launch.serve``, plus
``--device``): random weights from ``--seed``, a random prompt, one
prefill, then greedy or sampled decoding.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \
        --batch 4 --prompt-len 32 --gen 16
    PYTHONPATH=src python -m repro_torch.launch.serve --full \
        --arch tinyllama-1.1b-swa --batch 2 --prompt-len 8192 --gen 32

It runs on the CUDA card unless ``--device cpu`` is given, and refuses to
start when the card is asked for and missing.  Prefill and decode are
timed apart (host clock, the device synchronised at each end), and the
first call's kernel build counts in the prefill time.
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch import configs as C
from repro_torch.launch.train import resolve_device
from repro_torch.models import transformer as T
from repro_torch.train import serve


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--full", action="store_true",
                    help="full config (default: reduced smoke config)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device; the CPU only when asked for")
    return ap.parse_args(argv)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None):
    args = parse_args(argv)
    device = resolve_device(args.device)
    if args.gen < 1:
        raise SystemExit("--gen must be at least 1")
    cfg = C.get(args.arch) if args.full else C.get_smoke(args.arch)
    params = T.init_params(cfg, args.seed, device=device)
    gen = torch.Generator(device=device).manual_seed(args.seed + 1)
    prompt = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                           generator=gen, device=device)
    max_seq = args.prompt_len + args.gen

    _sync(device)
    t0 = time.perf_counter()
    last_logits, cache = T.prefill(params, cfg, prompt, max_seq=max_seq)
    _sync(device)
    t1 = time.perf_counter()
    toks = serve.decode(params, cfg, last_logits, cache, n_tokens=args.gen,
                        generator=gen, temperature=args.temperature)
    _sync(device)
    t2 = time.perf_counter()

    steps = args.gen - 1
    print(f"arch={cfg.name} device={device} batch={args.batch} "
          f"prompt={args.prompt_len} gen={args.gen}")
    print(f"prefill: {t1 - t0:.3f} s "
          f"({args.batch * args.prompt_len / (t1 - t0):.1f} prompt tok/s)")
    if steps:
        print(f"decode: {steps} steps in {t2 - t1:.3f} s, "
              f"{(t2 - t1) / steps * 1e3:.2f} ms/step, "
              f"{args.batch * steps / (t2 - t1):.1f} tok/s")
    print("sample tokens:", toks[0, :16].tolist())
    return toks


if __name__ == "__main__":
    main()
