"""Drive the PyTorch port's main path on one CUDA card and check it.

    python3 chip_smoke.py

Phases, in order (any failure exits non-zero, and no phase catches its
own failure):

  1. print the card's name and power limit (``nvidia-smi``);
  2. build the CUDA kernels from the sources in this checkout (one
     ``nvcc`` per source, all started together);
  3. hold each kernel against its plain PyTorch version on the card —
     m in {4, 10, 33}, float32 and bfloat16, a ragged d, the fused update
     with reset 0 and 1 and a NaN/inf accumulator cleared by the reset,
     and both kernels at the training slice's shape, where both versions
     are also held against a float64 sum — and time them with
     CUDA events beside the plain version, one PyTorch library call and
     the least time the card could take (the bound);
  4. run the training CLI's step at full TinyLlama-1.1B width (depth cut
     to 2 layers, random weights from seed 0): m=10 workers, 4 Byzantine,
     ``sign_flip`` against ``safeguard_double`` with T0=4 and T1=8, 12
     steps of batch 80 and sequence 64, once per safeguard backend
     (``kernel``, ``kernel_fused``, ``plain``) on the same parameters and
     batches.  It asserts finite losses, 24 launches of the backend's
     kernel, identical per-step good masks and agreeing A/B buffers;
  5. print one JSON line per kernel table and, last, the device line.

It needs one card and exits non-zero, printing no result, without one or
outside a checkout of the repository.
"""

from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# published peaks of one H100 SXM (NVIDIA data sheet): device memory
# bandwidth and the float32 rate of the CUDA cores (no tensor cores: the
# kernels use IEEE float32 FMAs)
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12

M, N_BYZ, STEPS, BATCH, SEQ, LAYERS = 10, 4, 12, 80, 64, 2
BACKENDS = ("kernel", "kernel_fused", "plain")
BACKEND_KERNEL = {"kernel": "pairwise_sqdist",
                  "kernel_fused": "fused_accumulate_sqdist"}
# A/B buffers of two backends: the accumulate arithmetic is the same
# (float32 multiply then add), so they differ only through the per-worker
# gradients' own run-to-run rounding; bound relative to the buffer's scale
AB_RTOL = 1e-3


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60,
        check=True).stdout.strip()
    return out.splitlines()[0]


def time_ms(fn, reps: int = 5, warmup: int = 2) -> float:
    """Mean of ``reps`` launches timed with CUDA events, each after a
    256 MB write that evicts the 50 MB L2, after ``warmup`` launches."""
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    total = 0.0
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def bound(bytes_moved: float, flops: float):
    t_bytes = bytes_moved / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_F32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    """Largest |a - b|, row by row (a slice-shape row is 0.9 GB)."""
    return max(float((x.double() - y.double()).abs().max())
               for x, y in zip(a.reshape(a.shape[0], -1),
                               b.reshape(b.shape[0], -1)))


def sqdist_f64(a: torch.Tensor) -> torch.Tensor:
    """(m, m) squared distances of ``a`` summed in float64, column chunk by
    column chunk: the yardstick for both float32 versions at a d where
    float32 rounding of a 2e8-term sum is no longer negligible."""
    m, d = a.shape
    gram = torch.zeros((m, m), dtype=torch.float64, device=a.device)
    for k in range(0, d, 1 << 24):
        c = a[:, k:k + (1 << 24)].double()
        gram += c @ c.T
    diag = gram.diagonal()
    return (diag[:, None] + diag[None, :] - 2.0 * gram).clamp_min(0.0)


def slice_check(name: str, k_out, p_out, exact, d: int) -> float:
    """Hold a kernel's (m, m) output at the slice shape against its plain
    version.  The kernel must be within 1e-4 * d of the float64 sum (the
    tolerance of the small shapes); against the plain version the
    tolerance adds the plain float32 product's own measured error.
    Returns the kernel-vs-plain error."""
    err, e_k, e_p = (max_err(k_out, p_out), max_err(k_out, exact),
                     max_err(p_out, exact))
    print(f"check {name} slice d={d}: vs plain max_abs_err={err:.3e} "
          f"tol={1e-4 * d + e_p:.3e}; vs float64 kernel {e_k:.3e} "
          f"(tol={1e-4 * d:.3e}) plain {e_p:.3e}", flush=True)
    check(e_k <= 1e-4 * d, f"{name} is off the float64 sum at the slice "
          "shape")
    check(err <= 1e-4 * d + e_p, f"{name} disagrees with the plain version "
          "at the slice shape")
    return err


def kernel_checks(ops, ref, d_slice: int):
    """Phase 3.  Returns {kernel name: measurements at the slice shape}."""
    gen = torch.Generator(device="cuda").manual_seed(0)

    def randn(m, d):
        return torch.randn((m, d), generator=gen, device="cuda")

    # small and ragged shapes: tolerance of the CPU parity tests, 1e-4 * d
    # (float32) and 1e-3 * d (bfloat16) — sums of d terms in another order
    for m in (4, 10, 33):
        for d in (128, 100_003):
            for dt, tol in ((torch.float32, 1e-4), (torch.bfloat16, 1e-3)):
                a = randn(m, d).to(dt)
                err = max_err(ops.pairwise_sqdist(a), ref.pairwise_sqdist(a))
                print(f"check pairwise_sqdist m={m} d={d} {dt}: max_abs_err="
                      f"{err:.3e} tol={tol * d:.3e}", flush=True)
                check(err <= tol * d, "pairwise_sqdist disagrees")
            acc, g = randn(m, d), randn(m, d)
            for reset in (0, 1):
                want_new, want_sq = ref.fused_accumulate_sqdist(acc, g,
                                                                reset, 0.1)
                new, sq = ops.fused_accumulate_sqdist(
                    acc.clone(), g, torch.tensor(reset, device="cuda"),
                    torch.tensor(0.1, device="cuda"))
                e_new, e_sq = max_err(new, want_new), max_err(sq, want_sq)
                print(f"check fused m={m} d={d} reset={reset}: new "
                      f"max_abs_err={e_new:.3e} tol=0 sqdist max_abs_err="
                      f"{e_sq:.3e} tol={1e-4 * d:.3e}", flush=True)
                check(e_new == 0.0 and e_sq <= 1e-4 * d, "fused disagrees")
    acc = torch.ones((8, 1000), device="cuda")
    acc[2], acc[3] = math.inf, math.nan
    g = torch.ones((8, 1000), device="cuda")
    new, sq = ops.fused_accumulate_sqdist(acc, g, 1, 0.5)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(new).all() and torch.isfinite(sq).all()),
          "the reset did not clear a non-finite accumulator")
    check(max_err(new, torch.full_like(new, 0.5)) == 0.0, "reset value")
    print("check fused reset clears inf/NaN rows: ok", flush=True)

    # the slice's shape: one (m, d) float32 buffer per kernel input
    results = {}
    m, d = M, d_slice
    a = randn(m, d)
    err = slice_check("pairwise_sqdist", ops.pairwise_sqdist(a),
                      ref.pairwise_sqdist(a), sqdist_f64(a), d)
    b_ms, b_by = bound(m * d * 4 + m * m * 4, m * (m + 1) * d)
    results["pairwise_sqdist"] = dict(
        max_abs_err=err, ms=time_ms(lambda: ops.pairwise_sqdist(a)),
        plain_ms=time_ms(lambda: ref.pairwise_sqdist(a)),
        library_ms=time_ms(lambda: torch.mm(a, a.T)),
        bound_ms=b_ms, bound_by=b_by)

    acc, g = a, randn(m, d)
    del a
    want_new, want_sq = ref.fused_accumulate_sqdist(acc, g, 0, 0.1)
    new, sq = ops.fused_accumulate_sqdist(acc, g, 0, 0.1)   # acc in place
    e_new = max_err(new, want_new)
    print(f"check fused_accumulate_sqdist slice m={m} d={d}: new "
          f"max_abs_err={e_new:.3e} tol=0", flush=True)
    check(e_new == 0.0, "fused update disagrees at the slice shape")
    e_sq = slice_check("fused_accumulate_sqdist", sq, want_sq,
                       sqdist_f64(new), d)
    del want_new, want_sq, new
    reset = torch.zeros((1,), dtype=torch.int32, device="cuda")
    scale = torch.full((1,), 0.1, device="cuda")
    b_ms, b_by = bound(3 * m * d * 4 + m * m * 4,
                       2 * m * d + m * (m + 1) * d)
    results["fused_accumulate_sqdist"] = dict(
        max_abs_err=max(e_new, e_sq),
        ms=time_ms(lambda: ops.fused_accumulate_sqdist(acc, g, reset,
                                                       scale)),
        plain_ms=time_ms(lambda: ref.fused_accumulate_sqdist(acc, g, reset,
                                                             scale)),
        library_ms=None, bound_ms=b_ms, bound_by=b_by)
    del acc, g
    torch.cuda.empty_cache()
    for name, r in results.items():
        print(f"time {name} m={m} d={d}: kernel {r['ms']:.3f} ms, plain "
              f"{r['plain_ms']:.3f} ms, library {r['library_ms']} ms, bound "
              f"{r['bound_ms']:.3f} ms ({r['bound_by']})", flush=True)
    return results


def main_path(params, batches, cfg, ops):
    """Phase 4: the training step, once per safeguard backend."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.core import attacks as atk_lib
    from repro_torch.core import defenses as dfn_lib
    from repro_torch.models import transformer as T
    from repro_torch.optim import make_optimizer
    from repro_torch.train import Trainer, init_train_state, make_train_step

    byz_mask = torch.arange(M, device="cuda") < N_BYZ
    attack = atk_lib.make_registry()["sign_flip"]
    opt = make_optimizer(TrainConfig(lr=0.05))
    launches, ref_run = {}, None
    for backend in BACKENDS:
        defense = dfn_lib.make_registry(
            M, N_BYZ, T0=4, T1=8, threshold_floor=1.0,
            backend=backend)["safeguard_double"]
        state = init_train_state(params, opt, defense=defense, attack=attack)
        step = make_train_step(lambda p, b: T.loss_fn(p, cfg, b), opt,
                               byz_mask=byz_mask, defense=defense,
                               attack=attack)
        trainer = Trainer(state, step, iter(batches), log_every=1,
                          name=f"{cfg.name}/{backend}")
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        trainer.run(1)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        hist = trainer.run(STEPS - 1)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        counts = dict(ops.LAUNCHES)
        for name, n in counts.items():
            want = 2 * STEPS if BACKEND_KERNEL.get(backend) == name else 0
            check(n == want, f"{backend}: {name} launched {n} times, "
                  f"expected {want}")
        if backend in BACKEND_KERNEL:
            launches[BACKEND_KERNEL[backend]] = counts[BACKEND_KERNEL[backend]]
        check(len(hist) == STEPS and all(math.isfinite(r["loss"])
                                         for r in hist), "non-finite loss")
        good = torch.stack(trainer.traces["good"])
        check(tuple(good.shape) == (STEPS, M), "good-mask trace shape")
        sg_state = trainer.state.defense_state
        print(f"run {backend}: caught_byz={hist[-1]['caught_byz']:.0f} "
              f"evicted_honest={hist[-1]['evicted_honest']:.0f} "
              f"first_step_s={t1 - t0:.3f} step_s={(t2 - t1) / (STEPS - 1):.3f} "
              f"launches={counts} peak_mem_gb="
              f"{torch.cuda.max_memory_allocated() / 1e9:.1f}", flush=True)
        if ref_run is None:
            ref_run = (backend, good, sg_state.A, sg_state.B)
        else:
            check(torch.equal(good, ref_run[1]),
                  f"good masks of {backend} differ from {ref_run[0]}")
            for name, buf, rbuf in (("A", sg_state.A, ref_run[2]),
                                    ("B", sg_state.B, ref_run[3])):
                scale = max(float(row.abs().max()) for row in rbuf)
                diff = max_err(buf, rbuf)
                print(f"compare {name} {backend} vs {ref_run[0]}: max_abs_"
                      f"diff={diff:.3e} tol={AB_RTOL * scale:.3e}", flush=True)
                check(diff <= AB_RTOL * scale, f"{name} buffers differ")
        del trainer, state, sg_state, step
        torch.cuda.empty_cache()
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        fail("no CUDA device")
    if not (SRC / "repro_torch" / "kernels").is_dir():
        fail(f"no checkout of the repository around {ROOT}")
    sys.path.insert(0, str(SRC))
    from repro_torch import configs as C
    from repro_torch.core import safeguard as sg
    from repro_torch.data import pipeline as data_lib
    from repro_torch.kernels import build
    from repro_torch.kernels.safeguard_filter import kernel as sf_kernel
    from repro_torch.kernels.safeguard_filter import ops, ref
    from repro_torch.models import transformer as T

    card = card_line()
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python "
          f"{sys.version.split()[0]}", flush=True)

    t0 = time.perf_counter()
    log = build.finish_builds(build.start_builds([sf_kernel.SOURCE]))
    sf_kernel._lib()
    print(f"build: {time.perf_counter() - t0:.1f} s", flush=True)
    for line in log.splitlines():
        if "registers" in line or "spill" in line or "error" in line:
            print(f"  ptxas {line.strip()}", flush=True)

    cfg = dataclasses.replace(C.get("tinyllama-1.1b"), n_layers=LAYERS)
    params = T.init_params(cfg, seed=0, device="cuda")
    d_slice = sg.make_layout(params).d_padded
    print(f"model {cfg.name} x{LAYERS} layers: d_padded={d_slice}",
          flush=True)

    results = kernel_checks(ops, ref, d_slice)

    it = data_lib.lm_batches(cfg.vocab_size, BATCH, SEQ, seed=0, m=M,
                             device="cuda")
    batches = [next(it) for _ in range(STEPS)]
    launches = main_path(params, batches, cfg, ops)

    source = "src/repro_torch/kernels/safeguard_filter/csrc/safeguard_filter.cu"
    replaces = {"pairwise_sqdist": "src/repro/kernels/safeguard_filter/"
                                   "kernel.py:59",
                "fused_accumulate_sqdist": "src/repro/kernels/"
                                           "safeguard_filter/kernel.py:103"}
    table = [dict(name=name, route="cuda", source=source,
                  replaces=replaces[name], launches=launches[name], **r)
             for name, r in results.items()]
    print(card, flush=True)
    print(json.dumps({"kernels": table}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
