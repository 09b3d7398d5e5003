"""Drive the PyTorch port's main path on one CUDA card and check it.

    python3 chip_smoke.py

Phases, in order (any failure exits non-zero, and no phase catches its
own failure):

  1. print the card's name and power limit (``nvidia-smi``);
  2. build the CUDA kernels from the sources in this checkout (one
     ``nvcc`` per source, all started together) and print each source's
     registers and spills from ``ptxas``;
  3. hold B1 and B2 (``safeguard_filter``) against their plain PyTorch
     versions on the card — m in {4, 10, 33}, float32 and bfloat16, a
     ragged d, the fused update with reset 0 and 1 and a NaN/inf
     accumulator cleared by the reset, and both kernels at the training
     slice's shape, where both versions are also held against a float64
     sum — and time them with CUDA events beside the plain version, one
     PyTorch library call and the least time the card could take (the
     bound);
  4. hold B3 (``robust_agg``: coordinate median and trimmed mean) against
     its plain version, bit for bit — m in {3, 9, 10, 16, 33, 64},
     float32 and bfloat16, ragged n, trim in {1, 2, 4}, columns with NaN
     and inf, every leaf of the slice's model at m=10, and one bfloat16
     (10, 253,755,392) matrix of more than 2**31 elements (a 22-layer
     stacked MLP leaf) — and time it at the slice's whole gradient (m=10)
     and at m=9 beside ``torch.median``;
  5. run the training CLI's step at full TinyLlama-1.1B width (depth cut
     to 2 layers, random weights from seed 0): m=10 workers, 4 Byzantine,
     ``sign_flip`` against ``safeguard_double`` with T0=4 and T1=8, 12
     steps of batch 80 and sequence 64, once per safeguard backend
     (``kernel``, ``kernel_fused``, ``plain``) on the same parameters and
     batches.  It asserts finite losses, 24 launches of the backend's
     kernel, identical per-step good masks and agreeing A/B buffers;
  6. run the paper's seven historyless baselines on the same model under
     the ``variance`` attack, 4 steps each (Zeno with a held batch of 8):
     ``coord_median`` and ``trimmed_mean`` must launch B3 once per
     parameter leaf per step and no other run may launch it; every loss
     must be finite.  On the first step's stacked gradients it holds the
     B3 aggregates against the plain version and prints which worker Krum
     and the medoid pick and the set Zeno keeps;
  7. hold B4 (``flash_attention``: bfloat16 on the tensor-core kernel,
     float32 on the CUDA-core kernel) against its plain version on the card
     — the sweep of the JAX package's kernel tests (MHA, GQA 8/2, MQA with
     window 96, ragged L=200, one tile of 128) in float32 and bfloat16, D=64
     at a ragged L=1984, the first query row against v's row 0, and both
     serve shapes as the model passes them (transpose views of (B, L, H, D)
     projections), in bfloat16 and cast to float32 — within 2e-5 (float32)
     and 2e-2 (bfloat16), bfloat16 elementwise also within 2e-5 plus one
     bfloat16 step (2**-7 * |ref|) — and time both kernels at both serve
     shapes beside the plain version, ``scaled_dot_product_attention``
     (causal, and with a boolean window mask) and the bound;
  8. serve full TinyLlama-1.1B (22 layers, bfloat16, random weights from
     seed 0): batch 4, a prompt of 1984 tokens, 64 generated (max_seq
     2048).  Two greedy ``generate`` calls must launch B4's tensor-core
     kernel exactly 22 times each (once per layer in the prefill, never in
     decode) and no other kernel, give ids below the vocabulary and the
     same tokens, equal to a manual prefill + ``decode_step`` loop, which
     is timed (prefill s, decode ms per token, tokens/s, peak GB); layer
     0's q, k and v, captured in that prefill, must give the same output
     through B4 and the plain version, in bfloat16 and cast to float32;
  9. the same for ``tinyllama-1.1b-swa`` (window 4096): batch 2, a prompt of
     8192 tokens, 32 generated, so the 4096-slot ring has wrapped before
     decode starts and B4 runs with its window;
 10. print one JSON line per kernel table and, last, the device line.

Float32 products run in full IEEE float32: TF32 is off for matmuls and
cuDNN (set in ``main``), so the plain versions keep float32 precision.

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
# bandwidth, the float32 rate of the CUDA cores (B1-B3 do float32 work
# that has no tensor-core form) and the dense bf16 tensor-core rate (B4's
# bound: the least time any kernel could take for attention's products)
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12
PEAK_BF16_FLOP_PER_S = 989e12

M, N_BYZ, STEPS, BATCH, SEQ, LAYERS = 10, 4, 12, 80, 64, 2
BASELINES = ("coord_median", "trimmed_mean", "geo_median", "weiszfeld",
             "krum", "zeno", "mean")
BASELINE_STEPS, HELD_BATCH = 4, 8
# B3's check of a leaf of more than 2**31 elements: a stacked MLP leaf of
# TinyLlama at its full 22 layers (m=10, 22 x 2048 x 5632 columns)
BIG_N = 22 * 2048 * 5632
BACKENDS = ("kernel", "kernel_fused", "plain")
BACKEND_KERNEL = {"kernel": "pairwise_sqdist",
                  "kernel_fused": "fused_accumulate_sqdist"}
# A/B buffers of two backends: the accumulate arithmetic is the same
# (float32 multiply then add), so they differ only through the per-worker
# gradients' own run-to-run rounding; bound relative to the buffer's scale
AB_RTOL = 1e-3
# B4 against its plain version: the JAX package's tolerances for its
# kernel against its reference (the sums run in another order; bfloat16
# output rounds once)
FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
# ... and, in bfloat16, elementwise within the float32 tolerance plus one
# bfloat16 unit in the last place of the plain version's value (at most
# 2**-7 * |ref|): both versions round float32 results that differ by less
# than FLASH_TOL[float32], so they may land one bfloat16 step apart and
# no further.  A flat 2e-2 alone is as large as a typical output of a
# row that sees thousands of keys.
FLASH_BF16_RTOL = 2.0 ** -7
# the serve phases: (arch, batch, prompt tokens, generated tokens)
SERVE_FULL = ("tinyllama-1.1b", 4, 1984, 64)
SERVE_SWA = ("tinyllama-1.1b-swa", 2, 8192, 32)


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


def bound(bytes_moved: float, flops: float,
          peak_flops: float = PEAK_F32_FLOP_PER_S):
    t_bytes = bytes_moved / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    """Largest |a - b|, row by row (a slice-shape row is 0.9 GB)."""
    return max(float((x.double() - y.double()).abs().max())
               for x, y in zip(a.reshape(a.shape[0], -1),
                               b.reshape(b.shape[0], -1)))


def flash_check(label: str, out: torch.Tensor, want: torch.Tensor) -> float:
    """Hold B4's ``out`` against its plain version's ``want`` (FLASH_TOL,
    and the elementwise bfloat16 bound); print and return max |error|."""
    err = max_err(out, want)
    ok = err <= FLASH_TOL[out.dtype]
    line = (f"check flash_attention {label} {out.dtype}: max_abs_err="
            f"{err:.3e} tol={FLASH_TOL[out.dtype]:.0e}")
    if out.dtype == torch.bfloat16:
        excess = max(
            float(((x.float() - y.float()).abs()
                   / (FLASH_TOL[torch.float32]
                      + FLASH_BF16_RTOL * y.float().abs())).max())
            for x, y in zip(out, want))
        ok = ok and excess <= 1.0
        line += f", worst |err| / (2e-5 + 2^-7 |ref|) = {excess:.3f} (<= 1)"
    print(line, flush=True)
    check(ok, f"flash_attention disagrees with its plain version ({label})")
    return err


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
    """Phase 5: the training step, once per safeguard backend."""
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


def ptxas_summary(log: str) -> str:
    """One line from ``nvcc -Xptxas -v``: entry functions, the most
    registers, stack frame and spill bytes of any of them."""
    regs, stack, spill = [0], [0], [0]
    for line in log.splitlines():
        words = line.replace(",", " ").split()
        for i, w in enumerate(words[1:], 1):
            if w == "registers" and words[i - 1].isdigit():
                regs.append(int(words[i - 1]))
            if w == "stack" and words[i - 2].isdigit():
                stack.append(int(words[i - 2]))
            if w == "spill" and words[i - 2].isdigit():
                spill.append(int(words[i - 2]))
    return (f"{log.count('Compiling entry function')} entry functions, "
            f"registers max {max(regs)}, stack frame max {max(stack)} B, "
            f"spill max {max(spill)} B")


def network_size(m: int) -> int:
    """Compare-exchanges of B3's sorting network for m values (Batcher's
    odd-even merge sort pruned to m wires, as in robust_agg.cu)."""
    count, p = 0, 1
    while p < m:
        k = p
        while k >= 1:
            j = k % p
            while j + k < m:
                count += sum(1 for i in range(k) if i + j + k < m
                             and (i + j) // (2 * p) == (i + j + k) // (2 * p))
                j += 2 * k
            k //= 2
        p *= 2
    return count


def vec_err(a: torch.Tensor, b: torch.Tensor) -> float:
    """Largest |a - b| of two float32 vectors: equal values (infinities
    too) and NaN against NaN count 0, NaN against a number inf."""
    same = (a == b) | (torch.isnan(a) & torch.isnan(b))
    diff = torch.nan_to_num((a.double() - b.double()).abs(), nan=math.inf)
    return float(torch.where(same, 0.0, diff).max())


def robust_bound(m: int, n: int, itemsize: int):
    """B3's bound: each input read once and the float32 output written
    once, or its compare-exchanges (two FMNMX each) plus the final add and
    multiply at the float32 rate."""
    return bound(m * n * itemsize + 4 * n, (2 * network_size(m) + 2) * n)


def robust_checks(ra_ops, ra_ref, leaf_sizes, d_slice: int):
    """Phase 4.  Returns the measurements of B3 at the slice's shape."""
    gen = torch.Generator(device="cuda").manual_seed(1)

    def randn(m, n, dt):
        return torch.randn((m, n), generator=gen, device="cuda", dtype=dt)

    def held(name, k_out, p_out):
        err = vec_err(k_out, p_out)
        check(err == 0.0, f"{name}: kernel and plain version differ "
              f"(max_abs_err={err:.3e}, tol=0)")
        return err

    # every check is exact: the median is a selection plus one float32
    # midpoint, the trimmed mean adds the kept ranks in rank order and
    # multiplies by the float32 reciprocal of their count, in both versions
    worst = 0.0
    for m in (3, 9, 10, 16, 33, 64):
        m_worst = 0.0
        for n in (1000, 100_003):
            for dt in (torch.float32, torch.bfloat16):
                g = randn(m, n, dt)
                m_worst = max(m_worst, held(f"coord_median m={m} n={n} {dt}",
                                            ra_ops.coord_median(g),
                                            ra_ref.coord_median(g)))
                for trim in (1, 2, 4):
                    if 2 * trim < m:
                        m_worst = max(m_worst, held(
                            f"trimmed_mean m={m} n={n} {dt} trim={trim}",
                            ra_ops.trimmed_mean(g, trim),
                            ra_ref.trimmed_mean(g, trim)))
        worst = max(worst, m_worst)
        print(f"check sorted_reduce m={m} n=1000,100003 f32,bf16 median and "
              f"trim 1,2,4: max_abs_err={m_worst} tol=0", flush=True)
    for m in (5, 10, 33):
        g = randn(m, 8, torch.float32)
        g[1, 0] = math.nan
        g[2, 1] = math.inf
        g[0, 2] = -math.inf
        g[3, 3], g[4, 3] = math.inf, -math.inf
        g[0, 4], g[m - 1, 4] = math.nan, math.nan
        g[:, 5] = math.nan
        g[2, 6], g[3, 6] = math.nan, math.inf
        med = ra_ops.coord_median(g)
        held(f"coord_median non-finite m={m}", med, ra_ref.coord_median(g))
        check(bool(torch.isnan(med[[0, 4, 5, 6]]).all()),
              "a column holding a NaN must give a NaN median")
        for trim in (1, 2):
            held(f"trimmed_mean non-finite m={m} trim={trim}",
                 ra_ops.trimmed_mean(g, trim), ra_ref.trimmed_mean(g, trim))
    print("check sorted_reduce NaN/inf columns m=5,10,33: NaN medians where "
          "a NaN is, equal to plain: ok", flush=True)

    # every leaf of the slice's model, at m=10 in bfloat16 (its gradients')
    from repro_torch.core.defenses import derive_trim
    trim = derive_trim(N_BYZ, M)
    for n in leaf_sizes:
        g = randn(M, n, torch.bfloat16)
        worst = max(worst, held(f"coord_median leaf n={n}",
                                ra_ops.coord_median(g),
                                ra_ref.coord_median(g)))
        worst = max(worst, held(f"trimmed_mean leaf n={n}",
                                ra_ops.trimmed_mean(g, trim),
                                ra_ref.trimmed_mean(g, trim)))
    del g
    print(f"check sorted_reduce slice leaves m={M} bf16 n={sorted(leaf_sizes)}"
          f": max_abs_err={worst} tol=0", flush=True)

    # more than 2**31 elements: 64-bit offsets; the plain version is held
    # column chunk by column chunk (its sort would need 60 GB at once)
    g = randn(M, BIG_N, torch.bfloat16)
    check(g.numel() > 2 ** 31, "the big case must exceed 2**31 elements")
    for name, k_fn, p_fn in (
            ("coord_median", ra_ops.coord_median, ra_ref.coord_median),
            ("trimmed_mean", lambda x: ra_ops.trimmed_mean(x, 2),
             lambda x: ra_ref.trimmed_mean(x, 2))):
        out = k_fn(g)
        err = max(vec_err(out[k:k + (1 << 24)], p_fn(g[:, k:k + (1 << 24)]))
                  for k in range(0, BIG_N, 1 << 24))
        check(err == 0.0, f"{name} differs beyond 2**31 elements "
              f"(max_abs_err={err:.3e})")
        print(f"check {name} m={M} n={BIG_N} bf16 ({g.numel()} elements): "
              f"max_abs_err={err} tol=0", flush=True)
        del out
    del g
    torch.cuda.empty_cache()

    # times at the slice's whole gradient: (m, d) bfloat16 over all leaves
    g = randn(M, d_slice, torch.bfloat16)
    err = held("coord_median slice", ra_ops.coord_median(g),
               ra_ref.coord_median(g))
    b_ms, b_by = robust_bound(M, d_slice, 2)
    result = dict(max_abs_err=max(worst, err),
                  ms=time_ms(lambda: ra_ops.coord_median(g)),
                  plain_ms=time_ms(lambda: ra_ref.coord_median(g)),
                  bound_ms=b_ms, bound_by=b_by, library_ms=None)
    t_ms = time_ms(lambda: ra_ops.trimmed_mean(g, trim))
    t_plain = time_ms(lambda: ra_ref.trimmed_mean(g, trim))
    g9 = g[:9]
    b9, b9_by = robust_bound(9, d_slice, 2)
    result["m9"] = dict(ms=time_ms(lambda: ra_ops.coord_median(g9)),
                        plain_ms=time_ms(lambda: ra_ref.coord_median(g9)),
                        library_ms=time_ms(lambda: torch.median(g9, dim=0)),
                        bound_ms=b9, bound_by=b9_by)
    del g, g9
    torch.cuda.empty_cache()
    print(f"time sorted_reduce median m={M} d={d_slice} bf16: kernel "
          f"{result['ms']:.3f} ms, plain {result['plain_ms']:.3f} ms, bound "
          f"{b_ms:.3f} ms ({b_by})", flush=True)
    print(f"time sorted_reduce trimmed_mean m={M} trim={trim} d={d_slice} "
          f"bf16: kernel {t_ms:.3f} ms, plain {t_plain:.3f} ms", flush=True)
    r9 = result["m9"]
    print(f"time sorted_reduce median m=9 d={d_slice} bf16: kernel "
          f"{r9['ms']:.3f} ms, plain {r9['plain_ms']:.3f} ms, torch.median "
          f"{r9['library_ms']:.3f} ms, bound {b9:.3f} ms ({b9_by})",
          flush=True)
    return result


def first_step_checks(params, batch, held_batch, cfg, ra_ref):
    """Phase 6, on step 1's stacked gradients under ``variance``: the B3
    aggregates against the plain version, and the baselines' choices."""
    from repro_torch.core import aggregators as agg_lib
    from repro_torch.core import attacks as atk_lib
    from repro_torch.core import tree_utils as tu
    from repro_torch.core.defenses import derive_trim
    from repro_torch.models import transformer as T
    from repro_torch.train.trainer import per_worker_grads, zeno_scores

    def loss(p, b):
        return T.loss_fn(p, cfg, b)

    byz_mask = torch.arange(M, device="cuda") < N_BYZ
    _, grads = per_worker_grads(loss, params, batch, M)
    grads, _ = atk_lib.make_registry()["variance"].act(grads, byz_mask, None,
                                                       0, None)
    trim = derive_trim(N_BYZ, M)
    for name, agg, plain in (
            ("coord_median", agg_lib.coordinate_median(grads),
             ra_ref.coord_median),
            ("trimmed_mean", agg_lib.trimmed_mean(grads, trim),
             lambda x: ra_ref.trimmed_mean(x, trim))):
        for path, out, g in zip(tu.tree_paths(grads), tu.tree_leaves(agg),
                                tu.tree_leaves(grads)):
            want = plain(g.reshape(M, -1)).reshape(g.shape[1:]).to(g.dtype)
            check(torch.equal(out, want), f"{name} aggregate of {path} "
                  "differs from the plain version")
        print(f"check {name} aggregate of step 1 (variance attack, "
              f"{len(tu.tree_leaves(grads))} leaves): equal to plain",
              flush=True)
    scores = zeno_scores(loss, params, grads, held_batch, eta=0.1, rho=5e-4)
    keep = agg_lib.zeno_keep(scores, N_BYZ)
    print(f"picks on step 1 (workers 0-{N_BYZ - 1} Byzantine): krum="
          f"{int(agg_lib.krum_index(grads, N_BYZ))} medoid="
          f"{int(agg_lib.medoid_index(grads))} zeno keeps "
          f"{keep.nonzero().flatten().tolist()} (scores "
          f"{[round(x, 4) for x in scores.tolist()]})", flush=True)


def baselines_path(params, batches, held, cfg, ra_ops, sf_ops):
    """Phase 6: the seven historyless baselines under ``variance``.
    Returns B3's launches in the coord_median and trimmed_mean runs."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.core import attacks as atk_lib
    from repro_torch.core import defenses as dfn_lib
    from repro_torch.core import tree_utils as tu
    from repro_torch.models import transformer as T
    from repro_torch.optim import make_optimizer
    from repro_torch.train import Trainer, init_train_state, make_train_step

    byz_mask = torch.arange(M, device="cuda") < N_BYZ
    attack = atk_lib.make_registry()["variance"]
    opt = make_optimizer(TrainConfig(lr=0.05))
    registry = dfn_lib.make_registry(M, N_BYZ)
    n_leaves = len(tu.tree_leaves(params))
    b3_launches = 0
    for name in BASELINES:
        defense = registry[name]
        state = init_train_state(params, opt, defense=defense, attack=attack)
        step = make_train_step(lambda p, b: T.loss_fn(p, cfg, b), opt,
                               byz_mask=byz_mask, defense=defense,
                               attack=attack)
        trainer = Trainer(
            state, step, iter(batches[:BASELINE_STEPS]),
            held_iter=iter(held) if defense.needs_held_batch else None,
            log_every=1, name=f"{cfg.name}/variance/{name}")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ra_ops.reset_launch_counts()
        sf_ops.reset_launch_counts()
        t0 = time.perf_counter()
        trainer.run(1, verbose=False)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        hist = trainer.run(BASELINE_STEPS - 1, verbose=False)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        counts = dict(ra_ops.LAUNCHES)
        check(not any(sf_ops.LAUNCHES.values()), f"{name}: B1/B2 launched")
        want = {k: n_leaves * BASELINE_STEPS if k == name else 0
                for k in counts}
        check(counts == want, f"{name}: B3 launches {counts}, expected "
              f"{want} ({n_leaves} leaves x {BASELINE_STEPS} steps)")
        b3_launches += sum(counts.values())
        losses = [r["loss"] for r in hist]
        check(len(hist) == BASELINE_STEPS and all(map(math.isfinite, losses)),
              f"{name}: non-finite loss")
        print(f"run {name} (variance): losses={[round(x, 5) for x in losses]}"
              f" grad_norm={hist[-1]['grad_norm']:.5g} first_step_s="
              f"{t1 - t0:.3f} step_s={(t2 - t1) / (BASELINE_STEPS - 1):.3f} "
              f"peak_mem_gb={torch.cuda.max_memory_allocated() / 1e9:.1f} "
              f"b3_launches={counts}", flush=True)
        del trainer, state, step
        torch.cuda.empty_cache()
    return b3_launches


def reachable_pairs(L: int, window: int) -> int:
    """(query, key) pairs causal attention with ``window`` computes over a
    sequence of L: each query q attends to min(q + 1, window) keys."""
    if window <= 0 or window >= L:
        return L * (L + 1) // 2
    return window * (window + 1) // 2 + (L - window) * window


def flash_bound(B: int, H: int, K: int, L: int, D: int, window: int,
                itemsize: int, peak_flops: float):
    """B4's bound: q, k and v read once and the output written once, or
    4 * D operations per reachable pair at ``peak_flops``."""
    return bound((2 * B * H + 2 * B * K) * L * D * itemsize,
                 4 * B * H * D * reachable_pairs(L, window), peak_flops)


def projections(B: int, H: int, K: int, L: int, D: int, dt, gen):
    """q (B, H, L, D) and k, v (B, K, L, D) as the model passes them:
    transpose(1, 2) views of (B, L, heads, D) tensors."""
    return [torch.randn((B, L, n, D), generator=gen, device="cuda",
                        dtype=dt).transpose(1, 2) for n in (H, K, K)]


def flash_times(fa_ops, fa_ref, label: str, q, k, v, win: int):
    """Phase 7's times of B4 at one serve shape, in q's dtype (bfloat16:
    the tensor-core kernel; float32: the CUDA-core kernel): the kernel, the
    plain version, SDPA on the same function (causal with the GQA map;
    with a window, a boolean mask on K/V repeated to H heads outside the
    timing, as the backends that take a mask take no GQA map), SDPA with
    the boolean mask also where causality is the whole mask, and the
    bound.  float32 is bound at the CUDA cores' float32 rate: the tensor
    cores take float32 only as TF32."""
    B, H, L, D = q.shape
    K = k.shape[1]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    pos = torch.arange(L, device="cuda")
    mask = pos[None, :] <= pos[:, None]
    if win:
        mask &= pos[None, :] > pos[:, None] - win
    kx, vx = (x.repeat_interleave(H // K, dim=1) for x in (k, v))
    masked = lambda: sdpa(q, kx, vx, attn_mask=mask)
    causal = lambda: sdpa(q, k, v, is_causal=True, enable_gqa=True)
    bf16 = q.dtype == torch.bfloat16
    b_ms, b_by = flash_bound(B, H, K, L, D, win, q.element_size(),
                             PEAK_BF16_FLOP_PER_S if bf16 else
                             PEAK_F32_FLOP_PER_S)
    r = dict(ms=time_ms(lambda: fa_ops.flash_attention(q, k, v, window=win)),
             plain_ms=time_ms(lambda: fa_ref.attention(q, k, v, window=win)),
             masked_sdpa_ms=time_ms(masked), bound_ms=b_ms, bound_by=b_by)
    r["library_ms"] = r["masked_sdpa_ms"] if win else time_ms(causal)
    r["bound_share"] = b_ms / r["ms"]
    print(f"time flash_attention_{'tc' if bf16 else 'f32'} serve-{label} "
          f"B={B} L={L} window={win} {q.dtype}: kernel {r['ms']:.3f} ms "
          f"({100 * r['bound_share']:.1f} % of the bound), plain "
          f"{r['plain_ms']:.3f} ms, sdpa {r['library_ms']:.3f} ms, sdpa with "
          f"a boolean mask {r['masked_sdpa_ms']:.3f} ms, bound {b_ms:.3f} ms "
          f"({b_by})", flush=True)
    return r


def flash_checks(fa_ops, fa_ref):
    """Phase 7.  Returns B4's measurements at the two serve shapes, by
    serve shape and then dtype, and the largest error of each dtype."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    worst = {torch.bfloat16: 0.0, torch.float32: 0.0}
    cases = [(1, 4, 4, 256, 64, 0), (2, 8, 2, 128, 64, 0),
             (1, 4, 1, 256, 64, 96), (2, 2, 2, 200, 32, 0),
             (1, 2, 2, 128, 128, 0), (1, 4, 2, 1984, 64, 0)]
    for B, H, K, L, D, win in cases:
        for dt in (torch.float32, torch.bfloat16):
            q, k, v = (torch.randn(shape, generator=gen, device="cuda",
                                   dtype=dt)
                       for shape in ((B, H, L, D), (B, K, L, D), (B, K, L, D)))
            err = flash_check(
                f"B={B} H={H} K={K} L={L} D={D} window={win}",
                fa_ops.flash_attention(q, k, v, window=win),
                fa_ref.attention(q, k, v, window=win))
            worst[dt] = max(worst[dt], err)
    q, k, v = (torch.randn((1, 2, 128, 32), generator=gen, device="cuda")
               for _ in range(3))
    err = max_err(fa_ops.flash_attention(q, k, v)[:, :, 0], v[:, :, 0])
    print(f"check flash_attention first row = v[0]: max_abs_err={err:.3e}",
          flush=True)
    check(err <= 1e-6, "the first query row must attend to key 0 only")

    from repro_torch import configs as C
    results = {}
    for label, (arch, batch, prompt, _) in (("full", SERVE_FULL),
                                            ("swa", SERVE_SWA)):
        cfg = C.get(arch)
        H, K, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        win = cfg.window if cfg.attn == "sliding" else 0
        q, k, v = projections(batch, H, K, prompt, D, torch.bfloat16, gen)
        out = fa_ops.flash_attention(q, k, v, window=win)
        check(out.transpose(1, 2).is_contiguous(),
              "B4's output must keep the projections' layout")
        shape = f"serve-{label} B={batch} H={H} K={K} L={prompt} D={D} " \
            f"window={win}"
        worst[q.dtype] = max(worst[q.dtype], flash_check(
            shape, out, fa_ref.attention(q, k, v, window=win)))
        # the same projections in float32, held to the float32 tolerance:
        # every late row and every tile of the window counts at this scale
        qf, kf, vf = (x.float() for x in (q, k, v))
        worst[qf.dtype] = max(worst[qf.dtype], flash_check(
            shape, fa_ops.flash_attention(qf, kf, vf, window=win),
            fa_ref.attention(qf, kf, vf, window=win)))
        results[label] = {
            dt: flash_times(fa_ops, fa_ref, label, x, y, z, win)
            for dt, (x, y, z) in (("bf16", (q, k, v)), ("f32", (qf, kf, vf)))}
        del q, k, v, out, qf, kf, vf
        torch.cuda.empty_cache()
    return results, worst


def serve_phase(label: str, arch: str, batch: int, prompt_len: int,
                gen_len: int, fa_ops, fa_ref, other_ops):
    """Phases 8 and 9: greedy serving of ``arch`` at full width and depth.
    Returns the launches of B4's tensor-core kernel in the first
    ``generate`` call (the main path's run, counted from 0)."""
    from repro_torch import configs as C
    from repro_torch.models import transformer as T
    from repro_torch.train import serve

    cfg = C.get(arch)
    params = T.init_params(cfg, seed=0, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(3)
    prompt = torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                           generator=gen, device="cuda")
    max_seq = prompt_len + gen_len
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    runs = []
    for _ in range(2):
        for ops in (fa_ops, *other_ops):
            ops.reset_launch_counts()
        t0 = time.perf_counter()
        toks = serve.generate(params, cfg, prompt, n_tokens=gen_len,
                              max_seq=max_seq)
        torch.cuda.synchronize()
        counts = {name: n for ops in (fa_ops, *other_ops)
                  for name, n in ops.LAUNCHES.items()}
        want = {name: cfg.n_layers if name in ("flash_attention",
                                               "flash_attention_tc") else 0
                for name in counts}
        check(counts == want, f"serve-{label}: launches {counts}, expected "
              f"{want} (one launch of B4's tensor-core kernel per layer in "
              "the prefill)")
        check(tuple(toks.shape) == (batch, gen_len), "token shape")
        check(int(toks.min()) >= 0 and int(toks.max()) < cfg.vocab_size,
              "token ids out of the vocabulary")
        runs.append((toks, time.perf_counter() - t0,
                     counts["flash_attention_tc"]))
    check(torch.equal(runs[0][0], runs[1][0]),
          f"serve-{label}: two greedy generate calls differ")

    # the manual loop, timed by phase; layer 0's q, k, v captured from B4
    captured = []
    real = fa_ops.flash_attention

    def record(q, k, v, *, window=0):
        out = real(q, k, v, window=window)
        if not captured:
            captured.append((q, k, v, window, out))
        return out

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fa_ops.flash_attention = record
    try:
        logits, cache = T.prefill(params, cfg, prompt, max_seq=max_seq)
    finally:
        fa_ops.flash_attention = real
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    check(bool(torch.isfinite(logits).all()), "non-finite prefill logits")
    cur = logits.argmax(-1)
    manual = [cur]
    for _ in range(gen_len - 1):
        logits, cache = T.decode_step(params, cfg, cur[:, None], cache)
        cur = logits.argmax(-1)
        manual.append(cur)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    check(cache["pos"] == max_seq - 1, "cache position after the loop")
    check(torch.equal(torch.stack(manual, 1), runs[0][0]),
          f"serve-{label}: generate differs from prefill + decode_step")

    q, k, v, win, out = captured[0]
    flash_check(f"serve-{label} layer 0", out,
                fa_ref.attention(q, k, v, window=win))
    qf, kf, vf = (x.float() for x in (q, k, v))
    flash_check(f"serve-{label} layer 0", fa_ops.flash_attention(
        qf, kf, vf, window=win), fa_ref.attention(qf, kf, vf, window=win))
    del qf, kf, vf
    steps = gen_len - 1
    print(f"run serve-{label} {cfg.name} x{cfg.n_layers} layers batch={batch}"
          f" prompt={prompt_len} gen={gen_len} ring={cache['blocks']['k'].shape[2]}"
          f": prefill_s={t1 - t0:.3f} decode_ms_per_token="
          f"{(t2 - t1) / steps * 1e3:.3f} tokens_per_s="
          f"{batch * steps / (t2 - t1):.1f} generate_s={runs[0][1]:.3f},"
          f"{runs[1][1]:.3f} peak_mem_gb="
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} b4_launches="
          f"{runs[0][2]},{runs[1][2]}; tokens[0][:8]="
          f"{runs[0][0][0, :8].tolist()}", flush=True)
    del params, cache, captured, q, k, v, out
    torch.cuda.empty_cache()
    return runs[0][2]


def main() -> int:
    if not torch.cuda.is_available():
        fail("no CUDA device")
    if not (SRC / "repro_torch" / "kernels").is_dir():
        fail(f"no checkout of the repository around {ROOT}")
    sys.path.insert(0, str(SRC))
    # every float32 product in full IEEE float32 (the plain versions are
    # the kernels' yardsticks): no TF32 in matmuls or cuDNN
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch import configs as C
    from repro_torch.core import safeguard as sg
    from repro_torch.data import pipeline as data_lib
    from repro_torch.core import tree_utils as tu
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref
    from repro_torch.kernels.robust_agg import kernel as ra_kernel
    from repro_torch.kernels.robust_agg import ops as ra_ops
    from repro_torch.kernels.robust_agg import ref as ra_ref
    from repro_torch.kernels.safeguard_filter import kernel as sf_kernel
    from repro_torch.kernels.safeguard_filter import ops, ref
    from repro_torch.models import transformer as T

    card = card_line()
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python "
          f"{sys.version.split()[0]}", flush=True)

    t0 = time.perf_counter()
    procs = build.start_builds([sf_kernel.SOURCE, ra_kernel.SOURCE,
                                *fa_kernel.SOURCES])
    logs = [(Path(p.args[-1]).name, build.finish_builds([p])) for p in procs]
    sf_kernel._lib()
    ra_kernel._lib()
    fa_kernel._lib()
    fa_kernel._lib_tc()
    print(f"build: {time.perf_counter() - t0:.1f} s", flush=True)
    for name, log in logs:
        print(f"  ptxas {name}: {ptxas_summary(log)}", flush=True)
        for line in log.splitlines():
            if "warning" in line.lower():
                print(f"    {line.strip()}", flush=True)

    cfg = dataclasses.replace(C.get("tinyllama-1.1b"), n_layers=LAYERS)
    params = T.init_params(cfg, seed=0, device="cuda")
    d_slice = sg.make_layout(params).d_padded
    print(f"model {cfg.name} x{LAYERS} layers: d_padded={d_slice}",
          flush=True)

    results = kernel_checks(ops, ref, d_slice)
    leaf_sizes = sorted({leaf.numel() for leaf in tu.tree_leaves(params)})
    b3 = robust_checks(ra_ops, ra_ref, leaf_sizes, d_slice)

    it = data_lib.lm_batches(cfg.vocab_size, BATCH, SEQ, seed=0, m=M,
                             device="cuda")
    batches = [next(it) for _ in range(STEPS)]
    launches = main_path(params, batches, cfg, ops)

    held_it = data_lib.lm_batches(cfg.vocab_size, HELD_BATCH, SEQ, seed=1,
                                  device="cuda")
    held = [next(held_it) for _ in range(BASELINE_STEPS)]
    b3_launches = baselines_path(params, batches, held, cfg, ra_ops, ops)
    first_step_checks(params, batches[0], held[0], cfg, ra_ref)
    del params, batches, held
    torch.cuda.empty_cache()

    b4, b4_err = flash_checks(fa_ops, fa_ref)
    launches_tc = {label: serve_phase(label, *cell, fa_ops, fa_ref,
                                      (ops, ra_ops))
                   for label, cell in (("full", SERVE_FULL),
                                       ("swa", SERVE_SWA))}

    source = "src/repro_torch/kernels/safeguard_filter/csrc/safeguard_filter.cu"
    replaces = {"pairwise_sqdist": "src/repro/kernels/safeguard_filter/"
                                   "kernel.py:59",
                "fused_accumulate_sqdist": "src/repro/kernels/"
                                           "safeguard_filter/kernel.py:103"}
    table = [dict(name=name, route="cuda", source=source,
                  replaces=replaces[name], launches=launches[name], **r)
             for name, r in results.items()]
    table.append(dict(
        name="sorted_reduce", route="cuda",
        source="src/repro_torch/kernels/robust_agg/csrc/robust_agg.cu",
        replaces="src/repro/kernels/robust_agg/kernel.py:42",
        launches=b3_launches, **b3))
    # B4 has two kernels: bfloat16 (the model's dtype) on the tensor
    # cores, float32 on the CUDA cores.  Each entry holds serve-full's
    # numbers and serve-swa's under "swa"; the float32 kernel is on no
    # serve path (it launches 0 times there) and is timed on the serve
    # shapes' projections cast to float32.
    for name, dt, src, n in (
            ("flash_attention_tc", "bf16", "flash_attention_tc.cu",
             launches_tc),
            ("flash_attention_f32", "f32", "flash_attention.cu",
             {"full": 0, "swa": 0})):
        err = b4_err[torch.bfloat16 if dt == "bf16" else torch.float32]
        table.append(dict(
            name=name, route="cuda",
            source=f"src/repro_torch/kernels/flash_attention/csrc/{src}",
            replaces="src/repro/kernels/flash_attention/kernel.py:82",
            launches=n["full"], max_abs_err=err, **b4["full"][dt],
            swa=dict(launches=n["swa"], **b4["swa"][dt])))
    print(card, flush=True)
    print(json.dumps({"kernels": table}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
