"""Port parity: ``repro_torch.kernels.flash_attention`` against the JAX
package's ``ops.flash_attention`` (the Pallas kernel in interpret mode)
and its ``ref.attention``, on the same numpy inputs.

Tolerances are the JAX package's own for its kernel against its
reference (``tests/test_kernels.py``): 2e-5 in float32, where only the
order of the sums differs, and 2e-2 in bfloat16, where the output rounds
once and the JAX ``ref`` also rounds p to bfloat16 before ``p @ v``.

Also on the CPU: the tensor maps' stride checks of the bfloat16 kernel
(``ops.tma_strides``) and an emulation of that kernel's arithmetic,
which shows why it splits p into two bfloat16 halves."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import ops as jops
from repro.kernels.flash_attention import ref as jref
from repro.models import layers as JL
from repro_torch.kernels.flash_attention import ops, ref

DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"f32": 2e-5, "bf16": 2e-2}


def _inputs(B, H, K, L, D, dt, seed):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(shape).astype(np.float32)
            for shape in ((B, H, L, D), (B, K, L, D), (B, K, L, D))]
    jdt, tdt = DTYPES[dt]
    return ([jnp.asarray(a).astype(jdt) for a in arrs],
            [torch.from_numpy(a).to(tdt) for a in arrs])


def _close(out: torch.Tensor, want, tol: float) -> None:
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(want, np.float32), atol=tol, rtol=0)


# the sweep of tests/test_kernels.py (flash_attention), with its blocks
@pytest.mark.parametrize("B,H,K,L,D,win,bq,bk", [
    (1, 4, 4, 256, 64, 0, 64, 64),     # MHA
    (2, 8, 2, 128, 64, 0, 64, 32),     # GQA
    (1, 4, 1, 256, 64, 96, 64, 64),    # MQA + sliding window
    (2, 2, 2, 200, 32, 0, 64, 64),     # padded sequence
    (1, 2, 2, 128, 128, 0, 128, 128),  # single block
])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_flash_attention_matches_jax_sweep(B, H, K, L, D, win, bq, bk, dt):
    (jq, jk, jv), (q, k, v) = _inputs(B, H, K, L, D, dt, B + H + L + win)
    out = ops.flash_attention(q, k, v, window=win)
    assert out.dtype == q.dtype and out.shape == q.shape
    _close(out, jops.flash_attention(jq, jk, jv, window=win, block_q=bq,
                                     block_k=bk), TOL[dt])
    _close(out, jref.attention(jq, jk, jv, window=win), TOL[dt])


@pytest.mark.parametrize("win", [0, 300])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_flash_attention_ragged_long_sequence(win, dt):
    """L = 1040: ragged against the reference's 128 blocks, and longer
    than the plain version's 512-row chunks (a window reaching across
    chunk edges)."""
    (jq, jk, jv), (q, k, v) = _inputs(1, 8, 2, 1040, 16, dt, win)
    out = ops.flash_attention(q, k, v, window=win)
    _close(out, jops.flash_attention(jq, jk, jv, window=win), TOL[dt])
    _close(out, jref.attention(jq, jk, jv, window=win), TOL[dt])


def test_flash_attention_first_row_is_v0():
    (_, _, _), (q, k, v) = _inputs(1, 2, 1, 128, 32, "f32", 5)
    out = ops.flash_attention(q, k, v)
    torch.testing.assert_close(out[0, :, 0], v[0, [0, 0], 0], atol=0,
                               rtol=1e-5)


def test_cpu_path_launches_nothing():
    (_, _, _), (q, k, v) = _inputs(1, 4, 2, 64, 16, "f32", 0)
    ops.reset_launch_counts()
    ops.flash_attention(q, k, v, window=8)
    ops.flash_attention(q.bfloat16(), k.bfloat16(), v.bfloat16(), window=8)
    assert ops.LAUNCHES == {"flash_attention": 0, "flash_attention_tc": 0,
                            "flash_attention_f32": 0}


def test_wrapper_refuses_what_does_not_fit():
    (_, _, _), (q, k, v) = _inputs(1, 4, 2, 64, 32, "f32", 1)
    with pytest.raises(ValueError, match="do not divide"):
        ops.flash_attention(q[:, :3], k, v)
    with pytest.raises(ValueError, match="head dims differ"):
        ops.flash_attention(q[..., :16], k, v)
    with pytest.raises(ValueError, match="differ or are empty"):
        ops.flash_attention(q[:, :, :32], k, v)
    with pytest.raises(ValueError, match="window"):
        ops.flash_attention(q, k, v, window=-1)
    with pytest.raises(ValueError, match="expected q"):
        ops.flash_attention(q, k, v[:, :1])
    with pytest.raises(ValueError, match="unsupported devices"):
        ops.flash_attention(q.to("meta"), k.to("meta"), v.to("meta"))


def test_kernel_checks_refuse_dtype_and_head_dim():
    """What the CUDA kernel does not take; the wrapper runs these checks
    on CUDA tensors before a launch (the plain version takes any)."""
    (_, _, _), (q, k, v) = _inputs(1, 4, 2, 64, 32, "f32", 2)
    ops.check_kernel_inputs(q, k, v)
    ops.check_kernel_inputs(q.bfloat16(), k.bfloat16(), v.bfloat16())
    with pytest.raises(TypeError):
        ops.check_kernel_inputs(q.half(), k.half(), v.half())
    with pytest.raises(TypeError, match="dtypes differ"):
        ops.check_kernel_inputs(q, k.bfloat16(), v)
    with pytest.raises(ValueError, match="head dim"):
        ops.check_kernel_inputs(q[..., :24], k[..., :24], v[..., :24])


def test_plain_version_holds_its_chunks_to_the_dense_form():
    """``ref.attention`` goes 512 rows at a time against the keys each
    chunk reaches; the dense masked softmax over all keys gives the same
    values."""
    (_, _, _), (q, k, v) = _inputs(2, 4, 2, 1100, 16, "f32", 3)
    for win in (0, 200):
        qpos = torch.arange(1100)[:, None]
        kpos = torch.arange(1100)[None, :]
        mask = kpos <= qpos
        if win:
            mask &= kpos > qpos - win
        kx, vx = k.repeat_interleave(2, 1), v.repeat_interleave(2, 1)
        s = (q @ kx.transpose(-1, -2) / 4.0).masked_fill(~mask, ref.NEG)
        dense = torch.softmax(s, -1) @ vx
        torch.testing.assert_close(ref.attention(q, k, v, window=win), dense,
                                   atol=2e-5, rtol=0)


def _reference_paths(dt):
    """The JAX package's three attentions at (B=1, H=8, K=2, L=1040,
    D=16): the Pallas kernel (interpret mode), ``flash_attention_jnp``
    (the LM path at L >= 1024, on K/V repeated to H heads as its caller
    does) and ``ref.attention``.  Returns them as float32 numpy arrays in
    the (B, H, L, D) layout, with the port's output."""
    (jq, jk, jv), (q, k, v) = _inputs(1, 8, 2, 1040, 16, dt, 11)
    pallas = jops.flash_attention(jq, jk, jv)
    kx, vx = (jnp.repeat(x, 4, axis=1).transpose(0, 2, 1, 3)
              for x in (jk, jv))
    blocked = JL.flash_attention_jnp(jq.transpose(0, 2, 1, 3), kx, vx,
                                     scale=0.25).transpose(0, 2, 1, 3)
    dense = jref.attention(jq, jk, jv)
    return [np.asarray(x, np.float32) for x in (pallas, blocked, dense)] + \
        [ops.flash_attention(q, k, v).float().numpy()]


def test_reference_paths_agree_in_f32():
    pallas, blocked, dense, port = _reference_paths("f32")
    for a in (pallas, blocked, dense):
        np.testing.assert_allclose(port, a, atol=2e-5, rtol=0)
    np.testing.assert_allclose(pallas, blocked, atol=2e-5, rtol=0)


def test_reference_paths_diverge_in_bf16():
    """``flash_attention_jnp`` rounds p to bfloat16 before ``p @ v`` and
    the Pallas kernel keeps it in float32, so the JAX package's two flash
    paths differ by more than a bfloat16 rounding of the output; the port
    follows the kernel, and all stay within 2e-2 of each other."""
    pallas, blocked, dense, port = _reference_paths("bf16")
    assert np.abs(pallas - blocked).max() > 1e-3
    for a, b in ((port, pallas), (port, blocked), (port, dense),
                 (pallas, dense), (blocked, dense)):
        np.testing.assert_allclose(a, b, atol=2e-2, rtol=0)



def test_tma_strides_of_the_models_views():
    """The tensor-core kernel's tensor maps take the caller's strides: a
    transpose(1, 2) view of (B, L, H, D) projections passes as it is; the
    stride of a dim of size 1 is never followed and is given as 16
    bytes."""
    x = torch.zeros((2, 300, 8, 64), dtype=torch.bfloat16).transpose(1, 2)
    kv = torch.zeros((1, 300, 2, 64), dtype=torch.bfloat16).transpose(1, 2)
    assert ops.tma_strides(x, x, x) == (300 * 8 * 64, 64, 8 * 64, 1) * 3
    assert ops.tma_strides(x[:1], kv, kv)[4:8] == (8, 64, 2 * 64, 1)


def test_tma_strides_refuse_what_tma_cannot_address():
    q = torch.zeros((1, 4, 64, 64), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="last-dim stride"):
        ops.tma_strides(q.transpose(2, 3).contiguous().transpose(2, 3), q, q)
    wide = torch.zeros((1, 4, 64, 68), dtype=torch.bfloat16)[..., :64]
    with pytest.raises(ValueError, match="multiples of 16 bytes"):
        ops.tma_strides(q, wide, q)
    flat = torch.zeros(4 * 64 * 64 + 1, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="aligned start"):
        ops.tma_strides(q, q, flat[1:].view(1, 4, 64, 64))


# The tensor-core kernel's arithmetic, emulated in float32 on the CPU: per
# key tile of BK (128, or 64 at D = 128), s = q . k of the bfloat16 inputs
# in float32 times f32(log2(e) / sqrt(D)), the -1e30 masks, p and alpha as
# 2^(x - m_new), l summed from the float32 p, and p @ v with p in
# bfloat16: split as hi = bf16(p), lo = bf16(p - hi) (what the kernel
# does), or rounded once (what it does not do).  Each is held against
# ``ref.attention`` in bfloat16 by the card's elementwise bound,
# 2e-5 + 2^-7 |ref|.

LOG2E = 1.4426950408889634
EMULATED = [(1, 4, 1, 256, 64, 96), (2, 2, 2, 200, 32, 0),
            (1, 8, 2, 1040, 16, 0), (1, 4, 2, 1984, 64, 0),
            (1, 4, 1, 700, 64, 33), (1, 2, 2, 300, 128, 50)]


def _emulate_tc(q, k, v, window: int, split: bool) -> torch.Tensor:
    B, H, L, D = q.shape
    G = H // k.shape[1]
    bk = 64 if D == 128 else 128
    scale_log2 = torch.tensor(LOG2E / np.sqrt(D), dtype=torch.float32)
    qf = q.float()
    kf, vf = (x.float().repeat_interleave(G, 1) for x in (k, v))
    m = torch.full((B, H, L, 1), ref.NEG)
    l = torch.zeros((B, H, L, 1))
    acc = torch.zeros((B, H, L, D))
    qpos = torch.arange(L)[:, None]
    for k0 in range(0, L, bk):
        kt, vt = kf[:, :, k0:k0 + bk], vf[:, :, k0:k0 + bk]
        s = (qf @ kt.transpose(-1, -2)) * scale_log2
        kpos = torch.arange(k0, k0 + kt.shape[2])[None, :]
        ok = kpos <= qpos
        if window:
            ok &= kpos > qpos - window
        s = s.masked_fill(~ok, ref.NEG)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        hi = p.bfloat16().float()
        pv = hi @ vt
        if split:
            pv = pv + (p - hi).bfloat16().float() @ vt
        acc = acc * alpha + pv
        m = m_new
    return (acc / l.clamp_min(1e-30)).bfloat16()


def _bf16_excess(out: torch.Tensor, want: torch.Tensor) -> float:
    o, w = out.float(), want.float()
    return float(((o - w).abs() / (2e-5 + 2.0 ** -7 * w.abs())).max())


@pytest.mark.parametrize("B,H,K,L,D,win", EMULATED)
def test_tc_arithmetic_with_split_p_holds_the_bf16_bound(B, H, K, L, D, win):
    (_, _, _), (q, k, v) = _inputs(B, H, K, L, D, "bf16", L + D + win)
    want = ref.attention(q, k, v, window=win)
    assert _bf16_excess(_emulate_tc(q, k, v, win, split=True), want) <= 1.0


@pytest.mark.parametrize("B,H,K,L,D,win", EMULATED)
def test_tc_arithmetic_with_p_rounded_once_breaks_the_bf16_bound(
        B, H, K, L, D, win):
    """Why the kernel pays for a second product: p rounded once to
    bfloat16 puts outputs many bfloat16 steps off the plain version."""
    (_, _, _), (q, k, v) = _inputs(B, H, K, L, D, "bf16", L + D + win)
    want = ref.attention(q, k, v, window=win)
    assert _bf16_excess(_emulate_tc(q, k, v, win, split=False), want) > 10.0
