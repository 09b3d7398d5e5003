"""The hand-written CUDA kernels of the port (B1 and B2 of
``safeguard_filter``, B3 of ``robust_agg``, B4 of ``flash_attention``)
against their plain PyTorch versions, on the card.  Imports no JAX, so it runs on a machine that
has only PyTorch; without a CUDA device every test skips.

    python -m pytest -q tests/test_torch_cuda.py
"""

import math

import pytest
import torch

from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.kernels.robust_agg import ops as ra_ops
from repro_torch.kernels.robust_agg import ref as ra_ref
from repro_torch.kernels.safeguard_filter import ops, ref

DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("m,d", [(1, 5), (4, 128), (10, 1000), (33, 129),
                                 (64, 4099), (10, 5 * 128 + 3)])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_pairwise_sqdist_kernel_matches_plain(cuda, m, d, dt):
    gen = torch.Generator(device=cuda).manual_seed(m + d)
    a = torch.randn((m, d), generator=gen, device=cuda).to(DTYPES[dt])
    before = ops.LAUNCHES["pairwise_sqdist"]
    tol = (1e-3 if dt == "bf16" else 1e-4) * d
    torch.testing.assert_close(ops.pairwise_sqdist(a), ref.pairwise_sqdist(a),
                               atol=tol, rtol=0)
    assert ops.LAUNCHES["pairwise_sqdist"] == before + 1


@pytest.mark.parametrize("m,d", [(3, 50), (10, 777), (64, 1024)])
@pytest.mark.parametrize("reset", [0, 1])
def test_fused_kernel_matches_plain(cuda, m, d, reset):
    gen = torch.Generator(device=cuda).manual_seed(m + d)
    acc = torch.randn((m, d), generator=gen, device=cuda)
    g = torch.randn((m, d), generator=gen, device=cuda)
    want_new, want_sq = ref.fused_accumulate_sqdist(acc, g, reset, 0.1)
    new, sq = ops.fused_accumulate_sqdist(
        acc, g, torch.tensor(reset, device=cuda),
        torch.tensor(0.1, device=cuda))
    assert new is acc
    # the same float32 multiply then add as the plain version: bit-exact
    torch.testing.assert_close(new, want_new, atol=0, rtol=0)
    torch.testing.assert_close(sq, want_sq, atol=1e-4 * d, rtol=0)


def test_fused_reset_clears_nonfinite(cuda):
    acc = torch.ones((8, 256), device=cuda)
    acc[2], acc[3] = float("inf"), float("nan")
    new, sq = ops.fused_accumulate_sqdist(acc, torch.ones_like(acc), 1, 0.5)
    assert torch.isfinite(new).all() and torch.isfinite(sq).all()
    torch.testing.assert_close(new, torch.full_like(new, 0.5))


def test_kernels_refuse_what_they_cannot_take(cuda):
    with pytest.raises(ValueError):
        ops.pairwise_sqdist(torch.ones((65, 8), device=cuda))
    with pytest.raises(TypeError):
        ops.pairwise_sqdist(torch.ones((4, 8), device=cuda,
                                       dtype=torch.float16))
    with pytest.raises(ValueError):
        ops.pairwise_sqdist(torch.ones((8, 4), device=cuda).T)
    with pytest.raises(TypeError):
        ops.fused_accumulate_sqdist(torch.ones((4, 8), device=cuda),
                                    torch.ones((4, 8), device=cuda,
                                               dtype=torch.bfloat16), 0, 1.0)


# B3: the coordinate median is a selection plus one float32 midpoint, and
# the trimmed mean adds the kept ranks in rank order, as the plain
# version does: both are held to the plain version bit for bit


def _robust_input(cuda, m, n, dt, seed):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    return torch.randn((m, n), generator=gen, device=cuda).to(DTYPES[dt])


def _assert_same(out, want):
    torch.testing.assert_close(out, want, atol=0, rtol=0, equal_nan=True)


@pytest.mark.parametrize("m", [1, 2, 3, 9, 10, 16, 33, 64])
@pytest.mark.parametrize("n", [1, 1000, 4099])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_coord_median_kernel_matches_plain(cuda, m, n, dt):
    g = _robust_input(cuda, m, n, dt, m * 1000 + n)
    before = ra_ops.LAUNCHES["coord_median"]
    _assert_same(ra_ops.coord_median(g), ra_ref.coord_median(g))
    assert ra_ops.LAUNCHES["coord_median"] == before + 1


@pytest.mark.parametrize("m", [3, 9, 10, 16, 33, 64])
@pytest.mark.parametrize("trim", [1, 2, 4])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_trimmed_mean_kernel_matches_plain(cuda, m, trim, dt):
    if 2 * trim >= m:
        with pytest.raises(ValueError):
            ra_ops.trimmed_mean(torch.zeros((m, 8), device=cuda), trim)
        return
    g = _robust_input(cuda, m, 4099, dt, m * 10 + trim)
    before = ra_ops.LAUNCHES["trimmed_mean"]
    _assert_same(ra_ops.trimmed_mean(g, trim), ra_ref.trimmed_mean(g, trim))
    assert ra_ops.LAUNCHES["trimmed_mean"] == before + 1


@pytest.mark.parametrize("m", [5, 10, 33])
def test_robust_kernel_nonfinite_columns(cuda, m):
    """NaN and inf column by column: the median of a column holding a NaN
    is NaN; the trimmed mean is NaN when a NaN reaches the kept ranks."""
    g = _robust_input(cuda, m, 8, "f32", m)
    g[1, 0] = math.nan
    g[2, 1] = math.inf
    g[0, 2] = -math.inf
    g[3, 3], g[4, 3] = math.inf, -math.inf
    g[0, 4], g[m - 1, 4] = math.nan, math.nan
    g[:, 5] = math.nan
    g[2, 6], g[3, 6] = math.nan, math.inf
    med = ra_ops.coord_median(g)
    _assert_same(med, ra_ref.coord_median(g))
    assert torch.isnan(med[[0, 4, 5, 6]]).all()
    for trim in (1, 2):
        _assert_same(ra_ops.trimmed_mean(g, trim),
                     ra_ref.trimmed_mean(g, trim))


def test_robust_kernel_refuses_what_it_cannot_take(cuda):
    with pytest.raises(ValueError):
        ra_ops.coord_median(torch.ones((65, 8), device=cuda))
    with pytest.raises(TypeError):
        ra_ops.coord_median(torch.ones((4, 8), device=cuda,
                                       dtype=torch.float16))
    with pytest.raises(ValueError):
        ra_ops.coord_median(torch.ones((8, 4), device=cuda).T)
    with pytest.raises(ValueError):
        ra_ops.trimmed_mean(torch.ones((4, 8), device=cuda), 2)


# B4: flash attention against its plain version.  Tolerances are the JAX
# package's for its kernel against its reference: the sums run in another
# order (2e-5 in float32), and the bfloat16 output rounds once (2e-2).
# In bfloat16 each element is also held within 2e-5 plus one bfloat16 step
# of the plain version's value (2**-7 * |ref|): both round float32 results
# that differ by less than 2e-5, so they land at most one step apart.

FLASH_TOL = {"f32": 2e-5, "bf16": 2e-2}
FLASH_BF16_RTOL = 2.0 ** -7
# the kernel each dtype goes to: bfloat16 to the tensor cores, float32 to
# the CUDA cores
FLASH_KERNEL = {"bf16": "flash_attention_tc", "f32": "flash_attention_f32"}


def _qkv(cuda, B, H, K, L, D, dt, seed):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    return [torch.randn(shape, generator=gen, device=cuda).to(DTYPES[dt])
            for shape in ((B, H, L, D), (B, K, L, D), (B, K, L, D))]


@pytest.mark.parametrize("B,H,K,L,D,win", [
    (1, 4, 4, 256, 64, 0),      # MHA
    (2, 8, 2, 128, 64, 0),      # GQA
    (1, 4, 1, 256, 64, 96),     # MQA + sliding window
    (2, 2, 2, 200, 32, 0),      # ragged L
    (1, 2, 2, 128, 128, 0),     # one tile of 128
    (1, 8, 2, 1040, 16, 0),     # the smoke model's head dim, ragged L
    (1, 4, 2, 1984, 64, 0),     # the serve prompt, ragged L
    (1, 4, 1, 700, 64, 33),     # a window that is not a tile multiple
])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_flash_attention_kernel_matches_plain(cuda, B, H, K, L, D, win, dt):
    q, k, v = _qkv(cuda, B, H, K, L, D, dt, B * H + L + D + win)
    name = FLASH_KERNEL[dt]
    before = fa_ops.LAUNCHES["flash_attention"], fa_ops.LAUNCHES[name]
    out = fa_ops.flash_attention(q, k, v, window=win)
    assert (fa_ops.LAUNCHES["flash_attention"],
            fa_ops.LAUNCHES[name]) == (before[0] + 1, before[1] + 1)
    assert out.dtype == q.dtype and out.shape == q.shape
    want = fa_ref.attention(q, k, v, window=win).float()
    torch.testing.assert_close(out.float(), want, atol=FLASH_TOL[dt], rtol=0)
    if dt == "bf16":
        torch.testing.assert_close(out.float(), want,
                                   atol=FLASH_TOL["f32"],
                                   rtol=FLASH_BF16_RTOL)


def test_flash_attention_kernel_takes_transposed_views(cuda):
    """(B, L, H, D) projections passed as transpose(1, 2) views: the same
    result as contiguous inputs, and an output in the same layout."""
    q, k, v = _qkv(cuda, 2, 8, 2, 300, 64, "bf16", 7)
    qt, kt, vt = (x.transpose(1, 2).contiguous().transpose(1, 2)
                  for x in (q, k, v))
    out = fa_ops.flash_attention(qt, kt, vt, window=50)
    assert out.transpose(1, 2).is_contiguous()
    torch.testing.assert_close(out, fa_ops.flash_attention(q, k, v,
                                                           window=50),
                               atol=0, rtol=0)


def test_flash_attention_kernel_first_row_is_v0(cuda):
    q, k, v = _qkv(cuda, 1, 2, 1, 128, 32, "f32", 3)
    out = fa_ops.flash_attention(q, k, v)
    torch.testing.assert_close(out[0, :, 0], v[0, [0, 0], 0], atol=0,
                               rtol=1e-5)


def test_flash_attention_kernel_refuses_what_it_cannot_take(cuda):
    q, k, v = _qkv(cuda, 1, 4, 2, 64, 64, "f32", 0)
    with pytest.raises(TypeError):
        fa_ops.flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(TypeError):
        fa_ops.flash_attention(q, k.bfloat16(), v)
    with pytest.raises(ValueError):
        fa_ops.flash_attention(q[..., :48], k[..., :48], v[..., :48])
    with pytest.raises(ValueError):
        fa_ops.flash_attention(q[:, :3], k, v)
    with pytest.raises(ValueError):
        fa_ops.flash_attention(q, k.cpu(), v)


@pytest.mark.parametrize("B,H,K,L,D,win", [
    (2, 8, 2, 1040, 64, 0),
    (1, 4, 1, 700, 64, 33),
    (1, 2, 2, 300, 128, 50),
])
def test_flash_attention_tc_kernel_repeats_its_bits(cuda, B, H, K, L, D, win):
    """No atomics and no split of the keys: two launches on the same
    inputs give the same bits."""
    q, k, v = _qkv(cuda, B, H, K, L, D, "bf16", 11 + win)
    first = fa_ops.flash_attention(q, k, v, window=win)
    torch.testing.assert_close(fa_ops.flash_attention(q, k, v, window=win),
                               first, atol=0, rtol=0)


def test_flash_attention_tc_kernel_serve_full_shape_wide_window(cuda):
    """The serve-full prefill's shape (B=4, H=32, K=4, L=1984, D=64) as the
    model passes it, transpose views of (B, L, H, D) projections, with a
    window of 4096 > L: the same function as causal attention."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    q, k, v = (torch.randn((4, 1984, n, 64), generator=gen, device=cuda,
                           dtype=torch.bfloat16).transpose(1, 2)
               for n in (32, 4, 4))
    before = fa_ops.LAUNCHES["flash_attention_tc"]
    out = fa_ops.flash_attention(q, k, v, window=4096)
    assert fa_ops.LAUNCHES["flash_attention_tc"] == before + 1
    assert out.transpose(1, 2).is_contiguous()
    want = fa_ref.attention(q, k, v, window=4096).float()
    torch.testing.assert_close(out.float(), want, atol=FLASH_TOL["bf16"],
                               rtol=0)
    torch.testing.assert_close(out.float(), want, atol=FLASH_TOL["f32"],
                               rtol=FLASH_BF16_RTOL)
    torch.testing.assert_close(out, fa_ops.flash_attention(q, k, v),
                               atol=0, rtol=0)


def test_flash_attention_tc_kernel_refuses_what_tma_cannot_address(cuda):
    """bfloat16 goes through TMA: a last-dim stride other than 1, or a
    stride that is not a multiple of 16 bytes, raises ValueError before
    any launch."""
    q, k, v = _qkv(cuda, 1, 4, 2, 64, 64, "bf16", 0)
    before = dict(fa_ops.LAUNCHES)
    qt = q.transpose(2, 3).contiguous().transpose(2, 3)    # d stride 64
    with pytest.raises(ValueError, match="last-dim stride"):
        fa_ops.flash_attention(qt, k, v)
    wide = torch.zeros((1, 4, 64, 68), device=cuda, dtype=torch.bfloat16)
    wide[..., :64] = q                                      # l stride 68
    with pytest.raises(ValueError, match="multiples of 16 bytes"):
        fa_ops.flash_attention(wide[..., :64], k, v)
    assert fa_ops.LAUNCHES == before
