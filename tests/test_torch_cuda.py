"""The hand-written CUDA kernels of the port against their plain PyTorch
versions, on the card.  Imports no JAX, so it runs on a machine that
has only PyTorch; without a CUDA device every test skips.

    python -m pytest -q tests/test_torch_cuda.py
"""

import pytest
import torch

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
