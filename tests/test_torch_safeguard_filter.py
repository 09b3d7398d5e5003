"""Port parity: ``repro_torch.kernels.safeguard_filter`` against the JAX
package's ``ops`` (Pallas kernels in interpret mode) and ``ref``, on the
same numpy inputs.  Tolerances are those of tests/test_kernels.py:
1e-4 * d for float32 and 1e-3 * d for bfloat16 distances (sums over d
terms in another order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.safeguard_filter import ops as jops
from repro.kernels.safeguard_filter import ref as jref
from repro_torch.kernels.safeguard_filter import ops, ref

DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _tol(name, d):
    return 1e-3 * d if name == "bf16" else 1e-4 * d


@pytest.mark.parametrize("m,d", [(4, 128), (10, 1000), (16, 4096),
                                 (7, 513), (32, 2048), (33, 129)])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_pairwise_sqdist_matches_jax(m, d, dt):
    a = np.random.default_rng(m * 7919 + d).standard_normal(
        (m, d)).astype(np.float32)
    jdt, tdt = DTYPES[dt]
    aj = jnp.asarray(a).astype(jdt)
    at = torch.from_numpy(a).to(tdt)
    out = ops.pairwise_sqdist(at)
    assert out.dtype == torch.float32 and out.shape == (m, m)
    tol = _tol(dt, d)
    for want in (jops.pairwise_sqdist(aj, block_d=None),
                 jref.pairwise_sqdist(aj)):
        np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=tol)
    np.testing.assert_allclose(torch.diagonal(out).numpy(), 0.0, atol=tol)


def test_pairwise_sqdist_symmetry():
    a = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (12, 777)).astype(np.float32))
    out = ops.pairwise_sqdist(a).numpy()
    np.testing.assert_allclose(out, out.T, atol=1e-4)


@pytest.mark.parametrize("m,d", [(10, 777), (8, 1024), (3, 50)])
@pytest.mark.parametrize("reset", [0, 1])
def test_fused_matches_jax(m, d, reset):
    rng = np.random.default_rng(d + reset)
    acc = rng.standard_normal((m, d)).astype(np.float32)
    g = rng.standard_normal((m, d)).astype(np.float32)
    jnew, jsq = jops.fused_accumulate_sqdist(jnp.asarray(acc), jnp.asarray(g),
                                             reset, 0.125)
    rnew, rsq = jref.fused_accumulate_sqdist(jnp.asarray(acc),
                                             jnp.asarray(g), reset, 0.125)
    acc_t = torch.from_numpy(acc.copy())
    new, sq = ops.fused_accumulate_sqdist(acc_t, torch.from_numpy(g),
                                          torch.tensor(reset),
                                          torch.tensor(0.125))
    assert new is acc_t, "the update is in place"
    for want_new, want_sq in ((jnew, jsq), (rnew, rsq)):
        np.testing.assert_allclose(new.numpy(), np.asarray(want_new),
                                   atol=1e-5)
        np.testing.assert_allclose(sq.numpy(), np.asarray(want_sq),
                                   atol=1e-3 * d)


def test_fused_reset_zeroes_nonfinite_accumulator():
    """The reset is a select, not a multiply: inf/NaN rows vanish."""
    acc = np.ones((8, 256), np.float32)
    acc[2], acc[3] = np.inf, np.nan
    g = np.ones((8, 256), np.float32)
    jnew, jsq = jref.fused_accumulate_sqdist(jnp.asarray(acc),
                                             jnp.asarray(g), 1, 0.5)
    new, sq = ops.fused_accumulate_sqdist(torch.from_numpy(acc.copy()),
                                          torch.from_numpy(g), 1, 0.5)
    assert torch.isfinite(new).all() and torch.isfinite(sq).all()
    np.testing.assert_allclose(new.numpy(), np.asarray(jnew))
    np.testing.assert_allclose(sq.numpy(), np.asarray(jsq), atol=1e-3)


@pytest.mark.parametrize("mag", [1e2, 1e4])
def test_sqdist_clamps_at_zero(mag):
    """Near-duplicate large rows push d_i + d_j - 2 G_ij into f32
    cancellation; every producer clamps at 0."""
    rng = np.random.default_rng(0)
    rows = (mag * rng.standard_normal((1, 256))
            + 1e-6 * mag * rng.standard_normal((8, 256))).astype(np.float32)
    rows_t = torch.from_numpy(rows)
    outs = {"ops": ops.pairwise_sqdist(rows_t),
            "ref": ref.pairwise_sqdist(rows_t),
            "fused": ops.fused_accumulate_sqdist(
                torch.zeros_like(rows_t), rows_t, 0, 1.0)[1]}
    for name, sq in outs.items():
        assert torch.isfinite(sq).all() and (sq >= 0).all(), name


def test_cpu_path_launches_no_kernel():
    ops.reset_launch_counts()
    a = torch.ones((4, 16))
    ops.pairwise_sqdist(a)
    ops.fused_accumulate_sqdist(a.clone(), a, 0, 1.0)
    assert ops.LAUNCHES == {"pairwise_sqdist": 0,
                            "fused_accumulate_sqdist": 0}


def test_wrappers_refuse_other_devices():
    """Only the CPU takes the plain version; any other non-CUDA device
    raises instead of silently falling back."""
    a = torch.empty((4, 16), device="meta")
    with pytest.raises(ValueError):
        ops.pairwise_sqdist(a)
    with pytest.raises(ValueError):
        ops.fused_accumulate_sqdist(a, a, 0, 1.0)
