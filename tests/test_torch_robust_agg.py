"""Port parity: ``repro_torch.kernels.robust_agg`` against the JAX
package's ``ops`` (the Pallas kernel in interpret mode), its ``ref`` and
the defense's own ``core.aggregators``, on the same numpy inputs.

Tolerance: none.  The median is a selection plus one float32
``(a + b) * 0.5``, and the trimmed mean adds the kept ranks in rank order
and multiplies by the float32 reciprocal of their count — what XLA makes
of ``jnp.mean`` over the kept rows — so the port equals the JAX package
bit for bit, in float32 and after the cast back to bfloat16.

On a column that holds a NaN the port follows the defense
(``jnp.median``: NaN); the JAX Pallas kernel sorts NaN last and returns
a finite middle value there, which one test records."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import aggregators as jagg
from repro.kernels.robust_agg import ops as jops
from repro.kernels.robust_agg import ref as jref
from repro_torch.core import aggregators as tagg
from repro_torch.kernels.robust_agg import ops, ref

DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
# the shape sweeps of tests/test_kernels.py (robust_agg)
MEDIAN_SHAPES = [(5, 128), (10, 1000), (16, 4096), (9, 257), (8, 130)]
TRIM_SHAPES = [(10, 512, 2), (16, 1000, 4), (7, 129, 1)]


def _pair(m, n, dt, seed):
    a = np.random.default_rng(seed).standard_normal((m, n)).astype(
        np.float32)
    jdt, tdt = DTYPES[dt]
    return jnp.asarray(a).astype(jdt), torch.from_numpy(a).to(tdt)


def _same(out: torch.Tensor, want) -> None:
    np.testing.assert_array_equal(out.float().numpy(),
                                  np.asarray(want).astype(np.float32))


@pytest.mark.parametrize("m,n", MEDIAN_SHAPES)
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_coord_median_matches_jax_bit_for_bit(m, n, dt):
    aj, at = _pair(m, n, dt, m * 7919 + n)
    out = ops.coord_median(at)
    assert out.dtype == torch.float32 and out.shape == (n,)
    for want in (jops.coord_median(aj), jref.coord_median(aj)):
        _same(out, want)
    _same(tagg.coordinate_median({"g": at})["g"],
          jagg.coordinate_median({"g": aj})["g"])


@pytest.mark.parametrize("m,n,trim", TRIM_SHAPES)
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_trimmed_mean_matches_jax_bit_for_bit(m, n, trim, dt):
    aj, at = _pair(m, n, dt, m * 131 + n + trim)
    out = ops.trimmed_mean(at, trim)
    assert out.dtype == torch.float32 and out.shape == (n,)
    for want in (jops.trimmed_mean(aj, trim=trim),
                 jref.trimmed_mean(aj, trim)):
        _same(out, want)
    _same(tagg.trimmed_mean({"g": at}, trim)["g"],
          jagg.trimmed_mean({"g": aj}, trim)["g"])


@pytest.mark.parametrize("m,trim", [(4, 2), (5, 3), (3, -1)])
def test_trimmed_mean_overtrim_raises(m, trim):
    with pytest.raises(ValueError):
        ops.trimmed_mean(torch.zeros((m, 128)), trim)
    if trim >= 0:
        with pytest.raises(ValueError):
            jops.trimmed_mean(jnp.zeros((m, 128)), trim=trim)


def _nonfinite(m):
    """(m, 8) with NaN and inf planted column by column: one NaN, +inf,
    -inf, both infs, two NaNs, all NaN, a NaN beside an inf, finite."""
    a = np.random.default_rng(m).standard_normal((m, 8)).astype(np.float32)
    a[1, 0] = np.nan
    a[2, 1] = np.inf
    a[0, 2] = -np.inf
    a[3, 3], a[4, 3] = np.inf, -np.inf
    a[0, 4], a[m - 1, 4] = np.nan, np.nan
    a[:, 5] = np.nan
    a[2, 6], a[3, 6] = np.nan, np.inf
    return a


@pytest.mark.parametrize("m", [5, 9, 10])
def test_coord_median_nonfinite_columns_follow_the_defense(m):
    a = _nonfinite(m)
    out = ops.coord_median(torch.from_numpy(a)).numpy()
    for want in (jagg.coordinate_median({"g": jnp.asarray(a)})["g"],
                 jref.coord_median(jnp.asarray(a))):
        np.testing.assert_array_equal(out, np.asarray(want))
    assert np.isnan(out[[0, 4, 5, 6]]).all() and np.isfinite(out[7])
    # the JAX Pallas kernel diverges from its own defense here: NaN sorts
    # last and the middle value stays finite
    assert np.isfinite(np.asarray(jops.coord_median(jnp.asarray(a)))[0])


@pytest.mark.parametrize("m,trim", [(10, 1), (10, 2), (10, 4), (9, 3)])
def test_trimmed_mean_nonfinite_columns_match_jax(m, trim):
    a = _nonfinite(m)
    out = ops.trimmed_mean(torch.from_numpy(a), trim).numpy()
    for want in (jref.trimmed_mean(jnp.asarray(a), trim),
                 jops.trimmed_mean(jnp.asarray(a), trim=trim),
                 jagg.trimmed_mean({"g": jnp.asarray(a)}, trim)["g"]):
        np.testing.assert_array_equal(out, np.asarray(want))
    assert np.isnan(out[5])


def test_coord_median_odd_m_is_the_midpoint_like_jnp_median():
    """``(v + v) * 0.5`` overflows where ``2 v`` does: the port keeps
    ``jnp.median``'s result, not the middle value itself."""
    a = np.full((3, 2), 3e38, np.float32)
    a[:, 1] = 1.5
    out = ops.coord_median(torch.from_numpy(a)).numpy()
    np.testing.assert_array_equal(out, np.asarray(
        jref.coord_median(jnp.asarray(a))))
    assert out[0] == np.inf and out[1] == 1.5


def test_plain_version_is_what_the_cpu_wrappers_run():
    a = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (10, 300)).astype(np.float32))
    assert torch.equal(ops.coord_median(a), ref.coord_median(a))
    assert torch.equal(ops.trimmed_mean(a, 3), ref.trimmed_mean(a, 3))


def test_cpu_path_launches_no_kernel():
    ops.reset_launch_counts()
    a = torch.ones((4, 16))
    ops.coord_median(a)
    ops.trimmed_mean(a, 1)
    assert ops.LAUNCHES == {"coord_median": 0, "trimmed_mean": 0}


def test_wrappers_refuse_other_devices():
    """Only the CPU takes the plain version; any other non-CUDA device
    raises instead of silently falling back."""
    a = torch.empty((4, 16), device="meta")
    with pytest.raises(ValueError):
        ops.coord_median(a)
    with pytest.raises(ValueError):
        ops.trimmed_mean(a, 1)
