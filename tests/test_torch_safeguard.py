"""Port parity: ``repro_torch.core.safeguard.safeguard_step`` against
``repro.core.safeguard.safeguard_step`` on the same numpy gradients, over
mode x rule, the engines/backends and ``reset_period`` (the grids of
tests/test_safeguard_flat.py).  Filter decisions must match exactly;
aggregates to rtol 1e-5; thresholds, distances and scores to rtol 1e-5 on
their squares, plus an absolute 64 * eps_f32 * max_i ||acc_i||^2.  That
term is the float32 cancellation in d_i + d_j - 2 G_ij: both packages
compute it in float32, summing in different orders, so the squared
distances carry an absolute error of order eps times the accumulators'
squared norms — large against the small honest distances."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import attacks as jatk
from repro.core import safeguard as jsg
from repro_torch.core import attacks as tatk
from repro_torch.core import safeguard as tsg
from repro_torch.core import tree_utils as tu

M = 10
SHAPES = {"w": (20, 5), "b": (5,), "blocks": {"h": (3, 4, 2)}}
EXACT = ("good", "med_B", "med_A", "newly_evicted", "restored")
EXACT_VALUES = ("n_good",)
# distance-valued info keys -> the accumulator they are measured on
DISTANCES = {"threshold_B": "B", "threshold_A": "A", "dist_to_med_B": "B",
             "dist_to_med_A": "A", "scores_B": "B"}
EPS = float(np.finfo(np.float32).eps)


def _params(lib):
    zeros = jnp.zeros if lib == "jax" else torch.zeros
    return {"w": zeros(SHAPES["w"]), "b": zeros(SHAPES["b"]),
            "blocks": {"h": zeros(SHAPES["blocks"]["h"])}}


def _grads(rng, mu=1.0, sigma=0.05):
    def one(shape):
        return (mu + sigma * rng.standard_normal((M,) + shape)
                ).astype(np.float32)
    return {"w": one(SHAPES["w"]), "b": one(SHAPES["b"]),
            "blocks": {"h": one(SHAPES["blocks"]["h"])}}


def _close(a, b, rtol=1e-5, atol=0.0):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), rtol=rtol,
                               atol=atol)


def _max_row_sq(st, name):
    buf = getattr(st, name)
    if buf is None:                      # single mode: A mirrors B
        buf = st.B
    rows = (tu.tree_row_sq_norms(buf) if isinstance(buf, dict)
            else buf.double().square().sum(dim=1))
    return float(rows.max())


def run_both(jcfg, tcfg, jattack, tattack, n_byz, steps):
    """Drive both steps on the same gradients; compare every step."""
    rng = np.random.default_rng(0)
    jst = jsg.init_state(jcfg, _params("jax"))
    tst = tsg.init_state(tcfg, _params("torch"))
    jstep = jax.jit(lambda s, g: jsg.safeguard_step(s, g, jcfg))
    byz_np = np.arange(M) < n_byz
    for t in range(steps):
        g = _grads(rng)
        gj, _ = jattack(jax.tree.map(jnp.asarray, g), jnp.asarray(byz_np),
                        None, jnp.int32(t), None)
        gt, _ = tattack(tu.tree_map(torch.from_numpy, g),
                        torch.from_numpy(byz_np), None, t, None)
        jst, jagg, jinfo = jstep(jst, gj)
        tst, tagg, tinfo = tsg.safeguard_step(tst, gt, tcfg)
        for k in EXACT:
            np.testing.assert_array_equal(tinfo[k].numpy(),
                                          np.asarray(jinfo[k]),
                                          err_msg=f"{k} at step {t}")
        for k in EXACT_VALUES:
            np.testing.assert_array_equal(tinfo[k].numpy(),
                                          np.asarray(jinfo[k]))
        for k, acc in DISTANCES.items():
            sq_t = np.asarray(tinfo[k], np.float64) ** 2
            sq_j = np.asarray(jinfo[k], np.float64) ** 2
            np.testing.assert_allclose(
                sq_t, sq_j, rtol=1e-5,
                atol=64 * EPS * _max_row_sq(tst, acc), err_msg=k)
        np.testing.assert_array_equal(tst.evicted_at.numpy(),
                                      np.asarray(jst.evicted_at))
        jleaves = jax.tree_util.tree_leaves(jagg)
        for a, b in zip(tu.tree_leaves(tagg), jleaves):
            _close(a, b)
    return jst, tst


def _acc_leaves(st):
    acc = [st.B] if st.A is None else [st.A, st.B]
    return [leaf for x in acc for leaf in
            (tu.tree_leaves(x) if isinstance(x, dict) else
             jax.tree_util.tree_leaves(x))]


def _kwargs(mode, rule):
    kw = dict(m=M, T0=10, T1=30, mode=mode, rule=rule)
    if rule == "empirical":
        kw["threshold_floor"] = 0.5
    else:
        t0, t1 = jsg.SafeguardConfig.theoretical_thresholds(10, 30, M, V=0.2)
        kw.update(thresh0=t0, thresh1=t1)
    return kw


@pytest.mark.parametrize("mode", ["double", "single"])
@pytest.mark.parametrize("rule", ["empirical", "theoretical"])
def test_step_matches_jax(mode, rule):
    kw = _kwargs(mode, rule)
    jst, tst = run_both(jsg.SafeguardConfig(**kw),
                        tsg.SafeguardConfig(**kw),
                        jatk.attack_sign_flip, tatk.attack_sign_flip, 4, 40)
    assert not tst.good[:4].any(), "the attack must be caught"
    for a, b in zip(_acc_leaves(tst), _acc_leaves(jst)):
        _close(a, b, atol=1e-6)


@pytest.mark.parametrize("jax_engine,jax_backend,engine,backend", [
    ("flat", "pallas_fused", "flat", "kernel_fused"),
    ("flat", "xla", "flat", "plain"),
    ("stacked", "pallas", "stacked", "kernel"),
])
def test_backends_match_jax(jax_engine, jax_backend, engine, backend):
    """Each port backend against its JAX counterpart (the mapping of the
    port's safeguard docstring); the A/B buffers compare column for
    column."""
    kw = _kwargs("double", "empirical")
    jst, tst = run_both(
        jsg.SafeguardConfig(engine=jax_engine, backend=jax_backend, **kw),
        tsg.SafeguardConfig(engine=engine, backend=backend, **kw),
        jatk.attack_sign_flip, tatk.attack_sign_flip, 4, 40)
    if engine == "flat":
        assert tst.A.shape == (M, jst.layout.d_padded)
    for a, b in zip(_acc_leaves(tst), _acc_leaves(jst)):
        _close(a, b, atol=1e-6)


def test_reset_period_matches_jax():
    kw = dict(m=M, T0=10, T1=20, threshold_floor=0.5, reset_period=30)
    jattack = jatk.make_burst(start=0, length=10, burst_scale=5.0)

    def tattack(grads, byz_mask, state, step, gen):
        # the reference's burst attack on the same rows (not ported yet)
        on = 0 <= step < 10
        return tu.tree_map(lambda g: torch.where(
            byz_mask.reshape((-1,) + (1,) * (g.ndim - 1)) & on,
            -5.0 * g, g), grads), state

    jst, tst = run_both(jsg.SafeguardConfig(**kw), tsg.SafeguardConfig(**kw),
                        jattack, tattack, 3, 35)
    assert tst.good.all(), "the reset restores every worker"


def test_layout_and_round_trip():
    params = _params("torch")
    lay = tsg.make_layout(params)
    jlay = jsg.make_layout(_params("jax"))
    assert (lay.d, lay.d_padded, lay.offsets, lay.sizes) == (
        jlay.d, jlay.d_padded, jlay.offsets, jlay.sizes)
    g = tu.tree_map(torch.from_numpy, _grads(np.random.default_rng(3)))
    flat = tsg.flatten_stacked(g, lay)
    jflat = jsg.flatten_stacked(jax.tree.map(
        lambda x: jnp.asarray(x.numpy()), g), jlay)
    np.testing.assert_array_equal(flat.numpy(), np.asarray(jflat))
    back = tsg.unflatten_row(flat[4], lay)
    for a, b in zip(tu.tree_leaves(back), tu.tree_leaves(g)):
        np.testing.assert_array_equal(a.numpy(), b[4].numpy())
