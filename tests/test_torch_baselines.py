"""Port parity of the paper's historyless baselines and the attacks that
break them: ``repro_torch.core.aggregators`` / ``defenses`` / ``attacks``
and ``train.trainer.zeno_scores`` against the JAX package, on the same
numpy inputs.

Tolerances:
  * the selections are exact — Krum and the medoid pick the same worker,
    Zeno keeps the same set — and so are the coordinate-wise median and
    trimmed mean (bit for bit, see tests/test_torch_robust_agg.py);
  * means of rows (``mean``, Zeno's masked mean, the variance and ipm
    attacks' honest statistics) add the same float32 terms in another
    order: rtol 1e-6, atol 1e-6 * the rows' scale;
  * Weiszfeld runs 8 iterations of such sums and a square root: rtol 1e-5;
  * Zeno's scores are differences of two losses of the smoke model, each
    a float32 sum over the held batch: atol 1e-5;
  * the 3-step runs of the smoke config under ``variance``: losses and
    parameters to atol 1e-5, as tests/test_torch_train.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import TrainConfig as JTrainConfig
from repro.configs import tinyllama_1_1b as jcfgs
from repro.core import aggregators as jagg
from repro.core import attacks as jatk
from repro.core import defenses as jdfn
from repro.data import pipeline as jdata
from repro.models import transformer as JT
from repro.optim import make_optimizer as jmake_optimizer
from repro.train import init_train_state as jinit
from repro.train import make_train_step as jmake_step
from repro.train.trainer import zeno_scores as jzeno_scores
from repro_torch.configs import TrainConfig
from repro_torch.configs import tinyllama_1_1b as tcfgs
from repro_torch.convert import params_from_jax
from repro_torch.core import aggregators as tagg
from repro_torch.core import attacks as tatk
from repro_torch.core import defenses as tdfn
from repro_torch.core import tree_utils as tu
from repro_torch.data import pipeline as tdata
from repro_torch.models import transformer as TT
from repro_torch.optim import make_optimizer
from repro_torch.train import init_train_state, make_train_step
from repro_torch.train.trainer import zeno_scores

M, N_BYZ = 10, 4
SHAPES = {"w": (20, 5), "b": (5,), "blocks": {"h": (3, 4, 2)}}
BASELINES = ("mean", "coord_median", "trimmed_mean", "geo_median",
             "weiszfeld", "krum", "zeno")
EXACT = ("coord_median", "trimmed_mean", "geo_median", "krum")
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _stacked(seed, m=M):
    """Per-worker gradients around a shared direction, as numpy."""
    rng = np.random.default_rng(seed)

    def leaf(shape):
        mu = rng.standard_normal(shape)
        return (mu + 0.5 * rng.standard_normal((m,) + shape)).astype(
            np.float32)
    return {"w": leaf(SHAPES["w"]), "b": leaf(SHAPES["b"]),
            "blocks": {"h": leaf(SHAPES["blocks"]["h"])}}


def _both(tree, dt="f32"):
    jdt, tdt = DTYPES[dt]
    return (jax.tree.map(lambda a: jnp.asarray(a).astype(jdt), tree),
            tu.tree_map(lambda a: torch.from_numpy(a).to(tdt), tree))


def _assert_tree(t_tree, j_tree, **tol):
    for path, a, b in zip(tu.tree_paths(t_tree), tu.tree_leaves(t_tree),
                          jax.tree_util.tree_leaves(j_tree)):
        assert a.dtype == {jnp.float32: torch.float32,
                           jnp.bfloat16: torch.bfloat16}[b.dtype.type], path
        got, want = a.float().numpy(), np.asarray(b).astype(np.float32)
        if tol:
            np.testing.assert_allclose(got, want, err_msg=path, **tol)
        else:
            np.testing.assert_array_equal(got, want, err_msg=path)


def _tol(name, tree):
    if name in EXACT:
        return {}
    scale = max(float(np.abs(np.asarray(x)).max())
                for x in jax.tree_util.tree_leaves(tree))
    if name == "weiszfeld":
        return dict(rtol=1e-5, atol=1e-5 * scale)
    return dict(rtol=1e-6, atol=1e-6 * scale)


@pytest.mark.parametrize("name", BASELINES)
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_baseline_defense_matches_jax(name, dt):
    tree = _stacked(1)
    jg, tg = _both(tree, dt)
    scores = np.random.default_rng(2).standard_normal(M).astype(np.float32)
    jd = jdfn.make_registry(M, N_BYZ)[name]
    td = tdfn.make_registry(M, N_BYZ)[name]
    for flag in ("needs_held_batch", "static_nbyz", "stateful",
                 "historyless"):
        assert getattr(td, flag) == getattr(jd, flag), flag
    jagg_, _, jinfo = jd.aggregate(None, jg, {"scores": jnp.asarray(scores)})
    tagg_, state, tinfo = td.aggregate(None, tg,
                                       {"scores": torch.from_numpy(scores)})
    assert state is None
    np.testing.assert_array_equal(tinfo["good"].numpy(),
                                  np.asarray(jinfo["good"]))
    assert float(tinfo["n_good"]) == float(jinfo["n_good"])
    tol = _tol(name, tree)
    if dt == "bf16" and tol:
        # one bf16 ulp after the cast of a float32 result that differs in
        # its last bits
        tol = dict(rtol=2 ** -7, atol=tol["atol"])
    _assert_tree(tagg_, jagg_, **tol)


def test_selections_pick_the_same_worker():
    """Krum and the medoid pick one worker's row; the port's index is the
    row the reference returned."""
    for seed in range(5):
        tree = _stacked(10 + seed)
        jg, tg = _both(tree)
        for t_index, j_rule in (
                (tagg.krum_index(tg, N_BYZ),
                 lambda g: jagg.krum(g, N_BYZ)),
                (tagg.medoid_index(tg), jagg.geometric_medoid)):
            picked = tu.tree_select_worker(tg, t_index)
            _assert_tree(picked, j_rule(jg))


def test_argmin_ties_pick_the_first_worker():
    """Identical rows tie every score: both packages pick worker 0."""
    row = _stacked(3, m=1)
    tree = jax.tree.map(lambda a: np.repeat(a, M, axis=0), row)
    jg, tg = _both(tree)
    assert int(tagg.krum_index(tg, N_BYZ)) == 0
    assert int(tagg.medoid_index(tg)) == 0
    _assert_tree(tagg.krum(tg, N_BYZ), jagg.krum(jg, N_BYZ))


def _jax_zeno_keep(scores, n_byz):
    """The reference's kept set, read through its masked mean of the
    identity rows (row i of the mean is keep[i] / |keep|)."""
    out = jagg.zeno({"e": jnp.eye(len(scores))}, jnp.asarray(scores),
                    n_byz)["e"]
    return np.asarray(out) > 0


@pytest.mark.parametrize("scores", [
    [0.3, -1.0, 2.0, 0.1, 0.1, 0.1, 5.0, -2.0, 0.0, 0.7],
    [1.0] * 10,                                   # all tied
    [0.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0],
])
def test_zeno_keeps_the_same_set(scores):
    scores = np.asarray(scores, np.float32)
    keep = tagg.zeno_keep(torch.from_numpy(scores), N_BYZ).numpy()
    np.testing.assert_array_equal(keep, _jax_zeno_keep(scores, N_BYZ))
    assert keep.sum() == M - N_BYZ


def test_krum_needs_more_than_b_plus_2_workers():
    jg, tg = _both(_stacked(4, m=6))
    with pytest.raises(ValueError, match="m > b"):
        tagg.krum(tg, 4)
    with pytest.raises(ValueError, match="m > b"):
        jagg.krum(jg, 4)


def test_zeno_without_scores_raises():
    _, tg = _both(_stacked(5))
    with pytest.raises(ValueError, match="scores"):
        tdfn.make_registry(M, N_BYZ)["zeno"].aggregate(None, tg, {})


@pytest.mark.parametrize("m", [3, 4, 7, 10, 16])
def test_derive_trim_matches_jax(m):
    for b in range(m + 1):
        assert tdfn.derive_trim(b, m) == jdfn.derive_trim(b, m)


def test_weiszfeld_guards_overflowing_distances():
    """Rows so large that every distance is inf: all weights are 0, and
    the guard keeps the iterate from turning into NaN (as the
    reference)."""
    tree = {"w": np.full((M, 4), 3e38, np.float32)}
    tree["w"][::2] *= -1
    jg, tg = _both(tree)
    out = tagg.geometric_median(tg)["w"].numpy()
    np.testing.assert_array_equal(out, np.asarray(
        jagg.geometric_median(jg)["w"]))


@pytest.mark.parametrize("name", ["variance", "ipm", "label_flip"])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_attacks_match_jax(name, dt):
    tree = _stacked(6)
    jg, tg = _both(tree, dt)
    byz = np.arange(M) < N_BYZ
    ja, ta = jatk.make_registry()[name], tatk.make_registry()[name]
    assert ta.data_attack == ja.data_attack
    assert (ta.init is None) == (ja.init is None)
    jout, _ = ja.act(jg, jnp.asarray(byz), None, jnp.int32(0), None)
    tout, _ = ta.act(tg, torch.from_numpy(byz), None, torch.tensor(0), None)
    scale = max(np.abs(a).max() for a in jax.tree_util.tree_leaves(tree))
    tol = dict(rtol=1e-6, atol=1e-6 * scale)
    if dt == "bf16":
        tol = dict(rtol=2 ** -7, atol=1e-6 * scale)
    _assert_tree(tout, jout, **tol)
    # honest rows pass through untouched
    for a, b in zip(tu.tree_leaves(tout), tu.tree_leaves(tg)):
        assert torch.equal(a[N_BYZ:], b[N_BYZ:])
    if name != "label_flip":
        # the colluders send one common vector
        for a in tu.tree_leaves(tout):
            assert torch.equal(a[0], a[N_BYZ - 1])


def test_label_flip_remaps_the_byzantine_token_streams():
    vocab = 50
    tokens = np.random.default_rng(7).integers(0, vocab, (4, 3, 8))
    np.testing.assert_array_equal(
        tdata.flip_labels(torch.from_numpy(tokens), vocab).numpy(),
        np.asarray(jdata.flip_labels(jnp.asarray(tokens), vocab)))
    flip = torch.tensor([True, False, True, False])
    plain = next(tdata.lm_batches(vocab, 12, 8, seed=3, m=4, device="cpu"))
    flipped = next(tdata.lm_batches(vocab, 12, 8, seed=3, m=4,
                                    flip_mask=flip, device="cpu"))
    want = torch.where(flip.reshape(4, 1, 1), vocab - 1 - plain["tokens"],
                       plain["tokens"])
    assert torch.equal(flipped["tokens"], want)


def _smoke_pair():
    jparams = JT.init_params(jcfgs.SMOKE, jax.random.PRNGKey(0))
    return jparams, params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")


def _held_tokens(seed=11):
    return np.random.default_rng(seed).integers(
        0, tcfgs.SMOKE.vocab_size, (8, 16)).astype(np.int32)


def test_zeno_scores_on_the_smoke_model_match_jax():
    jparams, tparams = _smoke_pair()
    rng = np.random.default_rng(8)
    grads = jax.tree.map(
        lambda p: (0.02 * rng.standard_normal((M,) + p.shape)).astype(
            np.float32), jax.tree.map(np.asarray, jparams))
    # the Byzantine rows point uphill, so their scores fall
    grads = jax.tree.map(lambda g: np.concatenate(
        [-4.0 * g[:N_BYZ], g[N_BYZ:]]), grads)
    held = _held_tokens()

    def jloss(p, b):
        return JT.loss_fn(p, jcfgs.SMOKE, b)

    def tloss(p, b):
        return TT.loss_fn(p, tcfgs.SMOKE, b)

    jscores = jzeno_scores(jloss, jparams, jax.tree.map(jnp.asarray, grads),
                           {"tokens": jnp.asarray(held)}, eta=0.1, rho=5e-4)
    tscores = zeno_scores(tloss, tparams,
                          tu.tree_map(torch.from_numpy, grads),
                          {"tokens": torch.from_numpy(held)}, eta=0.1,
                          rho=5e-4)
    np.testing.assert_allclose(tscores.numpy(), np.asarray(jscores),
                               atol=1e-5)
    keep = tagg.zeno_keep(tscores, N_BYZ).numpy()
    np.testing.assert_array_equal(keep, _jax_zeno_keep(
        np.asarray(jscores), N_BYZ))


def _batches(steps=3):
    rng = np.random.default_rng(0)
    vocab = tcfgs.SMOKE.vocab_size
    p = np.arange(1, vocab + 1, dtype=np.float64) ** -1.1
    return [rng.choice(vocab, size=(M, 2, 16), p=p / p.sum()
                       ).astype(np.int32) for _ in range(steps)]


@pytest.mark.parametrize("defense", ["coord_median", "krum", "zeno"])
def test_three_steps_under_variance_match_jax(defense):
    jparams, tparams = _smoke_pair()
    byz = np.arange(M) < N_BYZ
    jdef = jdfn.make_registry(M, N_BYZ)[defense]
    tdef = tdfn.make_registry(M, N_BYZ)[defense]
    jatt = jatk.make_registry()["variance"]
    tatt = tatk.make_registry()["variance"]
    jopt = jmake_optimizer(JTrainConfig(lr=0.05))
    topt = make_optimizer(TrainConfig(lr=0.05))
    jstate = jinit(jparams, jopt, defense=jdef, attack=jatt, seed=0)
    tstate = init_train_state(tparams, topt, defense=tdef, attack=tatt)
    jstep = jmake_step(lambda p, b: JT.loss_fn(p, jcfgs.SMOKE, b), jopt,
                       byz_mask=jnp.asarray(byz), defense=jdef, attack=jatt)
    tstep = make_train_step(lambda p, b: TT.loss_fn(p, tcfgs.SMOKE, b),
                            topt, byz_mask=torch.from_numpy(byz),
                            defense=tdef, attack=tatt)
    for t, tokens in enumerate(_batches()):
        held = _held_tokens(100 + t) if tdef.needs_held_batch else None
        jargs = () if held is None else ({"tokens": jnp.asarray(held)},)
        targs = () if held is None else ({"tokens": torch.from_numpy(held)},)
        jstate, jm = jstep(jstate, {"tokens": jnp.asarray(tokens)}, *jargs)
        tstate, tm = tstep(tstate, {"tokens": torch.from_numpy(tokens)},
                           *targs)
        assert set(tm) == set(jm)
        for k in ("loss", "honest_loss", "grad_norm"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       atol=1e-5, err_msg=f"{k} step {t}")
    for path, a, b in zip(tu.tree_paths(tstate.params),
                          tu.tree_leaves(tstate.params),
                          jax.tree_util.tree_leaves(jstate.params)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5,
                                   err_msg=path)


def test_held_batch_defense_refuses_a_step_without_one():
    _, tparams = _smoke_pair()
    tdef = tdfn.make_registry(M, N_BYZ)["zeno"]
    topt = make_optimizer(TrainConfig(lr=0.05))
    step = make_train_step(lambda p, b: TT.loss_fn(p, tcfgs.SMOKE, b), topt,
                           byz_mask=torch.arange(M) < N_BYZ, defense=tdef)
    state = init_train_state(tparams, topt, defense=tdef)
    with pytest.raises(ValueError, match="held-out batch"):
        step(state, {"tokens": torch.from_numpy(_batches(1)[0])})
