"""Port parity of the whole slice: 8 steps of ``make_train_step`` (SMOKE
TinyLlama in float32, m=10 with 4 Byzantine workers, ``sign_flip``
against ``safeguard_double`` with T0=2 and T1=4, so both windows reset)
in both packages, from the same parameters on the same numpy token
batches.  Each step's ``good``, ``caught_byz`` and ``evicted_honest``
match exactly; losses and parameters agree to atol 1e-5; the metric key
sets are equal."""

import gc
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import TrainConfig as JTrainConfig
from repro.configs import tinyllama_1_1b as jcfgs
from repro.core import attacks as jatk
from repro.core import defenses as jdfn
from repro.models import transformer as JT
from repro.optim import clip_by_global_norm as jclip
from repro.optim import make_optimizer as jmake_optimizer
from repro.optim import make_schedule as jmake_schedule
from repro.train import init_train_state as jinit
from repro.train import make_train_step as jmake_step
from repro_torch.configs import TrainConfig
from repro_torch.configs import tinyllama_1_1b as tcfgs
from repro_torch.convert import params_from_jax
from repro_torch.core import attacks as tatk
from repro_torch.core import defenses as tdfn
from repro_torch.core import tree_utils as tu
from repro_torch.models import transformer as TT
from repro_torch.optim import clip_by_global_norm, make_optimizer
from repro_torch.optim import make_schedule
from repro_torch.train import init_train_state, make_train_step
from repro_torch.train.trainer import per_worker_grads

M, N_BYZ, STEPS = 10, 4, 8
REG_KW = dict(T0=2, T1=4, threshold_floor=0.01)


def _batches():
    """Zipf(1.1) unigram tokens, the law of the LM pipeline: the honest
    gradients then share a direction, and the sign flip is caught over
    the steps (uniform tokens give gradients too noisy to filter)."""
    rng = np.random.default_rng(0)
    vocab = tcfgs.SMOKE.vocab_size
    p = np.arange(1, vocab + 1, dtype=np.float64) ** -1.1
    return [rng.choice(vocab, size=(M, 2, 16), p=p / p.sum()
                       ).astype(np.int32) for _ in range(STEPS)]


@pytest.mark.parametrize("optimizer,momentum", [("sgd", 0.0), ("sgd", 0.9),
                                                ("adam", 0.0)])
def test_train_steps_match_jax(optimizer, momentum):
    # Adam divides by sqrt(v): on a coordinate whose gradient is a few
    # ulps from 0 its step is ~lr whatever the last bits say, so it runs
    # at a smaller lr to keep that amplified rounding under atol
    lr = 0.05 if optimizer == "sgd" else 1e-4
    jparams = JT.init_params(jcfgs.SMOKE, jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    byz = np.arange(M) < N_BYZ

    jdef = jdfn.make_registry(M, N_BYZ, **REG_KW)["safeguard_double"]
    jatt = jatk.make_registry()["sign_flip"]
    jopt = jmake_optimizer(JTrainConfig(lr=lr, momentum=momentum,
                                        optimizer=optimizer))
    jstate = jinit(jparams, jopt, defense=jdef, attack=jatt, seed=0)
    jstep = jmake_step(lambda p, b: JT.loss_fn(p, jcfgs.SMOKE, b), jopt,
                       byz_mask=jnp.asarray(byz), defense=jdef, attack=jatt)

    tdef = tdfn.make_registry(M, N_BYZ, **REG_KW)["safeguard_double"]
    tatt = tatk.make_registry()["sign_flip"]
    topt = make_optimizer(TrainConfig(lr=lr, momentum=momentum,
                                      optimizer=optimizer))
    tstate = init_train_state(tparams, topt, defense=tdef, attack=tatt)
    tstep = make_train_step(lambda p, b: TT.loss_fn(p, tcfgs.SMOKE, b),
                            topt, byz_mask=torch.from_numpy(byz),
                            defense=tdef, attack=tatt)

    for t, tokens in enumerate(_batches()):
        jstate, jm = jstep(jstate, {"tokens": jnp.asarray(tokens)})
        tstate, tm = tstep(tstate, {"tokens": torch.from_numpy(tokens)})
        assert set(tm) == set(jm)
        for k in ("good", "caught_byz", "evicted_honest", "n_good",
                  "restored"):
            np.testing.assert_array_equal(tm[k].numpy(), np.asarray(jm[k]),
                                          err_msg=f"{k} at step {t}")
        for k in ("loss", "honest_loss"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       atol=1e-5, err_msg=k)
    assert int(tm["caught_byz"]) > 0, "the filter must act in this run"
    np.testing.assert_array_equal(
        tdfn.final_good(tstate.defense_state).numpy(),
        np.asarray(jdfn.final_good(jstate.defense_state)))
    for path, a, b in zip(tu.tree_paths(tstate.params),
                          tu.tree_leaves(tstate.params),
                          jax.tree_util.tree_leaves(jstate.params)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5,
                                   err_msg=path)


def test_step_gradients_freed_without_cycle_collector():
    """A step's stacked gradients die with their last reference: at full
    width each tree is 4.4 GB, and a reference cycle holding one per step
    fills the card before the cycle collector runs."""
    tparams = TT.init_params(tcfgs.SMOKE, seed=0, device="cpu")
    tokens = torch.from_numpy(_batches()[0])
    gc.collect()
    gc.disable()
    try:
        losses, grads = per_worker_grads(
            lambda p, b: TT.loss_fn(p, tcfgs.SMOKE, b), tparams,
            {"tokens": tokens}, M)
        leaf = weakref.ref(tu.tree_leaves(grads)[0])
        assert tuple(leaf().shape[:1]) == (M,)
        del grads
        assert leaf() is None, "stacked gradients outlive the step"
    finally:
        gc.enable()


@pytest.mark.parametrize("schedule,warmup", [("constant", 0), ("cosine", 0),
                                             ("cosine", 5)])
def test_schedules_match_jax(schedule, warmup):
    kw = dict(lr=0.1, schedule=schedule, warmup_steps=warmup,
              total_steps=20)
    jlr, tlr = jmake_schedule(JTrainConfig(**kw)), make_schedule(
        TrainConfig(**kw))
    for step in (0, 1, 4, 5, 12, 20, 30):
        np.testing.assert_allclose(
            float(tlr(torch.tensor(step, dtype=torch.int32))),
            float(jlr(jnp.int32(step))), rtol=1e-6)


def test_global_norm_clipping_matches_jax():
    rng = np.random.default_rng(0)
    tree = {"a": rng.standard_normal((3, 4)).astype(np.float32),
            "b": {"c": rng.standard_normal((5,)).astype(np.float32)}}
    jout, jnorm = jclip(jax.tree.map(jnp.asarray, tree), 1.0)
    tout, tnorm = clip_by_global_norm(tu.tree_map(torch.from_numpy, tree),
                                      1.0)
    np.testing.assert_allclose(float(tnorm), float(jnorm), rtol=1e-6)
    for a, b in zip(tu.tree_leaves(tout), jax.tree_util.tree_leaves(jout)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)
