"""Port parity: the dense TinyLlama path of ``repro_torch.models`` against
``repro.models`` on the SMOKE config in float32, with the JAX parameters
carried across by ``repro_torch.convert.params_from_jax``.  Logits and
loss agree to rtol 1e-5 (logits also to atol 1e-6, for those near zero
where a relative bound means nothing), per-leaf gradients to atol 1e-5, and the flat
safeguard layout lays out columns in JAX's ``tree_flatten`` order."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import tinyllama_1_1b as jcfgs
from repro.core import safeguard as jsg
from repro.models import transformer as JT
from repro_torch.configs import tinyllama_1_1b as tcfgs
from repro_torch.convert import params_from_jax
from repro_torch.core import safeguard as tsg
from repro_torch.core import tree_utils as tu
from repro_torch.models import transformer as TT

FLAT_ORDER = [
    "blocks.attn.wk", "blocks.attn.wo", "blocks.attn.wq", "blocks.attn.wv",
    "blocks.ln1.scale", "blocks.ln2.scale",
    "blocks.mlp.w_down", "blocks.mlp.w_gate", "blocks.mlp.w_up",
    "embed", "final_norm.scale", "lm_head",
]


@pytest.fixture(scope="module")
def pair():
    jparams = JT.init_params(jcfgs.SMOKE, jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    tokens = np.random.default_rng(0).integers(
        0, jcfgs.SMOKE.vocab_size, (4, 16)).astype(np.int32)
    return jparams, tparams, tokens


def test_forward_and_loss_match_jax(pair):
    jparams, tparams, tokens = pair
    jlogits, _, _ = JT.forward(jparams, jcfgs.SMOKE, jnp.asarray(tokens))
    tlogits = TT.forward(tparams, tcfgs.SMOKE, torch.from_numpy(tokens).long())
    assert tlogits.dtype == torch.float32
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits),
                               rtol=1e-5, atol=1e-6)
    jloss = JT.loss_fn(jparams, jcfgs.SMOKE, {"tokens": jnp.asarray(tokens)})
    tloss = TT.loss_fn(tparams, tcfgs.SMOKE,
                       {"tokens": torch.from_numpy(tokens).long()})
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)


def test_gradients_match_jax(pair):
    jparams, tparams, tokens = pair
    jgrads = jax.grad(JT.loss_fn)(jparams, jcfgs.SMOKE,
                                  {"tokens": jnp.asarray(tokens)})
    leaves = [p.clone().requires_grad_(True) for p in tu.tree_leaves(tparams)]
    p = tu.tree_unflatten(tparams, leaves)
    loss = TT.loss_fn(p, tcfgs.SMOKE, {"tokens": torch.from_numpy(tokens)})
    tgrads = torch.autograd.grad(loss, leaves)
    jleaves = jax.tree_util.tree_leaves(jgrads)
    assert len(jleaves) == len(tgrads)
    for path, a, b in zip(tu.tree_paths(tparams), tgrads, jleaves):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5,
                                   err_msg=path)


def test_flat_layout_column_order_is_jax_order(pair):
    jparams, tparams, _ = pair
    lay = tsg.make_layout(tparams)
    jlay = jsg.make_layout(jparams)
    jpaths = [".".join(str(k.key) for k in path) for path, _ in
              jax.tree_util.tree_flatten_with_path(jparams)[0]]
    assert list(lay.paths) == jpaths == FLAT_ORDER
    assert (lay.shapes, lay.offsets, lay.d, lay.d_padded) == (
        jlay.shapes, jlay.offsets, jlay.d, jlay.d_padded)


def test_bf16_params_carry_across_bit_exact():
    cfg = dataclasses.replace(jcfgs.SMOKE, dtype=jnp.bfloat16,
                              param_dtype=jnp.bfloat16)
    jparams = jax.tree.map(np.asarray,
                           JT.init_params(cfg, jax.random.PRNGKey(1)))
    tparams = params_from_jax(jparams, "cpu")
    for a, b in zip(tu.tree_leaves(tparams),
                    jax.tree_util.tree_leaves(jparams)):
        assert a.dtype == torch.bfloat16
        np.testing.assert_array_equal(a.view(torch.int16).numpy(),
                                      b.view(np.int16))


def test_init_params_matches_reference_tree():
    """The port's own init builds the reference's stacked tree."""
    jshapes = jax.eval_shape(lambda: JT.init_params(
        jcfgs.SMOKE, jax.random.PRNGKey(0)))
    tparams = TT.init_params(tcfgs.SMOKE, seed=0, device="cpu")
    assert tu.tree_paths(tparams) == FLAT_ORDER
    for a, b in zip(tu.tree_leaves(tparams),
                    jax.tree_util.tree_leaves(jshapes)):
        assert tuple(a.shape) == b.shape
