"""Port parity of the serving path: ``repro_torch`` prefill, decode and
``generate`` against ``repro`` on the SMOKE configs of tinyllama (full
attention) and tinyllama-swa (window 32), in float32, with the JAX
parameters carried across by ``repro_torch.convert.params_from_jax``.

Tolerances: logits to atol 1e-4 and K/V caches to atol 1e-5 (float32;
only the order of the sums differs, and from L = 1024 on the port's
flash path against the reference's ``flash_attention_jnp``).  Tokens,
ring slots and cache positions are exact."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as JC
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.train import serve as jserve
from repro_torch import configs as TC
from repro_torch.convert import params_from_jax
from repro_torch.launch import serve as cli
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT
from repro_torch.train import serve as tserve

ARCHS = ["tinyllama-1.1b", "tinyllama-1.1b-swa"]
LOGIT_ATOL, CACHE_ATOL = 1e-4, 1e-5


@pytest.fixture(scope="module")
def models():
    out = {}
    for arch in ARCHS:
        jcfg, tcfg = JC.get_smoke(arch), TC.get_smoke(arch)
        jparams = JT.init_params(jcfg, jax.random.PRNGKey(0))
        tparams = params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
        out[arch] = (jcfg, tcfg, jparams, tparams)
    return out


def _tokens(B, L, vocab, seed):
    return np.random.default_rng(seed).integers(0, vocab, (B, L)).astype(
        np.int32)


def _close(out: torch.Tensor, want, atol: float) -> None:
    np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=atol,
                               rtol=0)


def _same_cache(tcache, jcache) -> None:
    assert tcache["pos"] == int(jcache["pos"])
    for name in ("k", "v"):
        _close(tcache["blocks"][name], jcache["blocks"][name], CACHE_ATOL)


@pytest.mark.parametrize("L,S", [(5, 8), (8, 8), (13, 8), (40, 32), (3, 1)])
def test_ring_from_full_matches_jax(L, S):
    full = np.random.default_rng(L * S).standard_normal(
        (2, L, 3, 4)).astype(np.float32)
    np.testing.assert_array_equal(
        TL.ring_from_full(torch.from_numpy(full), S).numpy(),
        np.asarray(JL.ring_from_full(jnp.asarray(full), S)))


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_init_matches_jax(models, arch):
    jcfg, tcfg, _, _ = models[arch]
    jcache = JT.init_cache(jcfg, 3, 48)
    tcache = TT.init_cache(tcfg, 3, 48, device="cpu")
    assert tcache["pos"] == 0
    for name in ("k", "v"):
        assert tuple(tcache["blocks"][name].shape) == \
            jcache["blocks"][name].shape
        assert not tcache["blocks"][name].any()


@pytest.mark.parametrize("B,L", [(2, 24), (1, 1040)])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_matches_jax(models, arch, B, L):
    """L = 24 takes the dense branch, L = 1040 the flash branch (B4's
    plain version on the CPU; the reference's ``flash_attention_jnp``)."""
    jcfg, tcfg, jparams, tparams = models[arch]
    tokens = _tokens(B, L, jcfg.vocab_size, L)
    max_seq = L + 8
    jlogits, jcache = JT.prefill(jparams, jcfg, jnp.asarray(tokens),
                                 max_seq=max_seq)
    with torch.no_grad():
        tlogits, tcache = TT.prefill(tparams, tcfg,
                                     torch.from_numpy(tokens),
                                     max_seq=max_seq)
    assert tlogits.shape == (B, jcfg.vocab_size)
    _close(tlogits, jlogits, LOGIT_ATOL)
    _same_cache(tcache, jcache)


def test_train_forward_on_the_flash_branch_matches_jax(models):
    jcfg, tcfg, jparams, tparams = models["tinyllama-1.1b"]
    tokens = _tokens(1, 1030, jcfg.vocab_size, 9)
    jlogits, _, _ = JT.forward(jparams, jcfg, jnp.asarray(tokens))
    with torch.no_grad():
        tlogits = TT.forward(tparams, tcfg, torch.from_numpy(tokens))
    _close(tlogits, jlogits, LOGIT_ATOL)


def test_flash_branch_refuses_gradients(models):
    """B4 has no backward pass yet: a loss at L >= 1024 that needs
    gradients raises, and does not run the plain version instead."""
    _, tcfg, _, tparams = models["tinyllama-1.1b"]
    live = {k: v for k, v in tparams.items()}
    live["blocks"] = dict(tparams["blocks"])
    live["blocks"]["attn"] = {k: w.clone().requires_grad_(True)
                              for k, w in tparams["blocks"]["attn"].items()}
    tokens = torch.from_numpy(_tokens(1, TL.FLASH_THRESHOLD, 256, 1))
    with pytest.raises(NotImplementedError, match="backward"):
        TT.loss_fn(live, tcfg, {"tokens": tokens})


@pytest.mark.parametrize("arch,prompt_len", [("tinyllama-1.1b", 12),
                                             ("tinyllama-1.1b-swa", 40)])
def test_decode_steps_match_jax(models, arch, prompt_len):
    """8 decode steps on the same tokens.  For swa (window 32, ring 32) a
    prompt of 40 has already wrapped the ring, and every step wraps it
    further."""
    jcfg, tcfg, jparams, tparams = models[arch]
    B, steps = 2, 8
    max_seq = prompt_len + steps
    prompt = _tokens(B, prompt_len, jcfg.vocab_size, prompt_len)
    feed = _tokens(B, steps, jcfg.vocab_size, 99)
    _, jcache = JT.prefill(jparams, jcfg, jnp.asarray(prompt),
                           max_seq=max_seq)
    _, tcache = TT.prefill(tparams, tcfg, torch.from_numpy(prompt),
                           max_seq=max_seq)
    for i in range(steps):
        jlogits, jcache = JT.decode_step(jparams, jcfg,
                                         jnp.asarray(feed[:, i:i + 1]), jcache)
        tlogits, tcache = TT.decode_step(tparams, tcfg,
                                         torch.from_numpy(feed[:, i:i + 1]),
                                         tcache)
        _close(tlogits, jlogits, LOGIT_ATOL)
    assert tcache["pos"] == prompt_len + steps
    _same_cache(tcache, jcache)


@pytest.mark.parametrize("arch,prompt_len", [("tinyllama-1.1b", 12),
                                             ("tinyllama-1.1b-swa", 40)])
def test_greedy_generate_matches_jax(models, arch, prompt_len):
    jcfg, tcfg, jparams, tparams = models[arch]
    prompt = _tokens(3, prompt_len, jcfg.vocab_size, 7)
    n = 8
    jtoks = jserve.generate(jparams, jcfg, jnp.asarray(prompt), n_tokens=n,
                            max_seq=prompt_len + n)
    ttoks = tserve.generate(tparams, tcfg, torch.from_numpy(prompt),
                            n_tokens=n, max_seq=prompt_len + n)
    assert ttoks.shape == (3, n)
    np.testing.assert_array_equal(ttoks.numpy(), np.asarray(jtoks))


def test_generate_equals_manual_prefill_and_decode(models):
    _, tcfg, _, tparams = models["tinyllama-1.1b-swa"]
    prompt = torch.from_numpy(_tokens(2, 40, tcfg.vocab_size, 3))
    toks = tserve.generate(tparams, tcfg, prompt, n_tokens=5, max_seq=45)
    logits, cache = TT.prefill(tparams, tcfg, prompt, max_seq=45)
    cur = logits.argmax(-1)
    out = [cur]
    for _ in range(4):
        logits, cache = TT.decode_step(tparams, tcfg, cur[:, None], cache)
        cur = logits.argmax(-1)
        out.append(cur)
    torch.testing.assert_close(toks, torch.stack(out, 1), atol=0, rtol=0)


def test_sampling_repeats_with_one_generator_and_differs_with_two(models):
    _, tcfg, _, tparams = models["tinyllama-1.1b"]
    prompt = torch.from_numpy(_tokens(2, 8, tcfg.vocab_size, 4))

    def run(seed):
        gen = torch.Generator().manual_seed(seed)
        return tserve.generate(tparams, tcfg, prompt, n_tokens=8,
                               max_seq=16, generator=gen, temperature=2.0)

    assert torch.equal(run(1), run(1))
    assert not torch.equal(run(1), run(2))


def test_generate_rejects_embedding_prompts(models):
    _, tcfg, _, tparams = models["tinyllama-1.1b"]
    with pytest.raises(NotImplementedError, match="not ported"):
        tserve.generate(tparams, tcfg, torch.zeros((1, 4, tcfg.d_model)),
                        n_tokens=2, max_seq=6)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_runs_smoke_on_cpu(arch, capsys):
    toks = cli.main(["--device", "cpu", "--arch", arch, "--batch", "2",
                     "--prompt-len", "40", "--gen", "5"])
    assert toks.shape == (2, 5) and int(toks.max()) < 256
    out = capsys.readouterr().out
    assert "prefill:" in out and "decode: 4 steps" in out


def test_serve_cli_refuses_cuda_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="--device cpu"):
        cli.main([])
