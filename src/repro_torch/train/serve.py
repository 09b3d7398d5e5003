"""Batched autoregressive serving on top of prefill and decode (port of
``repro.train.serve``).

``generate`` runs one prefill over the prompt, then one decode step per
further token in a Python loop (the reference's ``lax.scan``).  The
Byzantine layer does not apply at inference.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as T


def sample(logits: torch.Tensor, *, temperature: float = 0.0,
           generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """(B, V) logits -> (B,) token ids: the argmax (the first one on a
    tie) when ``temperature`` is 0, else a draw from
    ``softmax(logits / temperature)`` with ``generator``."""
    if temperature <= 0.0:
        return logits.argmax(-1)
    probs = torch.softmax(logits.float() / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


def decode(params, cfg: ModelConfig, last_logits: torch.Tensor, cache, *,
           n_tokens: int, generator: Optional[torch.Generator] = None,
           temperature: float = 0.0) -> torch.Tensor:
    """Sample ``n_tokens`` tokens, the first from the prefill's
    ``last_logits``, each further one after a decode step on the one
    before.  Returns (B, n_tokens) int64; ``cache`` is updated in place."""
    toks = []
    logits = last_logits
    for i in range(n_tokens):
        tok = sample(logits, temperature=temperature, generator=generator)
        toks.append(tok)
        if i + 1 < n_tokens:
            logits, cache = T.decode_step(params, cfg, tok[:, None], cache)
    return torch.stack(toks, dim=1)


def generate(params, cfg: ModelConfig, prompt: torch.Tensor, *,
             n_tokens: int, max_seq: int,
             generator: Optional[torch.Generator] = None,
             temperature: float = 0.0) -> torch.Tensor:
    """Greedy (``temperature`` 0) or sampled generation.

    prompt: (B, Lp) token ids.  Sampling draws from ``generator`` (a
    ``torch.Generator`` on the prompt's device; a fresh one seeded 0 when
    None).  Returns (B, n_tokens) int64.  The reference's last decode step,
    whose logits no token uses, is skipped.
    """
    if prompt.ndim != 2:
        raise NotImplementedError("embedding prompts (stub-frontend archs) "
                                  "are not ported yet")
    if temperature > 0.0 and generator is None:
        generator = torch.Generator(device=prompt.device).manual_seed(0)
    last_logits, cache = T.prefill(params, cfg, prompt, max_seq=max_seq)
    return decode(params, cfg, last_logits, cache, n_tokens=n_tokens,
                  generator=generator, temperature=temperature)
