"""Synthetic data pipelines (port of ``repro.data.pipeline``).

``lm_batches`` draws token streams from the same Zipf(1.1) unigram law as
the reference, on an explicit ``torch.Generator`` on the given device.
The stream itself differs from the JAX one (threefry vs Philox); parity
tests feed both packages the same numpy tokens instead.
"""

from __future__ import annotations

from typing import Iterator, Optional

import numpy as np
import torch

from repro_torch.core import tree_utils as tu


def worker_split(batch, m: int):
    """Split leaves (B, ...) -> (m, B/m, ...)."""
    def one(x):
        B = x.shape[0]
        if B % m:
            raise ValueError(f"batch {B} not divisible by m={m}")
        return x.reshape((m, B // m) + tuple(x.shape[1:]))
    return tu.tree_map(one, batch)


def flip_labels(labels, n_classes: int):
    """Paper Section 5: label l becomes n_classes - 1 - l."""
    return n_classes - 1 - labels


def _zipf_probs(vocab: int, alpha: float, device) -> torch.Tensor:
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    p = ranks ** (-alpha)
    return torch.as_tensor(p / p.sum(), dtype=torch.float32, device=device)


def lm_batches(vocab: int, batch: int, seq_len: int, *, seed: int = 0,
               m: Optional[int] = None, flip_mask=None, alpha: float = 1.1,
               hetero_alpha: float = 0.0,
               device="cuda") -> Iterator[dict]:
    """Infinite iterator of {"tokens": (B, L)} int64 (or (m, B/m, L) when
    ``m``).  ``flip_mask`` (m,) remaps the marked workers' tokens through
    the label-flip involution (the label of an LM is the next token)."""
    if hetero_alpha > 0.0:
        raise NotImplementedError("hetero_alpha: the Dirichlet worker "
                                  "model is not ported yet")
    probs = _zipf_probs(vocab, alpha, device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    while True:
        toks = torch.multinomial(probs, batch * seq_len, replacement=True,
                                 generator=gen).reshape(batch, seq_len)
        out = {"tokens": toks}
        if m is not None:
            out = worker_split(out, m)
            if flip_mask is not None:
                sel = flip_mask.reshape((m, 1, 1))
                out = {"tokens": torch.where(
                    sel, flip_labels(out["tokens"], vocab), out["tokens"])}
        yield out
