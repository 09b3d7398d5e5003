"""Model assembly for dense decoder stacks (port of
``repro.models.transformer``): ``init_params``, ``forward`` in train mode,
``cross_entropy`` and ``loss_fn``.

The per-layer parameters are kept stacked, each ``blocks`` leaf shaped
``(n_layers, ...)`` as the reference's ``init_params`` builds them, so a
parameter tree carried over from JAX (``repro_torch.convert``) and the
flat safeguard layout built on it match the reference leaf for leaf.
The reference scans over the stack; here a Python loop indexes it.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import tree_utils as tu
from repro_torch.models import layers as L

f32 = torch.float32


def _check_ported(cfg: ModelConfig) -> None:
    if cfg.arch_type != "dense" or cfg.norm != "rmsnorm" or \
            cfg.tie_embeddings:
        raise NotImplementedError(f"{cfg.name}: only untied dense rmsnorm "
                                  "stacks are ported yet")


def init_params(cfg: ModelConfig, seed: int = 0,
                device="cuda") -> Dict[str, Any]:
    """Random parameters from ``seed`` (on the device, through a
    ``torch.Generator``; the values differ from the reference's init)."""
    _check_ported(cfg)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    n, d, pd = cfg.n_layers, cfg.d_model, cfg.param_dtype
    return {
        "embed": L._normal(gen, (cfg.vocab_size, d), pd, device, 0.02),
        "lm_head": L._normal(gen, (d, cfg.vocab_size), pd, device, 0.02),
        "final_norm": {"scale": torch.zeros((d,), dtype=pd, device=device)},
        "blocks": {
            "ln1": {"scale": torch.zeros((n, d), dtype=pd, device=device)},
            "attn": L.attn_block_init(gen, cfg, device, lead=(n,)),
            "ln2": {"scale": torch.zeros((n, d), dtype=pd, device=device)},
            "mlp": L.mlp_init(gen, cfg.mlp, d, cfg.d_ff, pd, device,
                              lead=(n,)),
        },
    }


def _apply_layer(p, cfg: ModelConfig, x, positions):
    """Pre-norm residual attention + MLP layer."""
    h = L.rms_norm(x, p["ln1"]["scale"])
    x = x + L.attn_block_apply(p["attn"], cfg, h, positions=positions)
    h = L.rms_norm(x, p["ln2"]["scale"])
    return x + L.mlp_apply(p["mlp"], cfg.mlp, h)


def forward(params, cfg: ModelConfig, tokens: torch.Tensor):
    """Train-mode forward: tokens (B, L) -> logits (B, L, V) float32."""
    _check_ported(cfg)
    B, Lq = tokens.shape
    x = torch.nn.functional.embedding(tokens, params["embed"]).to(cfg.dtype)
    positions = torch.arange(Lq, device=tokens.device)[None, :].expand(B, Lq)
    for i in range(cfg.n_layers):
        p = tu.tree_map(lambda leaf: leaf[i], params["blocks"])
        x = _apply_layer(p, cfg, x, positions)
    x = L.rms_norm(x, params["final_norm"]["scale"])
    head = params["lm_head"].to(x.dtype)
    return torch.einsum("bld,dv->blv", x.to(f32), head.to(f32))


def cross_entropy(logits, targets):
    """Mean next-token cross entropy in float32.  logits (B, L, V),
    targets (B, L)."""
    logits = logits.to(f32)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets[..., None].long())[..., 0]
    return (lse - gold).mean()


def loss_fn(params, cfg: ModelConfig, batch):
    """Next-token LM loss.  batch: {"tokens": (B, L)}."""
    tokens = batch["tokens"]
    logits = forward(params, cfg, tokens)
    return cross_entropy(logits[:, :-1], tokens[:, 1:])
