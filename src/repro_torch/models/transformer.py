"""Model assembly for dense decoder stacks (port of
``repro.models.transformer``): ``init_params``, ``init_cache``,
``forward`` (train, prefill and decode), ``cross_entropy``, ``loss_fn``,
``prefill`` and ``decode_step``.

The per-layer parameters are kept stacked, each ``blocks`` leaf shaped
``(n_layers, ...)`` as the reference's ``init_params`` builds them, so a
parameter tree carried over from JAX (``repro_torch.convert``) and the
flat safeguard layout built on it match the reference leaf for leaf.
The reference scans over the stack; here a Python loop indexes it.  The
decode cache is stacked the same way (``blocks.k``/``blocks.v`` shaped
``(n_layers, B, S, K, Dh)``), and its position ``cache["pos"]`` is a
Python int on the host, so the ring slot of a decode step costs no device
sync.
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


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, device="cuda"):
    """Zeroed decode cache: ``{"pos": 0, "blocks": {"k", "v"}}`` with
    ring buffers stacked over the layers, in ``cfg.dtype``."""
    _check_ported(cfg)
    return {"pos": 0,
            "blocks": L.attn_cache_init(cfg, batch, max_seq, cfg.dtype,
                                        device, lead=(cfg.n_layers,))}


def _apply_layer(p, cfg: ModelConfig, x, positions, cache, cache_pos: int,
                 cache_valid, max_seq: int):
    """Pre-norm residual attention + MLP layer.  Returns (x, new_cache)."""
    h = L.rms_norm(x, p["ln1"]["scale"])
    out, new_cache = L.attn_block_apply(p["attn"], cfg, h,
                                        positions=positions, cache=cache,
                                        cache_pos=cache_pos,
                                        cache_valid=cache_valid,
                                        max_seq=max_seq)
    x = x + out
    h = L.rms_norm(x, p["ln2"]["scale"])
    return x + L.mlp_apply(p["mlp"], cfg.mlp, h), new_cache


def forward(params, cfg: ModelConfig, tokens: torch.Tensor, *, cache=None,
            mode: str = "train", max_seq: int = 0):
    """Run the model on tokens (B, L).

    mode:
      * "train"   -- full sequence, no cache; returns logits (B, L, V)
        float32;
      * "prefill" -- full sequence; returns ``(logits, cache)`` with a
        fresh decode cache of capacity ``max_seq``;
      * "decode"  -- L == 1 with ``cache`` required; returns
        ``(logits, cache)``, the cache's buffers updated in place.

    Positions start at the cache's position (0 without a cache).
    """
    _check_ported(cfg)
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"unknown mode {mode!r}")
    if (mode == "decode") != (cache is not None):
        raise ValueError("decode needs a cache, and only decode reads one")
    if mode == "prefill" and max_seq <= 0:
        raise ValueError("prefill needs max_seq")
    if mode != "prefill":
        max_seq = 0
    B, Lq = tokens.shape
    x = torch.nn.functional.embedding(tokens, params["embed"]).to(cfg.dtype)
    cache_pos = cache["pos"] if mode == "decode" else 0
    positions = (torch.arange(Lq, device=tokens.device)[None, :]
                 + cache_pos).expand(B, Lq)
    cache_valid = None
    if mode == "decode":
        # every layer shares the ring's size and window: one mask a step
        cache_valid = L.ring_valid(
            cache_pos, cache["blocks"]["k"].shape[2],
            cfg.window if cfg.attn == "sliding" else 0, tokens.device)
    new_blocks = {"k": [], "v": []}
    for i in range(cfg.n_layers):
        p = tu.tree_map(lambda leaf: leaf[i], params["blocks"])
        c = None
        if mode == "decode":
            c = {name: buf[i] for name, buf in cache["blocks"].items()}
        x, nc = _apply_layer(p, cfg, x, positions, c, cache_pos,
                             cache_valid, max_seq)
        if mode == "prefill":
            for name in new_blocks:
                new_blocks[name].append(nc[name])
    x = L.rms_norm(x, params["final_norm"]["scale"])
    head = params["lm_head"].to(x.dtype)
    logits = torch.einsum("bld,dv->blv", x.to(f32), head.to(f32))
    if mode == "train":
        return logits
    if mode == "prefill":
        cache = {"blocks": {name: torch.stack(bufs)
                            for name, bufs in new_blocks.items()}}
    return logits, {"pos": cache_pos + Lq, "blocks": cache["blocks"]}


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


def prefill(params, cfg: ModelConfig, tokens: torch.Tensor, *,
            max_seq: int):
    """Process a full prompt (B, L): returns (last-token logits (B, V),
    decode cache)."""
    logits, cache = forward(params, cfg, tokens, mode="prefill",
                            max_seq=max_seq)
    return logits[:, -1], cache


def decode_step(params, cfg: ModelConfig, token: torch.Tensor, cache):
    """One decode step on token (B, 1): returns (logits (B, V), cache).
    The cache's buffers are updated in place; its ``pos`` advances by 1
    in the returned dict."""
    logits, cache = forward(params, cfg, token, cache=cache, mode="decode")
    return logits[:, -1], cache
