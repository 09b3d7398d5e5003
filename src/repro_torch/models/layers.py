"""Layers of the dense attention path (port of ``repro.models.layers``):
RMSNorm, RoPE, GQA attention with its decode cache, and the SwiGLU MLP,
as plain functions over dicts of tensors.

Numerics follow the reference: matmuls accumulate in float32 and cast
back to the first operand's dtype; softmax and norms run in float32.
Below ``FLASH_THRESHOLD`` attention is the dense masked form; from it on,
train-mode and prefill attention go through kernel B4
(``kernels.flash_attention``), the port's counterpart of the reference's
blocked ``flash_attention_jnp``.  B4 has no backward pass yet, so a
forward that needs gradients there raises.  Decode attends over the
ring-buffer cache with the dense form, as the reference does.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch

from repro_torch.kernels.flash_attention import ops as fa_ops

f32 = torch.float32

# sequence length from which the reference switches to blocked attention
FLASH_THRESHOLD = 1024


def _einsum(subscripts: str, *args, dtype: Optional[torch.dtype] = None):
    """einsum with float32 accumulation, cast back to the first arg's
    dtype (or ``dtype``).  The operands are widened to float32, which
    keeps bf16 products exact and the sum in float32."""
    out_dtype = dtype or args[0].dtype
    return torch.einsum(subscripts, *(a.to(f32) for a in args)).to(out_dtype)


def rms_norm(x, scale, eps: float = 1e-6):
    xf = x.to(f32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * (1.0 + scale.to(f32))).to(x.dtype)


def rope_cos_sin(positions, dim: int, theta: float):
    """positions (...,) -> cos, sin of shape (..., dim // 2), float32."""
    half = dim // 2
    freqs = theta ** (-torch.arange(0, half, dtype=f32,
                                    device=positions.device) / half)
    ang = positions.to(f32)[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, cos, sin, fraction: float = 1.0):
    """x: (B, L, H, D); cos/sin: (B, L, half_rot).  Rotates the first
    ``fraction * D`` channels, split in halves (llama/neox convention)."""
    d = x.shape[-1]
    rot = int(d * fraction)
    rot -= rot % 2
    x_rot, x_pass = x[..., :rot], x[..., rot:]
    half = rot // 2
    x1, x2 = x_rot[..., :half], x_rot[..., half:]
    while cos.ndim < x1.ndim:                  # broadcast over head axis
        cos, sin = cos[..., None, :], sin[..., None, :]
    x1f, x2f = x1.to(f32), x2.to(f32)
    r1 = x1f * cos - x2f * sin
    r2 = x2f * cos + x1f * sin
    out = torch.cat([r1.to(x.dtype), r2.to(x.dtype)], dim=-1)
    return torch.cat([out, x_pass], dim=-1)


def attention(q, k, v, *, scale: float, mask):
    """Masked softmax attention with GQA head grouping.

    q: (B, Lq, H, D);  k, v: (B, Lk, K, D);  mask broadcastable to
    (B, 1, 1, Lq, Lk) (True = attend).  Returns (B, Lq, H * Dv)."""
    B, Lq, H, D = q.shape
    K = k.shape[2]
    qg = q.reshape(B, Lq, K, H // K, D)
    scores = torch.einsum("blkgd,bskd->bkgls", qg.to(f32), k.to(f32)) * scale
    scores = torch.where(mask, scores, torch.full_like(scores, -1e30))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgls,bskd->blkgd", probs.to(v.dtype).to(f32),
                       v.to(f32)).to(v.dtype)
    return out.reshape(B, Lq, H * v.shape[-1])


def causal_mask(Lq: int, Lk: int, *, q_offset: int = 0, window: int = 0,
                device=None):
    """(Lq, Lk) bool mask; ``window`` > 0 keeps the last ``window``."""
    qpos = torch.arange(Lq, device=device)[:, None] + q_offset
    kpos = torch.arange(Lk, device=device)[None, :]
    m = kpos <= qpos
    if window > 0:
        m &= kpos > qpos - window
    return m


def ring_from_full(full, S: int):
    """Pack the last ``min(L, S)`` timesteps of a full-sequence tensor
    (B, L, ...) into a ring buffer of size S: absolute position p lives
    at slot ``p % S``."""
    B, Lf = full.shape[0], full.shape[1]
    keep = min(Lf, S)
    p0 = Lf - keep
    ring = torch.zeros((B, S) + tuple(full.shape[2:]), dtype=full.dtype,
                       device=full.device)
    slots = (p0 + torch.arange(keep, device=full.device)) % S
    ring[:, slots] = full[:, p0:]
    return ring


def attn_cache_init(cfg, batch: int, max_seq: int, dtype, device,
                    lead=()):
    """Zeroed K/V ring buffers (B, S, K, Dh): S is ``max_seq``, or at most
    the window for sliding layers.  ``lead`` prepends stacking axes."""
    S = max_seq if cfg.attn != "sliding" else min(max_seq, cfg.window)
    shape = tuple(lead) + (batch, S, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _flash(q, k, v, window: int):
    """Causal attention through kernel B4 on (B, L, H, D) projections,
    passed as (B, H, L, D) transpose views.  Returns (B, L, H * D)."""
    if q.requires_grad or k.requires_grad or v.requires_grad:
        raise NotImplementedError(
            f"sequence length {q.shape[1]} >= {FLASH_THRESHOLD} takes flash "
            "attention (kernel B4), whose backward pass is not ported yet")
    B, L, H, D = q.shape
    out = fa_ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                                 v.transpose(1, 2), window=window)
    return out.transpose(1, 2).reshape(B, L, H * D)


def ring_valid(cache_pos: int, S: int, window: int, device):
    """Which of a ring of S slots a decode token at absolute position
    ``cache_pos`` attends to, after its own K/V went into slot
    ``cache_pos % S``.  Slot j holds position
    ``abs_j = pos - ((pos - j) mod S)``, in ``(pos - S, pos]``."""
    j = torch.arange(S, device=device)
    abs_j = cache_pos - torch.remainder(cache_pos - j, S)
    valid = abs_j >= 0
    if window > 0:
        valid &= abs_j > cache_pos - window
    return valid


def attn_block_apply(params: Dict, cfg, x, *, positions, cache=None,
                     cache_pos: int = 0, cache_valid=None, max_seq: int = 0):
    """One attention layer: projections, rope, attention, output
    projection.  Returns ``(out, new_cache)``.

    Train/prefill (``cache is None``): causal (+window) attention over x
    (B, L, d); with ``max_seq > 0`` (prefill) ``new_cache`` holds ring
    buffers of that size (of the window, for sliding layers), else it is
    None.  Decode: ``cache`` = {"k", "v"} ring buffers, ``cache_pos`` the
    absolute position (a Python int) of the one incoming token, and
    ``cache_valid`` the ring's mask from ``ring_valid`` (made here when
    None; the model makes it once per step for all layers).  The token's
    K/V are written into the buffers IN PLACE, and ``new_cache`` is
    ``cache`` itself.
    """
    B, L, _ = x.shape
    H, K, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = _einsum("bld,dhq->blhq", x, params["wq"].reshape(cfg.d_model, H, Dh))
    k = _einsum("bld,dkq->blkq", x, params["wk"].reshape(cfg.d_model, K, Dh))
    v = _einsum("bld,dkq->blkq", x, params["wv"].reshape(cfg.d_model, K, Dh))
    if cfg.pos == "rope":
        rot = int(cfg.head_dim * cfg.rope_fraction)
        rot -= rot % 2
        cos, sin = rope_cos_sin(positions, rot, cfg.rope_theta)
        q = apply_rope(q, cos, sin, cfg.rope_fraction)
        k = apply_rope(k, cos, sin, cfg.rope_fraction)
    elif cfg.pos != "none":
        raise NotImplementedError(f"positions {cfg.pos!r} not ported yet")
    scale = 1.0 / math.sqrt(Dh)
    window = cfg.window if cfg.attn == "sliding" else 0

    if cache is None:
        if L >= FLASH_THRESHOLD:
            out = _flash(q, k, v, window)
        else:
            mask = causal_mask(L, L, window=window, device=x.device)
            out = attention(q, k, v, scale=scale, mask=mask[None, None, None])
        new_cache = None
        if max_seq > 0:
            S = min(max_seq, window) if window > 0 else max_seq
            new_cache = {"k": ring_from_full(k, S), "v": ring_from_full(v, S)}
    else:
        if L != 1:
            raise ValueError(f"decode takes one token at a time, got {L}")
        S = cache["k"].shape[1]             # ring size (or max seq)
        slot = cache_pos % S
        cache["k"][:, slot] = k[:, 0]
        cache["v"][:, slot] = v[:, 0]
        if cache_valid is None:
            cache_valid = ring_valid(cache_pos, S, window, x.device)
        out = attention(q, cache["k"], cache["v"], scale=scale,
                        mask=cache_valid[None, None, None, None, :])
        new_cache = cache
    return _einsum("blf,fd->bld", out, params["wo"]), new_cache


def _normal(gen: torch.Generator, shape, dtype, device, init_scale: float):
    return (init_scale * torch.randn(shape, generator=gen, dtype=f32,
                                     device=device)).to(dtype)


def attn_block_init(gen: torch.Generator, cfg, device, init_scale=0.02,
                    lead=()):
    """Attention weights; ``lead`` prepends stacking axes (layers)."""
    H, K, Dh, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_model
    pd, lead = cfg.param_dtype, tuple(lead)
    return {
        "wq": _normal(gen, lead + (d, H * Dh), pd, device, init_scale),
        "wk": _normal(gen, lead + (d, K * Dh), pd, device, init_scale),
        "wv": _normal(gen, lead + (d, K * Dh), pd, device, init_scale),
        "wo": _normal(gen, lead + (H * Dh, d), pd, device, init_scale),
    }


def mlp_apply(params: Dict, kind: str, x):
    if kind != "swiglu":
        raise NotImplementedError(f"mlp {kind!r} not ported yet")
    gate = torch.nn.functional.silu(
        _einsum("bld,df->blf", x, params["w_gate"], dtype=f32))
    up = _einsum("bld,df->blf", x, params["w_up"], dtype=f32)
    h = (gate * up).to(x.dtype)
    return _einsum("blf,fd->bld", h, params["w_down"])


def mlp_init(gen: torch.Generator, kind: str, d: int, d_ff: int,
             param_dtype, device, init_scale=0.02, lead=()):
    if kind != "swiglu":
        raise NotImplementedError(f"mlp {kind!r} not ported yet")
    lead = tuple(lead)
    return {"w_gate": _normal(gen, lead + (d, d_ff), param_dtype, device,
                              init_scale),
            "w_up": _normal(gen, lead + (d, d_ff), param_dtype, device,
                            init_scale),
            "w_down": _normal(gen, lead + (d_ff, d), param_dtype, device,
                              init_scale)}
