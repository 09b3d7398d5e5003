"""Layers of the dense attention path (port of ``repro.models.layers``):
RMSNorm, RoPE, GQA attention and the SwiGLU MLP, as plain functions over
dicts of tensors.

Numerics follow the reference: matmuls accumulate in float32 and cast
back to the first operand's dtype; softmax and norms run in float32.
Attention is the dense masked form that the reference runs below
``FLASH_THRESHOLD``; the blocked flash path (and the Pallas
``flash_attention`` kernel it mirrors) is a later port.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch

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


def attn_block_apply(params: Dict, cfg, x, *, positions):
    """One attention layer on the train path (no cache): projections,
    rope, dense causal attention, output projection."""
    B, L, _ = x.shape
    if L >= FLASH_THRESHOLD:
        raise NotImplementedError(
            f"sequence length {L} >= {FLASH_THRESHOLD} takes the blocked "
            "flash-attention path, which is not ported yet")
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
    window = cfg.window if cfg.attn == "sliding" else 0
    mask = causal_mask(L, L, window=window, device=x.device)[None, None, None]
    out = attention(q, k, v, scale=1.0 / math.sqrt(Dh), mask=mask)
    return _einsum("blf,fd->bld", out, params["wo"])


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
