"""Plain PyTorch version of the flash-attention kernel (port of
``repro.kernels.flash_attention.ref``, computed as the Pallas kernel
``flash_attention_kernel`` computes it).

The CPU wrapper runs it; on the card ``chip_smoke.py`` holds the CUDA
kernel against it.  The arithmetic is the Pallas kernel's: q, k and v
upcast to float32, scores times ``1/sqrt(D)``, the finite ``-1e30`` mask
for keys after the query and, with a window, for keys ``window`` or more
positions before it, softmax in float32 with p kept in float32 (the JAX
``ref.attention`` rounds p to v's dtype, the kernel does not), and the
output cast to q's dtype.  TF32 is off, so every product is IEEE float32.

Query rows go in chunks of ``CHUNK``, each against the keys its rows can
reach, so the scores of a long sequence (17 GB in float32 for
B=2, H=32, L=8192) never exist at once.  The keys dropped for a chunk are
masked for every row of it, so their probabilities would be exact zeros.
"""

import math

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

NEG = -1e30
CHUNK = 512


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              window: int = 0) -> torch.Tensor:
    """q: (B, H, L, D); k, v: (B, K, L, D), K dividing H; causal, with
    ``window`` > 0 a sliding window.  Returns (B, H, L, D) in q's dtype
    and q's memory layout."""
    B, H, L, D = q.shape
    K = k.shape[1]
    G = H // K
    scale = 1.0 / math.sqrt(D)
    kf, vf = k.float(), v.float()
    out = torch.empty_like(q)           # q's layout, as the kernel's output
    for lo in range(0, L, CHUNK):
        hi = min(lo + CHUNK, L)
        k_lo = max(0, lo - window + 1) if window > 0 else 0
        qc = q[:, :, lo:hi].float().reshape(B, K, G, hi - lo, D)
        s = torch.einsum("bkgld,bksd->bkgls", qc, kf[:, :, k_lo:hi]) * scale
        qpos = torch.arange(lo, hi, device=q.device)[:, None]
        kpos = torch.arange(k_lo, hi, device=q.device)[None, :]
        mask = kpos <= qpos
        if window > 0:
            mask &= kpos > qpos - window
        s = s.masked_fill(~mask, NEG)
        p = torch.softmax(s, dim=-1)
        o = torch.einsum("bkgls,bksd->bkgld", p, vf[:, :, k_lo:hi])
        out[:, :, lo:hi] = o.reshape(B, H, hi - lo, D).to(q.dtype)
    return out
