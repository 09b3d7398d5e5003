"""Model and training configuration dataclasses (port of
``repro.configs.base``), with torch dtypes.  Only the fields that the
dense attention path reads are kept."""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str                 # only "dense" is ported
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0              # 0 -> d_model // n_heads
    source: str = ""

    norm: str = "rmsnorm"
    mlp: str = "swiglu"
    pos: str = "rope"
    rope_theta: float = 10000.0
    rope_fraction: float = 1.0
    tie_embeddings: bool = False

    attn: str = "full"             # full | sliding
    window: int = 0

    dtype: torch.dtype = torch.float32
    param_dtype: torch.dtype = torch.float32

    def __post_init__(self):
        if self.head_dim == 0 and self.n_heads > 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    lr: float = 0.1
    momentum: float = 0.0
    weight_decay: float = 0.0
    optimizer: str = "sgd"          # sgd | adam
    warmup_steps: int = 0
    schedule: str = "constant"      # constant | cosine
    total_steps: int = 1000
    grad_clip: float = 0.0
    seed: int = 0
