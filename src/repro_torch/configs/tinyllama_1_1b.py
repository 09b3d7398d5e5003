"""tinyllama-1.1b [dense] — llama2-arch small.

22L d_model=2048 32H (GQA kv=4) d_ff=5632 vocab=32000. [arXiv:2401.02385]
"""

import torch

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="tinyllama-1.1b",
    arch_type="dense",
    n_layers=22,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    d_ff=5632,
    vocab_size=32000,
    source="arXiv:2401.02385",
    dtype=torch.bfloat16,
    param_dtype=torch.bfloat16,
)

SMOKE = ModelConfig(
    name="tinyllama-smoke",
    arch_type="dense",
    n_layers=2,
    d_model=128,
    n_heads=8,
    n_kv_heads=2,
    d_ff=384,
    vocab_size=256,
    source="arXiv:2401.02385",
)
