from repro_torch.kernels.safeguard_filter.ops import (  # noqa: F401
    LAUNCHES, fused_accumulate_sqdist, pairwise_sqdist, reset_launch_counts)
from repro_torch.kernels.safeguard_filter import ref                  # noqa: F401
