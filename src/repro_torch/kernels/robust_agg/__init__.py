from repro_torch.kernels.robust_agg.ops import (  # noqa: F401
    LAUNCHES, coord_median, reset_launch_counts, trimmed_mean)
from repro_torch.kernels.robust_agg import ref                      # noqa: F401
