from repro_torch.optim.optimizers import (   # noqa: F401
    OptimizerBundle, make_optimizer, global_norm, clip_by_global_norm)
from repro_torch.optim.schedules import make_schedule   # noqa: F401
