from repro_torch.train.trainer import (   # noqa: F401
    TrainState, Trainer, init_train_state, make_train_step)
