from bagel_tpu_torch.train.step import (
    TrainState,
    compute_losses,
    init_train_state,
    make_lr_schedule,
    make_optimizer,
    make_train_step,
)

__all__ = [
    "TrainState",
    "compute_losses",
    "init_train_state",
    "make_lr_schedule",
    "make_optimizer",
    "make_train_step",
]
