from .optimizer import (OptConfig, init_opt_state, adamw_update,
                        abstract_opt_state)
from .step import TrainConfig, loss_fn, make_train_step

__all__ = ["OptConfig", "init_opt_state", "adamw_update",
           "abstract_opt_state", "TrainConfig", "loss_fn", "make_train_step"]
