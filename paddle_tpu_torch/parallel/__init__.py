"""Training step and pure optimizers (one device; multi-GPU waits for a
later slice)."""
from .train_step import (DistributedTrainStep, global_norm_clip,
                         pure_adamw_init, pure_adamw_update, pure_lamb_init,
                         pure_lamb_update, pure_lars_init, pure_lars_update,
                         pure_momentum_init, pure_momentum_update,
                         pure_sgd_init, pure_sgd_update)

__all__ = ["DistributedTrainStep", "global_norm_clip", "pure_adamw_init",
           "pure_adamw_update", "pure_lamb_init", "pure_lamb_update",
           "pure_lars_init", "pure_lars_update", "pure_momentum_init",
           "pure_momentum_update", "pure_sgd_init", "pure_sgd_update"]
