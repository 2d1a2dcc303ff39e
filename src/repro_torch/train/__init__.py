from repro_torch.train.optimizer import (OptimizerConfig, OptState,  # noqa: F401
                                         adamw_update, global_norm,
                                         init_opt_state, schedule)
from repro_torch.train.trainer import (Trainer, TrainerConfig,  # noqa: F401
                                       loss_and_grads, make_train_step)
