"""``repro_torch.train`` (``repro.train`` counterpart): the optimizers and
the robust-DP trainers (``Trainer``, the AdamW path, and ``QNTrainer``,
the quasi-Newton protocol as the train step)."""
from repro_torch.train.optimizer import AdamW, SGD, apply_updates, global_norm
from repro_torch.train.trainer import (QNTrainConfig, QNTrainer, TrainConfig,
                                       Trainer, make_train_step)

__all__ = ["AdamW", "SGD", "apply_updates", "global_norm", "TrainConfig",
           "Trainer", "make_train_step", "QNTrainConfig", "QNTrainer"]
