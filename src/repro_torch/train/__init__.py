"""``repro_torch.train`` (``repro.train`` counterpart): the optimizers and
the robust-DP trainers (``Trainer``, the AdamW path, and ``QNTrainer``,
the quasi-Newton protocol as the train step)."""
