"""Training: AdamW (:mod:`~repro_torch.train.optimizer`), LR schedules
(:mod:`~repro_torch.train.schedule`), the train and eval steps
(:mod:`~repro_torch.train.step`) and checkpoints
(:mod:`~repro_torch.train.checkpoint`)."""
