"""Training: train state, optimizers and LR schedules, train/eval steps."""
