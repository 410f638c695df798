"""Training: the sparse and dense steps, the dense optimizers, metrics,
the trainer and its checkpoint."""
