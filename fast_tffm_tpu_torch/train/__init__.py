"""Training: the sparse step, metrics, the trainer and its checkpoint."""
