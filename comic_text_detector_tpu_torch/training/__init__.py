"""Training stack: losses, steps, optimizer, checkpoints, metrics and the seg/DB trainers."""
