"""Training: optimizer, train step, checkpoints, fault drills."""
