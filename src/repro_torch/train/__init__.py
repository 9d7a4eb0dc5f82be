"""Training: the step, the loop, optimizers and persistence."""
