"""Training: the train step, optimizer chain, loop, checkpoints, LR
schedules."""
