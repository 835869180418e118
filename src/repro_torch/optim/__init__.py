"""AdamW, learning-rate schedules and global-norm clipping
(``optim.adamw``)."""
