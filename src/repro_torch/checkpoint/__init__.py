"""Atomic, async, keep-N checkpoints (``checkpoint.manager``)."""
