"""Checkpoint/restart (``checkpoint.checkpointer``)."""
