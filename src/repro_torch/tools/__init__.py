"""Checks over the port's own source (run as ``python -m
repro_torch.tools.<name>``)."""
