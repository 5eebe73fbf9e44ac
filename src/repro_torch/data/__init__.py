"""Deterministic synthetic data (the reference's numpy pipeline)."""
