"""Deterministic synthetic token batches."""
