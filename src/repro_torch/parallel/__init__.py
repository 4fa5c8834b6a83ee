"""Data-parallel context and gradient synchronization."""
