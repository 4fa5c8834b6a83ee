"""Fault tolerance: checkpoint/restart and failure replay."""
