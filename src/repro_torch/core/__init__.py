"""Collectives on torch.distributed process groups."""
