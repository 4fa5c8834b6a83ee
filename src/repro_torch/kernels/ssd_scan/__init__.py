"""Mamba-2 SSD chunk scan: CUDA kernel, plain version and entry point."""
