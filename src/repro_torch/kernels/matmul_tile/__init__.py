"""Tiled matrix product (the paper's section 7 MatMul accelerator): CUDA
kernel, plain version and entry point."""
