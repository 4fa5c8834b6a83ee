"""Kernels written by hand for Hopper, each beside its plain PyTorch version.

Each kernel package provides ``csrc/`` (the CUDA source, built at first
use by :mod:`repro_torch.kernels._build`), ``kernel.py`` (the ctypes
binding, its checks and its launch counter), ``ref.py`` (the plain version)
and ``ops.py`` (the entry point: CPU tensors take the plain version, CUDA
tensors the kernel).

* ``flash_decode`` — decode attention over a KV cache with per-row lengths
  (replaces ``repro.kernels.flash_decode``; the serving path).
* ``allreduce_combine`` — elementwise sum/max/min of P parts (replaces
  ``repro.kernels.allreduce_combine``; the reduce stages of the
  hierarchical and compressed gradient sync).
* ``ssd_scan`` — the Mamba-2 SSD chunked dual form (replaces
  ``repro.kernels.ssd_scan``; every Mamba-2 layer's forward and
  recompute on the training path).
"""
