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
* ``matmul_tile`` — the paper's section 7 MatMul accelerator: C = A @ B
  with float32 accumulation (replaces ``repro.kernels.matmul_tile``; its
  entry point :func:`matmul` and the section 7 evaluation,
  :mod:`repro_torch.roofline.paper`). bf16/f16 rows that TMA can address
  (K, N multiples of 8, 16-byte aligned pointers) go to the ``wgmma``
  variant, other 16-bit rows to ``mma_sync``, float32 to ``ffma``
  (``kernel.variant_for``). The models' projections stay
  ``torch.matmul``, as the reference's stay XLA dots.

Importing this package imports the four entry points and builds nothing.
"""

from repro_torch.kernels.matmul_tile.ops import matmul
from repro_torch.kernels.allreduce_combine.ops import combine_parts
from repro_torch.kernels.flash_decode.ops import decode_attn
from repro_torch.kernels.ssd_scan.ops import ssd

__all__ = ["matmul", "combine_parts", "decode_attn", "ssd"]
