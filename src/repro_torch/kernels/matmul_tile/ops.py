"""Tiled matrix product entry point: the Hopper kernel on CUDA, the plain
version on the CPU.

Counterpart of ``repro.kernels.matmul_tile.ops``. The device of the tensors
decides: a CPU tensor goes to :func:`ref.matmul_ref` for any shape (the
tile sizes are not read, as the reference's non-TPU route ignores them), a
CUDA tensor to the kernel under the reference kernel's tile contract
(:func:`ref.check_args`), or the call raises. Nothing falls back from the
kernel to the plain version.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.matmul_tile.kernel import matmul_tile
from repro_torch.kernels.matmul_tile.ref import matmul_ref


def matmul(a: torch.Tensor, b: torch.Tensor, *, bm: int = 128,
           bn: int = 128, bk: int = 512) -> torch.Tensor:
    """C[M,N] = A[M,K] @ B[K,N], float32 accumulation, C in A's dtype."""
    if a.device.type == "cpu":
        return matmul_ref(a, b)
    if a.device.type != "cuda":
        raise ValueError(f"matmul runs on cpu or cuda, not {a.device}")
    return matmul_tile(a, b, bm=bm, bn=bn, bk=bk)


def flops_per_byte(m: int, n: int, k: int, dtype_bytes: int = 2) -> float:
    """Arithmetic intensity of the full problem (roofline napkin math)."""
    flops = 2.0 * m * n * k
    byts = dtype_bytes * (m * k + k * n + m * n)
    return flops / byts
