"""Plain PyTorch version of the tiled matrix product, and the tile contract.

Counterpart of ``repro.kernels.matmul_tile.ref.matmul_ref``. The CPU path of
:func:`repro_torch.kernels.matmul_tile.ops.matmul` runs it, and the on-card
checks hold the CUDA kernel against it. On a card it is a float32
``torch.matmul``, exact float32 only while
``torch.backends.cuda.matmul.allow_tf32`` is False (PyTorch's default).
"""

from __future__ import annotations

import torch

#: dtypes the kernel takes: the reference's test sweep, plus float16
DTYPES = (torch.float32, torch.bfloat16, torch.float16)


def check_args(a: torch.Tensor, b: torch.Tensor, bm: int = 128,
               bn: int = 128, bk: int = 512) -> None:
    """The reference kernel's contract (``repro.kernels.matmul_tile.kernel.
    matmul_tile``): A (M,K) and B (K,N) of one dtype, each tile size clamped
    to its dimension, then M % bm == N % bn == K % bk == 0. Raises
    ``ValueError`` on exactly the shapes the reference rejects (and on empty
    ones, where its clamped tile is 0)."""
    if a.dim() != 2 or b.dim() != 2:
        raise ValueError(f"matmul takes 2-D A and B, got {tuple(a.shape)} "
                         f"and {tuple(b.shape)}")
    M, K = a.shape
    K2, N = b.shape
    if K != K2:
        raise ValueError(f"inner dimensions differ: A {tuple(a.shape)}, "
                         f"B {tuple(b.shape)}")
    if a.dtype not in DTYPES or b.dtype != a.dtype:
        raise ValueError(f"A and B must share one dtype of {DTYPES}, got "
                         f"{a.dtype} and {b.dtype}")
    if min(bm, bn, bk) < 1:
        raise ValueError(f"tile sizes must be positive, got ({bm}, {bn}, "
                         f"{bk})")
    if min(M, N, K) < 1:
        raise ValueError(f"empty product: M={M}, N={N}, K={K}")
    bm, bn, bk = min(bm, M), min(bn, N), min(bk, K)
    if M % bm or N % bn or K % bk:
        raise ValueError(f"(M, N, K)=({M}, {N}, {K}) is not divisible by its "
                         f"tiles (bm, bn, bk)=({bm}, {bn}, {bk})")


def matmul_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """C = A @ B with float32 accumulation, result in A's dtype."""
    return torch.matmul(a.float(), b.float()).to(a.dtype)
