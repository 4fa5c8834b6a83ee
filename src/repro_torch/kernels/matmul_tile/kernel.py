"""Hopper tiled matrix product (``csrc/matmul_tile.cu``): binding and counter.

Counterpart of the Pallas TPU kernel ``repro.kernels.matmul_tile.kernel.
matmul_tile``. The CUDA source says what bounds the kernel and how its
design answers that. The library is built with ``nvcc`` at first call
(never at import) and bound with ``ctypes``; see
:mod:`repro_torch.kernels._build`.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.matmul_tile.ref import check_args

SOURCES = [Path(__file__).parent / "csrc" / "matmul_tile.cu"]
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

#: launches of the kernel in this process (one per :func:`matmul_tile` call
#: that reached the card); read and reset by the on-card smoke run
launches = 0


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("matmul_tile", SOURCES)
    i32, vp = ctypes.c_int, ctypes.c_void_p
    lib.mm_launch.argtypes = [i32, i32, vp, vp, vp, i32, i32, i32, i32, vp]
    lib.mm_launch.restype = i32
    lib.mm_error_string.argtypes = [i32]
    lib.mm_error_string.restype = ctypes.c_char_p
    return lib


def build() -> None:
    """Build (or load) the library now, so its cost is not in a timing."""
    _lib()


def vectorized(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> bool:
    """Whether the tiles move as 16-byte vectors: every row of A, B and C
    starts on a 16-byte boundary (K and N multiples of 16 bytes' worth of
    elements, pointers aligned); otherwise element by element."""
    per = 16 // a.element_size()
    K, N = b.shape
    return (K % per == 0 and N % per == 0
            and all(t.data_ptr() % 16 == 0 for t in (a, b, c)))


def matmul_tile(a: torch.Tensor, b: torch.Tensor, *, bm: int = 128,
                bn: int = 128, bk: int = 512) -> torch.Tensor:
    """C[M,N] = A[M,K] @ B[K,N] on the card: float32 accumulation over the
    whole K sweep, C in A's dtype. A and B contiguous on one CUDA device;
    the shapes must meet the reference kernel's tile contract for
    (bm, bn, bk) (:func:`check_args`). The kernel picks its own tiles, so
    bm, bn and bk only decide which shapes are taken. Raises on anything
    else."""
    global launches
    check_args(a, b, bm, bn, bk)
    dev = a.device
    for name, t in (("a", a), ("b", b)):
        if t.device != dev or dev.type != "cuda":
            raise ValueError(f"{name} is on {t.device}; A and B must be on "
                             f"one CUDA device (A is on {dev})")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    M, K = a.shape
    N = b.shape[1]
    out = torch.empty((M, N), dtype=a.dtype, device=dev)
    lib = _lib()
    err = lib.mm_launch(dev.index, _DTYPE_CODE[a.dtype], a.data_ptr(),
                        b.data_ptr(), out.data_ptr(), M, N, K,
                        int(vectorized(a, b, out)),
                        torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"matmul_tile launch failed: CUDA error {err} "
                           f"({lib.mm_error_string(err).decode()})")
    launches += 1
    return out
