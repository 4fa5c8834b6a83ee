"""Hopper combine kernel (``csrc/combine.cu``): binding and counter.

Counterpart of the Pallas TPU kernel ``repro.kernels.allreduce_combine.
kernel.combine``. The CUDA source says what bounds the kernel and how its
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
from repro_torch.kernels.allreduce_combine.ref import check_args

SOURCES = [Path(__file__).parent / "csrc" / "combine.cu"]
THREADS = 256            # kThreads in the source
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int32: 2}
_OP_CODE = {"sum": 0, "max": 1, "min": 2}

#: launches of the kernel in this process (one per :func:`combine` call that
#: reached the card); read and reset by the on-card smoke run
launches = 0


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("allreduce_combine", SOURCES)
    i32, i64, vp = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p
    lib.combine_launch.argtypes = [i32, i32, vp, vp, i32, i64, i64, i32, i32,
                                   vp]
    lib.combine_launch.restype = i32
    lib.combine_error_string.argtypes = [i32]
    lib.combine_error_string.restype = ctypes.c_char_p
    return lib


def build() -> None:
    """Build (or load) the library now, so its cost is not in a timing."""
    _lib()


@functools.cache
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def vectorized(stacked: torch.Tensor) -> bool:
    """Whether every row starts on a 16-byte boundary (the 16-byte vector
    path); otherwise the kernel walks L one element at a time."""
    esize = stacked.element_size()
    return stacked.data_ptr() % 16 == 0 and (stacked.stride(0) * esize) % 16 == 0


def combine(stacked: torch.Tensor, op: str = "sum") -> torch.Tensor:
    """stacked: (P, L) on a CUDA device, rows contiguous (``stride(1) ==
    1``) at any row stride -> (L,) in stacked's dtype. Raises on anything
    the kernel does not take."""
    global launches
    check_args(stacked, op)
    dev = stacked.device
    if dev.type != "cuda":
        raise ValueError(f"combine runs on a CUDA tensor, got {dev}")
    P, L = stacked.shape
    if L and stacked.stride(1) != 1:
        raise ValueError("each part (row) must be contiguous: stride(1) == 1")
    out = torch.empty((L,), dtype=stacked.dtype, device=dev)
    if L == 0:
        return out
    vec = vectorized(stacked)
    per_thread = 16 // stacked.element_size() if vec else 1
    work = max(L // per_thread, 1)
    blocks = max(1, min(-(-work // THREADS), 8 * _sm_count(dev.index)))
    lib = _lib()
    err = lib.combine_launch(
        _DTYPE_CODE[stacked.dtype], _OP_CODE[op], stacked.data_ptr(),
        out.data_ptr(), P, stacked.stride(0), L, int(vec), blocks,
        torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"combine launch failed: CUDA error {err} "
                           f"({lib.combine_error_string(err).decode()})")
    launches += 1
    return out
