"""Hopper SSD chunk-scan kernel (``csrc/ssd_scan.cu``): binding and counter.

Counterpart of the Pallas TPU kernel ``repro.kernels.ssd_scan.kernel``.
The CUDA source says what bounds the kernel and how its three-stage design
answers that. The library is built with ``nvcc`` at first call (never at
import) and bound with ``ctypes``; see :mod:`repro_torch.kernels._build`.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels import _build

SOURCES = [Path(__file__).parent / "csrc" / "ssd_scan.cu"]
#: limits of the source's tiles: kChunkMax, kP and kN
CHUNK_MAX, P_MAX, N_MAX = 256, 64, 128
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

#: launches of the kernel in this process (one per :func:`ssd_scan` call
#: that reached the card); read and reset by the on-card smoke run
launches = 0


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("ssd_scan", SOURCES)
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.ssd_launch.argtypes = [i32] + [vp] * 9 + [i32] * 6 + [vp]
    lib.ssd_launch.restype = i32
    lib.ssd_error_string.argtypes = [i32]
    lib.ssd_error_string.restype = ctypes.c_char_p
    return lib


def build() -> None:
    """Build (or load) the library now, so its cost is not in a timing."""
    _lib()


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             B: torch.Tensor, C: torch.Tensor, *, chunk: int = 256
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (b,l,h,p) f32 or bf16; dt: (b,l,h) f32; A: (h,) f32; B, C:
    (b,l,1,n) in x's dtype (n_groups=1). Returns (y (b,l,h,p) f32,
    final_state (b,h,p,n) f32). Needs ``l % chunk == 0``.

    CUDA tensors only; raises on anything the kernel does not take."""
    global launches
    if x.dim() != 4:
        raise ValueError(f"x must be (b,l,h,p), got {tuple(x.shape)}")
    b, l, h, p = x.shape
    if B.dim() != 4 or B.shape[2] != 1 or C.shape != B.shape:
        raise ValueError(f"B and C must be (b,l,1,n) (n_groups=1): B "
                         f"{tuple(B.shape)}, C {tuple(C.shape)}")
    n = B.shape[3]
    if B.shape[:2] != (b, l) or dt.shape != (b, l, h) or A.shape != (h,):
        raise ValueError(f"shape mismatch: x {tuple(x.shape)}, dt "
                         f"{tuple(dt.shape)}, A {tuple(A.shape)}, B "
                         f"{tuple(B.shape)}")
    if not 0 < chunk <= CHUNK_MAX or l % chunk:
        raise ValueError(f"need 0 < chunk <= {CHUNK_MAX} and l % chunk == 0:"
                         f" l={l}, chunk={chunk}")
    if p > P_MAX or n > N_MAX:
        raise ValueError(f"head_dim {p} > {P_MAX} or d_state {n} > {N_MAX}")
    if x.dtype not in _DTYPE_CODE or B.dtype != x.dtype or C.dtype != x.dtype:
        raise ValueError(f"dtypes x {x.dtype}, B {B.dtype}, C {C.dtype}: "
                         "need all float32 or all bfloat16")
    if dt.dtype != torch.float32 or A.dtype != torch.float32:
        raise ValueError(f"dt {dt.dtype} and A {A.dtype} must be float32")
    dev = x.device
    for name, t in (("x", x), ("dt", dt), ("A", A), ("B", B), ("C", C)):
        if t.device != dev or dev.type != "cuda":
            raise ValueError(f"{name} is on {t.device}; all inputs must be "
                             f"on one CUDA device (x is on {dev})")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    nc = l // chunk
    f32 = dict(dtype=torch.float32, device=dev)
    y = torch.empty((b, l, h, p), **f32)
    final = torch.empty((b, h, p, n), **f32)
    states = torch.empty((b, nc, h, p, n), **f32)
    cs_end = torch.empty((b, nc, h), **f32)
    lib = _lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.ssd_launch(
        _DTYPE_CODE[x.dtype], x.data_ptr(), dt.data_ptr(), A.data_ptr(),
        B.data_ptr(), C.data_ptr(), y.data_ptr(), final.data_ptr(),
        states.data_ptr(), cs_end.data_ptr(), b, l, h, p, n, chunk, stream)
    if err:
        raise RuntimeError(f"ssd_scan launch failed: CUDA error {err} "
                           f"({lib.ssd_error_string(err).decode()})")
    launches += 1
    return y, final
