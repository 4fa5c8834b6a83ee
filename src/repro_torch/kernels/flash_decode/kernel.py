"""Hopper flash-decode kernel (``csrc/flash_decode.cu``): binding and counter.

Counterpart of the Pallas TPU kernel ``repro.kernels.flash_decode.kernel``.
The CUDA source says what bounds the kernel and how its split-S design
answers that. The library is built with ``nvcc`` at first call (never at
import) and bound with ``ctypes``; see :mod:`repro_torch.kernels._build`.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels import _build

SOURCES = [Path(__file__).parent / "csrc" / "flash_decode.cu"]
#: query rows per CTA and K/V rows one CTA pass covers (bf16, dk 64); must
#: match kRowTile and kGroups * kUnroll in the source
ROW_TILE = 4
ROWS_PER_PASS = 64
#: (dk, dv) pairs the source instantiates
HEAD_DIMS = ((64, 64), (128, 128), (64, 128))
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

#: launches of the kernel in this process (one per :func:`flash_decode`
#: call that reached the card); read and reset by the on-card smoke run
launches = 0


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_decode", SOURCES)
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.fd_launch.argtypes = ([i32] * 4 + [vp] * 8 + [i32] * 4 + [i64] * 6
                              + [i32, ctypes.c_float, vp])
    lib.fd_launch.restype = i32
    lib.fd_error_string.argtypes = [i32]
    lib.fd_error_string.restype = ctypes.c_char_p
    return lib


def build() -> None:
    """Build (or load) the library now, so its cost is not in a timing."""
    _lib()


@functools.cache
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def num_splits(B: int, K: int, rep: int, S: int, sms: int) -> int:
    """Splits of S per (row, kv head): about two CTAs per SM, and no more
    splits than passes of ``ROWS_PER_PASS`` rows in the window."""
    ctas = B * K * -(-rep // ROW_TILE)
    return max(1, min(-(-2 * sms // ctas), -(-S // ROWS_PER_PASS)))


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 lengths: torch.Tensor) -> torch.Tensor:
    """q: (B,H,dk); k: (B,S,K,dk); v: (B,S,K,dv); lengths: (B,) int32 with
    values in [1, S]. Returns (B,H,dv) in q's dtype; positions ``>=
    lengths[b]`` of row b are neither read nor attended to.

    CUDA tensors only; raises on anything the kernel does not take."""
    global launches
    B, H, dk = q.shape
    if k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"caches must be (B,S,K,d): k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    _, S, K, dv = v.shape
    if k.shape[:3] != v.shape[:3] or k.shape[0] != B or k.shape[3] != dk:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    if H % K:
        raise ValueError(f"H={H} is not a multiple of K={K}")
    if (dk, dv) not in HEAD_DIMS:
        raise ValueError(f"(dk, dv)=({dk}, {dv}) not in {HEAD_DIMS}")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"dtypes q {q.dtype}, k {k.dtype}, v {v.dtype}: "
                         "need all float32 or all bfloat16")
    if lengths.dtype != torch.int32 or lengths.shape != (B,):
        raise ValueError(f"lengths must be ({B},) int32, got "
                         f"{tuple(lengths.shape)} {lengths.dtype}")
    dev = q.device
    for name, t in (("q", q), ("k", k), ("v", v), ("lengths", lengths)):
        if t.device != dev or dev.type != "cuda":
            raise ValueError(f"{name} is on {t.device}; all inputs must be "
                             f"on one CUDA device (q is on {dev})")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    rep = H // K
    n_splits = num_splits(B, K, rep, S, _sm_count(dev.index))
    out = torch.empty((B, H, dv), dtype=q.dtype, device=dev)
    m_part = torch.empty((n_splits, B, H), dtype=torch.float32, device=dev)
    l_part = torch.empty_like(m_part)
    acc_part = torch.empty((n_splits, B, H, dv), dtype=torch.float32,
                           device=dev)
    lib = _lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.fd_launch(
        dev.index, _DTYPE_CODE[q.dtype], dk, dv, q.data_ptr(), k.data_ptr(),
        v.data_ptr(), lengths.data_ptr(), out.data_ptr(), m_part.data_ptr(),
        l_part.data_ptr(), acc_part.data_ptr(), B, H, S, K,
        *k.stride()[:3], *v.stride()[:3], n_splits, dk ** -0.5, stream)
    if err:
        raise RuntimeError(f"flash_decode launch failed: CUDA error {err} "
                           f"({lib.fd_error_string(err).decode()})")
    launches += 1
    return out
