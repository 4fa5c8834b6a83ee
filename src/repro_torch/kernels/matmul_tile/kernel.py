"""Hopper tiled matrix product (``csrc/matmul_tile.cu``): binding and counters.

Counterpart of the Pallas TPU kernel ``repro.kernels.matmul_tile.kernel.
matmul_tile``. Three variants of the kernel, chosen by :func:`variant_for`
from the dtype and the alignment of the rows before the launch:

* ``wgmma`` — bf16/f16 where K and N are multiples of 8 and the pointers
  16-byte aligned (TMA's conditions): TMA-fed, warp-specialised,
  persistent ``wgmma``, its output tile chosen by :func:`wgmma_tile`;
* ``mma_sync`` — bf16/f16 rows TMA cannot address (K = 301, N = 100, a
  view at an odd offset): ``cp.async`` and ``mma.sync``;
* ``ffma`` — float32, on the CUDA cores (never TF32).

The CUDA source says what bounds each and how its design answers that. The
library is built with ``nvcc`` at first call (never at import) and bound
with ``ctypes``; see :mod:`repro_torch.kernels._build`.
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
#: the kernel's variants, by their code in ``mm_launch``
VARIANTS = ("ffma", "mma_sync", "wgmma")
#: wgmma's output tiles (rows, columns), largest first
WGMMA_TILES = ((128, 256), (128, 128), (64, 128))
#: the tile of ffma and mma_sync
TILE = (128, 128)
#: a wgmma tile is taken when the product has at least this many of it:
#: about one per SM of an H100 (132), so that no SM idles
FILL_TILES = 128

#: launches of the kernel in this process (one per :func:`matmul_tile` or
#: :func:`_launch` call that reached the card); read and reset by the
#: on-card smoke run
launches = 0
#: the same launches by variant
launches_by_variant = dict.fromkeys(VARIANTS, 0)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("matmul_tile", SOURCES)
    i32, vp = ctypes.c_int, ctypes.c_void_p
    lib.mm_launch.argtypes = [i32, i32, vp, vp, vp, i32, i32, i32, i32, i32,
                              i32, i32, vp]
    lib.mm_launch.restype = i32
    lib.mm_wgmma_probe.argtypes = [i32, i32, vp, vp, vp, vp]
    lib.mm_wgmma_probe.restype = i32
    lib.mm_error_string.argtypes = [i32]
    lib.mm_error_string.restype = ctypes.c_char_p
    return lib


def build() -> None:
    """Build (or load) the library now, so its cost is not in a timing."""
    _lib()


def vectorized(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> bool:
    """Whether the tiles move as 16-byte vectors: every row of A, B and C
    starts on a 16-byte boundary (K and N multiples of 16 bytes' worth of
    elements, pointers aligned); otherwise element by element. For 16-bit
    dtypes these are TMA's conditions too."""
    per = 16 // a.element_size()
    K, N = b.shape
    return (K % per == 0 and N % per == 0
            and all(t.data_ptr() % 16 == 0 for t in (a, b, c)))


def wgmma_tile(M: int, N: int, K: int) -> tuple[int, int]:
    """wgmma's output tile for an (M, N, K) product: the largest of
    :data:`WGMMA_TILES` of which the product has at least
    :data:`FILL_TILES`, else the smallest. A larger tile reads A and B
    fewer times; fewer tiles than SMs leave SMs idle. K does not enter:
    the K sweep is never split (that would change the float32 sum's order
    and need a second pass)."""
    for bm, bn in WGMMA_TILES:
        if -(-M // bm) * -(-N // bn) >= FILL_TILES:
            return bm, bn
    return WGMMA_TILES[-1]


def variant_for(a: torch.Tensor, b: torch.Tensor,
                out: torch.Tensor) -> tuple[str, tuple[int, int]]:
    """(variant, output tile) the kernel runs for C = A @ B into ``out``:
    ffma for float32; wgmma for 16-bit where :func:`vectorized` holds,
    with :func:`wgmma_tile`'s tile; mma_sync for other 16-bit rows. Reads
    shapes, dtypes and pointers only; builds nothing."""
    if a.dtype == torch.float32:
        return "ffma", TILE
    if vectorized(a, b, out):
        return "wgmma", wgmma_tile(a.shape[0], b.shape[1], a.shape[1])
    return "mma_sync", TILE


def _on_card(a: torch.Tensor, b: torch.Tensor) -> torch.device:
    dev = a.device
    for name, t in (("a", a), ("b", b)):
        if t.device != dev or dev.type != "cuda":
            raise ValueError(f"{name} is on {t.device}; A and B must be on "
                             f"one CUDA device (A is on {dev})")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return dev


def _raise_on(err: int, what: str) -> None:
    if err:
        raise RuntimeError(f"{what} failed: error {err} "
                           f"({_lib().mm_error_string(err).decode()})")


def _launch(a: torch.Tensor, b: torch.Tensor, variant: str,
            tile: tuple[int, int] | None = None,
            out: torch.Tensor | None = None) -> torch.Tensor:
    """C = A @ B through ``variant`` (and, for wgmma, ``tile``, by default
    :func:`wgmma_tile`'s), whatever :func:`variant_for` would pick, as long
    as the variant takes these tensors. For measurements and on-card tests
    that compare variants at one shape; :func:`matmul_tile` is the entry
    point. Counts the launch."""
    global launches
    check_args(a, b, 1, 1, 1)
    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {VARIANTS}, not {variant!r}")
    if (variant == "ffma") != (a.dtype == torch.float32):
        raise ValueError(f"{variant} does not take {a.dtype}")
    dev = _on_card(a, b)
    M, K = a.shape
    N = b.shape[1]
    if out is None:
        out = torch.empty((M, N), dtype=a.dtype, device=dev)
    vec = vectorized(a, b, out)
    if variant == "wgmma":
        if not vec:
            raise ValueError("wgmma needs K and N multiples of 8 and 16-byte "
                             "aligned pointers")
        tile = tile or wgmma_tile(M, N, K)
        if tile not in WGMMA_TILES:
            raise ValueError(f"wgmma tiles are {WGMMA_TILES}, not {tile}")
    elif tile not in (None, TILE):
        raise ValueError(f"{variant} runs {TILE} tiles, not {tile}")
    bm, bn = tile or TILE
    err = _lib().mm_launch(dev.index, _DTYPE_CODE[a.dtype], a.data_ptr(),
                           b.data_ptr(), out.data_ptr(), M, N, K, int(vec),
                           VARIANTS.index(variant), bm, bn,
                           torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, f"matmul_tile {variant} launch")
    launches += 1
    launches_by_variant[variant] += 1
    return out


def matmul_tile(a: torch.Tensor, b: torch.Tensor, *, bm: int = 128,
                bn: int = 128, bk: int = 512) -> torch.Tensor:
    """C[M,N] = A[M,K] @ B[K,N] on the card: float32 accumulation over the
    whole K sweep, C in A's dtype. A and B contiguous on one CUDA device;
    the shapes must meet the reference kernel's tile contract for
    (bm, bn, bk) (:func:`check_args`). The variant and its tile are
    :func:`variant_for`'s, so bm, bn and bk only decide which shapes are
    taken. Raises on anything else."""
    check_args(a, b, bm, bn, bk)
    dev = _on_card(a, b)
    out = torch.empty((a.shape[0], b.shape[1]), dtype=a.dtype, device=dev)
    variant, tile = variant_for(a, b, out)
    return _launch(a, b, variant, tile, out)


def wgmma_probe(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The descriptor check: C (64, 256) = A (64, 64) @ B (64, 256), 16-bit,
    in one TMA stage and one warpgroup, through the same swizzled boxes,
    descriptors and ``wgmma`` as the 128x256 tile. Not counted: no entry
    point calls it."""
    if a.shape != (64, 64) or b.shape != (64, 256) or b.dtype != a.dtype \
            or a.dtype not in (torch.bfloat16, torch.float16):
        raise ValueError("wgmma_probe takes 16-bit A (64, 64), B (64, 256)")
    dev = _on_card(a, b)
    out = torch.empty((64, 256), dtype=a.dtype, device=dev)
    if not vectorized(a, b, out):
        raise ValueError("wgmma_probe needs 16-byte aligned pointers")
    err = _lib().mm_wgmma_probe(dev.index, _DTYPE_CODE[a.dtype], a.data_ptr(),
                                b.data_ptr(), out.data_ptr(),
                                torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, "wgmma_probe launch")
    return out
