"""Hopper SSD chunk-scan kernel (``csrc/ssd_scan.cu``): binding and counters.

Counterpart of the Pallas TPU kernel ``repro.kernels.ssd_scan.kernel``.
Two variants of the kernel, chosen by :func:`variant_for` from the dtype and
the shape before the launch:

* ``mma_sync`` — bfloat16: the products on the tensor cores
  (``mma.sync`` m16n8k16, f32 accumulators), rounded to bf16 where the
  reference model's ``ssd_chunked`` rounds, plus one rounding more in the
  chunk states (:func:`ref.ssd_chunked_tc` is its plain version). It takes
  head_dim, d_state and chunk in multiples of 16; a bf16 call of another
  shape raises, it never goes to ``ffma``;
* ``ffma`` — float32: every product in float32 on the CUDA cores, the
  reference kernel's own arithmetic (:func:`ref.ssd_ref` to 1e-4).

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

SOURCES = [Path(__file__).parent / "csrc" / "ssd_scan.cu"]
#: limits of the source's tiles: kChunkMax, kP and kN
CHUNK_MAX, P_MAX, N_MAX = 256, 64, 128
#: mma_sync's granule: head_dim, d_state and chunk must be multiples of it
TC_MULTIPLE = 16
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
#: the kernel's variants, by their code in ``ssd_launch``
VARIANTS = ("ffma", "mma_sync")

#: launches of the kernel in this process (one per :func:`ssd_scan` or
#: :func:`_launch` call that reached the card, however many CUDA kernels it
#: ran); read and reset by the on-card smoke run
launches = 0
#: the same launches by variant
launches_by_variant = dict.fromkeys(VARIANTS, 0)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("ssd_scan", SOURCES)
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.ssd_launch.argtypes = [i32, i32] + [vp] * 10 + [i32] * 6 + [vp]
    lib.ssd_launch.restype = i32
    lib.ssd_error_string.argtypes = [i32]
    lib.ssd_error_string.restype = ctypes.c_char_p
    return lib


def build() -> None:
    """Build (or load) the library now, so its cost is not in a timing."""
    _lib()


def variant_for(dtype: torch.dtype, p: int, n: int, chunk: int) -> str:
    """The variant :func:`ssd_scan` runs for inputs of ``dtype`` with
    head_dim ``p``, d_state ``n`` and this ``chunk``: ``ffma`` for float32,
    ``mma_sync`` for bfloat16. Raises for a bfloat16 shape ``mma_sync`` does
    not take (p, n or chunk no multiple of :data:`TC_MULTIPLE`) and for
    other dtypes. Reads no tensor and builds nothing."""
    if dtype == torch.float32:
        return "ffma"
    if dtype != torch.bfloat16:
        raise ValueError(f"no ssd_scan variant for {dtype}")
    if p % TC_MULTIPLE or n % TC_MULTIPLE or chunk % TC_MULTIPLE:
        raise ValueError(f"the tensor-core variant (mma_sync) takes head_dim, "
                         f"d_state and chunk in multiples of {TC_MULTIPLE}: "
                         f"p={p}, n={n}, chunk={chunk}")
    return "mma_sync"


def _check(x, dt, A, B, C, chunk: int) -> tuple[int, int, int, int, int]:
    """(b, l, h, p, n) of inputs whose shapes and dtypes the kernel takes;
    raises on anything else."""
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
    return b, l, h, p, n


def _on_card(x, dt, A, B, C) -> None:
    dev = x.device
    for name, t in (("x", x), ("dt", dt), ("A", A), ("B", B), ("C", C)):
        if t.device != dev or dev.type != "cuda":
            raise ValueError(f"{name} is on {t.device}; all inputs must be "
                             f"on one CUDA device (x is on {dev})")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _launch(x, dt, A, B, C, *, chunk: int, variant: str
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """(y, final_state) through ``variant``, whatever :func:`variant_for`
    would pick, as long as the variant takes these inputs: ``ffma`` takes
    float32 and bfloat16 (the latter only for measurements and on-card tests
    that compare the variants on one input), ``mma_sync`` bfloat16 in
    multiples of 16 with 16-byte aligned pointers. :func:`ssd_scan` is the
    entry point. Counts the launch."""
    global launches
    b, l, h, p, n = _check(x, dt, A, B, C, chunk)
    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {VARIANTS}, not {variant!r}")
    # variant_for raises on the bf16 shapes mma_sync refuses
    if variant == "mma_sync" and variant_for(x.dtype, p, n, chunk) != variant:
        raise ValueError(f"mma_sync does not take {x.dtype}")
    _on_card(x, dt, A, B, C)
    if variant == "mma_sync" and any(t.data_ptr() % 16 for t in (x, B, C)):
        raise ValueError("mma_sync needs x, B and C 16-byte aligned")
    dev = x.device
    nc = l // chunk
    f32 = dict(dtype=torch.float32, device=dev)
    y = torch.empty((b, l, h, p), **f32)
    final = torch.empty((b, h, p, n), **f32)
    states = torch.empty((b, nc, h, p, n), **f32)
    states_bf16 = (torch.empty((b, nc, h, p, n), dtype=torch.bfloat16,
                               device=dev)
                   if variant == "mma_sync" else None)
    cs_end = torch.empty((b, nc, h), **f32)
    lib = _lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.ssd_launch(
        VARIANTS.index(variant), _DTYPE_CODE[x.dtype], x.data_ptr(),
        dt.data_ptr(), A.data_ptr(), B.data_ptr(), C.data_ptr(), y.data_ptr(),
        final.data_ptr(), states.data_ptr(),
        None if states_bf16 is None else states_bf16.data_ptr(),
        cs_end.data_ptr(), b, l, h, p, n, chunk, stream)
    if err:
        raise RuntimeError(f"ssd_scan {variant} launch failed: CUDA error "
                           f"{err} ({lib.ssd_error_string(err).decode()})")
    launches += 1
    launches_by_variant[variant] += 1
    return y, final


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             B: torch.Tensor, C: torch.Tensor, *, chunk: int = 256
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (b,l,h,p) f32 or bf16; dt: (b,l,h) f32; A: (h,) f32; B, C:
    (b,l,1,n) in x's dtype (n_groups=1). Returns (y (b,l,h,p) f32,
    final_state (b,h,p,n) f32). Needs ``l % chunk == 0``. The variant is
    :func:`variant_for`'s.

    CUDA tensors only; raises on anything the kernel does not take."""
    _, _, _, p, n = _check(x, dt, A, B, C, chunk)
    return _launch(x, dt, A, B, C, chunk=chunk,
                   variant=variant_for(x.dtype, p, n, chunk))
