"""Hopper flash-decode kernel (``csrc/flash_decode.cu``): binding, schedule
and counter.

Counterpart of the Pallas TPU kernel ``repro.kernels.flash_decode.kernel``.
The CUDA source says what bounds the kernel and how its design answers that:
one launch over a grid fixed by the shapes and the SM count; each CTA takes
an equal share of the live spans (:func:`schedule`, which the source
mirrors), streams K/V through a ``cp.async`` ring, and the last CTA of each
unit merges the partials (tickets and scratch in :func:`_buffers`). The
library is built with ``nvcc`` at first call (never at import) and bound
with ``ctypes``; see :mod:`repro_torch.kernels._build`.
"""

from __future__ import annotations

import ctypes
import functools
import math
from pathlib import Path

import torch

from repro_torch.kernels import _build

SOURCES = [Path(__file__).parent / "csrc" / "flash_decode.cu"]
#: positions per span (the unit of the schedule and of a ring stage) and the
#: most query rows of one unit; must match kSpan and kRowTile in the source
SPAN = 32
ROW_TILE = 8
#: (dk, dv) pairs the source instantiates
HEAD_DIMS = ((64, 64), (128, 128), (64, 128), (80, 80), (16, 16))
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

#: launches of the kernel in this process (one per :func:`flash_decode`
#: call that reached the card); read and reset by the on-card smoke run
launches = 0

#: (device index, stream) -> that stream's (tickets, partials): the int32
#: ticket counters, zero at rest (each launch's merging CTAs set theirs back
#: to 0), and the f32 scratch of the partials, used within a launch only
_stream_buffers: dict[tuple[int, int], tuple[torch.Tensor, torch.Tensor]] = {}
#: buffers outgrown by a larger call, kept alive: a captured graph may still
#: point at one
_retired: list[torch.Tensor] = []


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_decode", SOURCES)
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.fd_launch.argtypes = ([i32] * 4 + [vp] * 8 + [i32] * 4 + [i64] * 6
                              + [i32, ctypes.c_float, vp])
    lib.fd_launch.restype = i32
    lib.fd_blocks_per_sm.argtypes = [i32] * 5 + [ctypes.POINTER(i32)]
    lib.fd_blocks_per_sm.restype = i32
    lib.fd_merge_chunk.argtypes = [i32] * 4
    lib.fd_merge_chunk.restype = i32
    lib.fd_error_string.argtypes = [i32]
    lib.fd_error_string.restype = ctypes.c_char_p
    return lib


def build() -> None:
    """Build (or load) the library now, so its cost is not in a timing."""
    _lib()


def merge_chunk(dtype: torch.dtype, dk: int, dv: int, nrows: int) -> int:
    """Partials one pass of the kernel's merge stages for a unit of
    ``nrows`` rows: a unit shared by more CTAs takes several passes."""
    return _lib().fd_merge_chunk(_DTYPE_CODE[dtype], dk, dv, nrows)


def row_tiles(rep: int) -> int:
    """Query-row tiles of a GQA group of ``rep`` rows: one while ``rep <=
    ROW_TILE``, so no tile computes a padded row."""
    return -(-rep // ROW_TILE)


def tile_rows(rep: int, tile: int) -> tuple[int, int]:
    """Rows ``[r0, r1)`` of the group that tile ``tile`` computes; the tiles
    split the group evenly (at most ``ROW_TILE`` rows each)."""
    n = row_tiles(rep)
    return tile * rep // n, (tile + 1) * rep // n


def schedule(lengths, B: int, K: int, row_tiles: int, n_ctas: int,
             T: int = SPAN) -> list[tuple[int, int, int, int, int, int]]:
    """The kernel's partition of the work, as ``(cta, b, g, tile, start,
    end)`` segments in CTA order: CTA ``cta`` attends query-row tile
    ``tile`` of kv head ``g`` of row ``b`` to positions ``[start, end)``.

    The live positions of each unit (b, g, tile) are cut into spans of
    ``T`` (a row of length 0 still has one, empty, span); the N spans,
    ordered by (b, g, tile, span), are cut into ``n_ctas`` contiguous ranges,
    the first ``N % n_ctas`` of them one span longer: each CTA gets floor or
    ceil of ``N / n_ctas`` spans, and the CTAs left empty are the last ones.
    A range's spans of one unit form one segment.
    ``fd_decode_kernel`` in ``csrc/flash_decode.cu`` computes the same
    partition on the card from the lengths in device memory."""
    lens = [max(0, int(n)) for n in lengths]
    if len(lens) != B:
        raise ValueError(f"{len(lens)} lengths for B={B}")
    spans = [max(1, -(-n // T)) for n in lens]
    units = K * row_tiles
    pre = [0]
    for n in spans:
        pre.append(pre[-1] + n)
    N = units * pre[-1]
    q, rem = divmod(N, n_ctas)
    out = []
    b = 0
    for c in range(n_ctas):
        j, j1 = c * q + min(c, rem), (c + 1) * q + min(c + 1, rem)
        while j < j1:
            while units * pre[b + 1] <= j:
                b += 1
            nb = spans[b]
            u, s = divmod(j - units * pre[b], nb)
            e = min(j1, units * pre[b] + (u + 1) * nb)
            g, tile = divmod(u, row_tiles)
            out.append((c, b, g, tile, s * T,
                        min((s + e - j) * T, lens[b])))
            j = e
    return out


@functools.cache
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


@functools.cache
def _blocks_per_sm(device_index: int, dtype_code: int, dk: int, dv: int,
                   B: int) -> int:
    n = ctypes.c_int(0)
    err = _lib().fd_blocks_per_sm(device_index, dtype_code, dk, dv, B,
                                  ctypes.byref(n))
    if err or n.value < 1:
        raise RuntimeError(f"flash_decode: no CTA of ({dk}, {dv}) fits an SM "
                           f"at B={B}: CUDA error {err} "
                           f"({_lib().fd_error_string(err).decode()})")
    return n.value


def grid_ctas(B: int, K: int, rep: int, S: int, sms: int,
              blocks_per_sm: int) -> int:
    """The kernel's grid: every CTA the card holds at once, but no more than
    the most spans the shapes allow. A function of the shapes only, so a
    graph that captures the call stays right for any lengths."""
    return max(1, min(sms * blocks_per_sm,
                      B * K * row_tiles(rep) * -(-S // SPAN)))


@functools.cache
def _grid(device_index: int, code: int, dk: int, dv: int, B: int, K: int,
          rep: int, S: int) -> int:
    return grid_ctas(B, K, rep, S, _sm_count(device_index),
                     _blocks_per_sm(device_index, code, dk, dv, B))


def _buffers(dev: torch.device, stream: int, n_tickets: int,
             n_part: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The current stream's ticket counters (at least ``n_tickets``, zeroed
    when made) and partial scratch (at least ``n_part`` floats).

    They are made only outside graph capture: a zeroing captured with the
    call would run on replay only, so an eager call or another graph on the
    stream could meet counters never zeroed. Graphs captured on one stream
    share its buffers (as they share its cuBLAS workspace), so replay them
    one at a time."""
    key = (dev.index, stream)
    bufs = _stream_buffers.get(key)
    if bufs is None or bufs[0].numel() < n_tickets or bufs[1].numel() < n_part:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                "flash_decode: this stream has no ticket and scratch buffers "
                "for these shapes yet; call flash_decode once on the capture "
                "stream, outside capture, before capturing it")
        if bufs is not None:
            _retired.extend(bufs)
        bufs = (torch.zeros(max(n_tickets, 4096), dtype=torch.int32,
                            device=dev),
                torch.empty(max(n_part, 1 << 20), dtype=torch.float32,
                            device=dev))
        _stream_buffers[key] = bufs
    return bufs


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 lengths: torch.Tensor, *, lse: bool = False):
    """q: (B,H,dk); k: (B,S,K,dk); v: (B,S,K,dv); lengths: (B,) int32 with
    values in [1, S]. Returns (B,H,dv) in q's dtype; positions ``>=
    lengths[b]`` of row b are neither read nor attended to.

    With ``lse``: lengths in [0, S], and returns ``(out, lse)``, ``out``
    (B,H,dv) in float32 and ``lse`` (B,H) float32, each row's natural
    log-sum-exp of its scaled scores; a row of length 0 gives ``out`` 0 and
    ``lse`` -inf. The same launch: the CTA that writes a row's output
    writes its ``lse``.

    CUDA tensors only; raises on anything the kernel does not take. Never
    reads ``lengths`` to the host, so it can be captured in a CUDA graph."""
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
    code = _DTYPE_CODE[q.dtype]
    n_ctas = _grid(dev.index, code, dk, dv, B, K, rep, S)
    stream = torch.cuda.current_stream(dev).cuda_stream
    tickets, part = _buffers(dev, stream, B * K * row_tiles(rep),
                             2 * n_ctas * ROW_TILE * (dv + 2))
    out = torch.empty((B, H, dv), dtype=torch.float32 if lse else q.dtype,
                      device=dev)
    lse_out = (torch.empty((B, H), dtype=torch.float32, device=dev)
               if lse else None)
    lib = _lib()
    err = lib.fd_launch(
        dev.index, code, dk, dv, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        lengths.data_ptr(), out.data_ptr(), part.data_ptr(),
        tickets.data_ptr(), None if lse_out is None else lse_out.data_ptr(),
        B, H, S, K, *k.stride()[:3], *v.stride()[:3], n_ctas,
        dk ** -0.5 * math.log2(math.e), stream)
    if err:
        raise RuntimeError(f"flash_decode launch failed: CUDA error {err} "
                           f"({lib.fd_error_string(err).decode()})")
    launches += 1
    return (out, lse_out) if lse else out
