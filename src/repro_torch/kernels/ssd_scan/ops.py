"""SSD scan entry point: the Hopper kernel on CUDA, the plain version on the
CPU.

Counterpart of ``repro.kernels.ssd_scan.ops``. The device of the tensors
decides: a CPU tensor goes to :func:`ref.ssd_ref`, a CUDA tensor to the
kernel, a meta tensor to the kernel's custom op ``repro_torch::ssd_scan``
(for the dry run, :mod:`repro_torch.kernels._meta`), or the call raises.
Nothing falls back from the kernel to the plain version.
"""

from __future__ import annotations

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels._meta import KERNEL_BYTES, meta_only
from repro_torch.kernels.ssd_scan.kernel import _check, ssd_scan, variant_for
from repro_torch.kernels.ssd_scan.ref import ssd_ref
from repro_torch.roofline.hw import H100, H100_PEAK_F32_FLOPS


@torch.library.custom_op("repro_torch::ssd_scan", mutates_args=())
def ssd_scan_meta(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                  B: torch.Tensor, C: torch.Tensor, chunk: int
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    return meta_only("ssd_scan")(x, dt, A, B, C, chunk)


@ssd_scan_meta.register_fake
def _(x, dt, A, B, C, chunk):
    b, l, h, p, n = _check(x, dt, A, B, C, chunk)
    variant_for(x.dtype, p, n, chunk)
    return (x.new_empty((b, l, h, p), dtype=torch.float32),
            x.new_empty((b, h, p, n), dtype=torch.float32))


@register_flop_formula(torch.ops.repro_torch.ssd_scan)
def _(x_shape, dt_shape, A_shape, B_shape, C_shape, chunk, *args,
      out_shape=None, **kwargs) -> int:
    b, l, h, p = x_shape
    return ssd_cost(b, l, h, p, B_shape[3], chunk, 2)[1]


KERNEL_BYTES[torch.ops.repro_torch.ssd_scan.default] = \
    lambda x, dt, A, B, C, chunk: ssd_cost(*x.shape, B.shape[3], chunk,
                                           x.element_size())[0]


def ssd(x, dt, A, B, C, *, chunk: int = 256):
    """x: (b,l,h,p); dt: (b,l,h) f32; A: (h,) f32; B, C: (b,l,1,n).
    Returns (y (b,l,h,p) f32, final_state (b,h,p,n) f32)."""
    if x.device.type == "cpu":
        return ssd_ref(x, dt, A, B, C)
    if x.device.type == "meta":
        return torch.ops.repro_torch.ssd_scan(x, dt, A, B, C, chunk)
    if x.device.type != "cuda":
        raise ValueError(f"ssd runs on cpu, cuda or meta, not {x.device}")
    return ssd_scan(x, dt, A, B, C, chunk=chunk)


def ssd_cost(b: int, l: int, h: int, p: int, n: int, chunk: int,
             in_bytes: int) -> tuple[int, int]:
    """(bytes, flops) the SSD scan needs at least: x, B and C read once in
    their dtype (``in_bytes`` each element), dt read once in f32, y and the
    final state written once in f32; the products of the chunked dual form
    with the causal mask applied (C·Bᵀ and M·x over the pairs i >= j of each
    chunk, the chunk states, the entering-state term), 2 per multiply-add.
    Exponentials are not counted."""
    nc = l // chunk
    pairs = chunk * (chunk + 1) // 2
    nbytes = (b * l * h * p * in_bytes + b * l * h * 4 + h * 4
              + 2 * b * l * n * in_bytes + b * l * h * p * 4
              + b * h * p * n * 4)
    flops = (b * nc * pairs * n * 2            # C·Bᵀ, shared by the heads
             + b * nc * h * pairs * p * 2      # M·(x·dt)
             + 2 * b * nc * h * chunk * p * n * 2)   # states, y_off
    return nbytes, flops


def ssd_bound(b: int, l: int, h: int, p: int, n: int, chunk: int,
              in_bytes: int, variant: str) -> tuple[float, str]:
    """(ms, "bytes" or "operations"): the least time an H100 could take for
    the call, the larger of :func:`ssd_cost`'s bytes at the card's memory
    rate and its operations at the peak of the units ``variant`` runs them
    on: the bf16 tensor cores for ``mma_sync``, the float32 CUDA cores for
    ``ffma`` (figures from :mod:`repro_torch.roofline.hw`, at 700 W)."""
    peak = {"mma_sync": H100.peak_bf16_flops,
            "ffma": H100_PEAK_F32_FLOPS}[variant]
    nbytes, flops = ssd_cost(b, l, h, p, n, chunk, in_bytes)
    bytes_ms, ops_ms = nbytes / H100.hbm_bw * 1e3, flops / peak * 1e3
    return max(bytes_ms, ops_ms), \
        "bytes" if bytes_ms >= ops_ms else "operations"
