"""The paper's section 7 MatMul accelerator, evaluated for a card.

Counterpart of the reference's ``benchmarks/paper_tables.py::
matmul_accel_rows``: the same rows, notes and arithmetic (the paper's HLS
figures from :data:`repro_torch.core.exanet.params.DEFAULT`, the product's
arithmetic intensity from :func:`repro_torch.kernels.matmul_tile.ops.
flops_per_byte`), for any :class:`repro_torch.roofline.hw.HwSpec`.
"""

from __future__ import annotations

from repro_torch.core.exanet.params import DEFAULT, HwParams
from repro_torch.kernels.matmul_tile.ops import flops_per_byte
from repro_torch.roofline.hw import HwSpec

#: the square products the section 7 evaluation reads, (M, N, K)
SHAPES = ((1024, 1024, 1024), (4096, 4096, 4096), (8192, 8192, 8192))


def matmul_accel_rows(hw: HwSpec, params: HwParams = DEFAULT):
    """Rows of (name, us, note): the FPGA tile's execution time and its
    measured rate against its peak, then for each of :data:`SHAPES` the
    least time ``hw`` takes at its bf16 peak and whether the product sits
    above (compute-bound) or below (memory-bound) the card's ridge."""
    p = params
    peak = p.mm_clock_mhz * 1e6 * p.mm_flops_per_cycle / 1e9
    rows = [
        ("matmul_accel/tile_exec", p.mm_tile_exec_cycles / p.mm_clock_mhz,
         f"{p.mm_tile}x{p.mm_tile} tile, {p.mm_flops_per_cycle} flop/cycle"),
        ("matmul_accel/fpga_gflops", 0.0,
         f"paper {p.mm_measured_gflops:.0f} GFLOP/s = "
         f"{100*p.mm_measured_gflops/peak:.1f}% of {peak:.0f} peak; "
         f"{p.mm_gflops_per_watt:.0f} GFLOPS/W"),
    ]
    for mnk in SHAPES:
        ai = flops_per_byte(*mnk)
        ridge = hw.peak_bf16_flops / hw.hbm_bw
        bound = "compute" if ai > ridge else "memory"
        t_us = 2.0 * mnk[0] * mnk[1] * mnk[2] / hw.peak_bf16_flops * 1e6
        rows.append((f"matmul_accel/{hw.name}/{mnk[0]}^3", t_us,
                     f"AI={ai:.0f} flops/B ridge={ridge:.0f} -> {bound}-bound"))
    return rows
