"""Hardware figures of the card the port targets, for roofline bounds.

The port's counterpart of the reference's ``repro.roofline.hw``: the same
:class:`HwSpec` fields, so code written against the reference's spec reads
this one, and an :data:`H100` spec from NVIDIA's published figures for the
H100 SXM5 80 GB (data sheet, dense rates without sparsity, at the full
700 W power limit). A card set to a lower power limit runs slower under
load; a bound computed from these figures is a bound at 700 W.

:data:`V5E` is the reference's own TPU v5e spec, copied field for field.
It is a constant of the reference's machine model, not a reading of any
card: the port's collective planner (``TpuMachine`` in
:mod:`repro_torch.core.machine`) prices the reference's mesh with it, so
that it picks what the reference picks. No H100 bound or time is computed
from it.
"""

import dataclasses


@dataclasses.dataclass(frozen=True)
class HwSpec:
    name: str
    peak_bf16_flops: float      # FLOP/s per chip
    hbm_bw: float               # bytes/s per chip
    hbm_bytes: float            # capacity per chip
    ici_link_bw: float          # bytes/s per chip-to-chip link, each way
    ici_links: int              # chip-to-chip links per chip
    dcn_bw: float               # bytes/s per chip between hosts
    vmem_bytes: float           # fast on-chip memory one kernel block holds
    mxu_tile: int               # rows of the matrix unit's tile


#: H100 SXM5 80 GB. The fields named for the reference's chip hold, on this
#: card: ``ici_link_bw``/``ici_links`` its NVLink 4 (18 links of 25 GB/s
#: each way, 450 GB/s each way in all, to the other cards of the host);
#: ``dcn_bw`` one 400 Gb/s NIC per card (DGX H100), the bytes/s between
#: hosts; ``vmem_bytes`` the shared memory one thread block can use
#: (227 KB of the SM's 256 KB); ``mxu_tile`` the 64 rows of a ``wgmma``
#: tile.
H100 = HwSpec(
    name="h100-sxm5-80gb",
    peak_bf16_flops=989.4e12,
    hbm_bw=3.35e12,
    hbm_bytes=80 * 2 ** 30,
    ici_link_bw=25e9,
    ici_links=18,
    dcn_bw=50e9,
    vmem_bytes=232_448,
    mxu_tile=64,
)

#: H100 SXM5 float32 FLOP/s on the CUDA cores (FFMA, outside the tensor
#: cores; TF32 is not float32)
H100_PEAK_F32_FLOPS = 66.9e12

#: the reference's TPU v5e spec (``repro.roofline.hw.V5E``), kept only as
#: the machine-model constant its collective planner prices: ICI 50 GB/s a
#: link, DCN 6.25 GB/s a chip. Not a reading of this or any card
V5E = HwSpec(
    name="tpu-v5e",
    peak_bf16_flops=197e12,
    hbm_bw=819e9,
    hbm_bytes=16 * 2 ** 30,
    ici_link_bw=50e9,
    ici_links=4,
    dcn_bw=6.25e9,   # ~50 Gb/s effective per-chip cross-pod budget
    vmem_bytes=128 * 2 ** 20,
    mxu_tile=128,
)
