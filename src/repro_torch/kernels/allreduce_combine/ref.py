"""Plain PyTorch version of the multi-operand combine (allreduce arithmetic).

Counterpart of ``repro.kernels.allreduce_combine.ref.combine_ref``. The CPU
path of :func:`repro_torch.kernels.allreduce_combine.ops.combine_parts`
runs it, and the on-card checks hold the CUDA kernel against it. The sum
adds the parts in order 0..P-1 in float32, as the kernel does, so the two
agree bit for bit.
"""

from __future__ import annotations

import torch

#: dtypes the combine takes (the reference's test sweep)
DTYPES = (torch.float32, torch.bfloat16, torch.int32)
OPS = ("sum", "max", "min")


def check_args(stacked: torch.Tensor, op: str) -> None:
    if op not in OPS:
        raise ValueError(f"op must be one of {OPS}, got {op!r}")
    if stacked.dtype not in DTYPES:
        raise TypeError(f"combine takes {DTYPES}, got {stacked.dtype}")
    if stacked.dim() != 2:
        raise ValueError(f"stacked must be (P, L), got {tuple(stacked.shape)}")
    if stacked.shape[0] < 1:
        raise ValueError("stacked needs at least one part")


def combine_ref(stacked: torch.Tensor, op: str = "sum") -> torch.Tensor:
    """stacked: (P, L) -> (L,). Sum accumulates in float32 (int32 too,
    through float32 as the reference does: exact below 2^24) and casts back;
    max/min reduce in the native dtype and propagate NaN."""
    check_args(stacked, op)
    if op == "sum":
        acc = stacked[0].float()
        for p in range(1, stacked.shape[0]):
            acc = acc + stacked[p].float()
        return acc.to(stacked.dtype)
    if op == "max":
        return torch.amax(stacked, dim=0)
    return torch.amin(stacked, dim=0)
