"""Combine entry point used by the hierarchical allreduce's reduce stages:
the Hopper kernel on CUDA, the plain version on the CPU.

Counterpart of ``repro.kernels.allreduce_combine.ops``. The device of the
tensor decides: a CPU tensor goes to :func:`ref.combine_ref`, a CUDA tensor
to the kernel, or the call raises. Nothing falls back from the kernel to
the plain version.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.allreduce_combine.kernel import combine
from repro_torch.kernels.allreduce_combine.ref import combine_ref


def combine_parts(stacked: torch.Tensor, *, op: str = "sum") -> torch.Tensor:
    """stacked: (P, L) -> (L,) elementwise sum (f32 accumulation), max or
    min over the P parts; float32, bfloat16 or int32."""
    if stacked.device.type == "cpu":
        return combine_ref(stacked, op)
    if stacked.device.type != "cuda":
        raise ValueError(f"combine_parts runs on cpu or cuda, not "
                         f"{stacked.device}")
    return combine(stacked, op)
