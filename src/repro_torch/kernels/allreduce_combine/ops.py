"""Combine entry point used by the hierarchical allreduce's reduce stages:
the Hopper kernel on CUDA, the plain version on the CPU.

Counterpart of ``repro.kernels.allreduce_combine.ops``. The device of the
tensor decides: a CPU tensor goes to :func:`ref.combine_ref`, a CUDA tensor
to the kernel, a meta tensor to the kernel's custom op
``repro_torch::combine`` (its output shape, FLOPs and bytes, for the dry
run; :mod:`repro_torch.kernels._meta`), or the call raises. Nothing falls
back from the kernel to the plain version.
"""

from __future__ import annotations

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels._meta import KERNEL_BYTES, meta_only
from repro_torch.kernels.allreduce_combine.kernel import combine
from repro_torch.kernels.allreduce_combine.ref import check_args, combine_ref


def combine_cost(P: int, L: int, elem_bytes: int) -> tuple[int, int]:
    """(bytes, operations) of one combine: the P parts read once and the
    output written once; one add (or comparison) per element of each part
    after the first."""
    return (P + 1) * L * elem_bytes, (P - 1) * L


@torch.library.custom_op("repro_torch::combine", mutates_args=())
def combine_meta(stacked: torch.Tensor, op: str) -> torch.Tensor:
    return meta_only("combine")(stacked, op)


@combine_meta.register_fake
def _(stacked, op):
    check_args(stacked, op)
    return stacked.new_empty(stacked.shape[1:])


@register_flop_formula(torch.ops.repro_torch.combine)
def _(stacked_shape, op, *args, out_shape=None, **kwargs) -> int:
    return stacked_shape[0] * stacked_shape[1] - stacked_shape[1]


KERNEL_BYTES[torch.ops.repro_torch.combine.default] = \
    lambda stacked, op: combine_cost(*stacked.shape,
                                     stacked.element_size())[0]


def combine_parts(stacked: torch.Tensor, *, op: str = "sum") -> torch.Tensor:
    """stacked: (P, L) -> (L,) elementwise sum (f32 accumulation), max or
    min over the P parts; float32, bfloat16 or int32."""
    if stacked.device.type == "cpu":
        return combine_ref(stacked, op)
    if stacked.device.type == "meta":
        return torch.ops.repro_torch.combine(stacked, op)
    if stacked.device.type != "cuda":
        raise ValueError(f"combine_parts runs on cpu, cuda or meta, not "
                         f"{stacked.device}")
    return combine(stacked, op)
