"""Decode attention entry point: the Hopper kernel on CUDA, the plain
version on the CPU.

Counterpart of ``repro.kernels.flash_decode.ops``. The device of the tensors
decides: a CPU tensor goes to :func:`ref.decode_attention_ref`, a CUDA
tensor to the kernel, or the call raises. Nothing falls back from the
kernel to the plain version.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.flash_decode.kernel import flash_decode
from repro_torch.kernels.flash_decode.ref import decode_attention_ref


def decode_attn(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                length=None) -> torch.Tensor:
    """q: (B,H,dk); caches (B,S,K,d*); attends to positions ``< length``
    (``None``: all of S; an int; or a (B,) tensor with values in [1, S])."""
    if q.device.type == "cpu":
        return decode_attention_ref(q, k, v, length)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attn runs on cpu or cuda, not {q.device}")
    B, S = k.shape[:2]
    if length is None:
        length = S
    lengths = torch.as_tensor(length, dtype=torch.int32, device=q.device)
    lengths = torch.broadcast_to(lengths.reshape(-1), (B,)).contiguous()
    return flash_decode(q, k, v, lengths)


def hbm_bytes(lengths, heads: int, kv_heads: int, dk: int, dv: int,
              dtype_bytes: int = 2) -> int:
    """The least bytes decode attention must move: each live K/V row read
    once, q read once, the output written once, the int32 lengths read."""
    lengths = [int(n) for n in lengths]
    B = len(lengths)
    kv = sum(lengths) * kv_heads * (dk + dv) * dtype_bytes
    return kv + B * heads * (dk + dv) * dtype_bytes + 4 * B
