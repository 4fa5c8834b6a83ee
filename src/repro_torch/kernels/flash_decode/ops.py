"""Decode attention entry point: the Hopper kernel on CUDA, the plain
version on the CPU.

Counterpart of ``repro.kernels.flash_decode.ops``. The device of the tensors
decides: a CPU tensor goes to :func:`ref.decode_attention_ref`, a CUDA
tensor to the kernel, a meta tensor to the kernel's custom op
``repro_torch::flash_decode`` (``repro_torch::flash_decode_lse`` for the
log-sum-exp form; for the dry run, :mod:`repro_torch.kernels._meta`), or
the call raises. Nothing falls back
from the kernel to the plain version.
"""

from __future__ import annotations

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels._meta import KERNEL_BYTES, meta_only
from repro_torch.kernels.flash_decode.kernel import (_DTYPE_CODE, HEAD_DIMS,
                                                     flash_decode)
from repro_torch.kernels.flash_decode.ref import decode_attention_ref


@torch.library.custom_op("repro_torch::flash_decode", mutates_args=())
def flash_decode_meta(q: torch.Tensor, k: torch.Tensor,
                      v: torch.Tensor) -> torch.Tensor:
    return meta_only("flash_decode")(q, k, v)


def _check_meta(q, k, v) -> None:
    B, H, dk = q.shape
    _, S, K, dv = v.shape
    if k.shape[:3] != v.shape[:3] or k.shape[0] != B or k.shape[3] != dk \
            or H % K:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    if (dk, dv) not in HEAD_DIMS:
        raise ValueError(f"(dk, dv)=({dk}, {dv}) not in {HEAD_DIMS}")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"dtypes q {q.dtype}, k {k.dtype}, v {v.dtype}: "
                         "need all float32 or all bfloat16")


@flash_decode_meta.register_fake
def _(q, k, v):
    _check_meta(q, k, v)
    return q.new_empty(q.shape[:2] + (v.shape[3],))


@torch.library.custom_op("repro_torch::flash_decode_lse", mutates_args=())
def flash_decode_lse_meta(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor) -> tuple[torch.Tensor,
                                                    torch.Tensor]:
    return meta_only("flash_decode_lse")(q, k, v)


@flash_decode_lse_meta.register_fake
def _(q, k, v):
    _check_meta(q, k, v)
    f32 = torch.float32
    return (q.new_empty(q.shape[:2] + (v.shape[3],), dtype=f32),
            q.new_empty(q.shape[:2], dtype=f32))


def decode_flops(lengths, heads: int, dk: int, dv: int) -> int:
    """The kernel's products: each head's query against each live key
    (``dk`` multiply-adds) and its probability times the value (``dv``),
    2 per multiply-add. The softmax's exponentials are not counted."""
    return 2 * sum(int(n) for n in lengths) * heads * (dk + dv)


@register_flop_formula([torch.ops.repro_torch.flash_decode,
                        torch.ops.repro_torch.flash_decode_lse])
def _(q_shape, k_shape, v_shape, *args, out_shape=None, **kwargs) -> int:
    B, H, dk = q_shape
    return decode_flops([k_shape[1]] * B, H, dk, v_shape[3])


for _op, _lse in ((torch.ops.repro_torch.flash_decode, False),
                  (torch.ops.repro_torch.flash_decode_lse, True)):
    KERNEL_BYTES[_op.default] = (
        lambda q, k, v, lse=_lse: hbm_bytes(
            [k.shape[1]] * q.shape[0], q.shape[1], k.shape[2], q.shape[2],
            v.shape[3], q.element_size(), lse=lse))


def decode_attn(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                length=None, *, lse: bool = False):
    """q: (B,H,dk); caches (B,S,K,d*); attends to positions ``< length``
    (``None``: all of S; an int; or a (B,) tensor with values in [1, S]).
    On ``meta`` every row is reckoned at all of S: the dry run decodes the
    token after a full cache, and a meta tensor holds no lengths.

    With ``lse``, lengths in [0, S], and returns ``(out, lse)``: ``out``
    (B,H,dv) in float32 and each row's log-sum-exp (B,H) float32 (-inf,
    and ``out`` 0, for a row of length 0), for a merge of the blocks of a
    sequence split across ranks (the kernel's lse form; its plain
    version on the CPU)."""
    if q.device.type == "cpu":
        return decode_attention_ref(q, k, v, length, lse=lse)
    if q.device.type == "meta":
        if lse:
            return torch.ops.repro_torch.flash_decode_lse(q, k, v)
        return torch.ops.repro_torch.flash_decode(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attn runs on cpu, cuda or meta, not "
                         f"{q.device}")
    B, S = k.shape[:2]
    if length is None:
        length = S
    lengths = torch.as_tensor(length, dtype=torch.int32, device=q.device)
    lengths = torch.broadcast_to(lengths.reshape(-1), (B,)).contiguous()
    return flash_decode(q, k, v, lengths, lse=lse)


def hbm_bytes(lengths, heads: int, kv_heads: int, dk: int, dv: int,
              dtype_bytes: int = 2, lse: bool = False) -> int:
    """The least bytes decode attention must move: each live K/V row read
    once, q read once, the output written once, the int32 lengths read;
    with ``lse`` the output in float32 and each row's f32 log-sum-exp."""
    lengths = [int(n) for n in lengths]
    B = len(lengths)
    kv = sum(lengths) * kv_heads * (dk + dv) * dtype_bytes
    out = B * heads * ((4 * dv + 4) if lse else dv * dtype_bytes)
    return kv + B * heads * dk * dtype_bytes + out + 4 * B
