"""Plain PyTorch version of decode attention (one query token vs a KV cache).

Counterpart of ``repro.kernels.flash_decode.ref``, with ``length`` either a
scalar or a per-row ``(B,)`` vector. The CPU path of
:func:`repro_torch.kernels.flash_decode.ops.decode_attn` runs it, and the
on-card checks hold the CUDA kernel against it.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


def decode_attention_ref(q, k, v, length=None) -> torch.Tensor:
    """q: (B,H,dk); k: (B,S,K,dk); v: (B,S,K,dv); H % K == 0.

    Attends to positions ``< length`` (default: all of S); ``length`` is a
    scalar or a (B,) vector. Computes in float32, returns q's dtype."""
    B, H, dk = q.shape
    _, S, K, dv = v.shape
    rep = H // K
    qg = q.reshape(B, K, rep, dk).float()
    s = torch.einsum("bgrh,bkgh->bgrk", qg, k.float()) * dk ** -0.5
    if length is not None:
        lim = torch.as_tensor(length, device=q.device).reshape(-1, 1)
        mask = torch.arange(S, device=q.device)[None, :] < lim     # (B|1, S)
        s = torch.where(mask[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bgrk,bkgd->bgrd", p, v.float())
    return out.reshape(B, H, dv).to(q.dtype)
