"""Plain PyTorch version of decode attention (one query token vs a KV cache).

Counterpart of ``repro.kernels.flash_decode.ref``, with ``length`` either a
scalar or a per-row ``(B,)`` vector. The CPU path of
:func:`repro_torch.kernels.flash_decode.ops.decode_attn` runs it, and the
on-card checks hold the CUDA kernel against it.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


def decode_attention_ref(q, k, v, length=None, *, lse: bool = False):
    """q: (B,H,dk); k: (B,S,K,dk); v: (B,S,K,dv); H % K == 0.

    Attends to positions ``< length`` (default: all of S); ``length`` is a
    scalar or a (B,) vector. Computes in float32, returns q's dtype. A row
    of length 0 gives zeros, as the kernel does.

    With ``lse``, returns ``(out, lse)``: ``out`` (B,H,dv) in float32 and
    ``lse`` (B,H), each row's natural log-sum-exp of its scaled scores over
    its live positions, -inf for a row of length 0 (the kernel's lse form,
    for merging blocks of one sequence)."""
    B, H, dk = q.shape
    _, S, K, dv = v.shape
    rep = H // K
    qg = q.reshape(B, K, rep, dk).float()
    s = torch.einsum("bgrh,bkgh->bgrk", qg, k.float()) * dk ** -0.5
    live = None
    if length is not None:
        lim = torch.as_tensor(length, device=q.device).reshape(-1, 1)
        mask = torch.arange(S, device=q.device)[None, :] < lim     # (B|1, S)
        s = torch.where(mask[:, None, None, :], s, NEG_INF)
        live = lim > 0                                             # (B|1, 1)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bgrk,bkgd->bgrd", p, v.float()).reshape(B, H, dv)
    if live is not None:
        out = torch.where(live[:, :, None], out, 0.0)
    if not lse:
        return out.to(q.dtype)
    lse_ = torch.logsumexp(s, dim=-1).reshape(B, H)
    if live is not None:
        lse_ = torch.where(live, lse_, -torch.inf)
    return out, lse_
