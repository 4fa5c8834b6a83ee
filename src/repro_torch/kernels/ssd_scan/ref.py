"""Plain PyTorch versions of the Mamba-2 SSD scan.

:func:`ssd_ref`, the sequential recurrence, is the counterpart of
``repro.kernels.ssd_scan.ref.ssd_ref``: the CPU path of
:func:`repro_torch.kernels.ssd_scan.ops.ssd` runs it, and the on-card checks
hold both variants of the CUDA kernel against it (``ffma`` at the
reference's float32 tolerance, ``mma_sync`` at its bf16 one).
:func:`ssd_chunked_tc` is the plain version of the ``mma_sync`` variant's
rounding contract, which the on-card checks hold that variant to tightly.
"""

from __future__ import annotations

import torch


def ssd_ref(x, dt, A, B, C):
    """Sequential SSD recurrence (exact semantics of the chunked dual form).

    x: (b,l,h,p); dt: (b,l,h) f32 post-softplus; A: (h,) f32 (<0);
    B, C: (b,l,g,n) with h % g == 0.
    Returns (y: (b,l,h,p) f32, final_state: (b,h,p,n) f32)."""
    b, l, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    rep = h // g
    Bf = B.float().repeat_interleave(rep, dim=2)          # (b,l,h,n)
    Cf = C.float().repeat_interleave(rep, dim=2)
    xf = x.float()
    dt = dt.float()
    A = A.float()
    state = torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(l):
        dA = torch.exp(dt[:, t] * A)                       # (b,h)
        xdt = xf[:, t] * dt[:, t][..., None]               # (b,h,p)
        state = state * dA[..., None, None] + \
            torch.einsum("bhn,bhp->bhpn", Bf[:, t], xdt)
        ys.append(torch.einsum("bhn,bhpn->bhp", Cf[:, t], state))
    return torch.stack(ys, dim=1), state


def _bf16(t):
    """``t`` rounded to bfloat16, then widened to float32."""
    return t.to(torch.bfloat16).float()


def ssd_chunked_tc(x, dt, A, B, C, chunk: int):
    """The chunked dual form as the ``mma_sync`` variant rounds it.

    x: (b,l,h,p) bf16; dt: (b,l,h) f32; A: (h,) f32; B, C: (b,l,1,n) bf16;
    ``l % chunk == 0``. Returns (y (b,l,h,p) f32, final_state (b,h,p,n)
    f32). Every product takes bf16 operands and sums in float32, as a
    tensor core does:

    * C·Bᵀ from the bf16 C and B;
    * y_diag: M = bf16(CB · exp(cs_i − cs_j)) for j ≤ i, times
      xdt = bf16(x · dt);
    * chunk states: Bᵀ times bf16(bf16(exp(cs_end − cs_j)) · xdt). The
      model's ``ssd_chunked`` multiplies B, the decay and xdt in float32:
      this is one rounding more, because the decay cannot be factored out
      of the sum over the chunk;
    * y_off: bf16(exp(cs_i)) times C·bf16(state_in)ᵀ (the decay factors out
      of the sum over n: the same roundings as the model);
    * the carry stays float32 across chunks; only the entering state that
      y_off reads is rounded."""
    b, l, h, p = x.shape
    n = B.shape[-1]
    nc = l // chunk
    xc = x.reshape(b, nc, chunk, h, p).float()
    dtc = dt.reshape(b, nc, chunk, h).float()
    Bc = B.reshape(b, nc, chunk, n).float()
    Cc = C.reshape(b, nc, chunk, n).float()
    cs = torch.cumsum(dtc * A.float(), dim=2)                  # (b,nc,c,h)
    CB = torch.einsum("bzcn,bzsn->bzcs", Cc, Bc)
    seg = cs[:, :, :, None, :] - cs[:, :, None, :, :]         # (b,nc,c,s,h)
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=x.device))[..., None]
    M = _bf16(torch.where(tri, CB[..., None] * torch.exp(
        torch.where(tri, seg, 0.0)), 0.0))
    xdt = _bf16(xc * dtc[..., None])                          # (b,nc,c,h,p)
    y_diag = torch.einsum("bzcsh,bzshp->bzchp", M, xdt)
    U = _bf16(_bf16(torch.exp(cs[:, :, -1:] - cs))[..., None] * xdt)
    contrib = torch.einsum("bzsn,bzshp->bzhpn", Bc, U)
    chunk_decay = torch.exp(cs[:, :, -1])                     # (b,nc,h)
    carry = torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
    prev = []
    for z in range(nc):
        prev.append(_bf16(carry))
        carry = carry * chunk_decay[:, z, :, None, None] + contrib[:, z]
    y_off = torch.einsum("bzcn,bzhpn->bzchp", Cc, torch.stack(prev, dim=1))
    y = y_diag + y_off * _bf16(torch.exp(cs))[..., None]
    return y.reshape(b, l, h, p), carry
