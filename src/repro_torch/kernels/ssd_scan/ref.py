"""Plain PyTorch version of the Mamba-2 SSD scan: the sequential recurrence.

Counterpart of ``repro.kernels.ssd_scan.ref.ssd_ref``. The CPU path of
:func:`repro_torch.kernels.ssd_scan.ops.ssd` runs it, and the on-card
checks hold the CUDA kernel against it.
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
