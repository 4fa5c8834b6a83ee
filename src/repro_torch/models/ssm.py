"""Mamba-2 SSD (state-space duality) block — arXiv:2405.21060.

Counterpart of ``repro.models.ssm``. Train and prefill use the chunked dual
form; decode is the O(1)-state recurrent update. ``mamba2_forward`` reaches
the SSD through :class:`SSDFunction`: on CUDA its forward pass launches the
hand-written ``ssd_scan`` kernel (bf16 inputs: products on the tensor
cores, rounded to bf16 where :func:`ssd_chunked` rounds plus once more in
the chunk states; float32 inputs: float32 products throughout), on the CPU
it runs :func:`ssd_chunked`, which rounds to the model dtype where the
reference rounds. Its backward pass recomputes the chunked dual form in
float32 and differentiates that, on both devices.

On a sharded context the block runs split over ``model`` as the
reference's ``param_specs`` lay it out: a rank holds its
heads' columns of ``wz``/``wx``/``wdt``, ``conv_x`` and ``norm_scale``,
their ``A_log``/``D``/``dt_bias`` and rows of ``out_proj``, and a block of
``d_state`` of ``wB``/``wC`` and their convs. B and C are convolved on the
rank's ``d_state`` block and then gathered whole over ``model``, so the SSD
runs unchanged on the rank's heads with all of ``d_state`` and the state
keeps the reference's layout, (B, h/tp, p, n); the gated norm's mean of
squares and ``out_proj``'s product are sums over ``model``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.config import ArchConfig
from repro_torch.kernels.ssd_scan.ops import ssd as ssd_kernel
from repro_torch.models.layers import (dense_init, dtype_of, rmsnorm_gated,
                                       silu, tp_active)
from repro_torch.parallel.tensor_parallel import (copy_to_model,
                                                  gather_over_model,
                                                  sum_over_model)


def _dims(cfg: ArchConfig):
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    nh = d_in // s.head_dim
    conv_ch = d_in + 2 * s.n_groups * s.d_state
    return s, d_in, nh, conv_ch


def init_mamba2(gen: torch.Generator, cfg: ArchConfig, device) -> dict:
    """The reference's per-role projections (z/x/B/C/dt: a column partition
    of the canonical fused ``in_proj``), with its leaf names and shapes."""
    s, d_in, nh, conv_ch = _dims(cfg)
    dt = dtype_of(cfg)
    d = cfg.d_model
    gn = s.n_groups * s.d_state

    def const(shape, value, dtype):
        return torch.full(shape, value, dtype=dtype, device=device)

    return {
        "wz": dense_init(gen, (d, d_in), dt, device),
        "wx": dense_init(gen, (d, d_in), dt, device),
        "wB": dense_init(gen, (d, gn), dt, device),
        "wC": dense_init(gen, (d, gn), dt, device),
        "wdt": dense_init(gen, (d, nh), dt, device),
        "conv_x": dense_init(gen, (s.d_conv, d_in), dt, device, scale=0.3),
        "conv_B": dense_init(gen, (s.d_conv, gn), dt, device, scale=0.3),
        "conv_C": dense_init(gen, (s.d_conv, gn), dt, device, scale=0.3),
        "conv_bx": const((d_in,), 0.0, dt),
        "conv_bB": const((gn,), 0.0, dt),
        "conv_bC": const((gn,), 0.0, dt),
        "A_log": const((nh,), 0.0, torch.float32),
        "D": const((nh,), 1.0, torch.float32),
        "dt_bias": const((nh,), 0.0, torch.float32),
        "norm_scale": const((d_in,), 1.0, torch.float32),
        "out_proj": dense_init(gen, (d_in, d), dt, device),
    }


def _causal_conv(xBC, conv_w, conv_b, prev=None):
    """Depthwise causal conv along seq. xBC: (B,L,C); conv_w: (W,C).
    ``prev``: (B,W-1,C) left context (decode/streaming). Returns the
    activation and the last W-1 inputs (the next call's ``prev``)."""
    W = conv_w.shape[0]
    L = xBC.shape[1]
    if prev is None:
        prev = xBC.new_zeros((xBC.shape[0], W - 1) + tuple(xBC.shape[2:]))
    xp = torch.cat([prev, xBC], dim=1)
    out = xp[:, 0:L] * conv_w[0]
    for i in range(1, W):
        out = out + xp[:, i:i + L] * conv_w[i]
    # a copy, not a view: a view would keep all of xp alive with the state
    return silu(out + conv_b), xp[:, -(W - 1):].clone()


def _project(p, x, cfg, conv_prev=None, pctx=None):
    """Input projections + causal depthwise convs on x/B/C. Returns (z, xi,
    B, C, dt_raw, conv_state). Under tensor parallelism (``pctx``) ``x``
    enters the rank's columns through a copy to ``model``, and B and C,
    convolved on the rank's ``d_state`` block, are gathered whole over
    ``model``; the conv state keeps the block."""
    if pctx is not None:
        x = copy_to_model(x, pctx)
    z = x @ p["wz"]
    xc = x @ p["wx"]
    Bc = x @ p["wB"]
    Cc = x @ p["wC"]
    dtr = x @ p["wdt"]
    prev = (None, None, None) if conv_prev is None else conv_prev
    xc, sx = _causal_conv(xc, p["conv_x"], p["conv_bx"], prev[0])
    Bc, sB = _causal_conv(Bc, p["conv_B"], p["conv_bB"], prev[1])
    Cc, sC = _causal_conv(Cc, p["conv_C"], p["conv_bC"], prev[2])
    if pctx is not None:
        Bc, Cc = (gather_over_model(t, -1, pctx) for t in (Bc, Cc))
    return z, xc, Bc, Cc, dtr, (sx, sB, sC)


def _local(cfg: ArchConfig, p: dict, pctx) -> tuple[int, int]:
    """(d_inner, heads) of this rank's block. Under tensor parallelism the
    reference's ``param_spec`` splits the heads (``wx``/``wz``/``wdt``
    columns, the per-head vectors, ``out_proj`` rows) and ``d_state``
    (``wB``/``wC`` and their convs) over ``model`` where they divide; the
    port runs the block split and needs both to."""
    s, d_in, nh, _ = _dims(cfg)
    if not tp_active(pctx):
        return d_in, nh
    tp, gn = pctx.tp_size, s.n_groups * s.d_state
    if p["wx"].shape[1] * tp != d_in or p["wB"].shape[1] * tp != gn:
        raise ValueError(f"{cfg.name}: {nh} heads and d_state {gn} must "
                         f"both split over {tp} '{pctx.tp_axis}' ranks; this "
                         f"rank holds {tuple(p['wx'].shape)} of wx and "
                         f"{tuple(p['wB'].shape)} of wB")
    return d_in // tp, nh // tp


def _segsum(x):
    """x: (..., T) -> (..., T, T) with out[i, j] = sum_{k=j+1..i} x[k] for
    j <= i (0 on the diagonal), -inf above the diagonal."""
    T = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    ss = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((T, T), dtype=torch.bool, device=x.device))
    return torch.where(mask, ss, -torch.inf)


def _softplus(x):
    """``jax.nn.softplus`` as it is written: ``logaddexp(x, 0)``."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _wide(t, dtype):
    """``t`` rounded to ``dtype``, then widened to float32: an einsum operand
    of the reference's ``preferred_element_type=float32`` products."""
    return t.to(dtype).float()


def ssd_chunked(x, dt, A, B, C, chunk: int):
    """SSD dual form.

    x: (b,l,h,p) inputs; dt: (b,l,h) f32 (post-softplus); A: (h,) f32 (<0);
    B, C: (b,l,g,n). Returns (y: (b,l,h,p) f32, final_state: (b,h,p,n)).
    M, x·dt, B, the decay factors and the entering states round to x's
    dtype before their products, which accumulate in float32, as in the
    reference."""
    b, l, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    l_orig = l
    if l % chunk != 0:
        # pad with dt=0 steps: dA=0 (no decay) and no input contribution,
        # so the final state is exact and padded outputs are dropped.
        pad = chunk - l % chunk
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, 0, 0, pad))
        l += pad
    nc = l // chunk
    rep = h // g
    xd = x.dtype

    xc = x.reshape(b, nc, chunk, h, p)
    dtc = dt.reshape(b, nc, chunk, h)
    Bc = B.reshape(b, nc, chunk, g, n)
    Cc = C.reshape(b, nc, chunk, g, n)
    dA = dtc * A                                          # (b,nc,c,h)

    # within-chunk (quadratic) term
    L = torch.exp(_segsum(dA.movedim(-1, -2)))            # (b,nc,h,c,c)
    CB = torch.einsum("bzcgn,bzsgn->bzgcs", Cc.float(), Bc.float())
    if rep > 1:
        CB = CB.repeat_interleave(rep, dim=2)             # (b,nc,h,c,s)
    M = CB * torch.where(torch.isfinite(L), L, 0.0)
    xdt = xc.float() * dtc[..., None]
    y_diag = torch.einsum("bzhcs,bzshp->bzchp", _wide(M, xd), _wide(xdt, xd))

    # chunk states
    dA_cum = torch.cumsum(dA, dim=2)                      # (b,nc,c,h)
    decay_states = torch.exp(dA_cum[:, :, -1:, :] - dA_cum)
    states = torch.einsum("bzcgn,bzch,bzchp->bzhpn", _wide(Bc, xd),
                          _wide(decay_states, xd), _wide(xdt, xd))

    # inter-chunk recurrence over nc, emitting the state *entering* each chunk
    chunk_decay = torch.exp(dA_cum[:, :, -1, :])          # (b,nc,h)
    carry = torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
    prev = []
    for z in range(nc):
        prev.append(carry)
        carry = carry * chunk_decay[:, z, :, None, None] + states[:, z]
    prev_states = torch.stack(prev, dim=1)                # (b,nc,h,p,n)

    # contribution of the entering state to each position
    state_decay = torch.exp(dA_cum)                       # (b,nc,c,h)
    y_off = torch.einsum("bzcgn,bzch,bzhpn->bzchp", _wide(Cc, xd),
                         _wide(state_decay, xd), _wide(prev_states, xd))
    y = (y_diag + y_off).reshape(b, l, h, p)
    return y[:, :l_orig], carry


class SSDFunction(torch.autograd.Function):
    """The SSD of one layer: ``(y, final_state) = ssd(x, dt, A, B, C)``.

    Forward: on CUDA the ``ssd_scan`` kernel (its ``mma_sync`` variant for
    bf16 inputs, bf16 products on the tensor cores rounded as
    ``kernels.ssd_scan.ref.ssd_chunked_tc`` rounds; its ``ffma`` variant,
    float32 products, for float32 inputs; the sequence is padded to a chunk
    multiple with dt = 0 steps, as :func:`ssd_chunked` pads, and the padded
    outputs dropped); on the CPU
    :func:`ssd_chunked`, the reference model's own form. Backward, on both
    devices: the chunked dual form recomputed in float32 and differentiated
    (the reference has no backward kernel either: XLA differentiates its
    jnp form). A hand-written backward kernel is later work (ROADMAP.md)."""

    @staticmethod
    def forward(ctx, x, dt, A, B, C, chunk: int):
        ctx.chunk = chunk
        ctx.save_for_backward(x, dt, A, B, C)
        ctx.set_materialize_grads(False)
        if x.device.type in ("cuda", "meta"):
            # meta: the kernel's custom op, as the dry run traces the card
            return _ssd_on_card(x, dt, A, B, C, chunk)
        return ssd_chunked(x, dt, A, B, C, chunk)

    @staticmethod
    def backward(ctx, gy, gfinal):
        x, dt, A, B, C = ctx.saved_tensors
        ins = [t.detach().float().requires_grad_(True)
               for t in (x, dt, A, B, C)]
        with torch.enable_grad():
            y, final = ssd_chunked(*ins, ctx.chunk)
            outs, grads = [], []
            if gy is not None:
                outs.append(y)
                grads.append(gy.float())
            if gfinal is not None:
                outs.append(final)
                grads.append(gfinal.float())
            if not outs:
                return None, None, None, None, None, None
            got = torch.autograd.grad(outs, ins, grads, allow_unused=True,
                                      materialize_grads=True)
        return (*(g.to(t.dtype) for g, t in zip(got, (x, dt, A, B, C))),
                None)


def _ssd_on_card(x, dt, A, B, C, chunk: int):
    if B.shape[2] != 1:
        raise ValueError(f"the ssd_scan kernel takes n_groups=1, got "
                         f"{B.shape[2]}")
    l = x.shape[1]
    pad = -l % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, 0, 0, pad))
    y, final = ssd_kernel(x.contiguous(), dt.contiguous(), A.contiguous(),
                          B.contiguous(), C.contiguous(), chunk=chunk)
    return (y[:, :l] if pad else y), final


def ssd(x, dt, A, B, C, chunk: int):
    """The model's SSD route (see :class:`SSDFunction`)."""
    return SSDFunction.apply(x, dt, A, B, C, chunk)


def mamba2_forward(p: dict, x: torch.Tensor, cfg: ArchConfig, pctx=None
                   ) -> tuple[torch.Tensor, dict]:
    """Full-sequence SSD. x: (B,L,d). Returns (y, state) where state =
    {conv: (sx, sB, sC) each (B,W-1,C), ssm: (B,h,p,n)} for streaming
    continuation. On a sharded context ``p`` holds this rank's blocks and
    the state is this rank's block of it, as ``cache_specs`` lays it
    out."""
    tpc = pctx if tp_active(pctx) else None
    s = cfg.ssm
    d_in, nh = _local(cfg, p, tpc)
    Bsz, L = x.shape[0], x.shape[1]
    z, xc, Bc, Cc, dtr, conv_state = _project(p, x, cfg, pctx=tpc)
    xi = xc.reshape(Bsz, L, nh, s.head_dim)
    B_ = Bc.reshape(Bsz, L, s.n_groups, s.d_state)
    C_ = Cc.reshape(Bsz, L, s.n_groups, s.d_state)
    dt = _softplus(dtr.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    y, ssm_state = ssd(xi, dt, A, B_, C_, s.chunk)
    y = y + xi.float() * p["D"][:, None]
    y = y.reshape(Bsz, L, d_in).to(x.dtype)
    y = rmsnorm_gated(p["norm_scale"], y, z, tpc)
    y = y @ p["out_proj"]
    if tpc is not None:
        y = sum_over_model(y, tpc)
    return y, {"conv": conv_state, "ssm": ssm_state}


def mamba2_decode(p: dict, x: torch.Tensor, cfg: ArchConfig, state: dict,
                  pctx=None) -> tuple[torch.Tensor, dict]:
    """Single-token recurrent update. x: (B,1,d). On a sharded context
    ``p`` and ``state`` are this rank's blocks, as :func:`mamba2_forward`
    leaves them, and so is the new state."""
    tpc = pctx if tp_active(pctx) else None
    s = cfg.ssm
    d_in, nh = _local(cfg, p, tpc)
    B1 = x.shape[0]
    z, xc, Bc, Cc, dtr, conv_state = _project(p, x, cfg,
                                              conv_prev=state["conv"],
                                              pctx=tpc)
    xi = xc.reshape(B1, nh, s.head_dim)
    rep = nh // s.n_groups
    B_ = Bc.reshape(B1, s.n_groups, s.d_state).repeat_interleave(rep, dim=1)
    C_ = Cc.reshape(B1, s.n_groups, s.d_state).repeat_interleave(rep, dim=1)
    dt = _softplus(dtr.float() + p["dt_bias"])[:, 0]    # (B,h)
    A = -torch.exp(p["A_log"])
    dA = torch.exp(dt * A)                                # (B,h)
    xdt = xi.float() * dt[..., None]                      # (B,h,p)
    new_state = state["ssm"] * dA[..., None, None] + \
        torch.einsum("bhn,bhp->bhpn", B_.float(), xdt)
    y = torch.einsum("bhn,bhpn->bhp", C_.float(), new_state)
    y = y + xi.float() * p["D"][:, None]
    y = y.reshape(B1, 1, d_in).to(x.dtype)
    y = rmsnorm_gated(p["norm_scale"], y, z, tpc)
    y = y @ p["out_proj"]
    if tpc is not None:
        y = sum_over_model(y, tpc)
    return y, {"conv": conv_state, "ssm": new_state}
