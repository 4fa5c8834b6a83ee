"""Core layers: norms, RoPE, MLPs, embeddings — functions over dicts of tensors.

Counterpart of ``repro.models.layers``: the decode path's share of it,
for training ``softmax_xent`` and the chunked ``lm_loss``, and Mamba-2's
``rmsnorm_gated``.
Parameters are nested dicts of tensors; init functions mirror apply
functions. Weights are drawn from an explicit CPU ``torch.Generator`` in
float32 and then moved, so one seed gives the same weights on every device.
A generator on the card draws there instead (a full-width expert stack is
billions of draws, too slow for the host's one stream). ``device="meta"``
gives the shapes and dtypes without drawing anything (the counterpart of
``jax.eval_shape``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.config import ArchConfig


def dtype_of(cfg: ArchConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


# ----------------------------------------------------------------- init utils
def dense_init(gen: torch.Generator, shape, dtype, device: torch.device,
               scale: float | None = None) -> torch.Tensor:
    if device.type == "meta":
        return torch.empty(shape, dtype=dtype, device=device)
    fan_in = shape[0] if len(shape) >= 2 else 1
    scale = scale if scale is not None else fan_in ** -0.5
    if gen.device.type == "cpu":
        w = torch.randn(shape, generator=gen, dtype=torch.float32) * scale
        return w.to(device=device, dtype=dtype)
    # drawn on the generator's device in float32 slices along dim 0, each
    # rounded into the leaf, so no float32 copy of a whole leaf exists
    w = torch.empty(shape, dtype=dtype, device=device)
    rows = w.view(shape[0], -1) if len(shape) >= 2 else w.view(1, -1)
    step = max(1, (1 << 28) // max(rows.shape[1], 1))
    for i in range(0, rows.shape[0], step):
        part = torch.randn(rows[i:i + step].shape, generator=gen,
                           dtype=torch.float32, device=gen.device)
        rows[i:i + step] = (part * scale).to(device=device, dtype=dtype)
    return w


# ---------------------------------------------------------------------- norms
def init_norm(cfg: ArchConfig, d: int, device: torch.device) -> dict:
    # norm parameters stay float32 whatever the model dtype, as in the reference
    p = {"scale": torch.ones((d,), dtype=torch.float32, device=device)}
    if cfg.norm == "layernorm":
        p["bias"] = torch.zeros((d,), dtype=torch.float32, device=device)
    return p


def apply_norm(p: dict, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    xf = x.float()
    if cfg.norm == "layernorm":
        mu = xf.mean(dim=-1, keepdim=True)
        var = (xf - mu).square().mean(dim=-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + 1e-5) * p["scale"] + p["bias"]
    else:
        var = xf.square().mean(dim=-1, keepdim=True)
        y = xf * torch.rsqrt(var + 1e-6) * p["scale"]
    return y.to(x.dtype)


def rmsnorm_gated(scale: torch.Tensor, x: torch.Tensor,
                  gate: torch.Tensor, pctx=None) -> torch.Tensor:
    """Mamba-2 gated RMSNorm: norm(x * silu(gate)) * scale, with the
    reference's casts: the gate's silu in float32, rounded to x's dtype,
    the product widened to float32 for the norm. Under tensor parallelism
    ``x``, ``gate`` and ``scale`` are this rank's channels and the mean of
    squares runs over all of them: the float32 sum of squares is summed
    over ``model`` (both ways: each rank's norm reads the whole sum)."""
    xf = (x * silu(gate.float()).to(x.dtype)).float()
    if tp_active(pctx):
        from repro_torch.parallel.tensor_parallel import (copy_to_model,
                                                          sum_over_model)
        ss = xf.square().sum(dim=-1, keepdim=True)
        var = copy_to_model(sum_over_model(ss, pctx), pctx) / (
            xf.shape[-1] * pctx.tp_size)
    else:
        var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + 1e-6) * scale).to(x.dtype)


# ----------------------------------------------------------------------- RoPE
def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: (..., seq).

    Split-halves rotation (not interleaved), computed in float32."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)             # (hd/2,)
    angles = positions[..., :, None].float() * freqs              # (..., S, hd/2)
    cos = torch.cos(angles)[..., :, None, :]
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ------------------------------------------------------------------------ MLP
def init_mlp(gen, cfg: ArchConfig, d: int, ff: int, device) -> dict:
    dt = dtype_of(cfg)
    p = {}
    if cfg.mlp_gated:
        p["w_gate"] = dense_init(gen, (d, ff), dt, device)
    p["w_up"] = dense_init(gen, (d, ff), dt, device)
    p["w_out"] = dense_init(gen, (ff, d), dt, device)
    if cfg.mlp_bias:
        p["b_up"] = torch.zeros((ff,), dtype=dt, device=device)
        p["b_out"] = torch.zeros((d,), dtype=dt, device=device)
    return p


def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu`` as jax.nn writes it: ``x * (1 / (1 + exp(-x)))``,
    rounding in x's dtype at each op."""
    return x * (1 / (1 + torch.exp(-x)))


def _act(cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu`` / ``jax.nn.gelu`` (tanh form) written out op by op as
    jax.nn writes them, so a bf16 model rounds where the reference rounds
    (``F.silu``/``F.gelu`` round once and differ from it by an ulp on ~40%
    of bf16 elements). jax.nn.gelu's constants enter in x's dtype (a
    weak-typed 0.044715 is rounded to bf16 first), so they are tensors of
    that dtype here: a Python scalar would multiply at float32."""
    if cfg.mlp_act == "silu":
        return silu(x)
    c = torch.tensor((2 / torch.pi) ** 0.5, dtype=x.dtype)
    k = torch.tensor(0.044715, dtype=x.dtype)
    return x * (0.5 * (1.0 + torch.tanh(c * (x + k * (x ** 3)))))


def tp_active(pctx) -> bool:
    """Whether ``pctx`` runs tensor parallelism: a sharded context (see
    :class:`repro_torch.parallel.ctx.ParallelCtx`) with a ``model`` axis of
    more than one rank."""
    return pctx is not None and pctx.sharded and pctx.tp_size > 1


def mlp_tp(ff: int, pctx) -> bool:
    """Whether an MLP of hidden width ``ff`` runs split over ``model``: its
    ``param_spec`` shards ``w_up``'s columns there iff ``ff`` divides."""
    return tp_active(pctx) and ff % pctx.tp_size == 0


def apply_mlp(p: dict, x: torch.Tensor, cfg: ArchConfig, pctx=None,
              ff: int | None = None) -> torch.Tensor:
    """The MLP of ``x``. Under tensor parallelism (``mlp_tp(ff, pctx)``,
    ``ff`` the global hidden width) ``p`` holds this rank's columns of
    ``w_gate``/``w_up``/``b_up`` and rows of ``w_out``: ``x`` enters
    through a copy to ``model`` and the partial ``w_out`` products are
    summed over it before ``b_out``."""
    from repro_torch.parallel.tensor_parallel import (copy_to_model,
                                                      sum_over_model)
    tp = mlp_tp(cfg.d_ff if ff is None else ff, pctx)
    if tp:
        x = copy_to_model(x, pctx)
    up = x @ p["w_up"]
    if cfg.mlp_bias:
        up = up + p["b_up"]
    h = _act(cfg, x @ p["w_gate"]) * up if cfg.mlp_gated else _act(cfg, up)
    out = h @ p["w_out"]
    if tp:
        out = sum_over_model(out, pctx)
    if cfg.mlp_bias:
        out = out + p["b_out"]
    return out


# ----------------------------------------------------------------- embeddings
def init_embedding(gen, cfg: ArchConfig, device) -> dict:
    dt = dtype_of(cfg)
    p = {"tokens": dense_init(gen, (cfg.vocab_size, cfg.d_model), dt, device,
                              scale=0.02)}
    if not cfg.tie_embeddings:
        p["head"] = dense_init(gen, (cfg.d_model, cfg.vocab_size), dt, device)
    if cfg.pos_embedding == "learned":
        # sized as in the reference so its parameters transfer one to one
        p["positions"] = dense_init(gen, (32768 + 8, cfg.d_model), dt, device,
                                    scale=0.02)
    return p


def embed_tokens(p: dict, tokens: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    return p["tokens"][tokens.long()]


def logits(p: dict, h: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """``h @ w`` in the model dtype, then widened to float32."""
    w = p["tokens"].T if cfg.tie_embeddings else p["head"]
    return (h @ w).float()


# --------------------------------------------------------------------- loss
def softmax_xent(logits_: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Stable cross entropy; logits (..., V) f32, labels int (...)."""
    m = torch.amax(logits_, dim=-1, keepdim=True)
    lse = m[..., 0] + torch.log(torch.sum(torch.exp(logits_ - m), dim=-1))
    gold = torch.take_along_dim(logits_, labels.long()[..., None],
                                dim=-1)[..., 0]
    return lse - gold


def _chunk_loss(hc: torch.Tensor, tc: torch.Tensor,
                w: torch.Tensor) -> torch.Tensor:
    lg = (hc @ w).float()
    valid = tc >= 0
    ls = softmax_xent(lg, torch.clamp(tc, min=0))
    return torch.sum(torch.where(valid, ls, 0.0))


def lm_loss(p: dict, h: torch.Tensor, targets: torch.Tensor, cfg: ArchConfig,
            *, chunk: int = 1024) -> torch.Tensor:
    """Mean next-token cross entropy with the head projection fused into a
    loop over sequence chunks, each recomputed in backward
    (``torch.utils.checkpoint``, the reference's ``jax.checkpoint``), so the
    (B, S, V) logits are never materialized; at most one chunk's (B, c, V)
    float32 logits exist at a time.

    h: (B, T, d) hidden states aligned with ``targets`` (B, T): the caller
    has already applied the shift. Pads T to a chunk multiple, with targets
    -1 (ignored) on the padding."""
    w = p["tokens"].T if cfg.tie_embeddings else p["head"]
    B, T, d = h.shape
    # adaptive chunk: cap the transient (B, c, V) f32 logits at ~1 GB
    c = max(64, min(chunk, (1 << 30) // max(1, cfg.vocab_size * 4 * B)))
    c = min(c, T)
    Tp = -(-T // c) * c
    if Tp != T:
        h = F.pad(h, (0, 0, 0, Tp - T))
        targets = F.pad(targets, (0, Tp - T), value=-1)
    tot = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(0, Tp, c):
        tot = tot + checkpoint(_chunk_loss, h[:, i:i + c], targets[:, i:i + c],
                               w, use_reentrant=False)
    n = torch.sum(targets >= 0)
    return tot / torch.clamp(n, min=1)
