"""Attention, decode slice: GQA (+RoPE) with head padding.

Counterpart of ``repro.models.attention`` for one new token against a KV
cache. ``gqa_decode`` routes its attention through
:func:`repro_torch.kernels.flash_decode.ops.decode_attn`: the Hopper kernel
on CUDA tensors, its plain version on CPU tensors. Layouts are the
reference's: ``wq`` (d, H, hd), ``wk``/``wv`` (d, K, hd), ``wo`` (H, hd, d),
caches (B, S, K, hd).
"""

from __future__ import annotations

import torch

from repro_torch.config import ArchConfig
from repro_torch.kernels.flash_decode.ops import decode_attn
from repro_torch.kernels.flash_decode.ref import decode_attention_ref
from repro_torch.models.layers import apply_rope, dense_init, dtype_of


def _pos_vec(pos, B: int, device) -> torch.Tensor:
    """Normalize a scalar or (B,) position into a (B,) int64 vector."""
    p = torch.as_tensor(pos, dtype=torch.int64, device=device)
    return torch.broadcast_to(p.reshape(-1), (B,))


def decode_attention(q, k_cache, v_cache, pos) -> torch.Tensor:
    """Plain version. q: (B,1,H,dk); caches: (B,S,K,d*); attend to
    positions ``<= pos`` (scalar or per-row vector)."""
    B = q.shape[0]
    length = _pos_vec(pos, B, q.device) + 1      # <= pos  ==  < pos + 1
    return decode_attention_ref(q[:, 0], k_cache, v_cache, length)[:, None]


# ------------------------------------------------------------------------ GQA
def _padded_heads(cfg: ArchConfig) -> int:
    if cfg.pad_heads_to is not None and cfg.pad_heads_to > cfg.n_heads:
        return cfg.pad_heads_to
    return cfg.n_heads


def init_gqa(gen, cfg: ArchConfig, d: int, device) -> dict:
    dt = dtype_of(cfg)
    hd = cfg.resolved_head_dim
    Hp = _padded_heads(cfg)
    K = cfg.n_kv_heads
    p = {
        "wq": dense_init(gen, (d, Hp, hd), dt, device, scale=d ** -0.5),
        "wk": dense_init(gen, (d, K, hd), dt, device, scale=d ** -0.5),
        "wv": dense_init(gen, (d, K, hd), dt, device, scale=d ** -0.5),
        "wo": dense_init(gen, (Hp, hd, d), dt, device,
                         scale=(Hp * hd) ** -0.5),
    }
    if Hp != cfg.n_heads:
        # padding heads start at zero and their outputs are masked
        p["wq"][:, cfg.n_heads:, :] = 0
        p["wo"][cfg.n_heads:] = 0
    if cfg.attn_bias:
        p["bq"] = torch.zeros((Hp, hd), dtype=dt, device=device)
        p["bk"] = torch.zeros((K, hd), dtype=dt, device=device)
        p["bv"] = torch.zeros((K, hd), dtype=dt, device=device)
    return p


def _head_mask(cfg: ArchConfig, out: torch.Tensor) -> torch.Tensor:
    Hp = _padded_heads(cfg)
    if Hp == cfg.n_heads:
        return out
    mask = (torch.arange(Hp, device=out.device) < cfg.n_heads).to(out.dtype)
    return out * mask[None, None, :, None]


def gqa_qkv(p: dict, x: torch.Tensor, cfg: ArchConfig, positions) -> tuple:
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"])
    if cfg.attn_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    if cfg.pos_embedding == "rope":
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _write_kv(cache: torch.Tensor, pos_b: torch.Tensor,
              new: torch.Tensor) -> None:
    """cache[b, pos_b[b]] = new[b] in place, dropping rows with pos_b >= S
    (the reference's ``.at[rows, pos].set`` drops out-of-range writes)."""
    S = cache.shape[1]
    rows = torch.arange(cache.shape[0], device=cache.device)
    idx = pos_b.clamp(max=S - 1)
    keep = (pos_b < S)[:, None, None]
    cache[rows, idx] = torch.where(keep, new.to(cache.dtype), cache[rows, idx])


def gqa_decode(p: dict, x: torch.Tensor, cfg: ArchConfig, cache: dict,
               pos) -> tuple[torch.Tensor, dict]:
    """x: (B,1,d); cache k/v: (B,S,K,hd), written IN PLACE at ``pos``
    (scalar or per-row (B,) for slot-based continuous batching); a write at
    ``pos >= S`` is dropped and the row then attends to all of S."""
    B = x.shape[0]
    pos_b = _pos_vec(pos, B, x.device)
    q, k_new, v_new = gqa_qkv(p, x, cfg, pos_b[:, None])
    k, v = cache["k"], cache["v"]
    _write_kv(k, pos_b, k_new[:, 0])
    _write_kv(v, pos_b, v_new[:, 0])
    S, K = k.shape[1], k.shape[2]
    Hp = q.shape[2]
    ka, va = k, v
    if Hp % K != 0:
        r = -(-Hp // K)
        ka = k.repeat_interleave(r, dim=2)[:, :, :Hp].contiguous()
        va = v.repeat_interleave(r, dim=2)[:, :, :Hp].contiguous()
    length = (pos_b + 1).clamp(max=S).to(torch.int32)
    out = decode_attn(q[:, 0], ka, va, length)[:, None]
    out = _head_mask(cfg, out)
    out = torch.einsum("bshk,hkd->bsd", out, p["wo"])
    return out, cache
