"""Attention: GQA (+RoPE) with head padding and DeepSeek MLA, for decode
and for training.

Counterpart of ``repro.models.attention``. ``gqa_decode`` takes one new
token against a KV cache and routes its attention through
:func:`repro_torch.kernels.flash_decode.ops.decode_attn`: the Hopper kernel
on CUDA tensors, its plain version on CPU tensors. ``gqa_attention`` runs a
full sequence (train and prefill) through ``flash_attention``, the
reference's double-chunked online softmax with its custom backward, in
plain PyTorch: the reference computes it outside any Pallas kernel. Layouts
are the reference's: ``wq`` (d, H, hd), ``wk``/``wv`` (d, K, hd), ``wo``
(H, hd, d), caches (B, S, K, hd).

Whisper's cross-attention keeps an ``init_gqa`` tree: ``cross_attention``
runs the decoder's full sequence against the encoder output through the
same non-causal ``flash_attention``, and ``cross_decode`` one token against
the whole cross cache through ``decode_attn``.

MLA (latent-compressed attention, arXiv:2412.19437) runs its expanded form
through the same ``flash_attention`` for train and prefill, and its
*absorbed* form for decode, so the cache stays (kv_lora + rope) wide per
token: ``{"c_kv": (B, S, kv_lora), "k_rope": (B, S, rope)}``. The absorbed
decode is the reference's float32 einsums in torch ops, no kernel: the
reference has none there either. Under tensor parallelism every family's
attention runs on this rank's heads: GQA's self-attention, whisper's
cross-attention (its K/V from the replicated encoder output) and MLA,
whose absorbed decode keeps the latent split over ``model`` as
``cache_specs`` lays it out.

Where ``cache_specs`` splits a decode cache's sequence over ``data`` (a
batch that does not divide the batch axes: the reference's ``long_500k``,
batch 1; :meth:`ParallelCtx.kv_seq_block` reads the rule from the
context's ``decode_shape``), the rank whose block holds ``pos`` writes the
new K/V (or latent and rope key), every rank attends its block (GQA
through ``decode_attn``'s log-sum-exp form, MLA by its float32 scores),
and :func:`~repro_torch.parallel.tensor_parallel.merge_softmax` merges the
parts over ``data``: what the reference's GSPMD computes from the same
layout.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.config import ArchConfig
from repro_torch.kernels.flash_decode.ops import decode_attn
from repro_torch.kernels.flash_decode.ref import NEG_INF, decode_attention_ref
from repro_torch.models.layers import (apply_norm, apply_rope, dense_init,
                                       dtype_of, init_norm, tp_active)
from repro_torch.parallel.sharding import Sharding
from repro_torch.core.collectives import tagged
from repro_torch.parallel.tensor_parallel import (copy_to_model, gather_leaf,
                                                  gather_over_model,
                                                  merge_softmax,
                                                  sum_over_model)


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


def _head_mask(cfg: ArchConfig, out: torch.Tensor,
               first: int = 0) -> torch.Tensor:
    """Zero the padding heads of ``out`` (B, S, h, d), whose heads are the
    global heads ``first .. first + h - 1``."""
    Hp = _padded_heads(cfg)
    if Hp == cfg.n_heads:
        return out
    heads = first + torch.arange(out.shape[2], device=out.device)
    mask = (heads < cfg.n_heads).to(out.dtype)
    return out * mask[None, None, :, None]


# ----------------------------------------------------- tensor parallelism
def gqa_tp(cfg: ArchConfig, pctx) -> bool:
    """Whether GQA runs split over ``model``: its ``param_spec`` shards the
    (padded) query heads there iff they divide."""
    return tp_active(pctx) and _padded_heads(cfg) % pctx.tp_size == 0


def _model_block(n: int, pctx) -> slice:
    """This rank's block of ``n`` items split over the ``model`` axis."""
    per = n // pctx.tp_size
    m = pctx.mesh.coords[pctx.tp_axis]
    return slice(m * per, (m + 1) * per)


def _gathered_over_model(p: dict, specs: dict, pctx, names) -> dict:
    """``p`` with the leaves ``names`` gathered whole over ``model`` (used
    replicated: backward keeps this rank's block of the gradient);
    ``specs`` are ``p``'s (the layer's attention specs)."""
    if specs is None:
        raise ValueError("attention on a sharded context needs its leaves' "
                         "specs (block_forward passes the layer's)")
    return {k: (gather_leaf(v, Sharding(pctx.mesh, specs[k]), pctx,
                            axes=(pctx.tp_axis,))
                if k in names and isinstance(v, torch.Tensor) else v)
            for k, v in p.items()}


def _mha_ize(cfg: ArchConfig, tp: int) -> bool:
    """The reference's ``mha_ize``: KV repeated to one head per (padded)
    query head when those are no multiple of the KV heads, or when the
    query heads split over ``model`` and the KV heads do not."""
    Hp, K = _padded_heads(cfg), cfg.n_kv_heads
    return Hp % K != 0 or (tp > 1 and Hp % tp == 0 and K % tp != 0)


def _repeat_kv(t: torch.Tensor, Hp: int) -> torch.Tensor:
    K = t.shape[2]
    return t.repeat_interleave(-(-Hp // K), dim=2)[:, :, :Hp]


def _gqa_tp_q(p: dict, xc: torch.Tensor, cfg: ArchConfig, pctx):
    """This rank's query heads (B, S, Hp/tp, hd) from the local ``wq``
    columns, ``xc`` already copied to ``model``; no rotation."""
    tp, Hp = pctx.tp_size, _padded_heads(cfg)
    if p["wq"].shape[1] != Hp // tp:
        raise ValueError(f"{cfg.name}: wq holds {p['wq'].shape[1]} heads on "
                         f"this rank, not {Hp} / {tp}")
    q = torch.einsum("bsd,dhk->bshk", xc, p["wq"])
    return q + p["bq"] if cfg.attn_bias else q


def _gqa_tp_kv(p: dict, x: torch.Tensor, cfg: ArchConfig, pctx, specs: dict,
               xc: torch.Tensor | None = None):
    """The KV heads of this rank's query heads, no rotation: from the local
    ``wk``/``wv`` when the KV heads split (``x`` entering through ``xc``,
    its copy to ``model``), else (the reference's ``mha_ize``) the whole KV
    computed replicated from ``x``, repeated to Hp heads, and this rank's
    block of them."""
    tp = pctx.tp_size
    Hp, K = _padded_heads(cfg), cfg.n_kv_heads
    if _mha_ize(cfg, tp):
        names = ("wk", "wv", "bk", "bv") if K % tp == 0 else ()
        pf = _gathered_over_model(p, specs, pctx, names)
        k = torch.einsum("bsd,dhk->bshk", x, pf["wk"])
        v = torch.einsum("bsd,dhk->bshk", x, pf["wv"])
        if cfg.attn_bias:
            k, v = k + pf["bk"], v + pf["bv"]
        blk = _model_block(Hp, pctx)
        k = copy_to_model(_repeat_kv(k, Hp), pctx)[:, :, blk]
        v = copy_to_model(_repeat_kv(v, Hp), pctx)[:, :, blk]
        return k, v
    if p["wk"].shape[1] != K // tp:
        raise ValueError(f"{cfg.name}: wk holds {p['wk'].shape[1]} KV "
                         f"heads on this rank, not {K} / {tp}")
    xc = copy_to_model(x, pctx) if xc is None else xc
    k = torch.einsum("bsd,dhk->bshk", xc, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", xc, p["wv"])
    if cfg.attn_bias:
        k, v = k + p["bk"], v + p["bv"]
    return k, v


def _gqa_tp_qkv(p: dict, x: torch.Tensor, cfg: ArchConfig, positions, pctx,
                specs: dict):
    """This rank's query heads and their KV heads under GQA tensor
    parallelism: ``q`` (B, S, Hp/tp, hd) from the local ``wq`` columns;
    ``k``, ``v`` as :func:`_gqa_tp_kv` gives them. The counterpart of the
    reference's ``_qkv_hint``: the local head counts are checked."""
    xc = copy_to_model(x, pctx)
    q = _gqa_tp_q(p, xc, cfg, pctx)
    k, v = _gqa_tp_kv(p, x, cfg, pctx, specs, xc)
    if cfg.pos_embedding == "rope":
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _cache_block(t: torch.Tensor, pctx) -> torch.Tensor:
    """A (B, S, K, hd) cache computed whole, cut as ``cache_specs`` lays it
    over ``model``: its KV heads if they divide, else its head dim if that
    does, else whole."""
    tp = pctx.tp_size
    if t.shape[2] % tp == 0:
        return t[:, :, _model_block(t.shape[2], pctx)]
    if t.shape[3] % tp == 0:
        return t[..., _model_block(t.shape[3], pctx)]
    return t


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


def _seq_block(pctx, S: int) -> tuple[int, object] | None:
    """(first global position, ``data`` group) of this rank's block of a
    decode cache of ``S`` local positions whose sequence is split over
    ``data``; None where the rank holds all of it."""
    blk = None if pctx is None else pctx.kv_seq_block(S)
    if blk is None:
        return None
    return blk[0], pctx.mesh.group(blk[1])


def _write_kv(cache: torch.Tensor, pos_b: torch.Tensor, new: torch.Tensor,
              start: int = 0) -> None:
    """cache[b, pos_b[b] - start] = new[b] in place, dropping rows whose
    position lies outside the block ``[start, start + S)`` the cache holds
    (the reference's ``.at[rows, pos].set`` drops out-of-range writes; a
    block of a cache split over ``data`` starts at ``start``); cache (B, S,
    *F), new (B, *F)."""
    S = cache.shape[1]
    rows = torch.arange(cache.shape[0], device=cache.device)
    at = pos_b - start
    idx = at.clamp(0, S - 1)
    keep = ((at >= 0) & (at < S)).view((-1,) + (1,) * (new.dim() - 1))
    cache[rows, idx] = torch.where(keep, new.to(cache.dtype), cache[rows, idx])


def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, pos_b,
            seq) -> torch.Tensor:
    """One token's attention (q (B, H, dk)) to positions ``<= pos_b`` of
    the caches k, v (B, S, ., .), in q's dtype: through ``decode_attn``;
    where ``seq`` (:func:`_seq_block`) says the caches are a block of a
    sequence split over ``data``, the block's positions through its
    log-sum-exp form and the parts merged over ``data``."""
    S = k.shape[1]
    start = 0 if seq is None else seq[0]
    length = (pos_b + 1 - start).clamp(0, S).to(torch.int32)
    if seq is None:
        return decode_attn(q, k.contiguous(), v.contiguous(), length)
    out, lse = decode_attn(q, k.contiguous(), v.contiguous(), length,
                           lse=True)
    return merge_softmax(out, lse, seq[1]).to(q.dtype)


def gqa_decode(p: dict, x: torch.Tensor, cfg: ArchConfig, cache: dict,
               pos, pctx=None, specs=None) -> tuple[torch.Tensor, dict]:
    """x: (B,1,d); cache k/v: (B,S,K,hd), written IN PLACE at ``pos``
    (scalar or per-row (B,) for slot-based continuous batching); a write at
    ``pos >= S`` is dropped and the row then attends to all of S. Under
    tensor parallelism the cache holds this rank's KV heads (as prefill
    left it) and the kernel runs on them; where ``cache_specs`` splits the
    head dim instead, the cache is gathered over ``model`` for the kernel.
    Where the context's ``decode_shape`` splits the cache's sequence over
    ``data``, the cache is this rank's block of positions: the new KV is
    written on the rank that holds ``pos`` and the softmax merged over
    ``data`` (the module's docstring). ``specs``: the layer's attention
    specs, on a sharded context."""
    B = x.shape[0]
    pos_b = _pos_vec(pos, B, x.device)
    k, v = cache["k"], cache["v"]
    seq = _seq_block(pctx, k.shape[1])
    start = 0 if seq is None else seq[0]
    first = 0
    if gqa_tp(cfg, pctx):
        q, k_new, v_new = _gqa_tp_qkv(p, x, cfg, pos_b[:, None], pctx,
                                      specs)
        first = _model_block(_padded_heads(cfg), pctx).start
        _write_kv(k, pos_b, k_new[:, 0], start)
        _write_kv(v, pos_b, v_new[:, 0], start)
        ka, va = k, v
    elif tp_active(pctx):
        # replicated attention over a cache cut as prefill cut it
        # (_cache_block of the mha_ize'd KV): write this rank's block of
        # the new KV, gather the cut dim over model for the kernel
        p = _gathered_over_model(p, specs, pctx, tuple(p))
        q, k_new, v_new = gqa_qkv(p, x, cfg, pos_b[:, None])
        if _mha_ize(cfg, 1):
            k_new = _repeat_kv(k_new, q.shape[2])
            v_new = _repeat_kv(v_new, q.shape[2])
        k_blk = _cache_block(k_new, pctx)
        _write_kv(k, pos_b, k_blk[:, 0], start)
        _write_kv(v, pos_b, _cache_block(v_new, pctx)[:, 0], start)
        ka, va = k, v
        cut = [d for d in (2, 3) if k_blk.shape[d] != k_new.shape[d]]
        if cut:
            from repro_torch.parallel.sharding import Sharding, Spec
            from repro_torch.parallel.tensor_parallel import gather_dims
            sh = Sharding(pctx.mesh, Spec(*([None] * cut[0]), pctx.tp_axis))
            with tagged("kv_cache_gather"):
                ka, va = (gather_dims(t, sh, cut) for t in (k, v))
    else:
        q, k_new, v_new = gqa_qkv(p, x, cfg, pos_b[:, None])
        _write_kv(k, pos_b, k_new[:, 0], start)
        _write_kv(v, pos_b, v_new[:, 0], start)
        ka, va = k, v
        Hp, K = q.shape[2], k.shape[2]
        if Hp % K != 0:
            ka, va = _repeat_kv(k, Hp), _repeat_kv(v, Hp)
    out = _attend(q[:, 0], ka, va, pos_b, seq)
    out = _head_mask(cfg, out[:, None], first)
    out = torch.einsum("bshk,hkd->bsd", out, p["wo"])
    if gqa_tp(cfg, pctx):
        out = sum_over_model(out, pctx)
    return out, cache


# ------------------------------------------------------- flash (train/prefill)
def _block_mask(s, i, j, qc, kc, causal, kv_valid):
    """s: (B,K,rep,qc,kc) scores of q block i against kv block j."""
    kpos = j * kc + torch.arange(kc, device=s.device)
    if causal:
        qpos = i * qc + torch.arange(qc, device=s.device)
        mask = (qpos[:, None] >= kpos[None, :]) & (kpos[None, :] < kv_valid)
        return torch.where(mask, s, NEG_INF)
    return torch.where(kpos < kv_valid, s, NEG_INF)


def _skipped(i, j, qc, kc, causal, kv_valid) -> bool:
    """Whether every score of block (i, j) is masked. Such a block adds
    exactly nothing in the reference (p = exp(NEG_INF - m) = 0 once row max
    m is finite, which block 0 makes it), so leaving it out changes no bit."""
    return j * kc >= kv_valid or (causal and j * kc > (i + 1) * qc - 1)


def _blocks(t, n, c, K):
    """(B, n*c, H, d) -> list of n blocks (B, c, K, H // K, d)."""
    B, _, H, d = t.shape
    return [t[:, b * c:(b + 1) * c].reshape(B, c, K, H // K, d)
            for b in range(n)]


def _flash_fwd_impl(q, k, v, causal, qc, kc, kv_valid):
    """Online-softmax forward over (q block, kv block) pairs. bf16 operands
    are widened to float32 for the products (exact), so every product sums
    in float32 as the reference's ``preferred_element_type`` asks."""
    B, Sq, H, dk = q.shape
    _, Skv, K, dv = v.shape
    rep = H // K
    nq, nk = Sq // qc, Skv // kc
    scale = dk ** -0.5
    qb = _blocks(q, nq, qc, K)
    kb = [t[:, :, :, 0] for t in _blocks(k, nk, kc, K)]
    vb = [t[:, :, :, 0] for t in _blocks(v, nk, kc, K)]
    outs, lses = [], []
    for i in range(nq):
        q_i = qb[i].float()
        m = torch.full((B, K, rep, qc), NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros((B, K, rep, qc, dv), dtype=torch.float32,
                          device=q.device)
        for j in range(nk):
            if _skipped(i, j, qc, kc, causal, kv_valid):
                continue
            s = torch.einsum("bqgrh,bkgh->bgrqk", q_i, kb[j].float()) * scale
            s = _block_mask(s, i, j, qc, kc, causal, kv_valid)
            m_new = torch.maximum(m, torch.amax(s, dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + torch.sum(p, dim=-1)
            pv = torch.einsum("bgrqk,bkgd->bgrqd", p.to(q.dtype).float(),
                              vb[j].float())
            acc = acc * corr[..., None] + pv
            m = m_new
        out_i = acc / torch.clamp(l, min=1e-30)[..., None]
        lses.append(m + torch.log(torch.clamp(l, min=1e-30)))
        # (B,K,rep,qc,dv) -> (B,qc,H,dv)
        outs.append(out_i.to(q.dtype).permute(0, 3, 1, 2, 4)
                    .reshape(B, qc, H, dv))
    return torch.cat(outs, dim=1), torch.cat(lses, dim=-1)   # lse (B,K,rep,Sq)


def _flash_bwd_impl(q, k, v, out, lse, dout, causal, qc, kc, kv_valid):
    """Blockwise recompute: p from the saved lse, D = rowsum(dout * out),
    ds = p * (dp - D) * scale; p and ds are cast to q's dtype before their
    products, where the reference casts them."""
    B, Sq, H, dk = q.shape
    _, Skv, K, dv = v.shape
    rep = H // K
    nq, nk = Sq // qc, Skv // kc
    scale = dk ** -0.5
    D = torch.sum(dout.float() * out.float(), dim=-1)            # (B,Sq,H)
    D = D.reshape(B, Sq, K, rep).permute(0, 2, 3, 1)              # (B,K,rep,Sq)
    qb = _blocks(q, nq, qc, K)
    dob = _blocks(dout, nq, qc, K)
    kb = [t[:, :, :, 0] for t in _blocks(k, nk, kc, K)]
    vb = [t[:, :, :, 0] for t in _blocks(v, nk, kc, K)]
    dq = [torch.zeros((B, qc, K, rep, dk), dtype=torch.float32,
                      device=q.device) for _ in range(nq)]
    dks, dvs = [], []
    for j in range(nk):
        k_j, v_j = kb[j].float(), vb[j].float()
        dk_j = torch.zeros((B, kc, K, dk), dtype=torch.float32, device=q.device)
        dv_j = torch.zeros((B, kc, K, dv), dtype=torch.float32, device=q.device)
        for i in range(nq):
            if _skipped(i, j, qc, kc, causal, kv_valid):
                continue
            q_i, do_i = qb[i].float(), dob[i].float()
            D_i = D[..., i * qc:(i + 1) * qc]
            lse_i = lse[..., i * qc:(i + 1) * qc]
            s = torch.einsum("bqgrh,bkgh->bgrqk", q_i, k_j) * scale
            s = _block_mask(s, i, j, qc, kc, causal, kv_valid)
            p = torch.exp(s - lse_i[..., None])                   # (B,K,rep,qc,kc)
            dv_j = dv_j + torch.einsum("bgrqk,bqgrd->bkgd",
                                       p.to(q.dtype).float(), do_i)
            dp = torch.einsum("bqgrd,bkgd->bgrqk", do_i, v_j)
            ds = (p * (dp - D_i[..., None]) * scale).to(q.dtype).float()
            dk_j = dk_j + torch.einsum("bgrqk,bqgrh->bkgh", ds, q_i)
            dq[i] = dq[i] + torch.einsum("bgrqk,bkgh->bqgrh", ds, k_j)
        dks.append(dk_j)
        dvs.append(dv_j)
    dq_ = torch.cat(dq, dim=1).reshape(B, Sq, H, dk).to(q.dtype)
    dk_ = torch.cat(dks, dim=1).to(k.dtype)
    dv_ = torch.cat(dvs, dim=1).to(v.dtype)
    return dq_, dk_, dv_


class _Flash(torch.autograd.Function):
    """FlashAttention-style custom backward: forward saves only (q, k, v,
    out, lse), backward recomputes probabilities blockwise."""

    @staticmethod
    def forward(ctx, q, k, v, causal, qc, kc, kv_valid):
        out, lse = _flash_fwd_impl(q, k, v, causal, qc, kc, kv_valid)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.cfg = (causal, qc, kc, kv_valid)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _flash_bwd_impl(q, k, v, out, lse, dout.contiguous(),
                                     *ctx.cfg)
        return dq, dk, dv, None, None, None, None


def flash_attention(q, k, v, *, causal: bool = True, q_chunk: int = 1024,
                    kv_chunk: int = 1024) -> torch.Tensor:
    """q: (B,Sq,H,dk); k: (B,Skv,K,dk); v: (B,Skv,K,dv); H % K == 0.

    Double-chunked online-softmax attention (``repro.models.attention.
    flash_attention``) in plain PyTorch with its custom backward. Ragged
    lengths are padded up to chunk multiples: padded keys are masked out,
    padded query rows dropped."""
    B, Sq, H, dk = q.shape
    _, Skv, K, dv = v.shape
    qc = min(q_chunk, Sq)
    kc = min(kv_chunk, Skv)
    Sq_p = -(-Sq // qc) * qc
    Skv_p = -(-Skv // kc) * kc
    if Sq_p != Sq:
        q = F.pad(q, (0, 0, 0, 0, 0, Sq_p - Sq))
    if Skv_p != Skv:
        k = F.pad(k, (0, 0, 0, 0, 0, Skv_p - Skv))
        v = F.pad(v, (0, 0, 0, 0, 0, Skv_p - Skv))
    out = _Flash.apply(q, k, v, causal, qc, kc, Skv)
    return out[:, :Sq]


def gqa_attention(p: dict, x: torch.Tensor, cfg: ArchConfig, *, positions,
                  causal: bool = True, pctx=None,
                  specs=None) -> tuple[torch.Tensor, dict]:
    """Full-sequence (train/prefill) GQA. Returns (out, cache). KV is
    repeated to one head per query head when the (padded) query heads are
    no multiple of the KV heads, as the reference's ``mha_ize`` does, and
    under tensor parallelism also when the query heads split over
    ``model`` and the KV heads do not. Under tensor parallelism
    (:func:`gqa_tp`) this rank attends with its block of the heads, the
    partial ``wo`` products are summed over ``model``, and the cache holds
    this rank's KV heads. ``specs``: the layer's attention specs, on a
    sharded context."""
    if gqa_tp(cfg, pctx):
        q, k, v = _gqa_tp_qkv(p, x, cfg, positions, pctx, specs)
        first = _model_block(_padded_heads(cfg), pctx).start
    else:
        if tp_active(pctx):
            p = _gathered_over_model(p, specs, pctx, tuple(p))
        q, k, v = gqa_qkv(p, x, cfg, positions)
        if _mha_ize(cfg, 1):
            k, v = _repeat_kv(k, q.shape[2]), _repeat_kv(v, q.shape[2])
        first = 0
    out = flash_attention(q, k, v, causal=causal, q_chunk=cfg.q_chunk,
                          kv_chunk=cfg.kv_chunk)
    out = _head_mask(cfg, out, first)
    out = torch.einsum("bshk,hkd->bsd", out, p["wo"])
    if gqa_tp(cfg, pctx):
        out = sum_over_model(out, pctx)
    elif tp_active(pctx):
        k, v = _cache_block(k, pctx), _cache_block(v, pctx)
    return out, {"k": k, "v": v}


# ------------------------------------------------- cross attention (whisper)
def init_cross_attention(gen, cfg: ArchConfig, d: int, device) -> dict:
    """An ``init_gqa`` tree: ``wq``/``wk``/``wv``/``wo`` (and ``bq``/``bk``/
    ``bv`` with ``attn_bias``)."""
    return init_gqa(gen, cfg, d, device)


def cross_q(p: dict, x: torch.Tensor, cfg: ArchConfig,
            pctx=None) -> torch.Tensor:
    """The cross-attention query of the decoder stream x (B, S, d): (B, S,
    H, hd), no rotation; under :func:`gqa_tp` this rank's heads."""
    if gqa_tp(cfg, pctx):
        return _gqa_tp_q(p, copy_to_model(x, pctx), cfg, pctx)
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    return q + p["bq"] if cfg.attn_bias else q


def _cross_whole(p: dict, cfg: ArchConfig, pctx, specs) -> dict:
    """``p`` gathered whole over ``model`` where the heads do not split it
    (the cross-attention then runs whole on every ``model`` rank)."""
    if tp_active(pctx) and not gqa_tp(cfg, pctx):
        return _gathered_over_model(p, specs, pctx, tuple(p))
    return p


def cross_kv(p: dict, enc: torch.Tensor, cfg: ArchConfig, pctx=None,
             specs=None) -> tuple:
    """The cross-attention keys and values of the encoder output enc (B,
    S_enc, d): each (B, S_enc, K, hd). Under :func:`gqa_tp` the KV heads
    of this rank's query heads, ``enc`` (the same on every ``model`` rank)
    entering them through a copy to ``model``. ``specs``: the layer's
    ``xattn`` specs, on a sharded context."""
    if gqa_tp(cfg, pctx):
        return _gqa_tp_kv(p, enc, cfg, pctx, specs)
    p = _cross_whole(p, cfg, pctx, specs)
    k = torch.einsum("bsd,dhk->bshk", enc, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", enc, p["wv"])
    if cfg.attn_bias:
        k, v = k + p["bk"], v + p["bv"]
    return k, v


def cross_attention(p: dict, x: torch.Tensor, cfg: ArchConfig, kv: tuple,
                    pctx=None, specs=None) -> torch.Tensor:
    """The decoder's full-sequence attention to the encoder: every query
    position sees all of ``kv`` (``flash_attention(causal=False)``, padded
    keys masked where S_enc is no multiple of the chunk). Under
    :func:`gqa_tp` on this rank's heads, the partial ``wo`` products summed
    over ``model``."""
    p = _cross_whole(p, cfg, pctx, specs)
    out = flash_attention(cross_q(p, x, cfg, pctx), *kv, causal=False,
                          q_chunk=cfg.q_chunk, kv_chunk=cfg.kv_chunk)
    out = torch.einsum("bshk,hkd->bsd", out, p["wo"])
    return sum_over_model(out, pctx) if gqa_tp(cfg, pctx) else out


def cross_decode(p: dict, x: torch.Tensor, cfg: ArchConfig, kv: tuple,
                 pctx=None, specs=None) -> torch.Tensor:
    """One decoder token x (B, 1, d) against the whole encoder cache ``kv``
    (each (B, S_enc, K, hd)), never written after prefill: through
    ``decode_attn`` at ``length = S_enc`` (the kernel on CUDA tensors).
    Under :func:`gqa_tp` the cache holds this rank's KV heads, as prefill
    left it, and the kernel reads them for this rank's query heads."""
    p = _cross_whole(p, cfg, pctx, specs)
    q = cross_q(p, x, cfg, pctx)
    k, v = kv
    out = decode_attn(q[:, 0], k.contiguous(), v.contiguous(), k.shape[1])
    out = torch.einsum("bshk,hkd->bsd", out[:, None], p["wo"])
    return sum_over_model(out, pctx) if gqa_tp(cfg, pctx) else out


# ------------------------------------------------------------------------ MLA
def init_mla(gen, cfg: ArchConfig, d: int, device) -> dict:
    """The reference's tree: no head padding (``cfg.n_heads`` as it stands),
    norms with float32 scales."""
    m = cfg.mla
    dt = dtype_of(cfg)
    qk = m.qk_nope_head_dim + m.qk_rope_head_dim
    H = cfg.n_heads
    return {
        "wq_a": dense_init(gen, (d, m.q_lora_rank), dt, device),
        "q_norm": init_norm(cfg, m.q_lora_rank, device),
        "wq_b": dense_init(gen, (m.q_lora_rank, H, qk), dt, device),
        "wkv_a": dense_init(gen, (d, m.kv_lora_rank + m.qk_rope_head_dim), dt,
                            device),
        "kv_norm": init_norm(cfg, m.kv_lora_rank, device),
        "wkv_b": dense_init(gen, (m.kv_lora_rank, H,
                                  m.qk_nope_head_dim + m.v_head_dim), dt,
                            device),
        "wo": dense_init(gen, (H, m.v_head_dim, d), dt, device,
                         scale=(H * m.v_head_dim) ** -0.5),
    }


def mla_tp(cfg: ArchConfig, pctx) -> bool:
    """Whether MLA's expanded form runs split over ``model``: its
    ``param_spec`` shards ``wq_b``/``wkv_b``/``wo`` over the heads iff they
    divide."""
    return tp_active(pctx) and cfg.n_heads % pctx.tp_size == 0


def _mla_q(p, x, cfg, positions, pctx=None):
    m = cfg.mla
    q_lat = apply_norm(p["q_norm"], x @ p["wq_a"], cfg)
    if mla_tp(cfg, pctx):
        q_lat = copy_to_model(q_lat, pctx)
    q = torch.einsum("bsr,rhk->bshk", q_lat, p["wq_b"])
    q_nope = q[..., :m.qk_nope_head_dim]
    q_rope = apply_rope(q[..., m.qk_nope_head_dim:], positions,
                        cfg.rope_theta)
    return q_nope, q_rope


def _mla_latent(p, x, cfg, positions):
    """(c_kv (B, S, kv_lora) normed, k_rope (B, S, 1, rope) rotated)."""
    m = cfg.mla
    kv = x @ p["wkv_a"]
    c_kv = apply_norm(p["kv_norm"], kv[..., :m.kv_lora_rank], cfg)
    k_rope = apply_rope(kv[..., None, m.kv_lora_rank:], positions,
                        cfg.rope_theta)
    return c_kv, k_rope


def mla_attention(p: dict, x: torch.Tensor, cfg: ArchConfig, *,
                  positions, pctx=None,
                  specs=None) -> tuple[torch.Tensor, dict]:
    """Expanded-form MLA for train and prefill: keys and values expanded
    from the latent per head (k_rope shared by every head), causal
    ``flash_attention`` at dk = nope + rope, dv = v. The cache it returns
    stays compressed: ``{"c_kv": (B, S, kv_lora), "k_rope": (B, S,
    rope)}``. Under tensor parallelism (:func:`mla_tp`) the latent and the
    rope key, computed replicated, enter this rank's heads through a copy
    to ``model``, the partial ``wo`` products are summed over it, and the
    cache is cut over ``model`` as ``cache_specs`` lays it out. ``specs``:
    the layer's attention specs, on a sharded context."""
    m = cfg.mla
    tp = mla_tp(cfg, pctx)
    if tp_active(pctx) and not tp:
        p = _gathered_over_model(p, specs, pctx, tuple(p))
    q_nope, q_rope = _mla_q(p, x, cfg, positions, pctx)
    c_kv, k_rope = _mla_latent(p, x, cfg, positions)
    c_in, kr_in = ((copy_to_model(c_kv, pctx), copy_to_model(k_rope, pctx))
                   if tp else (c_kv, k_rope))
    kv = torch.einsum("bsr,rhk->bshk", c_in, p["wkv_b"])
    k_nope = kv[..., :m.qk_nope_head_dim]
    v = kv[..., m.qk_nope_head_dim:]
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, kr_in.expand(k_nope.shape[:3]
                                        + (m.qk_rope_head_dim,))], dim=-1)
    out = flash_attention(q, k, v, causal=True, q_chunk=cfg.q_chunk,
                          kv_chunk=cfg.kv_chunk)
    out = torch.einsum("bshk,hkd->bsd", out, p["wo"])
    if tp:
        out = sum_over_model(out, pctx)
    cache = {"c_kv": c_kv, "k_rope": k_rope[:, :, 0, :]}
    if tp_active(pctx):
        cache = {n: (t[..., _model_block(t.shape[-1], pctx)]
                     if t.shape[-1] % pctx.tp_size == 0 else t)
                 for n, t in cache.items()}
    return out, cache


def mla_decode(p: dict, x: torch.Tensor, cfg: ArchConfig, cache: dict,
               pos, pctx=None, specs=None) -> tuple[torch.Tensor, dict]:
    """Absorbed-form decode of x (B, 1, d): the new latent and rope key are
    written IN PLACE at ``pos`` (scalar or per-row; a write at ``pos >= S``
    is dropped, as in ``gqa_decode``); W_UK is folded into the query and
    W_UV applied after the attention, all in float32 in the reference's
    order, and ``wo`` in the model dtype.

    Under tensor parallelism the cache stays as ``cache_specs`` lays it out
    and prefill writes it: ``c_kv`` (B, S, r/tp) and ``k_rope`` (B, S,
    rope/tp), each where it divides, while the heads split over ``model``
    through ``wq_b``/``wkv_b``/``wo`` (:func:`mla_tp`). A rank holds part
    of both axes of each contraction over the latent, so: the absorbed
    queries ``q_c`` and ``q_rope`` are gathered over ``model`` (every head),
    the scores of every head on the rank's blocks are summed over ``model``,
    the softmax runs on them whole, ``o_c`` on the rank's ``r`` block is
    gathered over ``model`` and cut to the rank's heads, and ``w_uv`` and
    the row-split ``wo`` end in a sum over ``model``. The cache is never
    gathered. Where the context's ``decode_shape`` splits the cache's
    sequence over ``data``, each rank scores its block, and its softmax
    part (``o_c`` and the scores' log-sum-exp) is merged over ``data``
    before ``o_c`` is gathered over ``model``. ``specs``: the layer's
    attention specs (read where the heads do not split and the leaves are
    gathered whole)."""
    m = cfg.mla
    tp, heads = tp_active(pctx), mla_tp(cfg, pctx)
    if tp and not heads:
        p = _gathered_over_model(p, specs, pctx, tuple(p))
    B = x.shape[0]
    pos_b = _pos_vec(pos, B, x.device)
    positions = pos_b[:, None]
    q_nope, q_rope = _mla_q(p, x, cfg, positions, pctx)   # (B,1,H/tp,*)
    c_new, kr_new = _mla_latent(p, x, cfg, positions)
    c_kv, k_rope = cache["c_kv"], cache["k_rope"]
    r_cut = c_kv.shape[-1] != m.kv_lora_rank
    m_cut = k_rope.shape[-1] != m.qk_rope_head_dim
    c_new, kr_new = c_new[:, 0], kr_new[:, 0, 0, :]
    if r_cut:
        c_new = c_new[..., _model_block(m.kv_lora_rank, pctx)]
    if m_cut:
        kr_new = kr_new[..., _model_block(m.qk_rope_head_dim, pctx)]
    seq = _seq_block(pctx, c_kv.shape[1])
    start = 0 if seq is None else seq[0]
    _write_kv(c_kv, pos_b, c_new, start)
    _write_kv(k_rope, pos_b, kr_new, start)
    w_uk = p["wkv_b"][..., :m.qk_nope_head_dim]            # (r,H,nope)
    w_uv = p["wkv_b"][..., m.qk_nope_head_dim:]            # (r,H,v)
    c32 = c_kv.float()
    q_c = torch.einsum("bshk,rhk->bhr", q_nope.float(), w_uk.float())
    q_r = q_rope[:, 0].float()                             # (B,H,rope)
    if heads:
        q_c, q_r = (gather_over_model(t, 1, pctx) for t in (q_c, q_r))
    if r_cut:
        q_c = q_c[..., _model_block(m.kv_lora_rank, pctx)]
    if m_cut:
        q_r = q_r[..., _model_block(m.qk_rope_head_dim, pctx)]
    s_c = torch.einsum("bhr,bkr->bhk", q_c, c32)
    s_r = torch.einsum("bhm,bkm->bhk", q_r, k_rope.float())
    if r_cut and m_cut:
        s = sum_over_model(s_c + s_r, pctx)
    else:
        s = ((sum_over_model(s_c, pctx) if r_cut else s_c)
             + (sum_over_model(s_r, pctx) if m_cut else s_r))
    s = s * (m.qk_nope_head_dim + m.qk_rope_head_dim) ** -0.5
    mask = (start + torch.arange(c_kv.shape[1], device=x.device)[None, :]
            <= pos_b[:, None])
    if seq is None:
        s = torch.where(mask[:, None, :], s, NEG_INF)
        pr = torch.softmax(s, dim=-1)
        o_c = torch.einsum("bhk,bkr->bhr", pr, c32)
    else:
        # this block's softmax part (0, and lse -inf, where it holds no
        # position <= pos), merged over data
        s = torch.where(mask[:, None, :], s, -torch.inf)
        lse = torch.logsumexp(s, dim=-1)
        pr = torch.exp(s - torch.where(torch.isneginf(lse), 0.0,
                                       lse)[..., None])
        o_c = merge_softmax(torch.einsum("bhk,bkr->bhr", pr, c32), lse,
                            seq[1])
    if r_cut:
        o_c = gather_over_model(o_c, -1, pctx)
    if heads:
        o_c = o_c[:, _model_block(cfg.n_heads, pctx)]
    o = torch.einsum("bhr,rhv->bhv", o_c, w_uv.float())
    out = torch.einsum("bhv,hvd->bd", o.to(x.dtype), p["wo"])[:, None, :]
    if heads:
        out = sum_over_model(out, pctx)
    return out, cache
