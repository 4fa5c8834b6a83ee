"""Decoder-only dense LM: training (``loss_fn``), prefill and decode.

Counterpart of the dense branches of ``repro.models.transformer``. The
parameter tree keeps the reference's layout, with every block parameter
stacked on a leading layer axis (``dense_stack.attn.wq`` is (L, d, H, hd)),
so JAX parameters transfer one to one by tree path (see
:mod:`repro_torch.bridge`). The reference's ``lax.scan`` over layers is a
Python loop over that leading axis; on the full-sequence path each layer
runs under ``torch.utils.checkpoint``, as the reference remats its block.
"""

from __future__ import annotations

import dataclasses

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import tree as tree_util
from repro_torch.config import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models.layers import (apply_mlp, apply_norm, dtype_of,
                                       embed_tokens, init_embedding, init_mlp,
                                       init_norm, lm_loss, logits)


def _unported(cfg: ArchConfig) -> str | None:
    """Why ``cfg`` cannot run on the port yet (and which ROADMAP item ports
    it), or None when its decode path is ported."""
    if cfg.family in ("ssm", "hybrid") or cfg.ssm is not None:
        return "Mamba-2 / hybrid stacks (ROADMAP.md queue 1 item 4)"
    if cfg.family == "audio" or cfg.encdec is not None:
        return "encoder-decoder models (ROADMAP.md queue 1 item 5)"
    if cfg.family == "vlm" or cfg.vision is not None:
        return "the VLM patch prefix (ROADMAP.md queue 1 item 5)"
    if cfg.family == "moe" or cfg.moe is not None:
        return "MoE layers (ROADMAP.md queue 1 item 2)"
    if cfg.mla is not None or cfg.mtp_depth:
        return "MLA attention and MTP (ROADMAP.md queue 1 item 3)"
    return None


# ------------------------------------------------------------------ blocks
def init_block(gen, cfg: ArchConfig, kind: str, device) -> dict:
    if kind != "dense":
        raise NotImplementedError(f"block kind {kind!r} is not ported")
    d = cfg.d_model
    return {
        "ln1": init_norm(cfg, d, device),
        "attn": attn.init_gqa(gen, cfg, d, device),
        "ln2": init_norm(cfg, d, device),
        "ffn": init_mlp(gen, cfg, d, cfg.d_ff, device),
    }


def _ffn(p, h, cfg, kind):
    return apply_mlp(p["ffn"], h, cfg)


def block_forward(p: dict, x, cfg: ArchConfig, kind: str, *, positions):
    """Full-sequence causal block. Returns (x, cache)."""
    h = apply_norm(p["ln1"], x, cfg)
    y, cache = attn.gqa_attention(p["attn"], h, cfg, positions=positions)
    x = x + y
    h2 = apply_norm(p["ln2"], x, cfg)
    return x + _ffn(p, h2, cfg, kind), cache


def block_decode(p: dict, x, cfg: ArchConfig, kind: str, *, cache, pos):
    h = apply_norm(p["ln1"], x, cfg)
    y, cache = attn.gqa_decode(p["attn"], h, cfg, cache, pos)
    x = x + y
    h2 = apply_norm(p["ln2"], x, cfg)
    return x + _ffn(p, h2, cfg, kind), cache


# ------------------------------------------------------------ stacked layers
def init_stack(gen, cfg: ArchConfig, kind: str, n: int, device):
    if n == 0:
        return None
    blocks = [init_block(gen, cfg, kind, device) for _ in range(n)]

    def gather(trees):
        if isinstance(trees[0], dict):
            return {k: gather([t[k] for t in trees]) for k in trees[0]}
        return torch.stack(trees)

    return gather(blocks)


def stack_forward(stack, x, cfg, kind, *, positions):
    """Run the stacked blocks layer by layer, each recomputed in backward;
    returns (x, caches) with caches k/v stacked as (L, B, S, K, hd)."""
    n = stack["ln1"]["scale"].shape[0]
    ks, vs = [], []
    for i in range(n):
        layer_p = tree_util.tree_map(lambda t: t[i], stack)

        def body(carry, layer_p=layer_p):
            return block_forward(layer_p, carry, cfg, kind,
                                 positions=positions)

        if torch.is_grad_enabled():
            x, cache = checkpoint(body, x, use_reentrant=False)
        else:
            x, cache = body(x)
        ks.append(cache["k"])
        vs.append(cache["v"])
    return x, {"k": torch.stack(ks), "v": torch.stack(vs)}


def stack_decode(stack, x, cfg, kind, *, caches, pos):
    """Run the stacked blocks layer by layer. ``caches`` k/v are (L,B,S,K,hd);
    layer i writes its new KV into ``caches[...][i]`` IN PLACE (the
    reference's scan returns new caches instead)."""
    for i in range(caches["k"].shape[0]):
        layer_p = tree_util.tree_map(lambda t: t[i], stack)
        x, _ = block_decode(layer_p, x, cfg, kind, pos=pos,
                            cache={"k": caches["k"][i], "v": caches["v"][i]})
    return x, caches


# ------------------------------------------------------------------ LM model
@dataclasses.dataclass(frozen=True)
class LM:
    """Decoder-only dense LM: ``init``, ``loss_fn``, ``prefill``,
    ``init_cache`` and ``decode_step``."""
    cfg: ArchConfig

    def __post_init__(self):
        why = _unported(self.cfg)
        if why is not None:
            raise NotImplementedError(
                f"{self.cfg.name}: {why} not ported to repro_torch yet")

    def init(self, gen: torch.Generator, device=None) -> dict:
        """Random parameters drawn from ``gen`` (a CPU generator), on
        ``device`` (default cuda; ``"meta"`` gives shapes only)."""
        cfg = self.cfg
        device = resolve_device(device)
        return {
            "embed": init_embedding(gen, cfg, device),
            "dense_stack": init_stack(gen, cfg, "dense", cfg.n_layers, device),
            "final_norm": init_norm(cfg, cfg.d_model, device),
        }

    # -------- shared trunk
    def _inputs(self, params: dict, batch: dict):
        cfg = self.cfg
        x = embed_tokens(params["embed"], batch["tokens"], cfg)
        B, S = x.shape[0], x.shape[1]
        positions = torch.arange(S, device=x.device).expand(B, S)
        if cfg.pos_embedding == "learned":
            x = x + params["embed"]["positions"][:S]
        return x, positions

    def _trunk(self, params: dict, x, positions):
        cfg = self.cfg
        x, caches = stack_forward(params["dense_stack"], x, cfg, "dense",
                                  positions=positions)
        return apply_norm(params["final_norm"], x, cfg), {"dense": caches}

    # -------- train
    def loss_fn(self, params: dict, batch: dict, pctx=None) -> torch.Tensor:
        """Mean next-token cross entropy of ``batch`` (``tokens``,
        ``labels`` (B, S) int). ``pctx`` is accepted for the reference's
        signature; the port's data parallelism syncs gradients outside the
        model (:mod:`repro_torch.parallel.grad_sync`)."""
        x, positions = self._inputs(params, batch)
        h, _ = self._trunk(params, x, positions)
        labels = batch["labels"]
        return lm_loss(params["embed"], h[:, :-1], labels[:, 1:], self.cfg)

    # -------- serving
    def prefill(self, params: dict, batch: dict, pctx=None):
        """Logits of the last position (B, 1, V) float32 and the per-layer
        KV caches ``{"dense": {"k", "v"}}`` each (L, B, S, K, hd)."""
        x, positions = self._inputs(params, batch)
        h, caches = self._trunk(params, x, positions)
        return logits(params["embed"], h[:, -1:, :], self.cfg), caches

    def decode_step(self, params: dict, caches: dict, batch: dict):
        """One token per row. ``batch``: ``token`` (B,) and ``pos`` (scalar or
        (B,)). Returns (logits (B,1,V) float32, caches), the caches updated
        in place."""
        cfg = self.cfg
        tok = batch["token"][:, None]
        pos = batch["pos"]
        x = embed_tokens(params["embed"], tok, cfg)
        if cfg.pos_embedding == "learned":
            pos_b = attn._pos_vec(pos, x.shape[0], x.device)
            x = x + params["embed"]["positions"][pos_b][:, None, :]
        x, _ = stack_decode(params["dense_stack"], x, cfg, "dense",
                            caches=caches["dense"], pos=pos)
        h = apply_norm(params["final_norm"], x, cfg)
        return logits(params["embed"], h, cfg), caches

    def init_cache(self, batch_size: int, seq_len: int, device=None) -> dict:
        """Zero KV caches shaped for a ``seq_len`` window:
        ``{"dense": {"k", "v"}}`` each (L, B, S, K, hd)."""
        cfg = self.cfg
        device = resolve_device(device)
        shape = (cfg.n_layers, batch_size, seq_len, cfg.n_kv_heads,
                 cfg.resolved_head_dim)
        dt = dtype_of(cfg)
        return {"dense": {"k": torch.zeros(shape, dtype=dt, device=device),
                          "v": torch.zeros(shape, dtype=dt, device=device)}}


def build_model(cfg: ArchConfig) -> LM:
    """The port's model for ``cfg``; raises ``NotImplementedError`` for the
    families not ported yet, naming the ROADMAP item that ports each."""
    return LM(cfg)
