"""Decoder-only dense, MoE and VLM LM (with DeepSeek's MLA attention and MTP
head), the Mamba-2 LM, the Zamba2-style hybrid and the Whisper-style
encoder-decoder: training (``loss_fn``), prefill and decode.

Counterpart of ``repro.models.transformer``, every family it builds.
The parameter tree keeps the reference's layout, with every block parameter
stacked on a leading layer axis (``dense_stack.attn.wq`` is (L, d, H, hd),
``stack.ssm.wx`` is (L, d, d_inner)), so JAX parameters transfer one to one
by tree path (see :mod:`repro_torch.bridge`). The reference's ``lax.scan``
over layers is a Python loop over that leading axis; on the full-sequence
path each layer runs under ``torch.utils.checkpoint``, as the reference
remats its block.
"""

from __future__ import annotations

import dataclasses
import functools

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import tree as tree_util
from repro_torch.config import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.layers import (apply_mlp, apply_norm, dense_init,
                                       dtype_of, embed_tokens, init_embedding,
                                       init_mlp, init_norm, lm_loss, logits)
from repro_torch.parallel.sharding import Sharding, is_spec, param_specs
from repro_torch.parallel.tensor_parallel import (cut_seq, gather_leaf,
                                                  gather_seq)


def _is_hybrid(cfg: ArchConfig) -> bool:
    return cfg.family == "hybrid" or bool(cfg.hybrid_attn_every)


def _refuse_hybrid(cfg: ArchConfig) -> None:
    if _is_hybrid(cfg):
        raise ValueError(f"{cfg.name} is a hybrid config: build it with "
                         "HybridLM (or build_model)")


def _refuse_encdec(cfg: ArchConfig) -> None:
    if cfg.encdec is not None:
        raise ValueError(f"{cfg.name} is an encoder-decoder config: build it "
                         "with EncDecLM (or build_model)")


# ---------------------------------------------------------------- sharding
def _is_expert_stack(names: tuple[str, ...], leaf) -> bool:
    return (len(names) == 2 and names[0] == "ffn" and leaf.dim() == 3
            and names[1] in ("w_gate", "w_up", "w_out"))


@functools.lru_cache(maxsize=None)
def _structure_specs(what: str, cfg: ArchConfig, kind: str, sizes: tuple,
                     axes: tuple, tp_axis: str):
    from repro_torch.launch.mesh import AbstractMesh
    from repro_torch.parallel.ctx import ParallelCtx
    pctx = ParallelCtx(mesh=AbstractMesh(sizes, axes), tp_axis=tp_axis,
                       dp_axes=tuple(a for a in ("pod", "data") if a in axes))
    meta = torch.device("meta")
    if what == "block":
        tree = init_block(None, cfg, kind, meta)
    else:
        tree = {"embed": init_embedding(None, cfg, meta)}
        if cfg.mtp_depth:
            tree["mtp"] = {"proj": torch.empty(
                (2 * cfg.d_model, cfg.d_model), device=meta)}
        if cfg.encdec is not None:
            tree["enc_pos"] = torch.empty(
                (cfg.encdec.encoder_seq, cfg.d_model), device=meta)
    return param_specs(tree, cfg, pctx)


def _key(pctx) -> tuple:
    m = pctx.mesh
    return (tuple(m.shape[a] for a in m.axis_names), tuple(m.axis_names),
            pctx.tp_axis)


def layer_specs(cfg: ArchConfig, kind: str, pctx):
    """The specs of one block of ``kind`` ("dense", "moe", "ssm",
    "encoder", "decoder"): the
    per-layer specs of a stack's leaves (their stack dims stripped), read
    from the block's structure on the meta device."""
    return _structure_specs("block", cfg, kind, *_key(pctx))


def top_specs(cfg: ArchConfig, pctx) -> dict:
    """The specs of ``{"embed": ..., "mtp": {"proj"}, "enc_pos"}`` (``mtp``
    with an MTP head, ``enc_pos`` for an encoder-decoder)."""
    return _structure_specs("top", cfg, "", *_key(pctx))


def _unfsdp(p: dict, cfg: ArchConfig, pctx, kind: str,
            part: str | None = None) -> tuple[dict, dict]:
    """ZeRO-3 for one layer (the reference's ``_unfsdp`` with
    ``gather_weights``): its leaves sharded over ``data`` gathered whole
    over ``data`` at the layer's entry (a reduce-scatter of their gradient
    in backward), ``model`` blocks kept. Expert stacks stay in their EP
    layout, which the MoE layer consumes as it is. Returns the layer's
    leaves and their specs (None on an unsharded context), which the
    attention reads where it gathers its ``model`` blocks. With ``part``,
    ``p`` is that subtree of a block of ``kind`` (a decoder layer's
    ``xattn``)."""
    if pctx is None or not pctx.sharded:
        return p, None
    specs = layer_specs(cfg, kind, pctx)
    if part is not None:
        specs = specs[part]
    out = []
    for (name, leaf), spec in zip(tree_util.named_leaves(p),
                                  tree_util.leaves(specs, is_leaf=is_spec),
                                  strict=True):
        if not _is_expert_stack(tuple(name.split(".")), leaf):
            leaf = gather_leaf(leaf, Sharding(pctx.mesh, spec), pctx,
                               axes=("data",))
        out.append(leaf)
    return tree_util.unflatten(p, out), specs


def _seq_split(pctx, seq_len: int) -> bool:
    return pctx is not None and pctx.seq_split(seq_len)


def _check_stream(x, cfg: ArchConfig, pctx) -> None:
    if pctx is not None and pctx.sharded and x.shape[-1] != cfg.d_model:
        raise ValueError(f"residual stream {tuple(x.shape)} is not this "
                         f"rank's rows at d_model {cfg.d_model}")


def _hint(x, cfg: ArchConfig, pctx, seq_len: int):
    """The reference's ``_hint``: the residual stream of a ``seq_len``
    sequence as it lies between blocks. Under a sharded context it is this
    rank's rows at the full width; with ``seq_shard`` (where
    ``pctx.seq_split(seq_len)``) only this rank's ``seq_len / tp`` of the
    sequence, cut from a whole stream here (:func:`cut_seq`) and left as it
    is when it arrives cut."""
    _check_stream(x, cfg, pctx)
    if _seq_split(pctx, seq_len) and x.shape[1] == seq_len:
        return cut_seq(x, pctx)
    return x


def _whole(x, pctx, seq_len: int):
    """A residual stream that :func:`_hint` may have cut, whole again
    (:func:`gather_seq`): a block's input, the final norm's, the MTP
    head's."""
    if _seq_split(pctx, seq_len) and x.shape[1] != seq_len:
        return gather_seq(x, pctx)
    return x


def _gathered_top(params: dict, cfg: ArchConfig, pctx) -> tuple[dict, dict]:
    """The embedding (and the MTP projection) gathered whole over every
    axis its spec names at use, as the reference's whole-table math reads
    them (GSPMD partitions that math; the port gathers): ``(embed,
    mtp)``."""
    embed, mtp = params["embed"], params.get("mtp")
    if pctx is None or not pctx.sharded:
        return embed, mtp
    specs = top_specs(cfg, pctx)

    def full(t, spec):
        return gather_leaf(t, Sharding(pctx.mesh, spec), pctx)

    embed = {k: full(v, specs["embed"][k]) for k, v in embed.items()}
    if mtp is not None:
        mtp = {**mtp, "proj": full(mtp["proj"], specs["mtp"]["proj"])}
    return embed, mtp


# ------------------------------------------------------------------ blocks
def init_block(gen, cfg: ArchConfig, kind: str, device) -> dict:
    d = cfg.d_model
    if kind == "ssm":
        return {"ln1": init_norm(cfg, d, device),
                "ssm": ssm_lib.init_mamba2(gen, cfg, device)}
    if kind not in ("dense", "moe", "encoder", "decoder"):
        raise ValueError(kind)
    p = {
        "ln1": init_norm(cfg, d, device),
        "attn": (attn.init_mla(gen, cfg, d, device) if cfg.mla is not None
                 else attn.init_gqa(gen, cfg, d, device)),
        "ln2": init_norm(cfg, d, device),
        "ffn": (moe_lib.init_moe(gen, cfg, d, device) if kind == "moe"
                else init_mlp(gen, cfg, d, cfg.d_ff, device)),
    }
    if kind == "decoder":
        p["ln_x"] = init_norm(cfg, d, device)
        p["xattn"] = attn.init_cross_attention(gen, cfg, d, device)
    return p


def _ffn(p, h, cfg, kind, pctx):
    if kind == "moe":
        return moe_lib.apply_moe(p["ffn"], h, cfg, pctx)
    return apply_mlp(p["ffn"], h, cfg, pctx)


def block_forward(p: dict, x, cfg: ArchConfig, kind: str, *, positions,
                  pctx=None, causal: bool = True, cross=None):
    """Full-sequence block (self-attention ``causal`` or not). Returns (x,
    cache); for ``kind="ssm"`` the cache is the Mamba-2 state ``{"conv",
    "ssm"}``, for an MLA config ``{"c_kv", "k_rope"}``. A ``"decoder"``
    block then attends to the encoder output ``cross`` (B, S_enc, d), its
    cross K/V computed here from it, so a recompute in backward computes
    them again. ``pctx`` reaches the MoE layer (expert
    parallelism over its mesh's ``data`` axis) and, on a sharded mesh,
    every layer: ``p`` holds this rank's blocks (``param_specs``), the
    layer's ``data`` shards are gathered at its entry and attention, the
    FFN and the Mamba-2 block run split over ``model``. With ``seq_shard``
    the stream arrives whole or as this rank's rows of the ``S`` positions
    of ``positions`` (B, S) and leaves as :func:`_hint` lays it out: the
    block runs on the whole stream, as without it."""
    p, specs = _unfsdp(p, cfg, pctx, kind)
    S = positions.shape[1]
    _check_stream(x, cfg, pctx)
    x = _whole(x, pctx, S)
    h = apply_norm(p["ln1"], x, cfg)
    if kind == "ssm":
        y, state = ssm_lib.mamba2_forward(p["ssm"], h, cfg, pctx)
        return _hint(x + y, cfg, pctx, S), state
    a_specs = None if specs is None else specs["attn"]
    if cfg.mla is not None:
        y, cache = attn.mla_attention(p["attn"], h, cfg, positions=positions,
                                      pctx=pctx, specs=a_specs)
    else:
        y, cache = attn.gqa_attention(p["attn"], h, cfg, positions=positions,
                                      causal=causal, pctx=pctx, specs=a_specs)
    x = x + y
    if kind == "decoder":
        x_specs = None if specs is None else specs["xattn"]
        hx = apply_norm(p["ln_x"], x, cfg)
        kv = attn.cross_kv(p["xattn"], cross, cfg, pctx, x_specs)
        x = x + attn.cross_attention(p["xattn"], hx, cfg, kv, pctx, x_specs)
    h2 = apply_norm(p["ln2"], x, cfg)
    return _hint(x + _ffn(p, h2, cfg, kind, pctx), cfg, pctx, S), cache


def block_decode(p: dict, x, cfg: ArchConfig, kind: str, *, cache, pos,
                 pctx=None, cross_kv=None):
    """One token per row through one block; a ``"decoder"`` block attends
    to its layer's encoder cache ``cross_kv`` (k, v) after its
    self-attention. On a sharded mesh ``cache`` (and ``cross_kv``) are this
    rank's blocks, as prefill leaves them."""
    p, specs = _unfsdp(p, cfg, pctx, kind)
    x = _hint(x, cfg, pctx, x.shape[1])
    h = apply_norm(p["ln1"], x, cfg)
    if kind == "ssm":
        y, state = ssm_lib.mamba2_decode(p["ssm"], h, cfg, cache, pctx)
        return x + y, state
    a_specs = None if specs is None else specs["attn"]
    if cfg.mla is not None:
        y, cache = attn.mla_decode(p["attn"], h, cfg, cache, pos, pctx,
                                   specs=a_specs)
    else:
        y, cache = attn.gqa_decode(p["attn"], h, cfg, cache, pos, pctx,
                                   specs=a_specs)
    x = x + y
    if kind == "decoder":
        hx = apply_norm(p["ln_x"], x, cfg)
        x = x + attn.cross_decode(p["xattn"], hx, cfg, cross_kv, pctx,
                                  None if specs is None else specs["xattn"])
    h2 = apply_norm(p["ln2"], x, cfg)
    return x + _ffn(p, h2, cfg, kind, pctx), cache


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


def _stack_trees(trees: list):
    """One tree whose leaves stack the corresponding leaves of ``trees``
    on a new leading axis (the reference scan's stacked outputs)."""
    cols = zip(*[tree_util.leaves(t) for t in trees])
    return tree_util.unflatten(trees[0], [torch.stack(c) for c in cols])


def stack_forward(stack, x, cfg, kind, *, positions, pctx=None,
                  causal: bool = True, cross=None):
    """Run the stacked blocks layer by layer, each recomputed in backward
    (a decoder block's cross K/V from ``cross`` with it); returns (x,
    caches), each cache leaf stacked on a leading layer axis:
    k/v (L, B, S, K, hd) for attention, c_kv (L, B, S, kv_lora) and k_rope
    (L, B, S, rope) for MLA; for ``kind="ssm"`` the states
    ``{"conv": (sx, sB, sC) each (L, B, W-1, C), "ssm": (L, B, h, p, n)}``.
    ``x`` and the returned stream lie as :func:`_hint` lays them out: with
    ``seq_shard`` each layer's checkpointed input is this rank's rows."""
    n = stack["ln1"]["scale"].shape[0]
    x = _hint(x, cfg, pctx, positions.shape[1])
    caches = []
    for i in range(n):
        layer_p = tree_util.tree_map(lambda t: t[i], stack)

        def body(carry, enc, layer_p=layer_p):
            return block_forward(layer_p, carry, cfg, kind,
                                 positions=positions, pctx=pctx,
                                 causal=causal, cross=enc)

        if torch.is_grad_enabled():
            x, cache = checkpoint(body, x, cross, use_reentrant=False)
        else:
            x, cache = body(x, cross)
        caches.append(cache)
    return x, _stack_trees(caches)


def stack_decode(stack, x, cfg, kind, *, caches, pos, pctx=None,
                 cross_kv=None):
    """Run the stacked blocks layer by layer over ``caches`` (leaves with a
    leading layer axis), updated IN PLACE (the reference's scan returns new
    caches instead): attention layers write their new KV into
    ``caches[...][i]`` (MLA layers their latent and rope key); SSM layers'
    new conv and SSM states are copied into layer i's slice. Decoder
    layers read layer i of ``cross_kv`` ((k, v), each (L, B, S_enc, K,
    hd)) and write nothing there."""
    n = stack["ln1"]["scale"].shape[0]
    for i in range(n):
        layer_p = tree_util.tree_map(lambda t: t[i], stack)
        cache = tree_util.tree_map(lambda t: t[i], caches)
        ckv = None if cross_kv is None else (cross_kv[0][i], cross_kv[1][i])
        x, new = block_decode(layer_p, x, cfg, kind, pos=pos, cache=cache,
                              pctx=pctx, cross_kv=ckv)
        if kind == "ssm":
            for dst, src in zip(tree_util.leaves(cache),
                                tree_util.leaves(new)):
                dst.copy_(src)
    return x, caches


# ------------------------------------------------------------------ LM model
@dataclasses.dataclass(frozen=True)
class LM:
    """Decoder-only LM, dense, MoE or VLM: ``init``, ``loss_fn``,
    ``prefill``, ``init_cache`` and ``decode_step``. A VLM config
    (``cfg.vision``) puts ``batch["patches"]`` (B, n_patches, d), rounded
    to the model dtype, before the token embeddings: positions run over
    both, the loss reads the token positions only, and a decode step's
    ``pos`` counts the patches. An MoE config's first
    ``n_dense_layers`` blocks form ``dense_stack`` and the rest
    ``moe_stack`` (an empty stack is None, as in the reference); caches
    are keyed ``"dense"`` and ``"moe"`` likewise. With ``cfg.mla`` every
    block attends by MLA and caches its latent; with ``cfg.mtp_depth`` the
    tree holds DeepSeek-V3's MTP head (``mtp``), which only training uses,
    as in the reference. On a sharded mesh a VLM's ``patches`` are this
    rank's rows, as ``batch_specs`` splits them over the batch axes."""
    cfg: ArchConfig

    def __post_init__(self):
        _refuse_hybrid(self.cfg)
        _refuse_encdec(self.cfg)
        if self.cfg.ssm is not None:
            raise ValueError(f"{self.cfg.name} is a Mamba-2 config: build it "
                             "with SSMLM (or build_model)")

    @property
    def stacks(self) -> tuple[tuple[str, str, int], ...]:
        """(cache key, block kind, layers) of the dense and MoE stacks."""
        cfg = self.cfg
        if cfg.moe is None:
            return (("dense", "dense", cfg.n_layers), ("moe", "moe", 0))
        return (("dense", "dense", cfg.n_dense_layers),
                ("moe", "moe", cfg.n_layers - cfg.n_dense_layers))

    def init(self, gen: torch.Generator, device=None) -> dict:
        """Random parameters drawn from ``gen`` (a CPU generator, or one on
        the card, which draws there), on ``device`` (default cuda;
        ``"meta"`` gives shapes only)."""
        cfg = self.cfg
        device = resolve_device(device)
        p = {"embed": init_embedding(gen, cfg, device)}
        for key, kind, n in self.stacks:
            p[f"{key}_stack"] = init_stack(gen, cfg, kind, n, device)
        p["final_norm"] = init_norm(cfg, cfg.d_model, device)
        if cfg.mtp_depth:
            d = cfg.d_model
            p["mtp"] = {
                "proj": dense_init(gen, (2 * d, d), dtype_of(cfg), device),
                "block": init_block(gen, cfg, self._mtp_kind, device),
                "ln_h": init_norm(cfg, d, device),
                "ln_e": init_norm(cfg, d, device),
            }
        return p

    @property
    def _mtp_kind(self) -> str:
        return "moe" if self.cfg.moe is not None else "dense"

    @property
    def _n_patches(self) -> int:
        return 0 if self.cfg.vision is None else self.cfg.vision.n_patches

    # -------- shared trunk
    def _inputs(self, embed: dict, batch: dict):
        cfg = self.cfg
        x = embed_tokens(embed, batch["tokens"], cfg)
        if cfg.vision is not None:
            x = torch.cat([batch["patches"].to(x.dtype), x], dim=1)
        B, S = x.shape[0], x.shape[1]
        positions = torch.arange(S, device=x.device).expand(B, S)
        if cfg.pos_embedding == "learned":
            x = x + embed["positions"][:S]
        return x, positions

    def _trunk(self, params: dict, x, positions, pctx=None):
        cfg = self.cfg
        caches = {}
        for key, kind, _ in self.stacks:
            if params[f"{key}_stack"] is not None:
                x, caches[key] = stack_forward(
                    params[f"{key}_stack"], x, cfg, kind,
                    positions=positions, pctx=pctx)
        x = _whole(x, pctx, positions.shape[1])
        return apply_norm(params["final_norm"], x, cfg), caches

    # -------- train
    def loss_fn(self, params: dict, batch: dict, pctx=None) -> torch.Tensor:
        """Mean next-token cross entropy of ``batch`` (``tokens``,
        ``labels`` (B, S) int). ``pctx`` (a :class:`ParallelCtx`) reaches
        the MoE layers, which run expert parallelism over its mesh's
        ``data`` axis; the port's data parallelism syncs gradients outside
        the model (:mod:`repro_torch.parallel.grad_sync`). On a sharded
        mesh ``params`` are this rank's blocks and ``batch`` its rows; the
        loss is the mean over those rows, the same on its ``model``
        ranks."""
        embed, _ = _gathered_top(params, self.cfg, pctx)
        x, positions = self._inputs(embed, batch)
        h, _ = self._trunk(params, x, positions, pctx)
        h = h[:, self._n_patches:]
        labels = batch["labels"]
        total = lm_loss(embed, h[:, :-1], labels[:, 1:], self.cfg)
        if self.cfg.mtp_depth:
            total = total + 0.3 * self._mtp_loss(params, h, batch, pctx)
        return total

    def _mtp_loss(self, params: dict, h, batch: dict, pctx=None):
        """DeepSeek-V3 MTP (depth 1): predict token t+2 from the normed
        final hidden state h_t joined with the normed embedding of token
        t+1, through one block and the shared head. The block is not
        recomputed in backward, as in the reference. A VLM's ``h`` is cut
        by the patch count here as well, as the reference cuts it (no
        config has both a patch prefix and an MTP head)."""
        cfg = self.cfg
        h = h[:, self._n_patches:]
        embed, mtp = _gathered_top(params, cfg, pctx)
        e_next = embed_tokens(embed, batch["tokens"][:, 1:], cfg)
        hh = apply_norm(mtp["ln_h"], h[:, :-1], cfg)
        ee = apply_norm(mtp["ln_e"], e_next, cfg)
        z = torch.cat([hh, ee], dim=-1) @ mtp["proj"]
        B, S = z.shape[0], z.shape[1]
        positions = torch.arange(S, device=z.device).expand(B, S)
        z, _ = block_forward(mtp["block"], z, cfg, self._mtp_kind,
                             positions=positions, pctx=pctx)
        z = _whole(z, pctx, S)
        return lm_loss(embed, z[:, :-1], batch["labels"][:, 2:], cfg)

    # -------- serving
    def prefill(self, params: dict, batch: dict, pctx=None):
        """Logits of the last position (B, 1, V) float32 and the per-layer
        KV caches ``{"dense": {"k", "v"}, "moe": {"k", "v"}}`` each (L, B,
        S, K, hd), a key for each non-empty stack (MLA: ``{"c_kv",
        "k_rope"}`` as :meth:`init_cache` shapes them). On a sharded mesh
        the rows are this rank's and the caches its blocks, laid out as
        ``cache_specs`` says. A VLM's caches hold the patch positions
        first."""
        embed, _ = _gathered_top(params, self.cfg, pctx)
        x, positions = self._inputs(embed, batch)
        h, caches = self._trunk(params, x, positions, pctx)
        return logits(embed, h[:, -1:, :], self.cfg), caches

    def decode_step(self, params: dict, caches: dict, batch: dict,
                    pctx=None):
        """One token per row. ``batch``: ``token`` (B,) and ``pos`` (scalar or
        (B,)). Returns (logits (B,1,V) float32, caches), the caches updated
        in place; on a sharded mesh, this rank's rows and cache blocks, as
        :meth:`prefill` leaves them."""
        cfg = self.cfg
        embed, _ = _gathered_top(params, cfg, pctx)
        tok = batch["token"][:, None]
        pos = batch["pos"]
        x = embed_tokens(embed, tok, cfg)
        if cfg.pos_embedding == "learned":
            pos_b = attn._pos_vec(pos, x.shape[0], x.device)
            x = x + embed["positions"][pos_b][:, None, :]
        for key, kind, _ in self.stacks:
            if params[f"{key}_stack"] is not None:
                x, _ = stack_decode(params[f"{key}_stack"], x, cfg, kind,
                                    caches=caches[key], pos=pos, pctx=pctx)
        h = apply_norm(params["final_norm"], x, cfg)
        return logits(embed, h, cfg), caches

    def init_cache(self, batch_size: int, seq_len: int, device=None) -> dict:
        """Zero KV caches shaped for a ``seq_len`` window: ``{"dense": {"k",
        "v"}, "moe": {"k", "v"}}`` each (L, B, S, K, hd), a key for each
        non-empty stack; for MLA ``{"c_kv": (L, B, S, kv_lora), "k_rope":
        (L, B, S, rope)}``, in the model dtype."""
        cfg = self.cfg
        device = resolve_device(device)
        dt = dtype_of(cfg)

        def zeros(*shape):
            return torch.zeros(shape, dtype=dt, device=device)

        out = {}
        for key, _, n in self.stacks:
            if not n:
                continue
            if cfg.mla is not None:
                m = cfg.mla
                out[key] = {"c_kv": zeros(n, batch_size, seq_len,
                                          m.kv_lora_rank),
                            "k_rope": zeros(n, batch_size, seq_len,
                                            m.qk_rope_head_dim)}
            else:
                shape = (n, batch_size, seq_len, cfg.n_kv_heads,
                         cfg.resolved_head_dim)
                out[key] = {"k": zeros(*shape), "v": zeros(*shape)}
        return out


# ------------------------------------------------------------------ SSM model
@dataclasses.dataclass(frozen=True)
class SSMLM:
    """Mamba-2 LM (attention-free): ``init``, ``loss_fn``, ``prefill``,
    ``init_cache`` and ``decode_step``. On a sharded mesh ``params`` are
    this rank's blocks, ``batch`` its rows and the states its blocks: each
    layer's ``data`` shards gathered at its entry and the block split over
    ``model`` by heads (:mod:`repro_torch.models.ssm`)."""
    cfg: ArchConfig

    def __post_init__(self):
        if self.cfg.ssm is None:
            raise ValueError(f"{self.cfg.name} is not a Mamba-2 config")
        _refuse_hybrid(self.cfg)

    def init(self, gen: torch.Generator, device=None) -> dict:
        """Random parameters drawn from ``gen`` (a CPU generator), on
        ``device`` (default cuda; ``"meta"`` gives shapes only)."""
        cfg = self.cfg
        device = resolve_device(device)
        return {
            "embed": init_embedding(gen, cfg, device),
            "stack": init_stack(gen, cfg, "ssm", cfg.n_layers, device),
            "final_norm": init_norm(cfg, cfg.d_model, device),
        }

    def _trunk(self, params: dict, embed: dict, tokens, pctx):
        cfg = self.cfg
        x = embed_tokens(embed, tokens, cfg)
        B, S = x.shape[:2]
        positions = torch.arange(S, device=x.device).expand(B, S)
        x, states = stack_forward(params["stack"], x, cfg, "ssm",
                                  positions=positions, pctx=pctx)
        x = _whole(x, pctx, S)
        return apply_norm(params["final_norm"], x, cfg), states

    def loss_fn(self, params: dict, batch: dict, pctx=None) -> torch.Tensor:
        """Mean next-token cross entropy of ``batch`` (``tokens``,
        ``labels`` (B, S) int); ``pctx`` as in :meth:`LM.loss_fn`."""
        embed, _ = _gathered_top(params, self.cfg, pctx)
        h, _ = self._trunk(params, embed, batch["tokens"], pctx)
        return lm_loss(embed, h[:, :-1], batch["labels"][:, 1:], self.cfg)

    def prefill(self, params: dict, batch: dict, pctx=None):
        """Logits of the last position (B, 1, V) float32 and the states
        ``{"conv": (sx, sB, sC) each (L, B, W-1, C), "ssm": (L, B, h, p,
        n) float32}`` to continue from; on a sharded mesh this rank's rows
        and blocks (channels and heads over ``model``, as ``cache_specs``
        says)."""
        embed, _ = _gathered_top(params, self.cfg, pctx)
        h, states = self._trunk(params, embed, batch["tokens"], pctx)
        return logits(embed, h[:, -1:, :], self.cfg), states

    def decode_step(self, params: dict, states: dict, batch: dict,
                    pctx=None):
        """One token per row. ``batch``: ``token`` (B,) and ``pos`` (unused
        by the recurrence; kept for the engine's signature). Returns
        (logits (B,1,V) float32, states), the states updated in place."""
        cfg = self.cfg
        embed, _ = _gathered_top(params, cfg, pctx)
        x = embed_tokens(embed, batch["token"][:, None], cfg)
        x, _ = stack_decode(params["stack"], x, cfg, "ssm", caches=states,
                            pos=batch["pos"], pctx=pctx)
        h = apply_norm(params["final_norm"], x, cfg)
        return logits(embed, h, cfg), states

    def init_cache(self, batch_size: int, seq_len: int, device=None) -> dict:
        """Zero states for ``batch_size`` rows (``seq_len`` is unused: the
        state does not grow with the sequence)."""
        cfg = self.cfg
        device = resolve_device(device)
        s, d_in, nh, conv_ch = ssm_lib._dims(cfg)
        gn = s.n_groups * s.d_state
        L, W, dt = cfg.n_layers, s.d_conv - 1, dtype_of(cfg)

        def zeros(*shape, dtype=dt):
            return torch.zeros(shape, dtype=dtype, device=device)

        return {"conv": (zeros(L, batch_size, W, d_in),
                         zeros(L, batch_size, W, gn),
                         zeros(L, batch_size, W, gn)),
                "ssm": zeros(L, batch_size, nh, s.head_dim, s.d_state,
                             dtype=torch.float32)}


# --------------------------------------------------------------- Hybrid model
def _unstack(stack, n: int) -> list:
    """The ``n`` trees along the leading axis of ``stack``'s leaves, by one
    ``unbind`` per leaf: in backward each leaf then gathers one gradient,
    where ``t[g]`` per tree would build a zero gradient the size of the
    whole leaf for every ``g``."""
    cols = [t.unbind(0) for t in tree_util.leaves(stack)]
    return [tree_util.unflatten(stack, [c[g] for c in cols])
            for g in range(n)]


@dataclasses.dataclass(frozen=True)
class HybridLM:
    """Zamba2-style: groups of Mamba-2 layers, each group followed by ONE
    shared attention+MLP block (a single weight copy, one KV cache per
    use). ``init``, ``loss_fn``, ``prefill``, ``init_cache`` and
    ``decode_step``, with the reference's tree: ``groups`` leaves are
    (G, group_size, ...), ``shared`` is one dense block. On a sharded mesh
    the SSM layers run as :class:`SSMLM`'s do and the shared block as the
    dense LM's (TP over ``model``, ZeRO-3 over ``data``)."""
    cfg: ArchConfig

    def __post_init__(self):
        cfg = self.cfg
        if not cfg.hybrid_attn_every or cfg.ssm is None:
            raise ValueError(f"{cfg.name} is not a hybrid Mamba-2 config")
        if cfg.n_layers % cfg.hybrid_attn_every:
            raise ValueError(f"{cfg.name}: {cfg.n_layers} layers do not "
                             f"split into groups of {cfg.hybrid_attn_every}")

    @property
    def group_size(self) -> int:
        return self.cfg.hybrid_attn_every

    @property
    def n_groups(self) -> int:
        """Layer groups (G), each followed by the shared block; not the
        SSM's B/C group count ``cfg.ssm.n_groups``."""
        return self.cfg.n_layers // self.group_size

    def init(self, gen: torch.Generator, device=None) -> dict:
        """Random parameters drawn from ``gen`` (a CPU generator), on
        ``device`` (default cuda; ``"meta"`` gives shapes only)."""
        cfg = self.cfg
        device = resolve_device(device)
        embed = init_embedding(gen, cfg, device)
        groups = _stack_trees([
            init_stack(gen, cfg, "ssm", self.group_size, device)
            for _ in range(self.n_groups)])
        return {
            "embed": embed,
            "groups": groups,                    # (G, group_size, ...)
            "shared": init_block(gen, cfg, "dense", device),
            "final_norm": init_norm(cfg, cfg.d_model, device),
        }

    def _trunk(self, params: dict, embed: dict, tokens, pctx):
        """Final-normed hidden states and, per group, its SSM states (leaves
        (group_size, ...)) and the shared block's KV cache. Under autograd
        the SSM layers are recomputed one by one in backward (inside
        ``stack_forward``) and the shared block alone, as the reference
        wraps it in ``jax.checkpoint``."""
        cfg = self.cfg
        x = embed_tokens(embed, tokens, cfg)
        B, S = x.shape[:2]
        positions = torch.arange(S, device=x.device).expand(B, S)

        def shared(h):
            return block_forward(params["shared"], h, cfg, "dense",
                                 positions=positions, pctx=pctx)

        ssm_states, attn_caches = [], []
        for group_p in _unstack(params["groups"], self.n_groups):
            x, states = stack_forward(group_p, x, cfg, "ssm",
                                      positions=positions, pctx=pctx)
            if torch.is_grad_enabled():
                x, cache = checkpoint(shared, x, use_reentrant=False)
            else:
                x, cache = shared(x)
            ssm_states.append(states)
            attn_caches.append(cache)
        h = apply_norm(params["final_norm"], _whole(x, pctx, S), cfg)
        return h, ssm_states, attn_caches

    def loss_fn(self, params: dict, batch: dict, pctx=None) -> torch.Tensor:
        """Mean next-token cross entropy of ``batch`` (``tokens``,
        ``labels`` (B, S) int); ``pctx`` as in :meth:`LM.loss_fn`."""
        embed, _ = _gathered_top(params, self.cfg, pctx)
        h, _, _ = self._trunk(params, embed, batch["tokens"], pctx)
        return lm_loss(embed, h[:, :-1], batch["labels"][:, 1:], self.cfg)

    def prefill(self, params: dict, batch: dict, pctx=None):
        """Logits of the last position (B, 1, V) float32 and the caches
        ``{"ssm": {"conv": (sx, sB, sC) each (G, gs, B, W-1, C), "ssm":
        (G, gs, B, h, p, n) float32}, "attn": {"k", "v"} each (G, B, S, K,
        hd)}``; on a sharded mesh this rank's rows and blocks, as
        ``cache_specs`` lays them out."""
        embed, _ = _gathered_top(params, self.cfg, pctx)
        h, ssm_states, attn_caches = self._trunk(params, embed,
                                                 batch["tokens"], pctx)
        return logits(embed, h[:, -1:, :], self.cfg), {
            "ssm": _stack_trees(ssm_states),
            "attn": _stack_trees(attn_caches)}

    def decode_step(self, params: dict, caches: dict, batch: dict,
                    pctx=None):
        """One token per row. ``batch``: ``token`` (B,) and ``pos`` (scalar or
        (B,)). Returns (logits (B,1,V) float32, caches), the caches updated
        in place: group g's SSM states and KV cache are written through
        views of slice ``[g]``."""
        cfg = self.cfg
        pos = batch["pos"]
        embed, _ = _gathered_top(params, cfg, pctx)
        x = embed_tokens(embed, batch["token"][:, None], cfg)
        for g, group_p in enumerate(_unstack(params["groups"],
                                             self.n_groups)):
            x, _ = stack_decode(group_p, x, cfg, "ssm", pos=pos, pctx=pctx,
                                caches=tree_util.tree_map(lambda t: t[g],
                                                          caches["ssm"]))
            x, _ = block_decode(params["shared"], x, cfg, "dense", pos=pos,
                                pctx=pctx, cache={k: v[g] for k, v in
                                                  caches["attn"].items()})
        h = apply_norm(params["final_norm"], x, cfg)
        return logits(embed, h, cfg), caches

    def init_cache(self, batch_size: int, seq_len: int, device=None) -> dict:
        """Zero caches for ``batch_size`` rows and a ``seq_len`` window,
        shaped as :meth:`prefill` returns them."""
        cfg = self.cfg
        device = resolve_device(device)
        s, d_in, nh, _ = ssm_lib._dims(cfg)
        gn = s.n_groups * s.d_state
        G, gs, W, dt = self.n_groups, self.group_size, s.d_conv - 1, \
            dtype_of(cfg)

        def zeros(*shape, dtype=dt):
            return torch.zeros(shape, dtype=dtype, device=device)

        kv = (G, batch_size, seq_len, cfg.n_kv_heads, cfg.resolved_head_dim)
        return {"ssm": {"conv": (zeros(G, gs, batch_size, W, d_in),
                                 zeros(G, gs, batch_size, W, gn),
                                 zeros(G, gs, batch_size, W, gn)),
                        "ssm": zeros(G, gs, batch_size, nh, s.head_dim,
                                     s.d_state, dtype=torch.float32)},
                "attn": {"k": zeros(*kv), "v": zeros(*kv)}}


# --------------------------------------------------------------- EncDec model
@dataclasses.dataclass(frozen=True)
class EncDecLM:
    """Whisper-style encoder-decoder; the conv frontend is a stub:
    precomputed frame embeddings arrive in ``batch["frames"]`` (B, S_enc,
    d). ``init``, ``loss_fn``, ``prefill``, ``init_cache`` and
    ``decode_step``, with the reference's tree: ``enc_pos`` (S_enc, d),
    ``encoder`` and ``decoder`` stacks (a decoder block adds ``ln_x`` and
    ``xattn``), ``enc_norm`` and ``final_norm``. On a sharded mesh
    ``enc_pos`` and the learned ``positions`` (split on ``d``) are gathered
    at use, the encoder runs the dense TP path without the causal mask,
    and each decoder layer's ``xattn`` heads split over ``model``: its K/V
    from the encoder output (the same on every ``model`` rank) enter them
    through a copy to ``model``, and ``cross`` caches this rank's heads."""
    cfg: ArchConfig

    def __post_init__(self):
        if self.cfg.encdec is None:
            raise ValueError(f"{self.cfg.name} is not an encoder-decoder "
                             "config")

    def init(self, gen: torch.Generator, device=None) -> dict:
        """Random parameters drawn from ``gen`` (a CPU generator, or one on
        the card), on ``device`` (default cuda; ``"meta"`` gives shapes
        only)."""
        cfg = self.cfg
        device = resolve_device(device)
        e = cfg.encdec
        return {
            "embed": init_embedding(gen, cfg, device),
            "enc_pos": dense_init(gen, (e.encoder_seq, cfg.d_model),
                                  dtype_of(cfg), device, scale=0.02),
            "encoder": init_stack(gen, cfg, "encoder", e.n_encoder_layers,
                                  device),
            "enc_norm": init_norm(cfg, cfg.d_model, device),
            "decoder": init_stack(gen, cfg, "decoder", cfg.n_layers, device),
            "final_norm": init_norm(cfg, cfg.d_model, device),
        }

    def _enc_pos(self, params: dict, pctx):
        """``enc_pos``, gathered whole on a sharded mesh."""
        if pctx is None or not pctx.sharded:
            return params["enc_pos"]
        return gather_leaf(params["enc_pos"], Sharding(
            pctx.mesh, top_specs(self.cfg, pctx)["enc_pos"]), pctx)

    def _encode(self, params: dict, frames, pctx):
        """The normed encoder output (B, S_enc, d): frames rounded to the
        model dtype plus ``enc_pos``, through the non-causal stack."""
        cfg = self.cfg
        x = frames.to(dtype_of(cfg)) + self._enc_pos(params, pctx)
        B, S = x.shape[:2]
        positions = torch.arange(S, device=x.device).expand(B, S)
        x, _ = stack_forward(params["encoder"], x, cfg, "encoder",
                             positions=positions, pctx=pctx, causal=False)
        return apply_norm(params["enc_norm"], _whole(x, pctx, S), cfg)

    def _decode_stack(self, params: dict, embed: dict, tokens, enc, pctx):
        """Final-normed decoder states and the self-attention caches; each
        layer computes its cross K/V from ``enc``."""
        cfg = self.cfg
        x = embed_tokens(embed, tokens, cfg)
        B, S = x.shape[:2]
        if cfg.pos_embedding == "learned":
            x = x + embed["positions"][:S]
        positions = torch.arange(S, device=x.device).expand(B, S)
        x, caches = stack_forward(params["decoder"], x, cfg, "decoder",
                                  positions=positions, pctx=pctx, cross=enc)
        x = _whole(x, pctx, S)
        return apply_norm(params["final_norm"], x, cfg), caches

    def loss_fn(self, params: dict, batch: dict, pctx=None) -> torch.Tensor:
        """Mean next-token cross entropy of ``batch`` (``frames`` (B, S_enc,
        d); ``tokens``, ``labels`` (B, S) int); ``pctx`` as in
        :meth:`LM.loss_fn`."""
        embed, _ = _gathered_top(params, self.cfg, pctx)
        enc = self._encode(params, batch["frames"], pctx)
        h, _ = self._decode_stack(params, embed, batch["tokens"], enc, pctx)
        return lm_loss(embed, h[:, :-1], batch["labels"][:, 1:], self.cfg)

    def prefill(self, params: dict, batch: dict, pctx=None):
        """Logits of the last position (B, 1, V) float32 and the caches
        ``{"self": {"k", "v"} each (L, B, S, K, hd), "cross": (k, v) each
        (L, B, S_enc, K, hd)}``, the cross K/V computed per layer from the
        encoder output; on a sharded mesh this rank's rows and KV heads."""
        cfg = self.cfg
        embed, _ = _gathered_top(params, cfg, pctx)
        enc = self._encode(params, batch["frames"], pctx)
        h, caches = self._decode_stack(params, embed, batch["tokens"], enc,
                                       pctx)
        xattn = params["decoder"]["xattn"]
        kvs = []
        for i in range(xattn["wk"].shape[0]):
            p_i, specs = _unfsdp(tree_util.tree_map(lambda t: t[i], xattn),
                                 cfg, pctx, "decoder", part="xattn")
            kvs.append(attn.cross_kv(p_i, enc, cfg, pctx, specs))
        cross = (torch.stack([k for k, _ in kvs]),
                 torch.stack([v for _, v in kvs]))
        return logits(embed, h[:, -1:, :], cfg), {"self": caches,
                                                  "cross": cross}

    def decode_step(self, params: dict, caches: dict, batch: dict,
                    pctx=None):
        """One token per row. ``batch``: ``token`` (B,) and ``pos`` (scalar or
        (B,)). Returns (logits (B,1,V) float32, caches): the self caches
        updated in place, the cross caches read whole (``decode_attn`` at
        length S_enc) and left as they are."""
        cfg = self.cfg
        embed, _ = _gathered_top(params, cfg, pctx)
        x = embed_tokens(embed, batch["token"][:, None], cfg)
        pos = batch["pos"]
        if cfg.pos_embedding == "learned":
            pos_b = attn._pos_vec(pos, x.shape[0], x.device)
            x = x + embed["positions"][pos_b][:, None, :]
        x, _ = stack_decode(params["decoder"], x, cfg, "decoder",
                            caches=caches["self"], pos=pos, pctx=pctx,
                            cross_kv=caches["cross"])
        h = apply_norm(params["final_norm"], x, cfg)
        return logits(embed, h, cfg), caches

    def init_cache(self, batch_size: int, seq_len: int, device=None) -> dict:
        """Zero caches shaped as :meth:`prefill` returns them, the self
        caches for a ``seq_len`` window."""
        cfg = self.cfg
        device = resolve_device(device)
        hd, K, L = cfg.resolved_head_dim, cfg.n_kv_heads, cfg.n_layers
        dt = dtype_of(cfg)

        def zeros(*shape):
            return torch.zeros(shape, dtype=dt, device=device)

        kv = (L, batch_size, seq_len, K, hd)
        xkv = (L, batch_size, cfg.encdec.encoder_seq, K, hd)
        return {"self": {"k": zeros(*kv), "v": zeros(*kv)},
                "cross": (zeros(*xkv), zeros(*xkv))}


def build_model(cfg: ArchConfig):
    """The port's model for ``cfg``: :class:`SSMLM` for the ``ssm`` family,
    :class:`HybridLM` for ``hybrid``, :class:`EncDecLM` for ``audio``,
    :class:`LM` otherwise (dense, MoE, VLM)."""
    if cfg.family == "ssm":
        return SSMLM(cfg)
    if cfg.family == "hybrid":
        return HybridLM(cfg)
    if cfg.family == "audio":
        return EncDecLM(cfg)
    return LM(cfg)
