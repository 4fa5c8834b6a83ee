"""Mixture-of-Experts FFN with expert-parallel (EP) dispatch.

Counterpart of ``repro.models.moe``. The paper's interconnect exists to make
this pattern cheap: many endpoints exchanging medium-size token blocks. The
reference expresses the dispatch as an ``all_to_all`` over the ``data`` mesh
axis inside ``shard_map``; here it is :func:`all_to_all` over the ``data``
process group of a :class:`repro_torch.launch.mesh.ProcessMesh`.

Two-level capacity buffers keep every shape static, as in the reference:

1. route: top-k over a replicated router (ties to the lower expert id, as
   ``jax.lax.top_k`` breaks them);
2. pack per-destination-rank capacity buffers (scatter by running index in
   the flat (token, choice) order);
3. ``all_to_all`` tokens and metadata to the ranks that hold their experts;
4. pack again into per-local-expert buffers (empty wire slots go to a trash
   bucket); batched expert products (E_l, C, d) x (E_l, d, f), plain
   ``torch.bmm`` as the reference's einsums are plain XLA dots;
5. ``all_to_all`` back, combine with the routing weights.

Tokens that overflow a capacity buffer are dropped. On a mesh of batch
axes only, every rank keeps the whole expert stack (replicated, as the
port's data parallelism keeps every leaf) and computes with its own ``E /
ep`` slice: its gradient of the other experts is zero, so the mean over the
world that the gradient sync takes is the gradient of the global mean loss,
as the reference's sharded step gives. On a sharded mesh (a ``model``
axis) the experts are stored as ``param_specs`` lays them out: dim 0 over
``data``, so a rank holds its ``E / ep`` experts and their gradient sums
its pod's tokens through the all_to_all's adjoint, and the expert hidden
dim over ``model`` (tensor parallelism: the buffers enter the local
experts through a copy to ``model``, and the partial ``w_out`` products
are summed over it, the reference's ``psum`` at ``moe.py:192-194``).

The body runs on R ranks' tokens at once (leading axis R): one on a real
rank, all ``ep`` ranks of a data group in :func:`emulate_ep`, where the
``all_to_all`` is a transpose of the stacked buffers. The two run the same
code.
"""

from __future__ import annotations

import math

import torch

from repro_torch.config import ArchConfig
from repro_torch.core.collectives import all_to_all, tagged
from repro_torch.models.layers import (_act, dense_init, dtype_of, mlp_tp,
                                       tp_active)
from repro_torch.parallel.tensor_parallel import copy_to_model, sum_over_model

#: when a list, each MoE layer call appends ``(routed, kept)``: the
#: (token, choice) slots its tokens routed (an int) and the slots its
#: experts took (a 0-dim device tensor). Over one process, or summed over a
#: data group, ``routed - kept`` slots were dropped
drop_log: list | None = None


def init_moe(gen, cfg: ArchConfig, d: int, device) -> dict:
    m = cfg.moe
    dt = dtype_of(cfg)
    p = {
        "router": dense_init(gen, (d, m.n_experts), torch.float32, device,
                             scale=0.02),
        "w_gate": dense_init(gen, (m.n_experts, d, m.d_expert), dt, device,
                             scale=d ** -0.5),
        "w_up": dense_init(gen, (m.n_experts, d, m.d_expert), dt, device,
                           scale=d ** -0.5),
        "w_out": dense_init(gen, (m.n_experts, m.d_expert, d), dt, device,
                            scale=m.d_expert ** -0.5),
    }
    if m.n_shared_experts:
        ff = m.d_shared * m.n_shared_experts
        p["shared"] = {"w_gate": dense_init(gen, (d, ff), dt, device),
                       "w_up": dense_init(gen, (d, ff), dt, device),
                       "w_out": dense_init(gen, (ff, d), dt, device)}
    return p


# ------------------------------------------------------------ all_to_all
class AllToAll(torch.autograd.Function):
    """``apply(x, fn)``: ``fn(x)`` for a block transpose ``fn`` (an
    :func:`all_to_all`, or its emulation on stacked buffers). A transpose is
    its own adjoint, so the backward is the same exchange of the
    gradient."""

    @staticmethod
    def forward(ctx, x, fn):
        ctx.fn = fn
        return fn(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.fn(g), None


def _qa2a_impl(x: torch.Tensor, fn) -> torch.Tensor:
    """int8 codes with one float32 scale per slot (the last dim), moved by
    ``fn`` beside their scales, dequantized in ``x``'s dtype."""
    xf = x.float()
    scale = torch.clamp(xf.abs().amax(-1, keepdim=True) / 127.0, min=1e-20)
    q8 = torch.round(xf / scale).to(torch.int8)
    q8, s = fn(q8), fn(scale)
    return q8.to(x.dtype) * s.to(x.dtype)


class QuantizedAllToAll(torch.autograd.Function):
    """int8-quantized exchange with a quantized adjoint (the reference's
    ``_qa2a``): the dispatch and its gradient both cross as int8 codes and
    float32 per-slot scales. ``apply(x, fn)``, ``fn`` the block transpose."""

    @staticmethod
    def forward(ctx, x, fn):
        ctx.fn = fn
        return _qa2a_impl(x, fn)

    @staticmethod
    def backward(ctx, g):
        return _qa2a_impl(g, ctx.fn).to(g.dtype), None


# ---------------------------------------------------------------- packing
def _lead_offsets(idx: torch.Tensor, n: int) -> torch.Tensor:
    """``idx`` (R, N) into R blocks of ``n`` rows, as flat row indices."""
    R = idx.shape[0]
    if R == 1:
        return idx
    return idx + torch.arange(R, device=idx.device)[:, None] * n


def _slots(dest, n_dest: int, capacity: int):
    """Per row of ``dest`` (R, N): its running index within its destination
    (the count of earlier rows, in flat order, with the same destination),
    whether it fits the capacity, and its flat slot ``dest * capacity +
    pos`` in ``n_dest * capacity`` slots, or ``n_dest * capacity`` (the
    overflow slot) when it does not fit."""
    dest = dest.long()
    classes = torch.arange(n_dest, device=dest.device)[:, None]
    # one row per destination, so the running count is an inner-dim scan
    seen = torch.cumsum(dest[:, None, :] == classes, dim=-1,
                        dtype=torch.int32)                      # (R, D, N)
    pos = seen.gather(1, dest[:, None, :])[:, 0].long() - 1
    valid = pos < capacity
    slot = torch.where(valid, dest * capacity + pos, n_dest * capacity)
    return pos, valid, slot


def _scatter(slot, n_slots: int, payload):
    """``payload`` (R, N, *F) rows written to their slots of (R, n_slots,
    *F) zeros; rows at the overflow slot ``n_slots`` are dropped."""
    R, N = slot.shape
    feat = payload.shape[2:]
    buf = payload.new_zeros((R * (n_slots + 1),) + feat)
    buf = buf.index_put((_lead_offsets(slot, n_slots + 1).reshape(-1),),
                        payload.reshape((R * N,) + feat))
    return buf.view((R, n_slots + 1) + feat)[:, :n_slots]


def _take(t, idx):
    """Rows ``idx`` (R, N) of ``t`` (R, M, d): (R, N, d)."""
    R, M, d = t.shape
    rows = _lead_offsets(idx, M).reshape(-1)
    return t.reshape(R * M, d).index_select(0, rows).view(R, -1, d)


def _pack(dest, n_dest: int, capacity: int, payload):
    """Scatter ``payload`` rows into ``(n_dest, capacity, ...)`` buffers by
    running index within each destination; returns (buffers, pos, valid),
    as the reference's ``_pack``: ``dest`` (N,) int, ``payload`` (N, *F); a
    row at or past ``capacity`` is dropped (the reference adds it as zero
    at slot ``capacity - 1``, which leaves the buffer as this does)."""
    pos, valid, slot = _slots(dest[None], n_dest, capacity)
    buf = _scatter(slot, n_dest * capacity, payload[None])
    return (buf[0].reshape((n_dest, capacity) + payload.shape[1:]), pos[0],
            valid[0])


# --------------------------------------------------------------- the body
def _expert_ffn(w_gate, w_up, w_out, x, cfg: ArchConfig):
    """x: (E_l, C, d) -> (E_l, C, d), batched over local experts."""
    g = torch.bmm(x, w_gate)
    u = torch.bmm(x, w_up)
    return torch.bmm(_act(cfg, g) * u, w_out)


def route(x: torch.Tensor, router_w: torch.Tensor, cfg: ArchConfig):
    """Top-k routing of tokens ``x`` (..., d): (weights (..., k) float32, ids
    (..., k), logits (..., E) float32). The router product is taken in
    ``x``'s dtype, then widened (bf16 logits tie often); a stable descending
    sort keeps the lower expert id first on ties, as ``jax.lax.top_k``."""
    m = cfg.moe
    logits = (x @ router_w.to(x.dtype)).float()
    vals, ids = torch.sort(logits, dim=-1, descending=True, stable=True)
    vals, ids = vals[..., :m.top_k], ids[..., :m.top_k]
    if m.router_softmax:
        w = torch.softmax(vals, dim=-1)
    else:
        w = torch.sigmoid(vals)
        w = w / torch.clamp(w.sum(dim=-1, keepdim=True), min=1e-9)
    return w, ids, logits


def _moe_body(x, router_w, w_gate, w_up, w_out, cfg: ArchConfig, fn=None,
              tp_pctx=None):
    """x: (R, T, d), the tokens of R ranks of one data group (R = 1 on a
    real rank); ``w_*``: (R * E_l, ...), each rank's E_l local experts in
    rank order; ``fn``: the block transpose of (R, ep, cap, ...) buffers
    over the group, or None when every expert is local (ep = 1);
    ``tp_pctx``: the context whose ``model`` axis splits the experts'
    hidden dim, or None.

    The reference's steps with the same capacities and drop order, laid
    out for the card: each pack writes its rows to distinct slots (the
    overflow to one slot that is cut off) and each un-pack reads rows, so
    no step accumulates into a buffer in forward or in backward."""
    m = cfg.moe
    R, T, d = x.shape
    E_l = w_gate.shape[0] // R
    ep = m.n_experts // E_l
    k = m.top_k
    w, ids, _ = route(x, router_w, cfg)                           # (R, T, k)

    # send side: pack each (t, j) slot for the rank that holds its expert
    flat_ids = ids.reshape(R, T * k)
    dest_shard = flat_ids // E_l
    cap_send = max(1, math.ceil(T * k / ep * m.capacity_factor))
    n_send = ep * cap_send
    _, valid_send, slot_send = _slots(dest_shard, ep, cap_send)
    payload = x[:, :, None].expand(R, T, k, d).reshape(R, T * k, d)
    send = _scatter(slot_send, n_send, payload)
    # local expert id + 1; 0 marks an empty slot
    send_meta = _scatter(slot_send, n_send, flat_ids % E_l + 1)

    if fn is not None and ep > 1:
        send = (QuantizedAllToAll if m.a2a_quant else AllToAll).apply(
            send.reshape(R, ep, cap_send, d), fn)
        send_meta = fn(send_meta.reshape(R, ep, cap_send))

    # destination side: group received slots by local expert; empty wire
    # slots go to bucket E_l so they never take expert capacity
    recv = send.reshape(R, n_send, d)
    recv_meta = send_meta.reshape(R, n_send)
    has_tok = recv_meta > 0
    local_e = torch.where(has_tok, recv_meta - 1, E_l)
    # per-local-expert capacity, the capacity factor squared as in the
    # reference (moe.py:167-168)
    cap_e = max(1, math.ceil(T * k / E_l
                             * m.capacity_factor * m.capacity_factor))
    _, valid_e, slot_e = _slots(local_e, E_l + 1, cap_e)
    valid_e = valid_e & has_tok
    slot_e = torch.where(valid_e, slot_e, E_l * cap_e)
    if drop_log is not None:
        drop_log.append((R * T * k, valid_e.sum()))
    ebuf = _scatter(slot_e, E_l * cap_e, recv).reshape(R * E_l, cap_e, d)
    if tp_pctx is not None:
        ebuf = copy_to_model(ebuf, tp_pctx)
    y_e = _expert_ffn(w_gate, w_up, w_out, ebuf, cfg)
    if tp_pctx is not None:
        y_e = sum_over_model(y_e, tp_pctx)
    # un-pack into the wire layout: a slot reads its expert's output, or 0
    back = _take(y_e.reshape(R, E_l * cap_e, d),
                 torch.where(valid_e, slot_e, 0))
    back = torch.where(valid_e[..., None], back, 0)

    if fn is not None and ep > 1:
        back = (QuantizedAllToAll if m.a2a_quant else AllToAll).apply(
            back.reshape(R, ep, cap_send, d), fn).reshape(R, n_send, d)

    # combine at the source: gather each (t, j) contribution, weight it and
    # sum a token's k of them in order, in x's dtype (the reference's
    # segment_sum over the sorted flat_src rounds after each add)
    contrib = _take(back, torch.where(valid_send, slot_send, 0))
    contrib = torch.where(valid_send[..., None], contrib, 0)
    contrib = contrib * w.reshape(R, T * k, 1).to(contrib.dtype)
    contrib = contrib.reshape(R, T, k, d)
    y = contrib[:, :, 0]
    for j in range(1, k):
        y = y + contrib[:, :, j]
    return y.to(x.dtype)


def _shared(p: dict, x, cfg: ArchConfig, pctx=None):
    """The shared experts: a gated MLP, split over ``model`` as the dense
    MLP is when its width divides."""
    sh, m = p["shared"], cfg.moe
    tp = mlp_tp(m.d_shared * m.n_shared_experts, pctx)
    if tp:
        x = copy_to_model(x, pctx)
    y = (_act(cfg, x @ sh["w_gate"]) * (x @ sh["w_up"])) @ sh["w_out"]
    return sum_over_model(y, pctx) if tp else y


def ep_size(pctx, cfg: ArchConfig) -> int:
    """Ranks the experts are spread over: the ``data`` axis of ``pctx``'s
    mesh when it is larger than 1 and divides the expert count, else 1 (the
    local path). A ``model`` axis splits the experts' hidden dim on top
    (:func:`expert_tp`)."""
    if pctx is None:
        return 1
    n = pctx.mesh.shape.get("data", 1)
    return n if n > 1 and cfg.moe.n_experts % n == 0 else 1


def expert_tp(pctx, cfg: ArchConfig) -> bool:
    """Whether the experts' hidden dim is split over ``model``: their
    ``param_spec`` shards it there iff it divides."""
    return tp_active(pctx) and cfg.moe.d_expert % pctx.tp_size == 0


def apply_moe(p: dict, x: torch.Tensor, cfg: ArchConfig,
              pctx=None) -> torch.Tensor:
    """x: (B, S, d), this rank's rows. With a :class:`ParallelCtx` whose mesh
    has a ``data`` axis of size ep > 1 that divides the expert count, EP
    over that axis: this rank (``data`` coordinate r) computes experts
    ``r*E/ep .. (r+1)*E/ep - 1`` for every rank of its pod's data group,
    through :func:`all_to_all` over the group. The reference tests that
    the global ``B*S`` splits over the DP ranks; here ``x`` is already one
    rank's share, and every rank of the data group must pass the same
    (B, S): both capacities derive from it, and the exchange needs equal
    buffers (the port's data-parallel batch split gives that). Otherwise
    the local path, all experts here. ``p``'s expert stacks hold all E
    experts (this rank's slice is taken here) or, on a sharded mesh, this
    rank's E/ep of them; on a sharded mesh the router and the shared
    experts are whole over ``data`` (gathered at the layer's entry) and
    the experts' hidden dim may be split over ``model``
    (:func:`expert_tp`)."""
    m = cfg.moe
    B, S, d = x.shape
    xt = x.reshape(1, B * S, d)
    ep = ep_size(pctx, cfg)
    tp_pctx = pctx if expert_tp(pctx, cfg) else None
    ws = [p["w_gate"], p["w_up"], p["w_out"]]
    stored = ws[0].shape[0]
    if stored != m.n_experts and (ep == 1 or stored != m.n_experts // ep):
        raise ValueError(f"the expert stack holds {stored} of "
                         f"{m.n_experts} experts, not what EP over "
                         f"{ep} data ranks uses")
    if ep > 1:
        mesh = pctx.mesh
        E_l = m.n_experts // ep
        if stored == m.n_experts:
            sl = slice(mesh.coords["data"] * E_l,
                       (mesh.coords["data"] + 1) * E_l)
            ws = [w[sl] for w in ws]
        group = mesh.group("data")

        def fn(t):
            with tagged("ep_all_to_all"):
                return all_to_all(t[0], group)[None]

        y = _moe_body(xt, p["router"], *ws, cfg, fn, tp_pctx)
    else:
        y = _moe_body(xt, p["router"], *ws, cfg, None, tp_pctx)
    y = y.reshape(B, S, d)
    if m.n_shared_experts:
        y = y + _shared(p, x, cfg, pctx)
    return y


def emulate_ep(p: dict, x: torch.Tensor, cfg: ArchConfig, ep: int,
               pods: int = 1) -> torch.Tensor:
    """The EP path of ``pods`` data groups of ``ep`` ranks, run in one
    process: ``x`` (B, S, d) holds every rank's rows, rank ``(pod, r)``
    the ``pod * ep + r``-th equal share of the flat tokens (the port's and
    the reference's data-parallel split). Each group's ``all_to_all`` is a
    transpose of its ranks' stacked buffers, so the result is what
    :func:`apply_moe` gives on each rank of a real mesh."""
    B, S, d = x.shape
    xt = x.reshape(pods, ep, B * S // (pods * ep), d)

    def fn(t):
        return t.transpose(0, 1).contiguous()

    y = torch.cat([_moe_body(xt[g], p["router"], p["w_gate"], p["w_up"],
                             p["w_out"], cfg, fn) for g in range(pods)])
    y = y.reshape(B, S, d)
    if cfg.moe.n_shared_experts:
        y = y + _shared(p, x, cfg)
    return y
