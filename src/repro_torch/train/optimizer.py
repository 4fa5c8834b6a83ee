"""AdamW with optional block-wise int8 state quantization.

Counterpart of ``repro.train.optimizer``, written out in PyTorch over the
reference's tree layout: ``{"m": tree, "v": tree, "step": int32 scalar}``,
each moment leaf float32 or, when quantized, ``{"q": int8 (param shape),
"scale": float32 (per last-dim block)}`` (8-bit Adam, arXiv:2110.02861), so
optimizer states and checkpoints cross frameworks. Parameters stay in their
own dtype (bf16) with no float32 master copy, as in the reference. The
update is functional: new tensors, the inputs untouched; or, donated, the
same arithmetic written into the given tensors.

On a sharded mesh (``shardings``: the parameters' tree of
:class:`~repro_torch.parallel.sharding.Sharding`) each rank updates its
blocks: the global gradient norm sums each leaf's squares over the ranks
of one copy of it (a replicated leaf counts once), and an int8 moment
whose per-block scales stay whole over the last dim's axis (the blocks no
longer divide it, ``opt_state_specs``) reads its scales by global block
and is quantized from its last dim gathered whole, so its bits are the
unsharded ones.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch import tree as tree_util


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    quantize_states: bool = False   # int8 block-quantized m/v
    qblock: int = 256
    warmup_steps: int = 100
    decay_steps: int = 10000


# ------------------------------------------------------- int8 block quant
def _quantizable(p: torch.Tensor, cfg: AdamWConfig) -> bool:
    return (cfg.quantize_states and p.dim() >= 1
            and p.shape[-1] % cfg.qblock == 0 and p.numel() >= 4 * cfg.qblock)


def _quant(x: torch.Tensor, block: int) -> tuple[torch.Tensor, torch.Tensor]:
    blocks = x.reshape(x.shape[:-1] + (x.shape[-1] // block, block))
    scale = torch.amax(torch.abs(blocks), dim=-1) / 127.0
    q = torch.round(blocks / torch.clamp(scale, min=1e-20)[..., None])
    return q.reshape(x.shape).to(torch.int8), scale.float()


def _dequant(q: torch.Tensor, scale: torch.Tensor, block: int) -> torch.Tensor:
    blocks = q.reshape(q.shape[:-1] + (q.shape[-1] // block, block))
    return (blocks.float() * scale[..., None]).reshape(q.shape)


def _is_state(x) -> bool:
    return isinstance(x, dict) and set(x) == {"q", "scale"}


def _state_for(p: torch.Tensor, cfg: AdamWConfig):
    if _quantizable(p, cfg):
        return {"q": torch.zeros(p.shape, dtype=torch.int8, device=p.device),
                "scale": torch.zeros(p.shape[:-1] + (p.shape[-1] // cfg.qblock,),
                                     dtype=torch.float32, device=p.device)}
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


def _split_blocks(state, cfg: AdamWConfig) -> bool:
    """Whether this block of an int8 state cuts its quantization blocks
    (its scales are whole over the last dim, its codes are not)."""
    return state["q"].shape[-1] != state["scale"].shape[-1] * cfg.qblock


def _last_offset(sh, t: torch.Tensor) -> int:
    """Where this rank's block of ``t``'s last dim starts."""
    return sh.block_index(sh.mesh.coords, t.dim())[-1] * t.shape[-1]


def _read(state, cfg: AdamWConfig, sh=None) -> torch.Tensor:
    if not _is_state(state):
        return state
    if not _split_blocks(state, cfg):
        return _dequant(state["q"], state["scale"], cfg.qblock)
    q = state["q"]
    n = q.shape[-1]
    blk = (_last_offset(sh, q) + torch.arange(n, device=q.device)) \
        // cfg.qblock
    return q.float() * state["scale"][..., blk]


def _write(val: torch.Tensor, state, cfg: AdamWConfig, sh=None):
    if not _is_state(state):
        return val
    if not _split_blocks(state, cfg):
        q, s = _quant(val, cfg.qblock)
        return {"q": q, "scale": s}
    from repro_torch.parallel.tensor_parallel import gather_dims
    n = val.shape[-1]
    q, s = _quant(gather_dims(val, sh, (val.dim() - 1,)), cfg.qblock)
    off = _last_offset(sh, val)
    return {"q": q[..., off:off + n].contiguous(), "scale": s}


# ---------------------------------------------------------------- schedule
def lr_at(step: torch.Tensor, cfg: AdamWConfig) -> torch.Tensor:
    """Linear warmup then cosine decay to 10% of ``cfg.lr``; float32."""
    s = step.float()
    warm = torch.clamp(s / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((s - cfg.warmup_steps)
                       / max(cfg.decay_steps - cfg.warmup_steps, 1), 0, 1)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (0.1 + 0.9 * cos)


# --------------------------------------------------------------- optimizer
def adamw_init(params, cfg: AdamWConfig) -> dict:
    device = tree_util.leaves(params)[0].device
    return {
        "m": tree_util.tree_map(lambda p: _state_for(p, cfg), params),
        "v": tree_util.tree_map(lambda p: _state_for(p, cfg), params),
        "step": torch.zeros((), dtype=torch.int32, device=device),
    }


def global_norm(tree, shardings=None) -> torch.Tensor:
    """sqrt of the sum of every element's square. With ``shardings``
    (``tree`` this rank's blocks) each leaf's sum of squares is summed over
    the ranks that hold one copy of it (coordinate 0 on every axis its spec
    does not name), in rank order by ``combine``: the same bits on every
    rank."""
    if shardings is None:
        return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                              for g in tree_util.leaves(tree)))
    from repro_torch.core.collectives import all_gather_stack
    from repro_torch.kernels.allreduce_combine.ops import combine_parts
    from repro_torch.parallel.sharding import spec_axes
    shards = _sharding_leaves(shardings)
    grads = tree_util.leaves(tree)
    mesh = shards[0].mesh
    local = torch.stack([torch.sum(torch.square(g.float())) for g in grads])
    every = all_gather_stack(local, mesh.group(mesh.axis_names))  # (W, n)
    named = [{a for e in s.spec for a in spec_axes(e)} for s in shards]
    keep = torch.tensor(
        [[all(c[a] == 0 for a in mesh.axis_names if a not in axes)
          for axes in named]
         for c in (mesh.coords_of(r) for r in range(every.shape[0]))],
        device=every.device)
    per_leaf = combine_parts(torch.where(keep, every, 0.0), op="sum")
    return torch.sqrt(per_leaf.sum())


def _sharding_leaves(shardings) -> list:
    from repro_torch.parallel.sharding import Sharding
    return tree_util.leaves(shardings,
                            is_leaf=lambda x: isinstance(x, Sharding))


def _step_terms(grads, opt_state: dict, cfg: AdamWConfig, shardings=None):
    """(step, gradient norm, clip scale, lr, bias corrections 1 and 2) of
    the update that ``opt_state`` takes next."""
    step = opt_state["step"] + 1
    gnorm = global_norm(grads, shardings)
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-12), max=1.0)
    sf = step.float()
    bc1 = 1 - torch.pow(torch.tensor(cfg.b1, dtype=torch.float32,
                                     device=sf.device), sf)
    bc2 = 1 - torch.pow(torch.tensor(cfg.b2, dtype=torch.float32,
                                     device=sf.device), sf)
    return step, gnorm, scale, lr_at(step, cfg), bc1, bc2


def adamw_update(grads, opt_state: dict, params, cfg: AdamWConfig,
                 donate: bool = False, shardings=None):
    """Returns (new_params, new_opt_state, metrics). With ``donate`` the
    parameters and moments are updated in place (the counterpart of
    ``jax.jit``'s ``donate_argnums``) and the returned trees hold the same
    tensors: the same arithmetic, so the same bits, but the old state is
    not kept beside the new one, and a leaf's temporaries are about 3
    float32 copies of it instead of 5. With ``shardings`` the trees hold
    this rank's blocks (see the module docstring)."""
    step, gnorm, scale, lr, bc1, bc2 = _step_terms(grads, opt_state, cfg,
                                                   shardings)

    def upd(p, g, m_st, v_st, sh):
        # m = b1*m + (1-b1)*g; v = b2*v + (1-b2)*g*g;
        # u = (m/bc1) / (sqrt(v/bc2) + eps) + wd*p; p - lr*u: the same ops in
        # the same order, written in place on the update's own temporaries so
        # that a leaf holds at most ~5 float32 copies of itself at once (a
        # 2.8B-parameter model's largest leaf is 3.4 GB in float32); donated,
        # float32 moments accumulate in their own storage
        g = g.float() * scale
        m = _read(m_st, cfg, sh)
        m = m.mul_(cfg.b1) if donate and m is m_st else cfg.b1 * m
        m += (1 - cfg.b1) * g
        v = _read(v_st, cfg, sh)
        v = v.mul_(cfg.b2) if donate and v is v_st else cfg.b2 * v
        t = (1 - cfg.b2) * g
        t *= g
        v += t
        del g, t
        den = v / bc2
        den.sqrt_().add_(cfg.eps)
        u = (m / bc1).div_(den)
        del den
        u += cfg.weight_decay * p.float()
        u.mul_(lr)
        if not donate:
            new_p = (p.float() - u).to(p.dtype)
            return new_p, _write(m, m_st, cfg, sh), _write(v, v_st, cfg, sh)
        p.copy_(p.float() - u)
        for new, st in ((m, m_st), (v, v_st)):
            if _is_state(st):
                w = _write(new, st, cfg, sh)
                st["q"].copy_(w["q"])
                st["scale"].copy_(w["scale"])
        return p, m_st, v_st

    flat_m = tree_util.leaves(opt_state["m"], is_leaf=_is_state)
    flat_v = tree_util.leaves(opt_state["v"], is_leaf=_is_state)
    flat_p = tree_util.leaves(params)
    shards = (_sharding_leaves(shardings) if shardings is not None
              else [None] * len(flat_p))
    out = [upd(p, g, m, v, sh) for p, g, m, v, sh in
           zip(flat_p, tree_util.leaves(grads), flat_m, flat_v, shards)]
    new_params = tree_util.unflatten(params, [o[0] for o in out])
    new_m = tree_util.unflatten(opt_state["m"], [o[1] for o in out],
                                is_leaf=_is_state)
    new_v = tree_util.unflatten(opt_state["v"], [o[2] for o in out],
                                is_leaf=_is_state)
    metrics = {"grad_norm": gnorm, "lr": lr}
    return new_params, {"m": new_m, "v": new_v, "step": step}, metrics


def opt_state_bytes_per_param(cfg: AdamWConfig) -> float:
    if cfg.quantize_states:
        return 2 * (1 + 4.0 / cfg.qblock)
    return 8.0
