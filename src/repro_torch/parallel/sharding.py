"""Sharding rules: parameter/activation specs for a (pod, data, model) mesh,
and the blocks they lay out.

Counterpart of ``repro.parallel.sharding``; the rules (``param_spec``,
``param_specs``, ``opt_state_specs``, ``batch_specs``, ``cache_specs``) are
the reference's, line for line. Axis roles:

* ``data``  — DP batch axis AND the FSDP weight axis (dim-0/"d_model" rows
  of every large matrix are sharded here, ZeRO-3 style);
* ``model`` — TP/EP axis (heads, d_ff columns, the expert hidden dim,
  vocab);
* ``pod``   — pure DP replication across pods.

A spec is a :class:`Spec`: a tuple with one entry per dim, each ``None``
(replicated), an axis name or a tuple of names (the reference's
``PartitionSpec``). The port has no partitioner, so the layout is explicit:
:class:`Sharding` (``NamedSharding``'s counterpart) cuts a leaf into this
rank's block and gathers it back. Blocks are laid out as JAX lays them: a
dim over one axis splits into that axis' size of equal contiguous blocks
in coordinate order, a dim over a tuple of axes splits major-to-minor in
the tuple's order, a dim over no axis is whole on every rank. Head/vocab
dims that do not divide the TP axis are replicated, as in the reference.
"""

from __future__ import annotations

import math

import torch

from repro_torch import tree as tree_util
from repro_torch.config import ArchConfig, ShapeConfig


def _entry(e):
    """A spec entry as ``PartitionSpec`` keeps it: a tuple of one name is
    that name, an empty one None."""
    if isinstance(e, (tuple, list)):
        e = tuple(e)
        return None if not e else e[0] if len(e) == 1 else e
    return e


class Spec(tuple):
    """One entry per dim: ``None``, an axis name or a tuple of names.
    ``Spec()`` is replicated; ``Spec(None, "data")`` shards dim 1 over
    ``data``."""

    def __new__(cls, *parts):
        return super().__new__(cls, tuple(_entry(p) for p in parts))

    def __repr__(self) -> str:
        return f"Spec{tuple(self)!r}"


def is_spec(x) -> bool:
    return isinstance(x, Spec)


def _div(n: int, k: int) -> bool:
    return k > 0 and n % k == 0


def _axis(name, ok: bool):
    return name if ok else None


def param_spec(path: tuple[str, ...], shape: tuple[int, ...], cfg: ArchConfig,
               pctx) -> Spec:
    """The spec of one parameter, keyed on its tree path and shape."""
    tp, fsdp = pctx.tp_axis, "data" if "data" in pctx.mesh.axis_names else None
    tp_n = pctx.mesh.shape[tp]
    fsdp_n = pctx.mesh.shape[fsdp] if fsdp else 1
    name = path[-1]
    P = Spec

    def dspec(dim_size):  # FSDP on a d_model-rows dim
        return _axis(fsdp, _div(dim_size, fsdp_n))

    # ---- embeddings
    if name == "tokens":
        return P(_axis(tp, _div(shape[0], tp_n)), dspec(shape[1]))
    if name == "head":
        return P(dspec(shape[0]), _axis(tp, _div(shape[1], tp_n)))
    if name in ("positions", "enc_pos"):
        return P(None, _axis(tp, _div(shape[-1], tp_n)))

    # ---- attention (GQA + MLA)
    if name in ("wq", "wk", "wv"):
        return P(dspec(shape[0]), _axis(tp, _div(shape[1], tp_n)), None)
    if name == "wo":
        return P(_axis(tp, _div(shape[0], tp_n)), None, dspec(shape[2]))
    if name in ("bq", "bk", "bv"):
        return P(_axis(tp, _div(shape[0], tp_n)), None)
    if name == "wq_a":
        return P(dspec(shape[0]), None)
    if name in ("wq_b", "wkv_b"):
        return P(None, _axis(tp, _div(shape[1], tp_n)), None)
    if name == "wkv_a":
        return P(dspec(shape[0]), None)

    # ---- MoE
    if name == "router":
        return P(dspec(shape[0]), None)
    if len(path) >= 2 and "ffn" in path and name in ("w_gate", "w_up",
                                                     "w_out") and len(shape) == 3:
        # stacked expert weights: EP over 'data', TP over 'model' on the
        # expert hidden dim (models/moe.py stores and runs them so)
        e_ax = _axis(fsdp, _div(shape[0], fsdp_n))
        if name == "w_out":
            return P(e_ax, _axis(tp, _div(shape[1], tp_n)), None)
        return P(e_ax, None, _axis(tp, _div(shape[2], tp_n)))

    # ---- dense MLP (2-D) incl. shared experts / mtp proj
    if name in ("w_gate", "w_up", "proj") and len(shape) == 2:
        return P(dspec(shape[0]), _axis(tp, _div(shape[1], tp_n)))
    if name == "w_out" and len(shape) == 2:
        return P(_axis(tp, _div(shape[0], tp_n)), dspec(shape[1]))
    if name in ("b_up",):
        return P(_axis(tp, _div(shape[0], tp_n)))
    if name in ("b_out",):
        return P(None)

    # ---- Mamba-2
    if name in ("wz", "wx"):
        return P(dspec(shape[0]), _axis(tp, _div(shape[1], tp_n)))
    if name in ("wB", "wC", "wdt"):
        return P(dspec(shape[0]), _axis(tp, _div(shape[1], tp_n)))
    if name in ("conv_x", "conv_B", "conv_C"):
        return P(None, _axis(tp, _div(shape[1], tp_n)))
    if name in ("conv_bx", "conv_bB", "conv_bC", "norm_scale"):
        return P(_axis(tp, _div(shape[0], tp_n)))
    if name in ("A_log", "D", "dt_bias"):
        return P(_axis(tp, _div(shape[0], tp_n)))
    if name == "out_proj":
        return P(_axis(tp, _div(shape[0], tp_n)), dspec(shape[1]))

    # ---- norms & everything small: replicated
    return P()


def _strip_stack_dims(path) -> int:
    """Stacked layer params have 1 (scan) or 2 (hybrid group) leading layer
    dims; specs above address the per-layer shape."""
    n = 0
    if any(k in path for k in ("dense_stack", "moe_stack", "stack",
                               "encoder", "decoder")):
        n = 1
    if "groups" in path:
        n = 2
    return n


def param_specs(params, cfg: ArchConfig, pctx):
    """The :class:`Spec` tree of a parameter tree (tensors; meta tensors
    do)."""
    out = []
    for name, leaf in tree_util.named_leaves(params):
        names = tuple(name.split("."))
        nstack = _strip_stack_dims(names)
        inner = param_spec(names, tuple(leaf.shape[nstack:]), cfg, pctx)
        out.append(Spec(*([None] * nstack), *inner))
    return tree_util.unflatten(params, out)


def _is_state(x) -> bool:
    return isinstance(x, dict) and set(x) == {"q", "scale"}


def opt_state_specs(opt_state, params, cfg: ArchConfig, pctx):
    """Specs of an AdamW state tree: m/v mirror the param specs (int8
    states are layout-preserving, so the spec transfers; per-block scales
    drop the last axis' sharding if it no longer divides)."""
    pspecs = tree_util.leaves(param_specs(params, cfg, pctx), is_leaf=is_spec)

    def axis_size(ax) -> int:
        if ax is None:
            return 1
        if isinstance(ax, (tuple, list)):
            return math.prod(pctx.mesh.shape[a] for a in ax)
        return pctx.mesh.shape[ax]

    def one(ps, st):
        if _is_state(st):
            parts = tuple(ps)
            last = parts[-1] if parts else None
            nblk = st["scale"].shape[-1]
            scale_last = last if nblk % axis_size(last) == 0 else None
            return {"q": Spec(*parts),
                    "scale": Spec(*parts[:-1], scale_last) if parts else Spec()}
        return ps

    def tree_for(states):
        flat = tree_util.leaves(states, is_leaf=_is_state)
        return tree_util.unflatten(states, [one(ps, st) for ps, st in
                                            zip(pspecs, flat, strict=True)],
                                   is_leaf=_is_state)

    return {"m": tree_for(opt_state["m"]), "v": tree_for(opt_state["v"]),
            "step": Spec()}


# ------------------------------------------------------------- activations
def batch_specs(cfg: ArchConfig, shape: ShapeConfig, pctx):
    """Specs of the input batch of a given assigned shape."""
    dp = pctx.dp_axes
    if shape.kind in ("train", "prefill"):
        specs = {"tokens": Spec(dp, None)}
        if shape.kind == "train":
            specs["labels"] = Spec(dp, None)
        if cfg.vision is not None:
            specs["patches"] = Spec(dp, None, None)
        if cfg.encdec is not None:
            specs["frames"] = Spec(dp, None, None)
        return specs
    # decode: batch over dp when divisible, else replicate batch and rely
    # on sequence-sharded caches (long_500k, batch=1)
    b_ax = dp if _div(shape.global_batch, pctx.dp_size) else None
    return {"token": Spec(b_ax), "pos": Spec()}


def cache_specs(cache, cfg: ArchConfig, shape: ShapeConfig, pctx):
    """Specs of KV caches / SSM states, identified by their dimension
    SUFFIX pattern (any number of leading layer/group stack dims):

      attention KV      (..., B, S, K, hd)  — B over dp; K over tp if it
                        divides, else hd over tp; S over 'data' when the
                        batch cannot shard (long_500k, B=1)
      MLA latent        (..., B, S, r)      — B over dp, r over tp
      SSM state         (..., B, h, p, n)   — B over dp, heads over tp
      conv state        (..., B, W, ch)     — B over dp, channels over tp
    """
    dp = pctx.dp_axes
    tp = pctx.tp_axis
    tp_n = pctx.mesh.shape[tp]
    B, S = shape.global_batch, shape.seq_len
    batch_sharded = _div(B, pctx.dp_size)
    b_ax = dp if batch_sharded else None
    seq_ax = pctx.kv_seq_axis(B, S)

    def spec_for(names, s):
        name = names[-1] if names else ""
        in_conv = any(n == "conv" for n in names)
        if name in ("k", "v") or (not in_conv and len(s) >= 4
                                  and s[-3] == S):
            nstack = len(s) - 4
            kv_ax = tp if _div(s[-2], tp_n) else None
            hd_ax = tp if kv_ax is None and _div(s[-1], tp_n) else None
            return Spec(*([None] * nstack), b_ax, seq_ax, kv_ax, hd_ax)
        if name in ("c_kv", "k_rope"):
            nstack = len(s) - 3
            r_ax = tp if _div(s[-1], tp_n) else None
            return Spec(*([None] * nstack), b_ax, seq_ax, r_ax)
        if in_conv or (name != "ssm" and len(s) >= 3 and s[-2] <= 8):
            nstack = len(s) - 3
            ch_ax = tp if _div(s[-1], tp_n) else None
            return Spec(*([None] * nstack), b_ax, None, ch_ax)
        nstack = len(s) - 4
        h_ax = tp if _div(s[-3], tp_n) else None
        return Spec(*([None] * nstack), b_ax, h_ax, None, None)

    return tree_util.unflatten(cache, [
        spec_for(tuple(name.split(".")), tuple(leaf.shape))
        for name, leaf in tree_util.named_leaves(cache)])


# ------------------------------------------------------------------ layout
def spec_axes(entry) -> tuple[str, ...]:
    """The axes of one spec entry, major first."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


class Sharding:
    """``NamedSharding``'s counterpart: a :class:`Spec` over a mesh (a
    :class:`~repro_torch.launch.mesh.ProcessMesh` to cut and gather, or an
    :class:`~repro_torch.launch.mesh.AbstractMesh` for the layout only)."""

    def __init__(self, mesh, spec):
        self.mesh = mesh
        self.spec = Spec(*spec)
        for e in self.spec:
            for a in spec_axes(e):
                if a not in mesh.axis_names:
                    raise ValueError(f"{self.spec}: no axis {a!r} in "
                                     f"{mesh.axis_names}")

    def __repr__(self) -> str:
        return f"Sharding({self.mesh!r}, {self.spec!r})"

    def _entries(self, ndim: int):
        if len(self.spec) > ndim:
            raise ValueError(f"{self.spec} has more entries than {ndim} dims")
        return tuple(self.spec) + (None,) * (ndim - len(self.spec))

    def parts(self, shape) -> tuple[int, ...]:
        """How many blocks each dim splits into."""
        return tuple(math.prod(self.mesh.shape[a] for a in spec_axes(e))
                     for e in self._entries(len(shape)))

    def local_shape(self, shape) -> tuple[int, ...]:
        out = []
        for n, k in zip(shape, self.parts(shape)):
            if n % k:
                raise ValueError(f"{self.spec}: dim of {n} does not split "
                                 f"into {k} blocks")
            out.append(n // k)
        return tuple(out)

    def global_shape(self, local_shape) -> tuple[int, ...]:
        return tuple(n * k for n, k in zip(local_shape,
                                            self.parts(local_shape)))

    def block_index(self, coords: dict, ndim: int) -> tuple[int, ...]:
        """The block a rank at ``coords`` holds, per dim."""
        out = []
        for e in self._entries(ndim):
            i = 0
            for a in spec_axes(e):
                i = i * self.mesh.shape[a] + coords[a]
            out.append(i)
        return tuple(out)

    def slices(self, shape, coords: dict) -> tuple[slice, ...]:
        """The global index window of the block at ``coords``."""
        local = self.local_shape(shape)
        return tuple(slice(i * n, (i + 1) * n) for i, n in
                     zip(self.block_index(coords, len(shape)), local))

    def shard(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's block of ``full``, a contiguous copy."""
        return full[self.slices(full.shape, self.mesh.coords)].contiguous()

    def gather(self, local: torch.Tensor) -> torch.Tensor:
        """The full leaf from every rank's block (a collective over the
        groups of the spec's axes; not differentiable)."""
        from repro_torch.parallel.tensor_parallel import gather_dims
        return gather_dims(local, self, range(local.dim()))


def _shardings(specs, mesh) -> list:
    return [Sharding(mesh, s) for s in tree_util.leaves(specs,
                                                        is_leaf=is_spec)]


def param_shardings(params, cfg: ArchConfig, pctx):
    """The tree of :class:`Sharding` of a parameter tree."""
    return tree_util.unflatten(params, _shardings(
        param_specs(params, cfg, pctx), pctx.mesh))


def shard_tree(full_tree, specs, mesh):
    """Each leaf of ``full_tree`` cut to this rank's block of ``specs``
    (a tree of :class:`Spec` shaped like it)."""
    shards = _shardings(specs, mesh)
    return tree_util.unflatten(full_tree, [
        s.shard(x) for s, x in zip(shards, tree_util.leaves(full_tree),
                                   strict=True)])


def gather_tree(local_tree, specs, mesh):
    """Each leaf of ``local_tree`` gathered back to the full leaf over the
    axes its spec names (every rank gets the full tree)."""
    shards = _shardings(specs, mesh)
    return tree_util.unflatten(local_tree, [
        s.gather(x) for s, x in zip(shards, tree_util.leaves(local_tree),
                                    strict=True)])
