"""The collectives a sharded model runs, as autograd Functions.

The port has no partitioner, so the collectives that GSPMD derives from the
reference's specs are written out here, in the style of
:class:`repro_torch.models.moe.AllToAll`:

* :class:`CopyToModel` — identity forward, sum over ``model`` backward: the
  entry of a tensor-parallel region (a replicated activation meets
  column-sharded weights, so each ``model`` rank holds part of its
  gradient);
* :class:`SumOverModel` — sum over ``model`` forward, identity backward: the
  exit (row-sharded weights leave each rank a partial product);
* :class:`GatherLeaf` — a weight's blocks gathered at use: all-gather
  forward; backward a reduce-scatter (sum) over the batch axes, whose ranks
  saw different rows, and this rank's own block over ``model``, whose
  ranks computed the same thing;
* :class:`GatherOverModel` — an activation's blocks gathered over
  ``model``: all-gather forward; backward a reduce-scatter over ``model``,
  whose ranks each used the whole for their own heads (Mamba-2's B and C,
  computed on this rank's ``d_state`` block, enter every rank's heads);
* :class:`GatherSeq` and :class:`CutSeq` — ``seq_shard``'s residual
  stream: a block's entry gathers the rank's ``S/tp`` rows whole over
  ``model`` (backward: this rank's rows of the gradient), and its exit cuts
  the rank's rows from the block's output (backward: the rows gathered
  whole). Inside a block the stream and its gradient are the same on every
  ``model`` rank, as without ``seq_shard`` (the branches' own
  :class:`CopyToModel` has already summed their gradients), so neither
  needs a sum, and the block's values and gradients are its unsharded ones
  bit for bit.

:func:`merge_softmax` merges the softmax of a decode whose cache's sequence
is split over ``data`` from each rank's part over its block.

Every sum is an all-gather of the parts plus ``combine`` over them in rank
order (:func:`repro_torch.kernels.allreduce_combine.ops.combine_parts`:
the Hopper kernel on CUDA tensors, its plain version on the CPU), or the
reduce-scatter of :func:`repro_torch.core.collectives.reduce_scatter_combine`;
so every rank of a ``model`` group holds the same bits, and what follows a
sum (norms, MoE routes, the next layer) stays identical across ``model``
replicas.
"""

from __future__ import annotations

import contextlib

import torch

from repro_torch.core.collectives import (all_gather_stack, group_size,
                                          reduce_scatter_combine, tagged)
from repro_torch.kernels.allreduce_combine.ops import combine_parts


def sum_across(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of every group rank's ``x``, in group-rank order, by
    ``combine``: the same bits on every rank."""
    parts = all_gather_stack(x, group)
    return combine_parts(parts.reshape(parts.shape[0], -1),
                         op="sum").reshape(x.shape)


def merge_softmax(out: torch.Tensor, lse: torch.Tensor,
                  group) -> torch.Tensor:
    """Softmax attention over a sequence whose blocks lie on the ranks of
    ``group``, from each rank's part over its block: ``out`` (..., d)
    float32, normalised over the rank's positions, and ``lse`` (...) their
    log-sum-exp (-inf where the rank has none). The largest ``lse`` M by
    ``combine`` (max) over the gathered ``lse``, each rank's weight w =
    exp(lse - M), then ``combine`` (sum) over the gathered ``[w out, w]``
    (one tensor) in group-rank order, and the quotient: float32, the same
    bits on every rank. Not differentiable (a decode step's)."""
    with tagged("kv_seq_merge"):
        parts = all_gather_stack(lse.contiguous(), group)
        m = combine_parts(parts.reshape(parts.shape[0], -1),
                          op="max").reshape(lse.shape)
        w = torch.where(torch.isneginf(lse), 0.0, torch.exp(lse - m))
        tot = sum_across(torch.cat([(out * w[..., None]).reshape(-1),
                                    w.reshape(-1)]), group)
    num, den = tot.split([out.numel(), w.numel()])
    return num.reshape(out.shape) / den.reshape(w.shape)[..., None]


class CopyToModel(torch.autograd.Function):
    """``apply(x, group)``: ``x`` forward; the gradient summed over
    ``group`` backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        with tagged("sum_over_model"):
            return sum_across(g.contiguous(), ctx.group), None


class SumOverModel(torch.autograd.Function):
    """``apply(x, group)``: ``x`` summed over ``group`` forward; the
    gradient as it is backward."""

    @staticmethod
    def forward(ctx, x, group):
        with tagged("sum_over_model"):
            return sum_across(x.contiguous(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class GatherOverModel(torch.autograd.Function):
    """``apply(x, dim, group)``: the blocks of ``x`` along ``dim``
    concatenated in group-rank order forward; backward the gradient summed
    over ``group`` and this rank's block of it (a reduce-scatter by
    ``combine``)."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        with tagged("gather_over_model"):
            return _gather_dim(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        d = ctx.dim
        with tagged("gather_over_model"):
            g = reduce_scatter_combine(g.movedim(d, 0).contiguous(),
                                       ctx.group)
        return g.movedim(0, d).contiguous(), None, None


class GatherSeq(torch.autograd.Function):
    """``apply(x, group, index)``: ``x`` (B, S/k, ...), this rank's rows of
    the sequence (the ``index``-th of ``group``'s k blocks), gathered to (B,
    S, ...) in group-rank order forward; backward this rank's rows of the
    gradient, which every rank of ``group`` holds whole and identical."""

    @staticmethod
    def forward(ctx, x, group, index):
        ctx.index, ctx.n = index, x.shape[1]
        with tagged("seq_gather"):
            return _gather_dim(x.contiguous(), 1, group)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(1, ctx.index * ctx.n, ctx.n).contiguous(), None, None


class CutSeq(torch.autograd.Function):
    """``apply(x, group, index)``: the ``index``-th of ``group``'s k blocks
    of ``x``'s sequence (dim 1; ``x`` the same on every rank), a copy of its
    own (no view keeps the whole alive) forward; backward every rank's
    block of the gradient gathered whole."""

    @staticmethod
    def forward(ctx, x, group, index):
        ctx.group = group
        n = x.shape[1] // group_size(group)
        return x.narrow(1, index * n, n).clone(
            memory_format=torch.contiguous_format)

    @staticmethod
    def backward(ctx, g):
        with tagged("seq_gather"):
            return _gather_dim(g.contiguous(), 1, ctx.group), None, None


def gather_seq(x: torch.Tensor, pctx) -> torch.Tensor:
    """This rank's rows of a ``seq_shard`` stream gathered whole over
    ``model`` (see :class:`GatherSeq`)."""
    return GatherSeq.apply(x, pctx.mesh.group(pctx.tp_axis),
                           pctx.mesh.coords[pctx.tp_axis])


def cut_seq(x: torch.Tensor, pctx) -> torch.Tensor:
    """This rank's ``S/tp`` rows of a whole stream (see :class:`CutSeq`)."""
    return CutSeq.apply(x, pctx.mesh.group(pctx.tp_axis),
                        pctx.mesh.coords[pctx.tp_axis])


def copy_to_model(x: torch.Tensor, pctx) -> torch.Tensor:
    return CopyToModel.apply(x, pctx.mesh.group(pctx.tp_axis))


def sum_over_model(x: torch.Tensor, pctx) -> torch.Tensor:
    return SumOverModel.apply(x, pctx.mesh.group(pctx.tp_axis))


def gather_over_model(x: torch.Tensor, dim: int, pctx) -> torch.Tensor:
    """This rank's block of an activation along ``dim`` gathered whole over
    ``model`` (see :class:`GatherOverModel`)."""
    return GatherOverModel.apply(x, dim % x.dim(),
                                 pctx.mesh.group(pctx.tp_axis))


# ------------------------------------------------------------ weight blocks
def _check_order(sharding, axes) -> None:
    names = sharding.mesh.axis_names
    if list(axes) != sorted(axes, key=names.index):
        raise NotImplementedError(
            f"{sharding.spec}: a dim over axes {axes} out of the mesh's order "
            f"{names}; the port gathers blocks in group-rank order")


def _gather_dim(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    parts = all_gather_stack(x, group)               # (k, *x.shape)
    if dim == 0:            # the parts already lie in order: no copy
        return parts.reshape((-1,) + tuple(x.shape[1:]))
    return torch.cat(parts.unbind(0), dim=dim)


def gather_dims(local: torch.Tensor, sharding, dims) -> torch.Tensor:
    """``local`` gathered over the axes of its spec's entries at ``dims``
    (not differentiable)."""
    from repro_torch.parallel.sharding import spec_axes
    entries = sharding._entries(local.dim())
    out = local
    for d in dims:
        axes = spec_axes(entries[d])
        if axes:
            _check_order(sharding, axes)
            out = _gather_dim(out, d, sharding.mesh.group(axes))
    return out


class GatherLeaf(torch.autograd.Function):
    """``apply(x, sharding, dims, reduce_axes)``: the block ``x`` gathered
    along ``dims``; backward, for each of those dims, a reduce-scatter over
    its group if its axes meet ``reduce_axes`` (the batch axes), else this
    rank's own block of the gradient."""

    @staticmethod
    def forward(ctx, x, sharding, dims, reduce_axes):
        ctx.sharding, ctx.dims, ctx.reduce = sharding, dims, reduce_axes
        with tagged("weight_gather"):
            return gather_dims(x, sharding, dims)

    @staticmethod
    def backward(ctx, g):
        from repro_torch.parallel.sharding import spec_axes
        sh = ctx.sharding
        entries = sh._entries(g.dim())
        index = sh.block_index(sh.mesh.coords, g.dim())
        for d in reversed(ctx.dims):
            axes = spec_axes(entries[d])
            if not axes:
                continue
            if set(axes) & set(ctx.reduce):
                with tagged("weight_grad_reduce_scatter"):
                    g = reduce_scatter_combine(g.movedim(d, 0).contiguous(),
                                               sh.mesh.group(axes))
                g = g.movedim(0, d)
            else:
                n = g.shape[d] // sh.parts(g.shape)[d]
                g = g.narrow(d, index[d] * n, n)
        return g.contiguous(), None, None, None


#: the gathered leaves kept by :func:`keep_gathered`, while one is open
_kept: dict | None = None


@contextlib.contextmanager
def keep_gathered():
    """Within the block, a leaf gathered with no gradient taken is gathered
    once and kept: a later :func:`gather_leaf` of the same block (the same
    storage, offset, shape and version, over the same spec and dims) reads
    the kept copy. For a run of sharded decode steps over parameters that
    do not change (a serving session): each step otherwise gathers the
    embedding and every layer's ``data`` shards again. The copies live
    until the block ends. Every rank of the mesh opens the block around
    the same calls (the ranks skip the same collectives)."""
    global _kept
    outer, _kept = _kept, {}
    try:
        yield
    finally:
        _kept = outer


def _kept_key(x: torch.Tensor, sharding, dims) -> tuple:
    return (x.device, x.untyped_storage().data_ptr(), x.storage_offset(),
            tuple(x.shape), x.stride(), x.dtype, x._version,
            id(sharding.mesh), tuple(sharding.spec), dims)


def gather_leaf(x: torch.Tensor, sharding, pctx, axes=None) -> torch.Tensor:
    """``x`` (this rank's block of a leaf laid out by ``sharding``) gathered
    over ``axes`` (default: every axis its spec names); differentiable, see
    :class:`GatherLeaf`. A leaf with nothing to gather is returned as it
    is; within :func:`keep_gathered`, with no gradient taken, a block
    gathered before is read back."""
    from repro_torch.parallel.sharding import spec_axes
    entries = sharding._entries(x.dim())
    dims = tuple(d for d, e in enumerate(entries) if spec_axes(e)
                 and (axes is None or set(spec_axes(e)) <= set(axes)))
    if not dims:
        return x
    if _kept is None or torch.is_grad_enabled():
        return GatherLeaf.apply(x, sharding, dims, tuple(pctx.dp_axes))
    key = _kept_key(x, sharding, dims)
    if key not in _kept:
        # the block is held with its copy, so its storage is not reused
        with tagged("weight_gather"):
            _kept[key] = (x, gather_dims(x, sharding, dims))
    return _kept[key][1]
