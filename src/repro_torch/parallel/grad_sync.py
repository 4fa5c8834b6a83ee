"""Gradient synchronization strategies over a data-parallel process mesh.

Counterpart of ``repro.parallel.grad_sync`` (``flatten_to_buckets``,
``sync_gradients``, ``_compressed_allreduce``, ``CompressedSync``):

* ``flat``         — one all-reduce over all DP axes (the software baseline)
* ``hierarchical`` — reduce-scatter(intra) + allreduce(inter) +
                     all-gather(intra), the NI Allreduce accelerator's
                     schedule (section 4.7), reduced by the ``combine``
                     kernel (:mod:`repro_torch.core.collectives`)
* ``compressed``   — the hierarchical schedule with int8 codes on the slow
                     (inter) hop (``_compressed_inter``); error feedback is
                     :class:`CompressedSync`
* ``auto``         — raises ``NotImplementedError``: the reference asks its
                     collective planner, whose port is ROADMAP.md queue 1
                     item 10

Gradients are packed into float32 buckets of ``CommPolicy.bucket_bytes``
bytes in the reference's leaf order (sorted dict keys), so bucket
boundaries, and with them the compressed sync's per-shard scales, are the
reference's.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist

from repro_torch import tree as tree_util
from repro_torch.core.collectives import (all_gather_stack, flat_allreduce,
                                          hierarchical_allreduce,
                                          hierarchical_schedule)
from repro_torch.core.comm import CommPolicy
from repro_torch.kernels.allreduce_combine.ops import combine_parts

STRATEGIES = ("flat", "hierarchical", "compressed")


# ------------------------------------------------------------------ buckets
def flatten_to_buckets(tree, bucket_bytes: int):
    """Pack a tree into float32 1-D buckets of ``bucket_bytes // 4``
    elements (the last one shorter); returns (buckets, spec) where spec
    allows exact unpacking."""
    leaves = tree_util.leaves(tree)
    spec = (tree, [(tuple(l.shape), l.dtype) for l in leaves])
    if leaves:
        big = torch.cat([l.float().reshape(-1) for l in leaves])
    else:
        big = torch.zeros((0,), dtype=torch.float32)
    per = max(bucket_bytes // 4, 1)
    return [big[i:i + per] for i in range(0, big.numel(), per)], spec


def unflatten_from_buckets(buckets, spec):
    template, shapes = spec
    big = torch.cat(buckets) if buckets else torch.zeros((0,))
    out, off = [], 0
    for shape, dtype in shapes:
        n = math.prod(shape)
        out.append(big[off:off + n].reshape(shape).to(dtype))
        off += n
    return tree_util.unflatten(template, out)


def bucket_sizes(tree, bucket_bytes: int) -> list[int]:
    """Elements in each bucket of ``tree`` (shapes only; meta tensors do)."""
    n = sum(l.numel() for l in tree_util.leaves(tree))
    per = max(bucket_bytes // 4, 1)
    return [min(per, n - i) for i in range(0, n, per)]


def combine_launches_per_sync(mesh, n_buckets: int, strategy: str, *,
                              intra_axis: str = "data",
                              inter_axis: str | None = "pod") -> int:
    """``combine`` launches one :func:`sync_gradients` call makes on each
    rank of ``mesh``: the intra reduce-scatter's and the inter allreduce's
    per bucket, plus the inter reduction of the scales for ``compressed``;
    none for ``flat`` (the backend reduces) or where the mesh has one DP
    axis of more than one rank (``flat`` then serves every strategy)."""
    if strategy == "flat" or len(_dp_axes(mesh, intra_axis, inter_axis)) < 2:
        return 0
    return n_buckets * (2 if strategy == "hierarchical" else 3)


# --------------------------------------------------------------- strategies
def _dp_axes(mesh, intra_axis, inter_axis) -> tuple[str, ...]:
    return tuple(a for a in (intra_axis, inter_axis)
                 if a and a in mesh.axis_names and mesh.shape[a] > 1)


def sync_gradients(grads, mesh, *, strategy: str = "hierarchical",
                   intra_axis: str = "data", inter_axis: str | None = "pod",
                   policy: CommPolicy | None = None, mean_over: int = 1):
    """All-reduce a gradient tree across the mesh's DP axes and divide by
    ``mean_over``; returns float32 buckets unpacked into each leaf's dtype.
    The reference's ``allow_lossy`` switch comes with ``strategy="auto"``."""
    if strategy == "auto":
        raise NotImplementedError(
            "strategy='auto' is not ported: the reference's collective "
            "planner needs the port's copies of core/comm, core/machine and "
            "core/planner (ROADMAP.md queue 1 item 10)")
    if strategy not in STRATEGIES:
        raise ValueError(f"strategy must be one of {STRATEGIES} (or 'auto'), "
                         f"got {strategy!r}")
    policy = policy or CommPolicy()
    axes = _dp_axes(mesh, intra_axis, inter_axis)
    if not axes:
        return grads
    world = math.prod(mesh.shape[a] for a in axes)
    buckets, spec = flatten_to_buckets(grads, policy.bucket_bytes(world))
    out = []
    for b in buckets:
        if strategy == "flat" or len(axes) == 1:
            r = flat_allreduce(b, mesh, axes)
        elif strategy == "hierarchical":
            r = hierarchical_allreduce(b, mesh, intra_axis=axes[0],
                                       inter_axis=axes[-1])
        else:
            r = hierarchical_schedule(b, mesh, _compressed_inter,
                                      intra_axis=axes[0], inter_axis=axes[-1])
        out.append(r / mean_over)
    return unflatten_from_buckets(out, spec)


def _compressed_inter(shard: torch.Tensor, inter) -> torch.Tensor:
    """The compressed sync's slow hop (the reference's
    ``_compressed_allreduce`` between its exact intra reduce-scatter and
    all-gather): int8 codes plus one scale per shard. The codes cross the
    wire as int16 while the inter axis has <= 255 ranks (int32 beyond), and
    are summed by ``combine`` in int32, which equals the int16 sum exactly
    (|sum| <= 255·127 < 2^24); the shard is dequantized by the mean of the
    scales. Error feedback is the caller's job (:class:`CompressedSync`)."""
    m = dist.get_world_size(inter)
    scale = torch.clamp(torch.amax(torch.abs(shard)) / 127.0, min=1e-20)
    q = torch.round(shard / scale).to(torch.int8)
    wire = torch.int16 if m <= 255 else torch.int32
    codes = all_gather_stack(q.to(wire), inter).to(torch.int32)
    qsum = combine_parts(codes, op="sum")
    ssum = combine_parts(all_gather_stack(scale.reshape(1), inter),
                         op="sum")[0] / m
    return qsum.float() * ssum


class CompressedSync:
    """EF-SGD-style error feedback (Karimireddy et al. 2019): the residual
    of the *local* quantization is carried into the next step, keeping the
    compressed sync unbiased over time."""

    def __init__(self, mesh, **kw):
        self.mesh = mesh
        self.kw = kw
        self.residual = None

    @staticmethod
    def _local_quant(g: torch.Tensor) -> torch.Tensor:
        scale = torch.clamp(torch.amax(torch.abs(g)) / 127.0, min=1e-20)
        return torch.round(g.float() / scale) * scale

    def __call__(self, grads):
        if self.residual is None:
            self.residual = tree_util.tree_map(
                lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                      device=g.device), grads)
        e = tree_util.tree_map(lambda g, r: g.float() + r, grads,
                               self.residual)
        g_hat = tree_util.tree_map(self._local_quant, e)
        self.residual = tree_util.tree_map(torch.subtract, e, g_hat)
        return sync_gradients(g_hat, self.mesh, strategy="compressed",
                              **self.kw)
