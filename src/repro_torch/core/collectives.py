"""Topology-aware collectives: the paper's Allreduce accelerator (section 4.7)
on ``torch.distributed`` process groups.

Counterpart of ``repro.core.collectives``. The accelerator's three phases
map onto a two-axis process mesh (:class:`repro_torch.launch.mesh.
ProcessMesh`):

  paper                          here
  ─────────────────────────────  ─────────────────────────────────────────
  level 0: intra-QFDB clients    reduce-scatter along the intra ("data")
  send to the server FPGA        axis: an all-to-all delivers the k parts
                                 of this rank's 1/k shard as one (k, n/k)
                                 tensor, and ``combine`` sums them
  levels 1..: servers exchange   allreduce of the shard along the inter
  across QFDBs                   ("pod") axis: the m shards gathered as
                                 (m, n/k), summed by ``combine``
  final level: broadcast         all-gather along the intra axis

Shard i is rows ``[i·n/k, (i+1)·n/k)`` of the padded input, as in the
reference's tiled ``psum_scatter``/``all_gather``. The reductions run in
:func:`repro_torch.kernels.allreduce_combine.ops.combine_parts`: the Hopper
kernel on CUDA tensors, its plain version on CPU tensors; parts are summed
in rank order, so every rank of a group computes the same bits. ``flat`` is
the software baseline: one ``all_reduce`` over all the axes, reduced inside
the communication backend, as the reference's one ``psum``.

With the gloo backend, CUDA tensors cross the wire through host memory
(gloo has no all-to-all for them); the reductions stay on the card.

Every collective of the port reaches the wire in one of four calls here:
``all_gather`` (:func:`all_gather_stack`), ``all_to_all_single``
(:func:`all_to_all`), ``all_reduce`` (:func:`flat_allreduce`) and the
point-to-point sends and receives of :func:`ppermute` (the counterpart of
``jax.lax.ppermute``: the conjugate-gradient example's halo exchange). Within
:func:`counting` each call adds its output's bytes on this rank (the
reference dry run's measure: what a chip injects into the fabric for the
op) to a count by kind, by the logical op that :func:`tagged` names
around it, and, where its group spans the ``pod`` axis, to the bytes that
cross pods. On a :class:`DryGroup` (the groups of
:class:`repro_torch.launch.mesh.DryMesh`, the dry run's stand-in for a
mesh it does not have) the same calls return tensors of the right shape
and dtype on the input's device, ``meta`` in the dry run, touch no
process group and count the same bytes.
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch
import torch.distributed as dist

from repro_torch.kernels.allreduce_combine.ops import combine_parts


@dataclasses.dataclass(frozen=True, eq=False)
class DryGroup:
    """A process group that does not exist: ``size`` ranks over ``axes``
    of a mesh without processes. The collectives here give a call on it
    the result's shape, dtype and device, and move nothing."""
    axes: tuple[str, ...]
    size: int


#: the axes of each process group a ProcessMesh made (for the pod count)
_GROUP_AXES: dict = {}


def register_group(group, axes: tuple[str, ...]) -> None:
    """Record which mesh axes ``group`` spans (``ProcessMesh`` calls it)."""
    _GROUP_AXES[group] = tuple(axes)


def group_size(group) -> int:
    """Ranks in ``group``: a real process group or a :class:`DryGroup`."""
    if isinstance(group, DryGroup):
        return group.size
    return dist.get_world_size(group)


#: the open count of :func:`counting`, and the stack of :func:`tagged` names
_count: dict | None = None
_tags: list[str] = []
#: the kinds every count holds; ``"ppermute"`` joins a count once a
#: :func:`ppermute` has run in it
KINDS = ("all_gather", "all_to_all", "all_reduce")


def new_count() -> dict:
    return {"bytes": dict.fromkeys(KINDS, 0), "ops": dict.fromkeys(KINDS, 0),
            "by_op": {}, "cross_pod_bytes": 0}


@contextlib.contextmanager
def counting():
    """Count every collective's output bytes on this rank while the block
    runs: yields ``{"bytes": {kind: n}, "ops": {kind: calls}, "by_op":
    {logical op: n}, "cross_pod_bytes": n}``. Counts nest: an inner block's
    bytes count in the outer one too."""
    global _count
    outer, mine = _count, new_count()
    _count = mine
    try:
        yield mine
    finally:
        _count = outer
        if outer is not None:
            _merge(outer, mine)


def _merge(into: dict, part: dict) -> None:
    for k in part["bytes"]:
        into["bytes"][k] = into["bytes"].get(k, 0) + part["bytes"][k]
        into["ops"][k] = into["ops"].get(k, 0) + part["ops"][k]
    for k, n in part["by_op"].items():
        into["by_op"][k] = into["by_op"].get(k, 0) + n
    into["cross_pod_bytes"] += part["cross_pod_bytes"]


@contextlib.contextmanager
def tagged(name: str):
    """Name the logical op of the collectives the block runs (the innermost
    name counts): ``"sum_over_model"``, ``"weight_gather"``, ...; untagged
    calls count as ``"other"``."""
    _tags.append(name)
    try:
        yield
    finally:
        _tags.pop()


def _record(kind: str, nbytes: int, group) -> None:
    if _count is None:
        return
    _count["bytes"][kind] = _count["bytes"].get(kind, 0) + nbytes
    _count["ops"][kind] = _count["ops"].get(kind, 0) + 1
    op = _tags[-1] if _tags else "other"
    _count["by_op"][op] = _count["by_op"].get(op, 0) + nbytes
    axes = group.axes if isinstance(group, DryGroup) else _GROUP_AXES.get(
        group, ())
    if "pod" in axes:
        _count["cross_pod_bytes"] += nbytes


def host_staged(t: torch.Tensor, group) -> bool:
    """Whether ``t`` crosses ``group`` through host memory: gloo moves CUDA
    tensors for some collectives only (all_to_all not at all), so the port
    stages every gloo transfer of a CUDA tensor through the host. The
    reduction arithmetic stays on the tensor's own device."""
    return (t.is_cuda and not isinstance(group, DryGroup)
            and dist.get_backend(group) == "gloo")


def _wire(t: torch.Tensor, group) -> torch.Tensor:
    return t.cpu() if host_staged(t, group) else t


#: dtypes moved as their bytes: neither gloo nor NCCL gathers int16, and
#: gloo builds differ in which collectives take 16-bit floats
_AS_BYTES = (torch.int16, torch.bfloat16, torch.float16)


def all_gather_stack(x: torch.Tensor, group) -> torch.Tensor:
    """(size, *x.shape): every rank's ``x`` in group-rank order. 16-bit
    dtypes travel as their bytes (exact)."""
    k = group_size(group)
    _record("all_gather", k * x.numel() * x.element_size(), group)
    if isinstance(group, DryGroup):
        return x.new_empty((k,) + tuple(x.shape))
    w = _wire(x.contiguous(), group)
    if w.dtype in _AS_BYTES:
        w = w.reshape(-1).view(torch.uint8)
    parts = [torch.empty_like(w) for _ in range(k)]
    dist.all_gather(parts, w, group=group)
    out = torch.stack(parts)
    if x.dtype in _AS_BYTES:
        out = out.view(x.dtype).reshape((len(parts),) + tuple(x.shape))
    return out.to(x.device)


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """``x``'s dim-0 blocks exchanged over ``group`` with equal splits (the
    reference's ``lax.all_to_all(x, axis, 0, 0, tiled=False)``): block i
    goes to the group's i-th rank, and block i of the result came from it.
    Moved as bytes (exact for every dtype); gloo takes a CUDA tensor
    through host memory, staged here explicitly. Not differentiable."""
    _record("all_to_all", x.numel() * x.element_size(), group)
    if isinstance(group, DryGroup):
        return torch.empty_like(x, memory_format=torch.contiguous_format)
    src = x.contiguous()
    wire = _wire(src, group).reshape(-1).view(torch.uint8)
    out = torch.empty_like(wire)
    dist.all_to_all_single(out, wire, group=group)
    return out.view(x.dtype).reshape(x.shape).to(x.device)


def ppermute(x: torch.Tensor, perm, group) -> torch.Tensor:
    """``x`` sent along ``perm``, a list of ``(src, dst)`` pairs of group
    ranks with no source and no destination twice (the reference's
    ``jax.lax.ppermute``): this rank gets the ``x`` of the rank that sends
    to it, zeros where none does. Every send and receive is posted before
    any is waited on (``batch_isend_irecv``), so a ring cannot deadlock;
    peers are named by their global ranks (``dist.get_global_rank``), so
    any group of a mesh works. Moved as bytes; gloo takes a CUDA tensor
    through host memory. Counts ``x``'s bytes. Not differentiable."""
    perm = [(int(s), int(d)) for s, d in perm]
    k = group_size(group)
    srcs, dsts = [s for s, _ in perm], [d for _, d in perm]
    if (len(set(srcs)) < len(srcs) or len(set(dsts)) < len(dsts)
            or not all(0 <= r < k for r in srcs + dsts)):
        raise ValueError(f"perm {perm} must name distinct sources and "
                         f"distinct destinations among {k} group ranks")
    _record("ppermute", x.numel() * x.element_size(), group)
    if isinstance(group, DryGroup):
        return torch.empty_like(x, memory_format=torch.contiguous_format)
    me = dist.get_rank(group)
    wire = _wire(x.contiguous(), group).reshape(-1).view(torch.uint8)
    out = torch.zeros_like(wire)
    ops = []
    for s, d in perm:
        if s == d == me:
            out.copy_(wire)
        elif s == me:
            ops.append(dist.P2POp(dist.isend, wire,
                                  dist.get_global_rank(group, d), group))
        elif d == me:
            ops.append(dist.P2POp(dist.irecv, out,
                                  dist.get_global_rank(group, s), group))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return out.view(x.dtype).reshape(x.shape).to(x.device)


def reduce_scatter_combine(x: torch.Tensor, group) -> torch.Tensor:
    """x: (n, ...) with n a multiple of the group size k -> this rank's
    summed shard (n/k, ...): rows ``[i·n/k, (i+1)·n/k)`` for group rank i.
    An all-to-all delivers the shard's k parts as (k, n/k·...) and
    ``combine`` sums them in group-rank order."""
    k = group_size(group)
    n = x.shape[0]
    recv = all_to_all(x.reshape(k, -1), group)
    shard = combine_parts(recv, op="sum")
    return shard.reshape((n // k,) + tuple(x.shape[1:]))


def _pad_rows(x: torch.Tensor, k: int) -> torch.Tensor:
    pad = (-x.shape[0]) % k
    if not pad:
        return x
    return torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])


def hierarchical_schedule(x: torch.Tensor, mesh, inter_stage, *,
                          intra_axis: str = "data", inter_axis: str = "pod"
                          ) -> torch.Tensor:
    """The accelerator's three phases around ``inter_stage(shard,
    inter_group) -> shard``, which reduces this rank's shard across the
    slow axis: rows padded to a multiple of the intra size, reduce-scatter
    along the fast axis, ``inter_stage``, all-gather back along the fast
    axis, padding dropped. Returns a new tensor; ``x`` is left as it is."""
    intra, inter = mesh.group(intra_axis), mesh.group(inter_axis)
    n = x.shape[0]
    xp = _pad_rows(x, group_size(intra))
    shard = reduce_scatter_combine(xp, intra)
    shard = inter_stage(shard, inter)
    return all_gather_stack(shard, intra).reshape(xp.shape)[:n]


def _sum_across(shard: torch.Tensor, group) -> torch.Tensor:
    parts = all_gather_stack(shard, group)
    return combine_parts(parts.reshape(parts.shape[0], -1),
                         op="sum").reshape(shard.shape)


def hierarchical_allreduce(x: torch.Tensor, mesh, *, intra_axis: str = "data",
                           inter_axis: str = "pod") -> torch.Tensor:
    """All-reduce ``x`` (the same shape on every rank, reduced over dim 0's
    rows elementwise) over the intra x inter axes with the accelerator's
    hierarchical schedule, the shard summed exactly across the slow axis.
    Returns a new tensor; ``x`` is left as it is."""
    return hierarchical_schedule(x, mesh, _sum_across, intra_axis=intra_axis,
                                 inter_axis=inter_axis)


def flat_allreduce(x: torch.Tensor, mesh, axes: tuple[str, ...]) -> torch.Tensor:
    """Single-phase sum over all ``axes`` (the software-allreduce
    baseline). Returns a new tensor."""
    group = mesh.group(axes if len(axes) > 1 else axes[0])
    _record("all_reduce", x.numel() * x.element_size(), group)
    if isinstance(group, DryGroup):
        return torch.empty_like(x)
    buf = _wire(x, group).clone()
    dist.all_reduce(buf, group=group)
    return buf.to(x.device)


def hierarchical_collective_bytes(n_bytes: int, intra: int, inter: int
                                  ) -> dict:
    """Napkin model of wire bytes per rank for both schedules.

    A ring all-reduce over p ranks moves 2(p-1)/p * n bytes per rank; the
    hierarchical schedule moves 2(k-1)/k * n on the intra axis and
    2(m-1)/m * n/k on the inter axis."""
    p = intra * inter
    flat = {"total": 2 * (p - 1) / p * n_bytes,
            "inter": 2 * (inter - 1) / inter * n_bytes}
    hier = {"intra": 2 * (intra - 1) / intra * n_bytes,
            "inter": 2 * (inter - 1) / inter * n_bytes / intra}
    hier["total"] = hier["intra"] + hier["inter"]
    return {"flat": flat, "hier": hier,
            "inter_reduction": flat["inter"] / max(hier["inter"], 1e-12)}
