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
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.kernels.allreduce_combine.ops import combine_parts


def host_staged(t: torch.Tensor, group) -> bool:
    """Whether ``t`` crosses ``group`` through host memory: gloo moves CUDA
    tensors for some collectives only (all_to_all not at all), so the port
    stages every gloo transfer of a CUDA tensor through the host. The
    reduction arithmetic stays on the tensor's own device."""
    return t.is_cuda and dist.get_backend(group) == "gloo"


def _wire(t: torch.Tensor, group) -> torch.Tensor:
    return t.cpu() if host_staged(t, group) else t


#: dtypes moved as their bytes: neither gloo nor NCCL gathers int16, and
#: gloo builds differ in which collectives take 16-bit floats
_AS_BYTES = (torch.int16, torch.bfloat16, torch.float16)


def all_gather_stack(x: torch.Tensor, group) -> torch.Tensor:
    """(size, *x.shape): every rank's ``x`` in group-rank order. 16-bit
    dtypes travel as their bytes (exact)."""
    w = _wire(x.contiguous(), group)
    if w.dtype in _AS_BYTES:
        w = w.reshape(-1).view(torch.uint8)
    parts = [torch.empty_like(w) for _ in range(dist.get_world_size(group))]
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
    src = x.contiguous()
    wire = _wire(src, group).reshape(-1).view(torch.uint8)
    out = torch.empty_like(wire)
    dist.all_to_all_single(out, wire, group=group)
    return out.view(x.dtype).reshape(x.shape).to(x.device)


def reduce_scatter_combine(x: torch.Tensor, group) -> torch.Tensor:
    """x: (n, ...) with n a multiple of the group size k -> this rank's
    summed shard (n/k, ...): rows ``[i·n/k, (i+1)·n/k)`` for group rank i.
    An all-to-all delivers the shard's k parts as (k, n/k·...) and
    ``combine`` sums them in group-rank order."""
    k = dist.get_world_size(group)
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
    xp = _pad_rows(x, dist.get_world_size(intra))
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
