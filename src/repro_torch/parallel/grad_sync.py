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
* ``auto``         — the collective planner (:mod:`repro_torch.core.planner`)
                     picks one of the above per bucket by predicted cost
                     on the policy's machine model, as the reference's
                     does (:func:`plan_buckets` lists its choices); host
                     code on byte counts and axis sizes only

On a sharded mesh (:func:`sync_sharded_gradients`) the leaves replicated
over ``data`` sync over ``(pod, data)`` as above, and the leaves sharded
over ``data`` (ZeRO-3 weights, expert stacks) over ``pod`` only: their
gather's backward (or the all_to_all's adjoint) has already summed them
over ``data``, the first two phases of the section 4.7 schedule without
the final all-gather.

Gradients are packed into float32 buckets of ``CommPolicy.bucket_bytes``
bytes in the reference's leaf order (sorted dict keys), so bucket
boundaries, and with them the compressed sync's per-shard scales, are the
reference's.

:func:`emit_sync_program` and :func:`cost_sync_program_s` are copies of the
reference's: the train-step sync as a Program of
:mod:`repro_torch.core.program`, costed on a machine model (pure host code,
no tensors).
"""

from __future__ import annotations

import math
from typing import Sequence

import torch

from repro_torch import tree as tree_util
from repro_torch.core.collectives import (all_gather_stack, flat_allreduce,
                                          group_size, hierarchical_allreduce,
                                          hierarchical_schedule)
from repro_torch.core.comm import CommPolicy
from repro_torch.core.planner import GRAD_SYNC_STRATEGIES as STRATEGIES
from repro_torch.kernels.allreduce_combine.ops import combine_parts
from repro_torch.parallel.sharding import Sharding, spec_axes
from repro_torch.parallel.tensor_parallel import sum_across

#: ``combine`` launches one bucket takes on a two-axis mesh, by strategy
_COMBINES = {"flat": 0, "hierarchical": 2, "compressed": 3}


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


def combine_launches_per_sync(mesh, plan: Sequence[str], *,
                              intra_axis: str = "data",
                              inter_axis: str | None = "pod") -> int:
    """``combine`` launches one :func:`sync_gradients` call makes on each
    rank of ``mesh``, given the strategy of each bucket (``[strategy] *
    n_buckets`` for a named one, :func:`plan_buckets` for ``"auto"``): the
    intra reduce-scatter's and the inter allreduce's per bucket, plus the
    inter reduction of the scales for ``compressed``; none for ``flat``
    (the backend reduces) or where the mesh has one DP axis of more than
    one rank (``flat`` then serves every strategy)."""
    unknown = sorted(set(plan) - set(STRATEGIES))
    if unknown:
        raise ValueError(f"unknown strategies {unknown} in the plan")
    if len(_dp_axes(mesh, intra_axis, inter_axis)) < 2:
        return 0
    return sum(_COMBINES[s] for s in plan)


# --------------------------------------------------------------- strategies
def _dp_axes(mesh, intra_axis, inter_axis) -> tuple[str, ...]:
    return tuple(a for a in (intra_axis, inter_axis)
                 if a and a in mesh.axis_names and mesh.shape[a] > 1)


def plan_bucket_strategy(policy: CommPolicy, nbytes: int,
                         axis_sizes: tuple[int, ...],
                         allow_lossy: bool = False) -> str:
    """Planner-chosen strategy for one bucket of ``nbytes`` over the given
    DP axis sizes (intra first). Pure host code: static ints only."""
    intra = axis_sizes[0]
    inter = axis_sizes[-1] if len(axis_sizes) > 1 else 1
    return policy.plan_bucket(nbytes, intra, inter,
                              allow_lossy=allow_lossy).schedule


def plan_buckets(tree, mesh, policy: CommPolicy | None = None,
                 allow_lossy: bool = False, *, intra_axis: str = "data",
                 inter_axis: str | None = "pod") -> list[str]:
    """The strategy of each bucket of ``tree`` on ``mesh``, in bucket order:
    the plan :func:`sync_gradients` with ``strategy="auto"`` runs (it calls
    this once a call). Shapes only: meta tensors do. Empty where the mesh
    has no DP axis of more than one rank."""
    policy = policy or CommPolicy()
    axes = _dp_axes(mesh, intra_axis, inter_axis)
    if not axes:
        return []
    axis_sizes = tuple(int(mesh.shape[a]) for a in axes)
    sizes = bucket_sizes(tree, policy.bucket_bytes(math.prod(axis_sizes)))
    return [plan_bucket_strategy(policy, n * 4, axis_sizes, allow_lossy)
            for n in sizes]


def sync_gradients(grads, mesh, *, strategy: str = "hierarchical",
                   intra_axis: str = "data", inter_axis: str | None = "pod",
                   policy: CommPolicy | None = None, mean_over: int = 1,
                   allow_lossy: bool = False):
    """All-reduce a gradient tree across the mesh's DP axes and divide by
    ``mean_over``; returns float32 buckets unpacked into each leaf's dtype.

    ``allow_lossy`` only matters for ``strategy="auto"``: it decides
    whether the planner may pick the int8-compressed sync (whose error
    feedback is the caller's job — see :class:`CompressedSync`). A bucket
    the planner finds no feasible schedule for raises ``ValueError``."""
    if strategy != "auto" and strategy not in STRATEGIES:
        raise ValueError(f"strategy must be one of {STRATEGIES} or 'auto', "
                         f"got {strategy!r}")
    policy = policy or CommPolicy()
    axes = _dp_axes(mesh, intra_axis, inter_axis)
    if not axes:
        return grads
    axis_sizes = tuple(int(mesh.shape[a]) for a in axes)
    buckets, spec = flatten_to_buckets(
        grads, policy.bucket_bytes(math.prod(axis_sizes)))
    plan = (plan_buckets(grads, mesh, policy, allow_lossy,
                         intra_axis=intra_axis, inter_axis=inter_axis)
            if strategy == "auto" else [strategy] * len(buckets))
    out = []
    for b, strat in zip(buckets, plan, strict=True):
        if strat == "flat" or len(axes) == 1:
            r = flat_allreduce(b, mesh, axes)
        elif strat == "hierarchical":
            r = hierarchical_allreduce(b, mesh, intra_axis=axes[0],
                                       inter_axis=axes[-1])
        elif strat == "compressed":
            r = hierarchical_schedule(b, mesh, _compressed_inter,
                                      intra_axis=axes[0], inter_axis=axes[-1])
        else:
            raise ValueError(strat)
        out.append(r / mean_over)
    return unflatten_from_buckets(out, spec)


def _split_by_data(grads, shardings) -> tuple[list[bool], list, list]:
    """(whether each leaf is sharded over ``data``, the replicated leaves,
    the sharded ones), in leaf order."""
    shards = tree_util.leaves(shardings,
                              is_leaf=lambda x: isinstance(x, Sharding))
    over = [any("data" in spec_axes(e) for e in s.spec) for s in shards]
    leaves = tree_util.leaves(grads)
    if len(leaves) != len(over):
        raise ValueError(f"{len(leaves)} gradient leaves, {len(over)} "
                         "shardings")
    return (over, [g for g, o in zip(leaves, over) if not o],
            [g for g, o in zip(leaves, over) if o])


def plan_sharded_sync(grads, shardings, mesh, policy: CommPolicy | None = None,
                      allow_lossy: bool = False) -> tuple[list[str], int]:
    """What :func:`sync_sharded_gradients` runs with ``strategy="auto"``:
    the plan of the leaves replicated over ``data`` (:func:`plan_buckets`
    over ``(pod, data)``) and the number of buckets of the leaves sharded
    over ``data`` that cross ``pod`` (one ``combine`` each). ``grads``: this
    rank's blocks (shapes only; meta tensors do)."""
    policy = policy or CommPolicy()
    _, rep, zero = _split_by_data(grads, shardings)
    plan = plan_buckets(rep, mesh, policy, allow_lossy)
    pods = int(mesh.shape.get("pod", 1))
    n_pod = (len(bucket_sizes(zero, policy.bucket_bytes(pods)))
             if pods > 1 else 0)
    return plan, n_pod


def sync_sharded_gradients(grads, shardings, mesh, *,
                           strategy: str = "hierarchical",
                           policy: CommPolicy | None = None,
                           mean_over: int = 1, allow_lossy: bool = False):
    """The gradient sync of a sharded train step: ``grads`` this rank's
    blocks, laid out by ``shardings`` (a tree of ``Sharding``). Leaves
    replicated over ``data`` go through :func:`sync_gradients` over
    ``(pod, data)``; leaves sharded over ``data`` are summed over ``pod``
    only, in buckets, each by ``combine`` in rank order. Every leaf is then
    divided by ``mean_over``."""
    policy = policy or CommPolicy()
    over, rep, zero = _split_by_data(grads, shardings)
    rep = sync_gradients(rep, mesh, strategy=strategy, policy=policy,
                         mean_over=mean_over, allow_lossy=allow_lossy)
    pods = int(mesh.shape.get("pod", 1))
    if pods > 1:
        buckets, spec = flatten_to_buckets(zero, policy.bucket_bytes(pods))
        buckets = [sum_across(b, mesh.group("pod")) for b in buckets]
        zero = unflatten_from_buckets([b / mean_over for b in buckets], spec)
    else:   # nothing crosses pods: the same float32 division, leaf by leaf
        zero = [(g.float() / mean_over).to(g.dtype) for g in zero]
    it_rep, it_zero = iter(rep), iter(zero)
    return tree_util.unflatten(grads, [next(it_zero) if o else next(it_rep)
                                       for o in over])


def _compressed_inter(shard: torch.Tensor, inter) -> torch.Tensor:
    """The compressed sync's slow hop (the reference's
    ``_compressed_allreduce`` between its exact intra reduce-scatter and
    all-gather): int8 codes plus one scale per shard. The codes cross the
    wire as int16 while the inter axis has <= 255 ranks (int32 beyond), and
    are summed by ``combine`` in int32, which equals the int16 sum exactly
    (|sum| <= 255·127 < 2^24); the shard is dequantized by the mean of the
    scales. Error feedback is the caller's job (:class:`CompressedSync`)."""
    m = group_size(inter)
    scale = torch.clamp(torch.amax(torch.abs(shard)) / 127.0, min=1e-20)
    q = torch.round(shard / scale).to(torch.int8)
    wire = torch.int16 if m <= 255 else torch.int32
    codes = all_gather_stack(q.to(wire), inter).to(torch.int32)
    qsum = combine_parts(codes, op="sum")
    ssum = combine_parts(all_gather_stack(scale.reshape(1), inter),
                         op="sum")[0] / m
    return qsum.float() * ssum


# -------------------------------------------------------- program emission
def emit_sync_program(nranks: int, bucket_bytes_list, *,
                      compute_us_per_bucket=0.0, algo: str = "auto",
                      overlap_depth: int = 0):
    """Emit the train-step gradient-sync
    :class:`repro_torch.core.program.Program` of a bucketed backward pass:
    per bucket, the backward-compute slice that produces it, then its
    allreduce.

    This is the Layer-B tie-in to the workload simulator: run it through
    :meth:`ExanetMPI.run_program` or :meth:`MachineModel.cost_program` and
    the planner's per-bucket schedule choices (``algo="auto"``) plus the
    compute/communication overlap of the bucket pipeline become
    inspectable quantities instead of trace-time guesses.

    ``bucket_bytes_list`` is the per-bucket byte count — e.g. the
    ``numel() * element_size()`` of each bucket that
    ``flatten_to_buckets(grads, n)`` returns — and
    ``compute_us_per_bucket`` a scalar or per-bucket sequence of the
    backward microseconds preceding each bucket's readiness.
    ``overlap_depth > 0`` emits the allreduces *nonblocking*
    (``Collective(handle=...)``): up to ``overlap_depth`` syncs ride
    behind the following buckets' compute, each drained by a ``Wait``
    that many buckets later, with a final ``Wait()`` at the end — the
    overlap seam the train co-sim (DESIGN.md §2.9) searches over.  Pure
    host code (no tensors): callable from tests without devices.
    """
    from repro_torch.core.program import Collective, Compute, Program, Wait
    sizes = [int(b) for b in bucket_bytes_list]
    try:
        per_bucket = [float(c) for c in compute_us_per_bucket]
    except TypeError:
        per_bucket = [float(compute_us_per_bucket)] * len(sizes)
    if len(per_bucket) != len(sizes):
        raise ValueError(f"{len(sizes)} buckets but {len(per_bucket)} "
                         f"compute entries")
    ops = []
    for i, (nb, us) in enumerate(zip(sizes, per_bucket)):
        if us > 0.0:
            ops.append(Compute(us))
        if overlap_depth > 0:
            ops.append(Collective("allreduce", max(nb, 1), algo,
                                  handle=f"g{i}"))
            if i - overlap_depth >= 0:
                ops.append(Wait((f"g{i - overlap_depth}",)))
        else:
            ops.append(Collective("allreduce", max(nb, 1), algo))
    if overlap_depth > 0:
        ops.append(Wait())
    return Program(tuple(tuple(ops) for _ in range(nranks)))


# per-machine memo of cost_sync_program_s: the planner/hillclimb inner
# loops hammer identical (nranks, bucket layout, algo) queries, and each
# miss re-emits, re-probes and re-simulates a whole Program.  Weak keys:
# a machine's entry dies with the machine.
_sync_cost_cache: "weakref.WeakKeyDictionary" = None  # built on first use
_sync_cost_stats = {"hits": 0, "misses": 0}


def sync_cost_cache_info() -> dict:
    """Hit/miss counters of the :func:`cost_sync_program_s` memo."""
    size = 0
    if _sync_cost_cache is not None:
        size = sum(len(v) for v in _sync_cost_cache.values())
    return {**_sync_cost_stats, "size": size}


def clear_sync_cost_cache() -> None:
    global _sync_cost_cache
    _sync_cost_cache = None
    _sync_cost_stats["hits"] = _sync_cost_stats["misses"] = 0


def cost_sync_program_s(machine, nranks: int, bucket_bytes_list, *,
                        compute_us_per_bucket=0.0, algo: str = "auto",
                        overlap_depth: int = 0, fidelity: str = "sim",
                        backend: str = "auto") -> float:
    """Predicted seconds of one bucketed gradient sync on a machine: the
    :func:`emit_sync_program` emission costed through
    :meth:`MachineModel.cost_program`.  At ``sim`` fidelity on the ExaNeSt
    machine, ``backend="auto"`` replays the bucket pipeline as a compiled
    level program (collective sites splice their compiled round programs),
    so sweeping bucket layouts is a batched array workload instead of
    per-bucket event interpretation.  Results are memoized per
    (machine, nranks, bucket tuple, compute tuple, algo, overlap depth,
    fidelity, backend) — see :func:`sync_cost_cache_info`.  Pure
    host code: no tensors, callable from tests without devices."""
    import inspect
    import weakref as _weakref
    global _sync_cost_cache
    sizes = tuple(int(b) for b in bucket_bytes_list)
    try:
        comp = tuple(float(c) for c in compute_us_per_bucket)
    except TypeError:
        comp = (float(compute_us_per_bucket),) * len(sizes)
    key = (int(nranks), sizes, comp, algo, int(overlap_depth), fidelity,
           backend)
    if _sync_cost_cache is None:
        _sync_cost_cache = _weakref.WeakKeyDictionary()
    try:
        per_machine = _sync_cost_cache.setdefault(machine, {})
    except TypeError:                 # unhashable/unweakrefable machine
        per_machine = None
    if per_machine is not None and key in per_machine:
        _sync_cost_stats["hits"] += 1
        return per_machine[key]
    _sync_cost_stats["misses"] += 1
    prog = emit_sync_program(nranks, sizes, compute_us_per_bucket=comp,
                             algo=algo, overlap_depth=overlap_depth)
    kw = {"fidelity": fidelity}
    # signature probe, not try/except TypeError: a genuine TypeError from
    # inside a machine's sim path must surface, not trigger a silent
    # backend-less recomputation
    if "backend" in inspect.signature(machine.cost_program).parameters:
        kw["backend"] = backend
    out = machine.cost_program(prog, **kw)
    if per_machine is not None:
        per_machine[key] = out
    return out


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
