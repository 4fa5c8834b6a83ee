"""Parallel context threaded through model code (mesh + axis roles).

Counterpart of ``repro.parallel.ctx`` and of ``repro.launch.mesh``'s
``make_parallel_ctx``, over the port's process meshes
(:class:`repro_torch.launch.mesh.ProcessMesh`, or an
:class:`~repro_torch.launch.mesh.AbstractMesh` where only the layout is
asked for). ``dp_axes`` carry the batch, ``data`` also ZeRO-3's weight
shards and the expert stacks, ``tp_axis`` ("model") tensor parallelism.

The port has no partitioner to choose between gathering weights and
reducing activations, so a sharded model always gathers its ``data``-
sharded weights at use: numerically what the reference does with
``gather_weights=True``, and the port has no such switch (ROADMAP.md
queue 3, R10). Nor has it the reference's ``pp_axis``, which no code there
reads either. Every model family runs on a sharded context.

``seq_shard`` is Megatron-style sequence parallelism of the residual
stream (the reference's ``_hint``): between blocks a rank holds its
``S/tp`` rows of the sequence, gathered whole over ``model`` at each
block's entry and cut again after the block's closing sum, so the
checkpointed layer inputs shrink by the ``model`` size while every block
computes what it computes without it (:meth:`ParallelCtx.seq_split` says
when it applies; :mod:`repro_torch.models.transformer` applies it). Off by
default, as in the reference; its one user there is the dry run's
``extra_flags`` (:mod:`repro_torch.launch.dryrun`).

``decode_shape`` is the (global batch, window) of the decode caches a
context steps. Where the batch does not divide the batch axes (the
reference's ``long_500k``, batch 1), ``cache_specs`` splits the caches'
sequence over ``data`` (:meth:`ParallelCtx.kv_seq_axis`), and the decode
paths read the same rule from this field: each rank attends its block and
the softmax is merged over ``data``
(:func:`repro_torch.parallel.tensor_parallel.merge_softmax`). None (the
default): the caches lie whole along their sequence, as for every batch
that divides.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any


@dataclasses.dataclass(frozen=True)
class ParallelCtx:
    mesh: Any
    dp_axes: tuple[str, ...] = ("data",)   # batch axes (DP/FSDP)
    tp_axis: str = "model"                 # tensor/expert-parallel axis
    #: Megatron-style sequence parallelism of the residual stream
    seq_shard: bool = False
    #: (global batch, window) of the decode caches this context steps
    decode_shape: tuple[int, int] | None = None

    @property
    def dp_size(self) -> int:
        return int(math.prod(self.mesh.shape[a] for a in self.dp_axes))

    @property
    def tp_size(self) -> int:
        return int(self.mesh.shape.get(self.tp_axis, 1))

    @property
    def sharded(self) -> bool:
        """Whether parameters live as ``param_specs`` blocks: the mesh has a
        ``tp_axis``. A mesh of batch axes only keeps every leaf whole on
        every rank (plain data parallelism; MoE experts replicated, each
        rank computing its own slice)."""
        return self.tp_axis in self.mesh.axis_names

    def seq_split(self, seq_len: int) -> bool:
        """Whether a residual stream of ``seq_len`` positions lies between
        blocks as this rank's ``seq_len / tp`` of them: ``seq_shard`` on a
        sharded context of more than one ``model`` rank, and, as the
        reference's ``_hint`` rules, more than one position that the
        ``model`` size divides (so a decode step's one token never
        splits)."""
        tp = self.tp_size
        return (self.seq_shard and self.sharded and tp > 1 and seq_len > 1
                and seq_len % tp == 0)

    def kv_seq_axis(self, batch: int, seq_len: int) -> str | None:
        """The axis a decode cache's sequence of ``seq_len`` positions is
        split over at a global batch of ``batch`` rows: ``"data"`` where the
        batch does not divide the batch axes and the sequence does (the
        reference's ``cache_specs`` rule), else None. The rank at ``data``
        coordinate d then holds positions ``[d S/n, (d+1) S/n)``; ranks on
        other ``pod`` coordinates hold the same blocks."""
        n = self.dp_size
        if batch % n and not seq_len % n:
            return "data"
        return None

    def kv_seq_block(self, seq_len: int) -> tuple[int, str] | None:
        """(first global position, axis) of this rank's block of a decode
        cache of ``seq_len`` local positions, where :attr:`decode_shape`
        puts the caches' sequence over an axis; None where they lie
        whole."""
        if self.decode_shape is None:
            return None
        axis = self.kv_seq_axis(*self.decode_shape)
        if axis is None:
            return None
        n = self.mesh.shape[axis]
        if seq_len * n != self.decode_shape[1]:
            raise ValueError(f"a cache block of {seq_len} positions is not "
                             f"1/{n} of the decode window "
                             f"{self.decode_shape[1]}")
        return self.mesh.coords[axis] * seq_len, axis


def make_parallel_ctx(mesh) -> ParallelCtx:
    """The context of a mesh: its ``pod``/``data`` axes are the batch axes
    (``dp_size`` is what the gradient sync averages over) and ``model`` the
    tensor-parallel axis."""
    dp = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
    return ParallelCtx(mesh=mesh, dp_axes=dp, tp_axis="model")
