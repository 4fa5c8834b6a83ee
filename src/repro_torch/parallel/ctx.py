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


def make_parallel_ctx(mesh) -> ParallelCtx:
    """The context of a mesh: its ``pod``/``data`` axes are the batch axes
    (``dp_size`` is what the gradient sync averages over) and ``model`` the
    tensor-parallel axis."""
    dp = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
    return ParallelCtx(mesh=mesh, dp_axes=dp, tp_axis="model")
