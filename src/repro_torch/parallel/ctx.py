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
queue 3). Nor has it the reference's ``pp_axis``, which no code there
reads either. Every model family runs on a sharded context; ``seq_shard``
(sequence parallelism), the one part of ROADMAP.md queue 1 item 6b left,
raises: its only user in the reference is the dry run's flags (item 9).
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

    def __post_init__(self):
        if self.seq_shard:
            raise NotImplementedError(
                "seq_shard (sequence parallelism over the model axis) is not "
                "ported to repro_torch yet (ROADMAP.md queue 1 item 6b)")

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


def make_parallel_ctx(mesh) -> ParallelCtx:
    """The context of a mesh: its ``pod``/``data`` axes are the batch axes
    (``dp_size`` is what the gradient sync averages over) and ``model`` the
    tensor-parallel axis."""
    dp = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
    return ParallelCtx(mesh=mesh, dp_axes=dp, tp_axis="model")
