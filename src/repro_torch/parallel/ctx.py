"""Parallel context threaded through the train step (mesh + axis roles).

Counterpart of ``repro.parallel.ctx`` and of ``repro.launch.mesh``'s
``make_parallel_ctx``, for the port's data-parallel process meshes
(:class:`repro_torch.launch.mesh.ProcessMesh`). Tensor and
pipeline parallelism, ZeRO weight gathering and sequence sharding wait for
the port's sharding (ROADMAP.md queue 1 item 6).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any


@dataclasses.dataclass(frozen=True)
class ParallelCtx:
    mesh: Any
    dp_axes: tuple[str, ...] = ("data",)   # batch axes (DP)

    @property
    def dp_size(self) -> int:
        return int(math.prod(self.mesh.shape[a] for a in self.dp_axes))


def make_parallel_ctx(mesh) -> ParallelCtx:
    """The context of a DP mesh: its ``pod``/``data`` axes are the batch
    axes, so ``dp_size`` is the world size the gradient sync averages
    over."""
    dp = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
    return ParallelCtx(mesh=mesh, dp_axes=dp)
