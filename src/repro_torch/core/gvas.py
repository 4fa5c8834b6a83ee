"""GVAS (section 4.3) -> sharded tensors over a process mesh.

Counterpart of ``repro.core.gvas``. The paper's 80-bit Global Virtual
Address is (PDID | node | rank | VA): any NI can read/write any process's
memory through SMMU translation. Here a global tensor is a :class:`GlobalArray`:
this rank's block plus the :class:`~repro_torch.parallel.sharding.Sharding`
that lays the blocks out over the mesh:

  PDID  -> the mesh itself (a protection/process-group boundary)
  node  -> mesh coordinates of a rank
  rank  -> the named-axis index along each mesh axis
  VA    -> index into the global tensor; the sharding is the translation
           table ("SMMU") from global index to (rank, local index)

A rank holds only its own block, so :func:`addr_of` computes the owners of
an element from the spec and the mesh's shape, and :func:`shard_of` gives
this rank's block (None for any other rank's, as ``addressable_shards``
holds only a process's own devices).
"""

from __future__ import annotations

import dataclasses
import itertools
import math

import torch


@dataclasses.dataclass(frozen=True)
class GlobalArray:
    """This rank's block ``local`` of a global tensor of ``shape`` laid out
    by ``sharding``."""
    local: torch.Tensor
    sharding: object
    shape: tuple[int, ...]

    @classmethod
    def of(cls, local: torch.Tensor, sharding) -> "GlobalArray":
        return cls(local, sharding, sharding.global_shape(tuple(local.shape)))

    @property
    def dtype(self) -> torch.dtype:
        return self.local.dtype


def addr_of(arr: GlobalArray, global_index: tuple[int, ...]) -> dict:
    """The GVAS 'address' of one element: its owning ranks (every replica)
    with their mesh coordinates and the local index there, in rank
    order."""
    mesh, sh = arr.sharding.mesh, arr.sharding
    out = []
    for coords in itertools.product(*(range(mesh.shape[a])
                                      for a in mesh.axis_names)):
        c = dict(zip(mesh.axis_names, coords))
        window = sh.slices(arr.shape, c)
        if all(s.start <= g < s.stop for g, s in zip(global_index, window)):
            out.append({"rank": mesh.rank_of(c), "coords": c,
                        "local_index": tuple(g - s.start for g, s in
                                             zip(global_index, window))})
    return {"global_index": tuple(global_index), "replicas": out}


def shard_of(arr: GlobalArray, rank: int) -> torch.Tensor | None:
    """The local VA window of ``rank``: this rank's block if it is this
    rank, else None (a rank addresses only its own memory)."""
    return arr.local if rank == arr.sharding.mesh.rank else None


def global_bytes(arr: GlobalArray) -> int:
    return math.prod(arr.shape) * arr.dtype.itemsize
