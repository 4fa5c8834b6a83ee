"""Process meshes over ``torch.distributed``.

Counterpart of ``repro.launch.mesh``. A :class:`ProcessMesh` lays the ranks
of an initialized default process group out on named axes, row-major with
the last axis fastest, as ``jax.make_mesh`` lays out devices: on
``(("pod", 2), ("data", 2))`` rank ``r`` sits at ``pod = r // 2``, ``data =
r % 2``. It holds one process group over every non-empty set of its axes
(the ranks that differ only along those axes, in ascending order): one per
axis, so a rank's place in an axis group is its coordinate, and one per
pair, e.g. ``("pod", "data")`` for the batch of a ``(pod, data, model)``
mesh. ``"pod"`` is the slow, inter axis of the hierarchical collectives,
``"data"`` the fast, intra one and ``"model"`` the tensor/expert-parallel
one. :class:`AbstractMesh` is the same layout without processes (the
counterpart of ``jax.sharding.AbstractMesh``): the sharding rules and the
GVAS map need only axis names and sizes. :class:`DryMesh` is one rank of a
mesh whose other ranks do not exist: its groups are
:class:`~repro_torch.core.collectives.DryGroup` stand-ins, on which the
collectives give results of the right shape and move nothing (the dry run,
:mod:`repro_torch.launch.dryrun`, plays rank 0 of the production mesh on
``meta`` tensors with it).

Nothing here picks an address or starts processes: callers run
``torch.distributed.init_process_group`` (``tcp://localhost:<port>``, world
size and rank given explicitly) first.
"""

from __future__ import annotations

import itertools
import math

import torch
import torch.distributed as dist

from repro_torch.core.collectives import DryGroup, register_group
from repro_torch.device import resolve_device


class AbstractMesh:
    """Named axes and their sizes, row-major (the last axis fastest)."""

    def __init__(self, shape: tuple[int, ...], axes: tuple[str, ...]):
        if len(shape) != len(axes):
            raise ValueError(f"shape {shape} and axes {axes} differ in length")
        self.axis_names = tuple(axes)
        self.shape = dict(zip(axes, (int(n) for n in shape)))
        self._strides = {a: math.prod(shape[i + 1:])
                         for i, a in enumerate(axes)}

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def coords_of(self, rank: int) -> dict:
        """The mesh coordinates of ``rank``."""
        return {a: (rank // self._strides[a]) % self.shape[a]
                for a in self.axis_names}

    def rank_of(self, coords: dict) -> int:
        return sum(coords[a] * self._strides[a] for a in self.axis_names)

    def __repr__(self) -> str:
        return f"{type(self).__name__}({self.shape})"


class ProcessMesh(AbstractMesh):
    """Named axes over the ranks of the default process group."""

    def __init__(self, shape: tuple[int, ...], axes: tuple[str, ...], *,
                 device=None):
        if not dist.is_initialized():
            raise RuntimeError("ProcessMesh needs torch.distributed "
                               "initialized (init_process_group) first")
        super().__init__(shape, axes)
        world = dist.get_world_size()
        if self.size != world:
            raise ValueError(f"mesh {self.shape} holds {self.size} ranks; "
                             f"the world has {world}")
        self.rank = dist.get_rank()
        self.device = resolve_device(device)
        self.coords = self.coords_of(self.rank)
        # every rank creates every group, in the same order
        self._groups: dict[tuple[str, ...], object] = {}
        for n in range(1, len(axes) + 1):
            for span in itertools.combinations(self.axis_names, n):
                key = tuple(sorted(span))
                if n == len(axes):
                    self._groups[key] = dist.new_group(list(range(world)))
                    register_group(self._groups[key], key)
                    continue
                fixed_axes = [a for a in self.axis_names if a not in span]
                for fixed in itertools.product(
                        *(range(self.shape[a]) for a in fixed_axes)):
                    base = dict(zip(fixed_axes, fixed))
                    ranks = sorted(self.rank_of({**base, **dict(zip(span, c))})
                                   for c in itertools.product(
                                       *(range(self.shape[a]) for a in span)))
                    g = dist.new_group(ranks)
                    if self.rank in ranks:
                        self._groups[key] = g
                        register_group(g, key)

    def group(self, axes) -> object:
        """The process group spanning ``axes`` (an axis name, or a tuple of
        them in any order): the ranks that share this rank's coordinates on
        every other axis, in ascending rank order."""
        key = (axes,) if isinstance(axes, str) else tuple(sorted(axes))
        if key not in self._groups:
            raise ValueError(f"no group over {axes}: the mesh's axes are "
                             f"{self.axis_names}")
        return self._groups[key]

    def __repr__(self) -> str:
        return f"ProcessMesh({self.shape}, rank={self.rank}, {self.device})"


class DryMesh(AbstractMesh):
    """Rank ``rank`` of a mesh without processes: ``coords``, ``device``
    (``meta``) and ``group(axes)`` as a :class:`ProcessMesh` has them, each
    group a :class:`~repro_torch.core.collectives.DryGroup` of the axes'
    size. Needs no ``torch.distributed``."""

    def __init__(self, shape: tuple[int, ...], axes: tuple[str, ...], *,
                 rank: int = 0, device="meta"):
        super().__init__(shape, axes)
        if not 0 <= rank < self.size:
            raise ValueError(f"rank {rank} outside the mesh's {self.size}")
        self.rank = rank
        self.device = torch.device(device)
        self.coords = self.coords_of(rank)

    def group(self, axes) -> DryGroup:
        key = (axes,) if isinstance(axes, str) else tuple(sorted(axes))
        if not set(key) <= set(self.axis_names):
            raise ValueError(f"no group over {axes}: the mesh's axes are "
                             f"{self.axis_names}")
        return DryGroup(key, math.prod(self.shape[a] for a in key))

    def __repr__(self) -> str:
        return f"DryMesh({self.shape}, rank={self.rank})"


def production_shape(multi_pod: bool) -> tuple[tuple[int, ...],
                                              tuple[str, ...]]:
    """The reference's production mesh: single-pod (16, 16) = ("data",
    "model"), multi-pod (2, 16, 16) = ("pod", "data", "model")."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...], *, device=None
              ) -> ProcessMesh:
    """A mesh over the initialized default group, e.g. ``make_mesh((2, 2),
    ("pod", "data"))`` on four ranks. Its groups use the default group's
    backend."""
    return ProcessMesh(shape, axes, device=device)


def make_production_mesh(*, multi_pod: bool = False, device=None
                         ) -> ProcessMesh:
    """The reference's production mesh over an initialized world of its
    size: single-pod (16, 16) = ("data", "model"), multi-pod (2, 16, 16) =
    ("pod", "data", "model")."""
    return ProcessMesh(*production_shape(multi_pod), device=device)

