"""Data-parallel process meshes over ``torch.distributed``.

Counterpart of ``repro.launch.mesh``. A :class:`ProcessMesh` lays the ranks
of an initialized default process group out on named axes, row-major with
the last axis fastest, as ``jax.make_mesh`` lays out devices: on
``(("pod", 2), ("data", 2))`` rank ``r`` sits at ``pod = r // 2``, ``data =
r % 2``. It holds one process group per axis (the ranks that differ only
along it, in ascending order, so a rank's place in its group is its
coordinate) and one over the whole mesh. ``"pod"`` is the slow, inter axis
of the hierarchical collectives and ``"data"`` the fast, intra one.

Nothing here picks an address or starts processes: callers run
``torch.distributed.init_process_group`` (``tcp://localhost:<port>``, world
size and rank given explicitly) first.
"""

from __future__ import annotations

import itertools
import math

import torch.distributed as dist

from repro_torch.device import resolve_device


class ProcessMesh:
    """Named axes over the ranks of the default process group."""

    def __init__(self, shape: tuple[int, ...], axes: tuple[str, ...], *,
                 device=None):
        if not dist.is_initialized():
            raise RuntimeError("ProcessMesh needs torch.distributed "
                               "initialized (init_process_group) first")
        if len(shape) != len(axes):
            raise ValueError(f"shape {shape} and axes {axes} differ in length")
        world = dist.get_world_size()
        if math.prod(shape) != world:
            raise ValueError(f"mesh {dict(zip(axes, shape))} holds "
                             f"{math.prod(shape)} ranks; the world has {world}")
        self.axis_names = tuple(axes)
        self.shape = dict(zip(axes, shape))
        self.rank = dist.get_rank()
        self.device = resolve_device(device)
        strides = [math.prod(shape[i + 1:]) for i in range(len(shape))]
        self.coords = {a: (self.rank // s) % n
                       for a, s, n in zip(axes, strides, shape)}
        # every rank creates every group, in the same order
        self._groups: dict[tuple[str, ...], object] = {}
        for i, axis in enumerate(axes):
            others = [range(n) for j, n in enumerate(shape) if j != i]
            for fixed in itertools.product(*others):
                ranks = []
                for c in range(shape[i]):
                    coord = list(fixed)
                    coord.insert(i, c)
                    ranks.append(sum(x * s for x, s in zip(coord, strides)))
                g = dist.new_group(ranks)
                if self.rank in ranks:
                    self._groups[(axis,)] = g
        self._groups[tuple(sorted(axes))] = dist.new_group(
            list(range(world)))

    def group(self, axes) -> object:
        """The process group spanning ``axes`` (one axis, or all of them)."""
        key = (axes,) if isinstance(axes, str) else tuple(sorted(axes))
        if key not in self._groups:
            raise ValueError(f"no group over {axes}: a mesh has one per axis "
                             f"and one over all of {self.axis_names}")
        return self._groups[key]

    def __repr__(self) -> str:
        return f"ProcessMesh({self.shape}, rank={self.rank}, {self.device})"


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...], *, device=None
              ) -> ProcessMesh:
    """A mesh over the initialized default group, e.g. ``make_mesh((2, 2),
    ("pod", "data"))`` on four ranks. Its groups use the default group's
    backend."""
    return ProcessMesh(shape, axes, device=device)
