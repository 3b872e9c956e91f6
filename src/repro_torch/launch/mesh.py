"""Meshes of ranks: the port's counterpart of ``repro.launch.mesh``.

A ``Mesh`` is a shape and axis names ("data", "model"; "pod" in front on
two pods) laid over the ranks of ``torch.distributed`` in row-major order:
rank r sits at the coordinates of r in the shape. With a process group
initialised, ``make_mesh`` builds one group per axis and per tuple of
axes (in mesh order) through every rank, so that ``Dist`` can run a
collective over any axis name or tuple of names. Without one it is a
description: coordinates and sizes, no groups.
"""
from __future__ import annotations

import itertools
import math
from typing import Dict, List, Optional, Sequence, Tuple


class Mesh:
    def __init__(self, shape: Sequence[int], axes: Sequence[str], rank: int = 0):
        self.shape = tuple(int(n) for n in shape)
        self.axes = tuple(axes)
        if len(self.shape) != len(self.axes):
            raise ValueError(f"mesh shape {self.shape} and axes {self.axes} differ in length")
        if not 0 <= rank < self.n_ranks:
            raise ValueError(f"rank {rank} is not on a mesh of {self.n_ranks}")
        self.rank = rank
        self._groups: Dict[Tuple[str, ...], object] = {}

    @property
    def n_ranks(self) -> int:
        return math.prod(self.shape)

    @property
    def axis_sizes(self) -> Dict[str, int]:
        return dict(zip(self.axes, self.shape))

    def coords(self, rank: Optional[int] = None) -> Dict[str, int]:
        """Axis name -> coordinate of `rank` (default: this rank)."""
        r = self.rank if rank is None else rank
        out = {}
        for a, n in reversed(list(zip(self.axes, self.shape))):
            out[a] = r % n
            r //= n
        return {a: out[a] for a in self.axes}

    def rank_of(self, coords: Dict[str, int]) -> int:
        r = 0
        for a, n in zip(self.axes, self.shape):
            r = r * n + coords[a]
        return r

    def key(self, axis) -> Tuple[str, ...]:
        """An axis name or tuple of names as the tuple of its axes larger
        than 1, which must stand in mesh order."""
        names = axis if isinstance(axis, tuple) else (axis,)
        for a in names:
            if a not in self.axes:
                raise ValueError(f"axis {a!r} is not on the mesh {self.axes}")
        key = tuple(a for a in names if self.axis_sizes[a] > 1)
        order = [self.axes.index(a) for a in key]
        if order != sorted(order):
            raise ValueError(f"axes {names} are not in mesh order {self.axes}")
        return key

    def size(self, axis) -> int:
        return math.prod(self.axis_sizes[a] for a in self.key(axis))

    def index(self, axis, rank: Optional[int] = None) -> int:
        """Row-major index of `rank` along the axes of `axis`."""
        c = self.coords(rank)
        i = 0
        for a in self.key(axis):
            i = i * self.axis_sizes[a] + c[a]
        return i

    def group_ranks(self, axis, rank: Optional[int] = None) -> List[int]:
        """The global ranks of `rank`'s group along `axis`, in index order."""
        key = self.key(axis)
        c = self.coords(rank)
        out = []
        for idx in itertools.product(*(range(self.axis_sizes[a]) for a in key)):
            c.update(zip(key, idx))
            out.append(self.rank_of(c))
        return out

    def all_groups(self, key: Tuple[str, ...]) -> List[List[int]]:
        """Every group along the axes of `key`, each in index order."""
        seen, groups = set(), []
        for r in range(self.n_ranks):
            g = self.group_ranks(key, r)
            if g[0] not in seen:
                seen.add(g[0])
                groups.append(g)
        return groups

    def build_groups(self, backend: Optional[str] = None):
        """One process group per axis and per tuple of axes larger than 1,
        through every rank: every rank must call this, in the same order."""
        import torch.distributed as td
        if td.get_world_size() != self.n_ranks:
            raise ValueError(f"world of {td.get_world_size()} ranks for a mesh "
                             f"of {self.n_ranks}")
        self.rank = td.get_rank()
        live = [a for a in self.axes if self.axis_sizes[a] > 1]
        for k in range(1, len(live) + 1):
            for key in itertools.combinations(live, k):
                mine, _ = td.new_subgroups_by_enumeration(self.all_groups(key),
                                                          backend=backend)
                self._groups[key] = mine
        return self

    def group(self, axis):
        key = self.key(axis)
        if key not in self._groups:
            raise ValueError(f"no process group for axes {key}: build_groups first")
        return self._groups[key]

    def __repr__(self):
        return f"Mesh({dict(zip(self.axes, self.shape))}, rank={self.rank})"


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The production shapes: one pod 16x16 ("data", "model"), two pods
    2x16x16 ("pod", "data", "model"). A description without groups."""
    if multi_pod:
        return Mesh((2, 16, 16), ("pod", "data", "model"))
    return Mesh((16, 16), ("data", "model"))


def make_mesh(shape, axes, *, backend: Optional[str] = None) -> Mesh:
    """A mesh of this process's rank; with torch.distributed initialised,
    its groups are built (a collective call: every rank makes the same
    mesh)."""
    import torch.distributed as td
    if td.is_available() and td.is_initialized():
        return Mesh(shape, axes, td.get_rank()).build_groups(backend)
    return Mesh(shape, axes)


def mesh_axis_sizes(mesh: Mesh) -> dict:
    return mesh.axis_sizes
