"""Distribution context of the port: the ``Dist`` interface every layer takes.

Layers are written against a ``Dist`` so that a later multi-device slice
can put ``torch.distributed`` collectives behind it without touching them.
This slice ships the single-device part only: ``Dist`` answers topology
questions from its axis sizes and is the identity on axes of size 1, and
``NullDist`` is a ``Dist`` whose every axis has size 1.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

AxisName = Union[str, Tuple[str, ...]]


class Dist:
    """Collective ops bound to mesh axis names."""

    def __init__(self, axis_sizes: dict[str, int]):
        self._sizes = dict(axis_sizes)

    # ------------- topology -------------
    def size(self, axis: Optional[AxisName]) -> int:
        if axis is None:
            return 1
        if isinstance(axis, tuple):
            n = 1
            for a in axis:
                n *= self._sizes.get(a, 1)
            return n
        return self._sizes.get(axis, 1)

    def index(self, axis: Optional[AxisName]) -> int:
        if self.size(axis) == 1:
            return 0
        raise NotImplementedError(
            "multi-device Dist needs torch.distributed, not ported yet")

    # ------------- collectives -------------
    def _local(self, x, axis):
        if self.size(axis) == 1:
            return x
        raise NotImplementedError(
            f"collective over axis {axis!r} (size {self.size(axis)}) needs "
            "torch.distributed, not ported yet")

    def psum(self, x, axis: Optional[AxisName]):
        return self._local(x, axis)

    def pmax(self, x, axis: Optional[AxisName]):
        return self._local(x, axis)

    def all_gather(self, x, axis: Optional[AxisName], dim: int = 0):
        return self._local(x, axis)

    def reduce_scatter(self, x, axis: Optional[AxisName], dim: int = 0):
        return self._local(x, axis)

    def all_to_all(self, x, axis: Optional[AxisName], split_dim: int,
                   concat_dim: int):
        return self._local(x, axis)

    def ppermute(self, x, axis: Optional[AxisName],
                 perm: Sequence[Tuple[int, int]]):
        return self._local(x, axis)

    def roll(self, x, axis: Optional[AxisName], shift: int = 1):
        return self._local(x, axis)


class NullDist(Dist):
    """Single-device stand-in: every collective is the identity."""

    def __init__(self):
        super().__init__({})

    def size(self, axis):
        return 1
