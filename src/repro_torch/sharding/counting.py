"""Bytes and calls of every collective a rank runs, by kind: the one rule
by which ``chip_smoke.py`` counts a run on the card and
``launch.dryrun`` counts a traced step.

``CountingDist`` wraps a rank's ``Dist`` and counts what its ``observer``
sees (see ``sharding.dist``): dispatch and combine (the MoE all-to-alls:
split the expert dim and concatenate capacity, and back), all_gather,
reduce_scatter, all_reduce (psum and pmax) and p2p (the expert move, ring
shifts). Bytes sent from this rank, per call, for a group of n ranks: an
all-to-all keeps 1/n of its input, an all-gather sends its input to n - 1
ranks, a reduce-scatter (n - 1)/n of its input, and an all-reduce twice
that (reduce-scatter, then all-gather), as a ring moves them. The
collectives that a backward runs are counted under "<kind>.backward";
with `by_axis` each kind is keyed by its axis as well ("all_gather@data").
A started all-to-all (``Dist.all_to_all_start``) is observed once, at its
start, with the arguments of a plain one, so it counts as one: the same
kind, bytes and call.
Everything else goes to the wrapped Dist.
"""
from __future__ import annotations

A2A_KINDS = {(0, 1): "dispatch", (1, 0): "combine"}


class CountingDist:
    """A rank's Dist with a count of the bytes each collective sends from
    this rank, by kind (see the module docstring)."""

    def __init__(self, dist, by_axis=False):
        self._dist = dist
        self._by_axis = by_axis
        dist.observer = self._observe
        self.reset()

    def __getattr__(self, name):
        return getattr(self._dist, name)

    def reset(self):
        self.counts = {}

    def snapshot(self):
        return {k: {"calls": c, "bytes": b} for k, (c, b) in self.counts.items()}

    def _observe(self, op, x, axis, backward=False, split_dim=None, concat_dim=None):
        n = self._dist.size(axis) if axis is not None else 2
        if op in ("psum", "pmax"):
            kind, share = "all_reduce", 2 * (n - 1) / n
        elif op == "all_gather":
            kind, share = op, n - 1
        elif op == "reduce_scatter":
            kind, share = op, (n - 1) / n
        elif op == "all_to_all":
            kind, share = A2A_KINDS.get((split_dim, concat_dim), op), (n - 1) / n
        else:
            kind, share = "p2p", 1
        if self._by_axis and axis is not None:
            kind += "@" + ("+".join(axis) if isinstance(axis, tuple) else axis)
        if backward:
            kind += ".backward"
        c = self.counts.setdefault(kind, [0, 0])
        c[0] += 1
        c[1] += int(x.numel() * x.element_size() * share)


def count_collectives(dist):
    """``serve``'s and ``train``'s `wrap_dist`: runs in every rank process."""
    return CountingDist(dist)


def count_collectives_by_axis(dist):
    return CountingDist(dist, by_axis=True)
