"""Expert-load skew and replication/placement search.

Layer: pure workload-side math, below `core.workload` (which consumes the
per-layer factors via `ServingPoint.moe_load` / `ServingPoint.moe_extra`)
and `core.sweep` (which turns them into per-op coefficient multipliers).
Nothing here touches topologies, tables, or timing.

Parity contract: every function is deterministic given
(num_experts, zipf_s, routing_seed, ep, extra_slots) — NumPy's
`default_rng` is stable across platforms, so the same Scenario produces
bit-identical load factors everywhere. Scalar (`optimizer.tpot_at`) and
batched (`sweep.GridEval`) paths both read these factors, which is what
keeps them within 1e-9 of each other under skew.

Model
-----
A `Scenario(routing="zipf", zipf_s=s, routing_seed=k)` draws, per MoE
layer, an expert-popularity vector p with p_(rank r) proportional to
r**(-s), assigned to expert ids by a seeded per-layer permutation
(`np.random.default_rng([seed, layer])`). The serving cost model then
charges the MAX per-rank expert load instead of the mean:

  load_factor(layer) = ep * max_r (sum of p_i over experts hosted on r)

which multiplies the row-linear terms of the expert grouped GEMM and the
A2A dispatch/gather payload (a symmetric collective finishes when its
hottest rank does). load_factor >= 1 always, with equality iff the load
is perfectly balanced; uniform routing gives exactly 1 and takes the
byte-identical fast path (no factors materialised at all).

Replication/placement search
----------------------------
`extra_slots=R` gives every rank R expert slots beyond its E/ep shard,
spending HBM headroom (`workload.model_shard_bytes(..., extra_experts=R)`
charges the weights; `max_batch_by_memory` shrinks the batch grid
accordingly). Replicas are allocated greedily — each of the ep*R slots
goes to the expert with the highest per-instance load p_i / c_i — and
instances are placed LPT (heaviest first into the least-loaded rank with
a free slot and no copy of that expert), flattening the per-rank and
per-link A2A load. `sweep` merges the R candidates with R=0 first, so
`placement="auto"` can never lose to no-placement and uniform scenarios
keep the byte-identical R=0 arm.
"""
from __future__ import annotations

from functools import lru_cache
from typing import Tuple

import numpy as np

__all__ = [
    "zipf_probs",
    "replica_counts",
    "place_instances",
    "layer_load_factors",
    "point_factors",
    "hosting_factor",
]


def zipf_probs(num_experts: int, s: float, seed: int, layer: int) -> np.ndarray:
    """Per-layer expert popularity: Zipf(s) over popularity rank, assigned
    to expert ids by a seeded per-layer permutation.

    The permutation depends only on (seed, layer) — NOT on s — so for a
    fixed scenario seed the same experts stay hot as s grows, and load
    factors are monotone in s.
    """
    if s <= 0.0:
        return np.full(num_experts, 1.0 / num_experts)
    ranks = np.arange(1, num_experts + 1, dtype=np.float64)
    w = ranks ** (-float(s))
    p = w / w.sum()
    perm = np.random.default_rng([int(seed), int(layer)]).permutation(num_experts)
    out = np.empty_like(p)
    out[perm] = p  # expert id perm[r] has popularity rank r+1
    return out


def replica_counts(probs: np.ndarray, ep: int, extra_slots: int) -> np.ndarray:
    """Greedy replica allocation: grant each of the ep*extra_slots spare
    slots to the expert with the highest per-instance load p_i / c_i.

    Returns instance counts (one per expert, >= 1, <= ep — a second copy
    on the same rank is useless). Deterministic: argmax breaks ties at
    the lowest expert id.
    """
    counts = np.ones(len(probs), dtype=np.int64)
    for _ in range(int(ep) * int(extra_slots)):
        per = probs / counts
        per[counts >= ep] = -1.0
        i = int(per.argmax())
        if per[i] < 0:
            break  # every expert already has one instance per rank
        counts[i] += 1
    return counts


def place_instances(probs: np.ndarray, counts: np.ndarray, ep: int,
                    cap: int) -> np.ndarray:
    """LPT placement of expert instances into ep rank bins of `cap` slots.

    Instances (load p_i / c_i each) are sorted heaviest-first and each is
    placed on the least-loaded rank that has a free slot and no copy of
    that expert yet. Returns the per-rank load shares (sums to 1).
    Deterministic: ties break at the lower expert id / lower rank id.
    """
    loads = np.zeros(ep, dtype=np.float64)
    free = np.full(ep, int(cap), dtype=np.int64)
    hosted = [set() for _ in range(ep)]
    inst = []
    for e, c in enumerate(counts):
        inst.extend([(probs[e] / c, e)] * int(c))
    inst.sort(key=lambda t: (-t[0], t[1]))
    for load, e in inst:
        placed = False
        for r in np.argsort(loads, kind="stable"):
            if free[r] > 0 and e not in hosted[r]:
                loads[r] += load
                free[r] -= 1
                hosted[r].add(e)
                placed = True
                break
        if not placed:  # cap exhausted (cannot happen when cap*ep >= instances)
            r = int(np.argmin(loads))
            loads[r] += load
    return loads


@lru_cache(maxsize=8192)
def _layer_factor(num_experts: int, ep: int, s: float, seed: int,
                  layer: int, extra_slots: int) -> float:
    """Hot-rank load factor (ep * max per-rank load share) for one MoE layer."""
    if ep <= 1:
        return 1.0
    probs = zipf_probs(num_experts, s, seed, layer)
    if extra_slots <= 0:
        # Naive placement: experts live on ranks in id order (contiguous
        # blocks). The per-layer permutation makes this equivalent to a
        # random assignment — the un-searched baseline.
        chunks = np.array_split(probs, ep)
        worst = max(float(c.sum()) for c in chunks)
    else:
        counts = replica_counts(probs, ep, extra_slots)
        cap = max(num_experts // ep, 1) + int(extra_slots)
        worst = float(place_instances(probs, counts, ep, cap).max())
    return max(ep * worst, 1.0)


def _n_moe_layers(cfg) -> int:
    return sum(1 for spec in cfg.layer_specs if spec.ffn == "moe")


@lru_cache(maxsize=4096)
def _factors_tuple(num_experts: int, n_moe: int, ep: int, s: float,
                   seed: int, extra_slots: int) -> Tuple[float, ...]:
    return tuple(_layer_factor(num_experts, ep, s, seed, li, extra_slots)
                 for li in range(n_moe))


def layer_load_factors(cfg, scenario, ep: int,
                       extra_slots: int = 0) -> Tuple[float, ...]:
    """Per-MoE-layer hot-rank load factors for a scenario (all >= 1).

    Layer index here is the MoE ordinal (0-based among MoE layers in
    execution order) — the same counter `workload.decode_iteration` and
    `optable.moe_layer` use, so factors line up across scalar and
    batched paths.
    """
    if cfg.moe is None:
        return ()
    skewed = getattr(scenario, "is_skewed", False)
    s = float(scenario.zipf_s) if skewed else 0.0
    seed = int(getattr(scenario, "routing_seed", 0))
    return _factors_tuple(cfg.moe.num_experts, _n_moe_layers(cfg),
                          int(ep), s, seed, int(extra_slots))


def point_factors(cfg, scenario, ep: int,
                  extra_slots: int = 0) -> Tuple[float, ...]:
    """`ServingPoint.moe_load` value for a scenario: per-MoE-layer load
    factors when the scenario is skewed, or () (the byte-identical
    uniform default) otherwise."""
    if cfg.moe is None or not getattr(scenario, "is_skewed", False):
        return ()
    return layer_load_factors(cfg, scenario, ep, extra_slots)


def hosting_factor(cfg, ep: int, extra_slots: int) -> float:
    """Weight-hosting multiplier for the expert grouped GEMM's streamed
    bytes: (E/ep + extra) / (E/ep). 1.0 without replication."""
    if cfg.moe is None or extra_slots <= 0:
        return 1.0
    experts_local = max(cfg.moe.num_experts // max(ep, 1), 1)
    return (experts_local + extra_slots) / experts_local
