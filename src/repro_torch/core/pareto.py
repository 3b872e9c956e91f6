"""Performance-vs-cost sweep + Pareto frontier (paper section 4.4, Fig 17).

Each point = (monthly cost per XPU, throughput per XPU) for one
(topology, link bandwidth, cluster size) under a scenario with all software
optimizations. The slope origin->point is throughput per cost; the Pareto
frontier is the upper-left hull.

Layer: presentation-side aggregation over sweep results + `core.tco`;
no timing math of its own, so parity is inherited from the sweep.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence

from repro_torch.configs.base import ModelConfig
from repro_torch.core import optimizer, tco
from repro_torch.core.hardware import XPUSpec
from repro_torch.core.optimizer import Scenario
from repro_torch.core.topology import TOPOLOGIES, make_cluster

# the paper's bandwidth sweep grid, as fractions of the 1x provision
BW_FRACTIONS = (1 / 9, 1 / 3, 2 / 3, 1.0, 2.0)


@dataclass(frozen=True)
class ParetoPoint:
    topology: str
    n_xpus: int
    link_bw: float
    cost_per_xpu: float            # monthly, normalized units
    throughput_per_xpu: float      # tokens/s
    throughput_per_cost: float
    batch: int
    tpot_ms: float

    def dominates(self, other: "ParetoPoint") -> bool:
        return (self.cost_per_xpu <= other.cost_per_xpu
                and self.throughput_per_xpu >= other.throughput_per_xpu
                and (self.cost_per_xpu < other.cost_per_xpu
                     or self.throughput_per_xpu > other.throughput_per_xpu))


def sweep_networks(cfg: ModelConfig, scenario: Scenario, xpu: XPUSpec,
                   *, sizes: Sequence[int] = (64, 256),
                   topologies: Sequence[str] = TOPOLOGIES,
                   bw_fracs: Sequence[float] = BW_FRACTIONS,
                   opts: str = "dbo+sd", c: float = 1.0) -> List[ParetoPoint]:
    """All (topology, link bandwidth) points of one scenario, evaluated as
    one batched grid per cluster size (the sweep engine requires a uniform
    device count per grid). Point order matches the seed's nested loops.
    `topologies` defaults to the registry's static four; pass
    `tuple(repro_torch.core.fabric.FABRICS)` to rank the OCS fabric too."""
    from repro_torch.core import api

    ops_by_size = {}
    for n in sizes:
        keys, clusters = [], []
        for topo in topologies:
            for f in bw_fracs:
                # each topology sweeps fractions of its own provision
                # (`Fabric.default_link_bw`; scale-out: NIC-class fabric
                # on top of the intra-node scale-up domain it always
                # carries — see core.fabric)
                keys.append((topo, f))
                clusters.append(make_cluster(topo, n, xpu,
                                             link_bw_mult=f))
        grid = api.solve_grid(cfg, clusters, [scenario],
                              api.SearchSpec(opts=opts))
        ops_by_size[n] = {k: (cl, row[0].point)
                          for k, cl, row in zip(keys, clusters, grid)}

    points: List[ParetoPoint] = []
    for topo in topologies:
        for n in sizes:
            for f in bw_fracs:
                cl, op = ops_by_size[n][(topo, f)]
                if op is None:
                    continue
                cost = tco.cluster_tco(cl).per_xpu(n, c)
                points.append(ParetoPoint(
                    topology=topo, n_xpus=n, link_bw=cl.link_bw,
                    cost_per_xpu=cost,
                    throughput_per_xpu=op.throughput / n,
                    throughput_per_cost=op.throughput / n / cost,
                    batch=op.batch, tpot_ms=op.tpot * 1e3))
    return points


def pareto_frontier(points: Sequence[ParetoPoint]) -> List[ParetoPoint]:
    """Upper-left hull: no other point has both lower cost and higher
    throughput."""
    frontier = [p for p in points
                if not any(q.dominates(p) for q in points)]
    return sorted(frontier, key=lambda p: p.cost_per_xpu)
