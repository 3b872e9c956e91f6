"""Forward-looking projection to Blackwell / Rubin (paper section 4.5).

Since future cost data is unavailable, the paper uses the bandwidth required
to reach throughput saturation as a proxy for cost-effectiveness: if the
saturating bandwidth of switchless topologies stays at/below the generation's
provision, their advantage persists.

The compute-time projection applies per-kernel roofline speedups (Table 5
FLOPs and memory-bandwidth scaling) — our compute model is already a
roofline, so switching the XPUSpec does exactly that.

`alpha_scale` models the paper's alpha-reduction study (Fig 19): scaling
alpha_r and alpha_d toward zero (lower software/protocol overhead).

Layer: top-of-stack study over `core.hardware` specs and the sweep
engines; it only swaps inputs (XPUSpec, alphas), so results inherit the
sweep layer's scalar/batched parity unchanged.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

from repro_torch.configs.base import ModelConfig
from repro_torch.core import optimizer
from repro_torch.core.hardware import XPUSpec, BLACKWELL, RUBIN
from repro_torch.core.optimizer import Scenario
from repro_torch.core.topology import (Cluster, TOPOLOGIES, get_fabric,
                                 make_cluster)


@dataclass(frozen=True)
class BWCurvePoint:
    topology: str
    link_bw: float
    throughput_per_xpu: float
    batch: int


def throughput_vs_bandwidth(cfg: ModelConfig, scenario: Scenario,
                            xpu: XPUSpec, topology: str, n: int,
                            bw_grid: Sequence[float], *,
                            opts: str = "dbo+sd",
                            alpha_scale: float = 1.0) -> List[BWCurvePoint]:
    """Throughput-per-XPU as link bandwidth sweeps (paper Fig 18/19).

    The whole bandwidth grid evaluates as one batched sweep; the alpha-scaled
    cluster subclass composes transparently because the sweep engine reads
    alphas through `cluster._ab()`."""
    from repro_torch.core import api

    clusters = []
    for bw in bw_grid:
        cl = make_cluster(topology, n, xpu, link_bw=bw)
        if alpha_scale != 1.0:
            cl = scaled_alpha_cluster(cl, alpha_scale)
        clusters.append(cl)
    grid = api.solve_grid(cfg, clusters, [scenario],
                          api.SearchSpec(opts=opts))
    pts = []
    for bw, row in zip(bw_grid, grid):
        op = row[0].point
        if op is None:
            continue
        pts.append(BWCurvePoint(topology=topology, link_bw=bw,
                                throughput_per_xpu=op.throughput / n,
                                batch=op.batch))
    return pts


def scaled_alpha_cluster(cluster: Cluster, alpha_scale: float) -> Cluster:
    """Cluster whose collectives use alpha_r/alpha_d scaled by
    `alpha_scale` (0.0 = the paper's theoretical bound in Fig 19)."""

    class _Scaled(Cluster):
        def _ab(self):
            ab = super()._ab()
            return dataclasses.replace(
                ab, alpha_r=ab.alpha_r * alpha_scale,
                alpha_d=ab.alpha_d * alpha_scale)

    return _Scaled(topology=cluster.topology, n_xpus=cluster.n_xpus,
                   xpu=cluster.xpu, link_bw=cluster.link_bw,
                   dims=cluster.dims)


def saturating_bandwidth(curve: Sequence[BWCurvePoint],
                         frac: float = 0.97) -> Optional[float]:
    """Smallest bandwidth whose throughput reaches `frac` of the curve's
    ceiling — the paper's saturation-point proxy."""
    if not curve:
        return None
    ceiling = max(p.throughput_per_xpu for p in curve)
    for p in sorted(curve, key=lambda p: p.link_bw):
        if p.throughput_per_xpu >= frac * ceiling:
            return p.link_bw
    return None


GENERATION_PROVISION = {"Blackwell": 900e9, "Rubin": 1800e9}


def generation_report(cfg: ModelConfig, scenario: Scenario, gen_name: str,
                      n: int = 256, *, alpha_scale: float = 1.0) -> Dict:
    """Per-topology saturating bandwidth vs the generation's provision."""
    xpu = {"Blackwell": BLACKWELL, "Rubin": RUBIN}[gen_name]
    provision = GENERATION_PROVISION[gen_name]
    grid = [provision * f for f in (1 / 8, 1 / 4, 1 / 2, 1.0, 2.0)]
    out = {"generation": gen_name, "provision": provision,
           "scenario": scenario.name, "topologies": {}}
    # the grid sweeps fractions of the generation's SCALE-UP provision, so
    # only the scale-up-provisioned static fabrics are comparable here
    # (scale-out's own axis is the NIC; registry-derived, not hardcoded)
    for topo in (t for t in TOPOLOGIES if not get_fabric(t).nic_provisioned):
        curve = throughput_vs_bandwidth(cfg, scenario, xpu, topo, n, grid,
                                        alpha_scale=alpha_scale)
        out["topologies"][topo] = {
            "curve": [(p.link_bw, p.throughput_per_xpu) for p in curve],
            "saturating_bw": saturating_bandwidth(curve),
        }
    return out
