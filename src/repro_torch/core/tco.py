"""Cluster TCO model (paper section 3.4).

Monthly TCO = amortized CapEx (3-year lifetime) + monthly OpEx.

CapEx:
  - XPU: catalog price each.
  - Switch: linear in capacity = radix x per-port bandwidth (R^2=0.93 fit in
    the paper); switchless topologies carry zero switch cost. The OCS
    fabric instead pays per MEMS port (bandwidth-independent).
  - Link: fixed cost per unit bandwidth per cable type; AOC = 6.7x copper;
    OCS transceiver-terminated fiber priced between the two.

OpEx: TDP x electricity price x PUE (plus switch/link port power).

An adjustment factor c scales the network share:
  monthly_tco = monthly_xpu + c * monthly_network.

Costs are reported normalized to a reference unit (paper: 'normalized to a
reference unit cost rather than absolute dollar figures').

Layer: cost side only — consumes `core.topology` inventories, never
timing; throughput/$ figures pair its output with sweep results
downstream (benchmarks), so it carries no scalar/batched parity
obligations.
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.core.topology import Cluster

HOURS_PER_MONTH = 730.0
AMORTIZE_MONTHS = 36.0

# cost constants (catalog-derived; normalized in all reports).
# SWITCH: linear capacity fit (radix x port BW); anchors: 64x400Gbps IB/Eth
# switch (3.2 TB/s) at ~$38k and NVLink-class scale-up switching at a
# premium -> ~$18 per GB/s of capacity on the blended fit.
# COPPER: 400G DAC ~ $300 for 50 GB/s -> ~$6 per GB/s; AOC = 6.7x (paper).
SWITCH_USD_PER_GBPS = 18.0         # linear capacity model (radix x port BW)
COPPER_USD_PER_GBPS = 6.0          # per GB/s of link bandwidth
AOC_MULT = 6.7                     # paper: AOCs priced at 6.7x copper
ELECTRICITY_USD_PER_KWH = 0.083    # US industrial average
PUE = 1.3                          # paper cites LBNL AI-cluster PUE
SWITCH_W_PER_GBPS = 0.025          # switch power scales with capacity
NIC_W_PER_XPU = 25.0

# OCS fabric pricing (docs/fabrics.md): a MEMS circuit-switch port costs
# the same whatever bandwidth the light carries — the OCS thesis — so it
# is priced PER PORT, not per GB/s; the per-GB/s cost sits in the
# transceivers that terminate each fiber, between copper DACs and the
# full AOC premium (the MEMS path replaces the electrical switch tiers,
# so `switch_capacity_total` is 0 and these two lines are the whole
# network bill). Port power is the MEMS mirror drive + monitoring, a few
# W per port — far below a packet switch ASIC's per-port burn.
OCS_PORT_USD = 300.0               # per MEMS port (bandwidth-independent)
OCS_TRX_USD_PER_GBPS = 10.0        # optical transceiver, per GB/s
OCS_W_PER_PORT = 1.5


@dataclass(frozen=True)
class TCOBreakdown:
    monthly_xpu: float
    monthly_switch: float
    monthly_link: float
    monthly_energy_xpu: float
    monthly_energy_net: float

    @property
    def monthly_network(self) -> float:
        return self.monthly_switch + self.monthly_link + self.monthly_energy_net

    def total(self, c: float = 1.0) -> float:
        return self.monthly_xpu + self.monthly_energy_xpu \
            + c * self.monthly_network

    def per_xpu(self, n: int, c: float = 1.0) -> float:
        return self.total(c) / n


def cluster_tco(cluster: Cluster) -> TCOBreakdown:
    n = cluster.n_xpus
    xpu = cluster.xpu

    capex_xpu = n * xpu.cost_usd
    capex_switch = (cluster.switch_capacity_total() / 1e9) * SWITCH_USD_PER_GBPS \
        + cluster.ocs_port_count() * OCS_PORT_USD
    links = cluster.link_inventory()
    capex_link = (links.copper_gbps_total * COPPER_USD_PER_GBPS
                  + links.aoc_gbps_total * COPPER_USD_PER_GBPS * AOC_MULT
                  + links.ocs_trx_gbps_total * OCS_TRX_USD_PER_GBPS)

    kwh_price = ELECTRICITY_USD_PER_KWH * PUE * HOURS_PER_MONTH / 1000.0
    energy_xpu = n * xpu.tdp_w * kwh_price
    net_w = (cluster.switch_capacity_total() / 1e9) * SWITCH_W_PER_GBPS \
        + n * NIC_W_PER_XPU + cluster.ocs_port_count() * OCS_W_PER_PORT
    energy_net = net_w * kwh_price

    return TCOBreakdown(
        monthly_xpu=capex_xpu / AMORTIZE_MONTHS,
        monthly_switch=capex_switch / AMORTIZE_MONTHS,
        monthly_link=capex_link / AMORTIZE_MONTHS,
        monthly_energy_xpu=energy_xpu,
        monthly_energy_net=energy_net,
    )


def throughput_per_cost(throughput_tok_s: float, cluster: Cluster,
                        c: float = 1.0) -> float:
    """tokens/s per normalized monthly cost unit."""
    tco = cluster_tco(cluster).total(c)
    return throughput_tok_s / max(tco, 1e-9)


def availability_adjusted_throughput_per_cost(cluster: Cluster, cfg,
                                              scenario, *,
                                              mtbf_scale: float = 1.0,
                                              max_total_faults: int = 2,
                                              c: float = 1.0,
                                              model=None):
    """fig14's throughput/$ metric with the numerator replaced by the
    expected steady-state throughput under the stationary failure
    distribution (`core/availability.py`): the cluster still pays full TCO
    while serving degraded. Pass a prebuilt `AvailabilityModel` via
    `model` to amortize the degraded searches across an MTBF sweep.

    Returns (tokens/s per cost unit, AvailabilityReport, AvailabilityModel).
    """
    from repro_torch.core import availability as av
    if model is None:
        model = av.build_availability(cluster, cfg, scenario,
                                      max_total_faults=max_total_faults)
    report = model.report(mtbf_scale)
    return (throughput_per_cost(report.expected_throughput, cluster, c),
            report, model)
