"""Extended alpha-beta (Hockney) communication model — paper section 3.2.2.

  T = alpha0 + R * alpha_r + D * alpha_d + coeff * m * beta
  beta = 1 / (link_utilization * peak_bandwidth)

alpha0   one-time launch latency per collective
alpha_r  per-communication-round latency (captures A2A growth with XPU count)
alpha_d  per-destination serialization cost
R, D, coeff come from the collective algorithm (core.collectives, Table 3).

Fitted values (paper Table 1, NCCL on DGX H100) are the defaults; the fitting
code itself (fit_alpha_beta) is exercised on synthetic data in
benchmarks/table1_alphabeta.py to validate the methodology.

Layer: leaf of the comm stack — consumed by `core.collectives` (which
supplies R, D, coeff) and `core.topology.Cluster.comm_spec`; depends on
nothing above it. Pure float arithmetic, identical on every path (scalar,
batched, jax), so it has no separate parity contract of its own.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class AlphaBeta:
    alpha0: float           # seconds
    alpha_r: float
    alpha_d: float
    link_utilization: float

    def time(self, *, rounds: float, dests: float, m_coeff: float,
             m_bytes: float, bandwidth: float) -> float:
        beta = 1.0 / (self.link_utilization * bandwidth)
        return (self.alpha0 + rounds * self.alpha_r + dests * self.alpha_d
                + m_coeff * m_bytes * beta)


# paper Table 1
INTRA_NODE = AlphaBeta(alpha0=5.874e-6, alpha_r=0.809e-6, alpha_d=0.323e-6,
                       link_utilization=0.717)
INTER_NODE = AlphaBeta(alpha0=26.508e-6, alpha_r=1.358e-6, alpha_d=0.340e-6,
                       link_utilization=0.843)

# scale-up domains beyond one node behave like the inter-node fit; the paper
# uses the inter-node parameters for cluster-scale collectives.
CLUSTER = INTER_NODE


def fit_alpha_beta(rounds, dests, m_bytes, bandwidth, times):
    """Least-squares fit of (alpha0, alpha_r, alpha_d, utilization) from
    measured collective times — the paper's Table 1 procedure.

    All args are 1-D arrays over measurements. Returns AlphaBeta.
    """
    rounds = np.asarray(rounds, float)
    dests = np.asarray(dests, float)
    m = np.asarray(m_bytes, float)
    times = np.asarray(times, float)
    # linear model: t = a0 + ar*R + ad*D + (1/(u*bw)) * m   (coeff folded in m)
    A = np.stack([np.ones_like(rounds), rounds, dests, m / bandwidth], axis=1)
    x, *_ = np.linalg.lstsq(A, times, rcond=None)
    a0, ar, ad, inv_u = x
    util = 1.0 / max(inv_u, 1e-9)
    return AlphaBeta(alpha0=max(a0, 0.0), alpha_r=max(ar, 0.0),
                     alpha_d=max(ad, 0.0),
                     link_utilization=float(np.clip(util, 0.05, 1.0)))


def mean_relative_error(model_times, actual_times) -> float:
    model_times = np.asarray(model_times, float)
    actual_times = np.asarray(actual_times, float)
    return float(np.mean(np.abs(actual_times - model_times) / actual_times))
