"""Collective algorithm cost coefficients per topology (paper Tables 2-3).

Each algorithm maps (cluster size / topology dims, message size m) to the
(rounds, dests, m_coeff) triple consumed by the alpha-beta model. `m` is the
TOTAL payload each XPU contributes (paper convention: ScaleUp-P2P carries
(N-1)/N * m past the NIC). Which algorithms a topology gets to choose from
(the paper-Table-2 menus) is owned by the fabric registry
(`core/fabric.py`); this module holds only the per-algorithm cost
primitives.

Table 3 ground truth (asserted in tests/test_collectives.py):
  ScaleUp-P2P     N=64: 1ar +  63ad + (63/64) m·b     N=256: 1ar + 255ad + (255/256) m·b
  ScaleUp-Bruck   N=64: 6ar +   6ad + 3 m·b           N=256: 8ar +   8ad + 4 m·b
  FullMesh-DoR    N=64: 3ar +  27ad + (9/4) m·b       N=256: 3ar +  51ad + (17/4) m·b
  Torus-HalfRing  N=64: 6ar +  36ad + 3 m·b           N=256: 12ar +  72ad + 6 m·b

beta uses each topology's PER-XPU aggregate bandwidth; the coefficients
already encode how much of that aggregate a given algorithm can actually
drive (e.g. full-mesh DoR is bottlenecked by its thinnest dimension).

Layer: pure coefficient tables between `core.alphabeta` (below) and
`core.topology` (above); no timing is computed here, so scalar/batched
parity is inherited, not asserted.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class CollCost:
    rounds: float
    dests: float
    m_coeff: float
    name: str = ""


# ---------------------------------------------------------------------------
# all-to-all
# ---------------------------------------------------------------------------

def a2a_p2p(n: int) -> CollCost:
    """Direct pairwise exchange (NCCL-style)."""
    return CollCost(rounds=1, dests=n - 1, m_coeff=(n - 1) / n, name="p2p")


def a2a_bruck(n: int) -> CollCost:
    """Bruck's log-round A2A: log2(N) rounds each moving m/2."""
    k = math.ceil(math.log2(n))
    return CollCost(rounds=k, dests=k, m_coeff=k / 2, name="bruck")


def a2a_fullmesh_dor(dims: Tuple[int, ...]) -> CollCost:
    """Dimension-order routing on nD full-mesh with cut-through: per-dim
    phases pipeline; the thinnest dimension bottlenecks the beta term."""
    links = sum(d - 1 for d in dims)
    return CollCost(rounds=len(dims), dests=3 * links,
                    m_coeff=links / min(dims), name="fullmesh-dor")


def a2a_fullmesh_oneshot(dims: Tuple[int, ...]) -> CollCost:
    """One-shot: direct per-destination sends over the mesh links (torus-P2P
    adapted): same bandwidth bottleneck as DoR, P2P-style serialization."""
    n = math.prod(dims)
    links = sum(d - 1 for d in dims)
    return CollCost(rounds=1, dests=n - 1, m_coeff=links / min(dims),
                    name="fullmesh-oneshot")


def a2a_torus_halfring(dims: Tuple[int, ...]) -> CollCost:
    """HalfRing on a 3D torus (Qin et al. [48] adapted): bidirectional ring
    phases per dimension; rounds scale with the largest dimension."""
    r = len(dims) * max(dims) // 2
    return CollCost(rounds=r, dests=2 * len(dims) * r, m_coeff=r / 2,
                    name="torus-halfring")


def a2a_torus_p2p(dims: Tuple[int, ...]) -> CollCost:
    """Direct sends with DOR routing on the torus; average hop dilation
    inflates the beta term (each dim contributes ~d/4 average hops on a
    bidirectional ring, and traffic shares 2 links per dim)."""
    n = math.prod(dims)
    # average hops per dim ~ d/4; effective bandwidth fraction ~ 6/(sum hops*..)
    avg_hops = sum(d / 4 for d in dims)
    return CollCost(rounds=1, dests=n - 1,
                    m_coeff=((n - 1) / n) * avg_hops, name="torus-p2p")


# ---------------------------------------------------------------------------
# point-to-point (pipeline-parallel stage boundary)
# ---------------------------------------------------------------------------

def pp_sendrecv() -> CollCost:
    """One send/recv between corresponding devices of adjacent pipeline
    stages: a single round to a single destination moving the full payload.
    The topology decides the bandwidth the hop rides (one mesh link, the
    NIC, or the scale-up switch — see `Cluster.comm_spec`)."""
    return CollCost(rounds=1, dests=1, m_coeff=1.0, name="sendrecv")


# ---------------------------------------------------------------------------
# all-reduce (coefficient of m is the classic 2(N-1)/N for BW-optimal algos;
# topology-specific effective-bandwidth derating folds into m_coeff)
# ---------------------------------------------------------------------------

def ar_ring(n: int, bw_derate: float = 1.0) -> CollCost:
    return CollCost(rounds=2 * (n - 1), dests=2 * (n - 1),
                    m_coeff=2 * (n - 1) / n * bw_derate, name="ring")


def ar_recursive_doubling(n: int, bw_derate: float = 1.0) -> CollCost:
    k = math.ceil(math.log2(n))
    return CollCost(rounds=k, dests=k, m_coeff=k * bw_derate,
                    name="recursive-doubling")


def ar_rabenseifner(n: int, bw_derate: float = 1.0) -> CollCost:
    """Reduce-scatter + all-gather (recursive halving/doubling)."""
    k = math.ceil(math.log2(n))
    return CollCost(rounds=2 * k, dests=2 * k,
                    m_coeff=2 * (n - 1) / n * bw_derate, name="rabenseifner")


def ar_swing_torus(dims: Tuple[int, ...]) -> CollCost:
    """Swing [12] on torus: near-BW-optimal using all 2*ndim links/XPU."""
    n = math.prod(dims)
    k = math.ceil(math.log2(n))
    return CollCost(rounds=2 * k, dests=2 * k, m_coeff=2 * (n - 1) / n,
                    name="swing")


# The per-topology algorithm MENUS (paper Table 2) live with the fabric
# classes in core/fabric.py (`Fabric.a2a_menu` / `Fabric.ar_menu`) — this
# module stays a registry-free layer of pure cost primitives.
