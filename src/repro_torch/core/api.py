"""Unified serving-search facade: one `solve()` for every search mode.

The operating-point search grew four entry points with overlapping kwarg
sprawls — `optimizer.max_throughput` (decode), `optimizer.best_of_opts`
(decode + software-optimization levels), `optimizer.max_throughput_prefill`
(chunked / disaggregated prefill), and `optimizer.degrade_policy` /
`sweep.degraded_max_throughput` (failure-aware re-search). Downstream
consumers (benchmarks, the traffic simulator, examples) should not need to
know which engine function answers which question, so this module is the
supported surface:

  SearchSpec   frozen value object naming the WHOLE search configuration
               (mapping axes, placement, backend, software opts, serving
               mode, fault state);
  solve()      one (cfg, cluster, scenario, spec) -> Solution call that
               routes to the decode / prefill / degraded search;
  solve_grid() the batched clusters x scenarios form (one engine pass,
               the shape every figure uses);
  solve_levels() the multi-opts-level form (shares one GridEval across
               levels, e.g. fig11's three curves for one engine pass);
  tpot_curve() TPOT over an arbitrary batch grid for a SOLVED point's
               configuration — the seam the traffic simulator clocks
               decode iterations through without touching engine
               internals.

Routing never re-implements a search: every path delegates to the same
`repro_torch.core.sweep` engine calls the legacy wrappers used, so results are
byte-identical to the pre-facade stack. The legacy `optimizer` wrappers
remain as thin shims that emit `ReproDeprecationWarning` (an in-repo
`DeprecationWarning` subclass pytest escalates to an error, so repo code
cannot regress onto them).
"""
from __future__ import annotations

import warnings
from dataclasses import dataclass, field, fields
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.configs.base import ModelConfig
from repro_torch.core import optable, optimizer, sweep
from repro_torch.core.optimizer import (DegradedPlan, OperatingPoint,
                                  PrefillOperatingPoint, Scenario)
from repro_torch.core.specdec import SpecDecConfig
from repro_torch.core.topology import Cluster, FaultSet


class ReproDeprecationWarning(DeprecationWarning):
    """Deprecation category for this repo's legacy entry points.

    A dedicated subclass lets pytest escalate exactly OUR deprecations to
    errors (`filterwarnings` in pyproject.toml) without tripping over
    third-party `DeprecationWarning`s from numpy/jax."""


def warn_deprecated(old: str, new: str) -> None:
    warnings.warn(f"{old} is deprecated; use {new}",
                  ReproDeprecationWarning, stacklevel=3)


PREFILL_MODES = ("decode", "chunked", "disagg")
OPTS_LEVELS = ("noopt", "dbo", "dbo+sd")


@dataclass(frozen=True)
class SearchSpec:
    """Everything that configures an operating-point search, in one frozen
    (hashable, cache-key-able) value object.

    Mapping axes: `tp` / `pp` take an int or "auto" (joint (tp, pp,
    ep = n/(tp*pp)) search); `ep` pins the expert-parallel degree (None =
    derived). `placement="auto"` searches expert replication for skewed
    scenarios. `backend` picks the sweep engine ("numpy" / "torch" / None =
    module default, "torch"); the torch engine's device is the module's
    (`sweep.set_default_device`: the card unless set to "cpu").

    Software opts: either fix the variant with `dbo` / `sd`, or set
    `opts` to a best-of level ("noopt" | "dbo" | "dbo+sd") — the two are
    mutually exclusive, `opts` searches over variants.

    Serving mode: `mode` "decode" (prefill unmodeled, the seed search)
    | "chunked" | "disagg"; prefill modes accept `chunk_grid` /
    `split_fracs` overrides (None = engine defaults).

    Fault state: a `FaultSet` in `faults` routes to the failure-aware
    remap-vs-degrade policy (`optimizer.degrade_policy`) — the Solution
    then carries a `DegradedPlan`. Note the policy's conventional mapping
    default is tp="auto" (re-shard searches the mapping); pass it
    explicitly, the spec default stays tp=1 like every other path.
    """
    tp: Union[int, str] = 1
    pp: Union[int, str] = 1
    ep: Optional[int] = None
    placement: Optional[str] = None
    backend: Optional[str] = None
    faults: Optional[FaultSet] = None
    dbo: bool = False
    sd: Optional[SpecDecConfig] = None
    opts: Optional[str] = None
    mode: str = "decode"
    dtype: str = "fp8"
    chunk_grid: Optional[Tuple[int, ...]] = None
    split_fracs: Optional[Tuple[float, ...]] = None

    def __post_init__(self):
        if self.mode not in PREFILL_MODES:
            raise ValueError(f"unknown mode {self.mode!r}; expected one of "
                             f"{PREFILL_MODES}")
        if self.opts is not None:
            if self.opts not in OPTS_LEVELS:
                raise ValueError(f"unknown opts {self.opts!r}; expected one "
                                 f"of {OPTS_LEVELS}")
            if self.dbo or self.sd is not None:
                raise ValueError("opts searches the (dbo, sd) variants; "
                                 "pass either opts or fixed dbo/sd, not "
                                 "both")
        if self.mode != "decode":
            if self.opts is not None:
                raise ValueError("prefill modes fix the variant via dbo; "
                                 "opts is decode-only")
            if self.sd is not None:
                raise ValueError("speculative decoding is not modeled in "
                                 "prefill modes")
            if self.placement is not None:
                raise ValueError("placement search is decode-only")
        if self.faults is not None:
            if self.mode != "decode":
                raise ValueError("the degraded search is decode-only")
            if self.opts is not None or self.placement is not None \
                    or self.ep is not None:
                raise ValueError("the degraded search resolves ep on the "
                                 "survivor cluster and fixes the variant "
                                 "via dbo/sd; opts/placement/ep do not "
                                 "apply")

    def replace(self, **kw) -> "SearchSpec":
        """`dataclasses.replace` spelled as a method (the spec is the unit
        callers tweak: `spec.replace(faults=fs)`)."""
        cur = {f.name: getattr(self, f.name) for f in fields(self)}
        cur.update(kw)
        return SearchSpec(**cur)


@dataclass(frozen=True)
class Solution:
    """Unified result of `solve()`.

    kind 'decode'   -> `point` is an `OperatingPoint` (or None: SLO
                       unreachable);
         'prefill'  -> `point` is a `PrefillOperatingPoint` (or None);
         'degraded' -> `plan` is the `DegradedPlan`; `point` is the plan's
                       chosen operating point (None when action='down').
    """
    kind: str
    point: Optional[Union[OperatingPoint, PrefillOperatingPoint]]
    plan: Optional[DegradedPlan] = None
    spec: SearchSpec = field(default_factory=SearchSpec, compare=False)

    @property
    def feasible(self) -> bool:
        return self.point is not None

    @property
    def throughput(self) -> float:
        """Tokens/s cluster-wide; 0.0 when infeasible. The degraded kind
        reports the plan's downtime-amortized effective throughput."""
        if self.kind == "degraded":
            return self.plan.effective_throughput if self.plan else 0.0
        return self.point.throughput if self.point else 0.0

    @property
    def tpot(self) -> Optional[float]:
        return self.point.tpot if self.point else None

    @property
    def batch(self) -> Optional[int]:
        return self.point.batch if self.point else None

    @property
    def prefill_point(self) -> Optional[PrefillOperatingPoint]:
        """The point as a `PrefillOperatingPoint`, wrapping decode-mode
        results the way `sweep.sweep_prefill(mode='decode')` does — the
        shape prefill-comparison consumers want."""
        if self.point is None or isinstance(self.point,
                                            PrefillOperatingPoint):
            return self.point
        return sweep._as_decode_point(self.point)


def _prefill_kw(spec: SearchSpec) -> Dict:
    kw: Dict = {}
    if spec.chunk_grid is not None:
        kw["chunk_grid"] = spec.chunk_grid
    if spec.split_fracs is not None:
        kw["split_fracs"] = spec.split_fracs
    return kw


def _solve_degraded(cfg: ModelConfig, cluster: Cluster, scenario: Scenario,
                    spec: SearchSpec) -> Solution:
    plan = optimizer.degrade_policy(cluster, cfg, scenario, spec.faults,
                                    tp=spec.tp, pp=spec.pp, dtype=spec.dtype,
                                    dbo=spec.dbo, sd=spec.sd)
    return Solution(kind="degraded", point=plan.point, plan=plan, spec=spec)


def solve_grid(cfg: ModelConfig, clusters: Sequence[Cluster],
               scenarios: Sequence[Scenario],
               spec: SearchSpec = SearchSpec()) -> List[List[Solution]]:
    """Batched `solve` over clusters x scenarios (one engine pass for the
    decode/prefill paths; the degraded path prices each cell's policy).
    Returns [cluster][scenario] Solutions."""
    if spec.faults is not None:
        return [[_solve_degraded(cfg, cl, sc, spec) for sc in scenarios]
                for cl in clusters]
    if spec.mode != "decode":
        grid = sweep.sweep_prefill(clusters, cfg, scenarios, mode=spec.mode,
                                   tp=spec.tp, pp=spec.pp, ep=spec.ep,
                                   dtype=spec.dtype, dbo=spec.dbo,
                                   backend=spec.backend, **_prefill_kw(spec))
        return [[Solution(kind="prefill", point=p, spec=spec) for p in row]
                for row in grid]
    if spec.opts is not None:
        grid = sweep.best_of_opts_grid(clusters, cfg, scenarios, spec.opts,
                                       tp=spec.tp, pp=spec.pp, ep=spec.ep,
                                       dtype=spec.dtype, backend=spec.backend,
                                       placement=spec.placement)
    else:
        grid = sweep.sweep_max_throughput(clusters, cfg, scenarios,
                                          dbo=spec.dbo, sd=spec.sd,
                                          tp=spec.tp, pp=spec.pp, ep=spec.ep,
                                          dtype=spec.dtype,
                                          backend=spec.backend,
                                          placement=spec.placement)
    return [[Solution(kind="decode", point=p, spec=spec) for p in row]
            for row in grid]


def solve(cfg: ModelConfig, cluster: Cluster, scenario: Scenario,
          spec: SearchSpec = SearchSpec()) -> Solution:
    """THE entry point: best operating point of `cluster` for `scenario`
    under the search configuration in `spec`.

    Routing (all delegate to `repro_torch.core.sweep`, byte-identical to the
    legacy wrappers):
      spec.faults set        -> remap-vs-degrade policy (kind 'degraded')
      spec.mode != 'decode'  -> prefill-aware search    (kind 'prefill')
      spec.opts set          -> best-of-(dbo, sd) search (kind 'decode')
      otherwise              -> fixed-variant decode search (kind 'decode')

    Batch several clusters/scenarios through `solve_grid` to amortize one
    grid evaluation across a whole figure.
    """
    return solve_grid(cfg, [cluster], [scenario], spec)[0][0]


def solve_levels(cfg: ModelConfig, clusters: Sequence[Cluster],
                 scenarios: Sequence[Scenario],
                 levels: Sequence[str] = OPTS_LEVELS,
                 spec: SearchSpec = SearchSpec()
                 ) -> Dict[str, List[List[Solution]]]:
    """`solve_grid` for SEVERAL best-of levels at once, sharing one
    GridEval across them ('dbo+sd' already evaluates everything 'noopt'
    and 'dbo' need — fig11's three curves cost one engine pass). `spec`
    must leave `opts`/`dbo`/`sd` at their defaults (the levels ARE the
    variant axis) and stay on the healthy decode path."""
    if spec.opts is not None or spec.dbo or spec.sd is not None:
        raise ValueError("solve_levels sweeps the variant axis itself; "
                         "leave spec.opts/dbo/sd at defaults")
    if spec.faults is not None or spec.mode != "decode":
        raise ValueError("solve_levels is a healthy decode-path search")
    multi = sweep.best_of_opts_multi(clusters, cfg, scenarios, list(levels),
                                     tp=spec.tp, pp=spec.pp, ep=spec.ep,
                                     dtype=spec.dtype, backend=spec.backend,
                                     placement=spec.placement)
    return {lvl: [[Solution(kind="decode", point=p,
                            spec=spec.replace(opts=lvl))
                   for p in row] for row in multi[lvl]]
            for lvl in levels}


def tpot_curve(cfg: ModelConfig, cluster: Cluster, scenario: Scenario,
               batches: Sequence[int], *, point: OperatingPoint,
               dtype: str = "fp8",
               backend: Optional[str] = None) -> np.ndarray:
    """TPOT seconds at each batch size for a SOLVED point's configuration
    (its (tp, pp, ep) mapping, placement, and software variant) on
    `cluster` — the decode-iteration clock of `repro_torch.core.traffic`.

    Runs the same GridEval the search used, so `curve[batch == point.batch]
    == point.tpot` exactly (modulo the knife-edge scalar fallback, which
    only re-derives the winning cell)."""
    b = np.asarray(list(batches), np.int64)
    table = optable.op_table(cfg, point.tp, max(point.ep, 1),
                             cluster.n_xpus, dtype, pp=point.pp)
    load = sweep.op_load_factors(table, cfg, [scenario],
                                 point.extra_experts)
    ev = sweep.GridEval(table, [cluster], [scenario], b, backend=backend,
                        load=load)
    sd = SpecDecConfig() if point.used_sd else None
    return ev.tpot(dbo=point.used_dbo, sd=sd)[0, 0]
